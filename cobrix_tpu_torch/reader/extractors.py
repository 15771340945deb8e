"""Decode-time options shared by the scalar oracle and the kernels.

Port copy of ``cobrix_tpu.reader.extractors``, reduced to `DecodeOptions`
and `_decode_primitive` (one field's bounds rule, which the variable-size
OCCURS extractor reads its DEPENDING ON counters with): the port
materializes rows from decoded columns only, so the host record walk
(`extract_record` and the rest of its helpers) is not carried over.
"""
from __future__ import annotations

from ..copybook.ast import Primitive
from ..copybook.datatypes import FloatingPointFormat, TrimPolicy
from ..ops import scalar_decoders


class DecodeOptions:
    """Decode-time options shared by the scalar oracle and the kernels."""

    def __init__(self,
                 trimming: TrimPolicy = TrimPolicy.BOTH,
                 ebcdic_code_page: str = "common",
                 ascii_charset: str = "us-ascii",
                 is_utf16_big_endian: bool = True,
                 floating_point_format: FloatingPointFormat = FloatingPointFormat.IBM):
        self.trimming = trimming
        self.ebcdic_code_page = ebcdic_code_page
        self.ascii_charset = ascii_charset
        self.is_utf16_big_endian = is_utf16_big_endian
        self.floating_point_format = floating_point_format

    @classmethod
    def from_copybook(cls, copybook) -> "DecodeOptions":
        return cls(trimming=copybook.string_trimming_policy,
                   ebcdic_code_page=copybook.ebcdic_code_page,
                   ascii_charset=copybook.ascii_charset,
                   is_utf16_big_endian=copybook.is_utf16_big_endian,
                   floating_point_format=copybook.floating_point_format)

    def decode(self, dtype, data: bytes):
        return scalar_decoders.decode_field(
            dtype, data,
            trimming=self.trimming,
            ebcdic_code_page=self.ebcdic_code_page,
            ascii_charset=self.ascii_charset,
            is_utf16_big_endian=self.is_utf16_big_endian,
            floating_point_format=self.floating_point_format)


def _decode_primitive(st: Primitive, offset: int, data: bytes,
                      options: DecodeOptions):
    """Bounds policy of reference Primitive.decodeTypeValue (Primitive.scala:102):
    strings may be truncated by the record end; non-strings must fit."""
    from ..copybook.datatypes import AlphaNumeric
    size = st.binary_properties.data_size
    is_string = isinstance(st.dtype, AlphaNumeric)
    if is_string:
        if offset > len(data):
            return None
    else:
        if offset + size > len(data):
            return None
    return options.decode(st.dtype, data[offset: offset + size])
