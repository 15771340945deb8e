"""Record header parsers: derive each record's length from its header.

Port copy of ``cobrix_tpu.reader.header_parsers``, unchanged: the
pluggable trait (reference headerparsers/RecordHeaderParser.scala:34-76)
and its RDW (RecordHeaderParserRDW.scala:24-87) and fixed-length
(RecordHeaderParserFixedLen.scala:22-52) implementations, plus the
dotted-name factory for custom parsers (RecordHeaderParserFactory.scala:22-45).
A custom parser must subclass THIS module's `RecordHeaderParser`: the
port imports nothing of the JAX package, so a class written against the
JAX package's base class is refused with its TypeError.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..copybook.datatypes import MAX_RDW_RECORD_SIZE
from .diagnostics import FramingError, hex_snapshot


@dataclass(frozen=True)
class RecordMetadata:
    record_length: int
    is_valid: bool


class RecordHeaderParser:
    """Pluggable record-length-from-header contract."""

    @property
    def header_length(self) -> int:
        raise NotImplementedError

    @property
    def is_header_defined_in_copybook(self) -> bool:
        return False

    def get_record_metadata(self, header: bytes, file_offset: int,
                            file_size: int, record_num: int) -> RecordMetadata:
        raise NotImplementedError

    def on_receive_additional_info(self, additional_info: str) -> None:
        pass


class RdwHeaderParser(RecordHeaderParser):
    """4-byte RDW: BE length in bytes[0..1], LE in bytes[3..2], plus an
    adjustment; zero-length records are a hard error; file header/footer
    regions are emitted as invalid records so callers skip them."""

    def __init__(self, is_big_endian: bool = False, file_header_bytes: int = 0,
                 file_footer_bytes: int = 0, rdw_adjustment: int = 0):
        self.is_big_endian = is_big_endian
        self.file_header_bytes = file_header_bytes
        self.file_footer_bytes = file_footer_bytes
        self.rdw_adjustment = rdw_adjustment

    @property
    def header_length(self) -> int:
        return 4

    def get_record_metadata(self, header: bytes, file_offset: int,
                            file_size: int, record_num: int) -> RecordMetadata:
        hlen = self.header_length
        if self.file_header_bytes > hlen and file_offset == hlen:
            return RecordMetadata(self.file_header_bytes - hlen, False)
        if (file_size > 0 and self.file_footer_bytes > 0
                and file_size - file_offset <= self.file_footer_bytes):
            return RecordMetadata(file_size - file_offset, False)
        if len(header) < hlen:
            return RecordMetadata(-1, False)
        if self.is_big_endian:
            length = header[1] + 256 * header[0] + self.rdw_adjustment
        else:
            length = header[2] + 256 * header[3] + self.rdw_adjustment
        if length > 0:
            if length > MAX_RDW_RECORD_SIZE:
                hdr = ",".join(str(b) for b in header)
                raise FramingError(
                    f"RDW headers too big (length = {length} > "
                    f"{MAX_RDW_RECORD_SIZE}). Headers = {hdr} at file offset "
                    f"{file_offset} (header bytes: {hex_snapshot(header)}).",
                    offset=file_offset, reason="oversized RDW header",
                    header=header)
            return RecordMetadata(length, True)
        hdr = ",".join(str(b) for b in header)
        raise FramingError(
            f"RDW headers should never be zero ({hdr}). "
            f"Found zero size record at file offset {file_offset} "
            f"(header bytes: {hex_snapshot(header)}).",
            offset=file_offset, reason="zero-length RDW header",
            header=header)


class FixedLengthHeaderParser(RecordHeaderParser):
    """No header; records are fixed-size; optional file header/footer bytes
    are emitted as invalid records."""

    def __init__(self, record_size: int, file_header_bytes: int = 0,
                 file_footer_bytes: int = 0):
        self.record_size = record_size
        self.file_header_bytes = file_header_bytes
        self.file_footer_bytes = file_footer_bytes

    @property
    def header_length(self) -> int:
        return 0

    def get_record_metadata(self, header: bytes, file_offset: int,
                            file_size: int, record_num: int) -> RecordMetadata:
        if self.file_header_bytes > 0 and file_offset == 0:
            return RecordMetadata(self.file_header_bytes, False)
        if (file_size > 0 and self.file_footer_bytes > 0
                and file_size - file_offset <= self.file_footer_bytes):
            return RecordMetadata(file_size - file_offset, False)
        if file_size - file_offset >= self.record_size:
            return RecordMetadata(self.record_size, True)
        return RecordMetadata(-1, False)


def create_record_header_parser(name: str,
                                record_size: int = 0,
                                file_header_bytes: int = 0,
                                file_footer_bytes: int = 0,
                                rdw_adjustment: int = 0) -> RecordHeaderParser:
    """Create a parser by well-known name ('rdw', 'rdw_big_endian',
    'rdw_little_endian', 'fixed_length') or by a dotted Python path to a
    custom RecordHeaderParser class."""
    lowered = name.lower()
    if lowered in ("rdw", "rdw_little_endian"):
        return RdwHeaderParser(False, file_header_bytes, file_footer_bytes,
                               rdw_adjustment)
    if lowered == "rdw_big_endian":
        return RdwHeaderParser(True, file_header_bytes, file_footer_bytes,
                               rdw_adjustment)
    if lowered in ("fixed_length", "fixed_len"):
        return FixedLengthHeaderParser(record_size, file_header_bytes,
                                       file_footer_bytes)
    module_name, _, class_name = name.rpartition(".")
    if not module_name:
        raise ValueError(
            f"Unknown record header parser '{name}'. Use one of 'rdw', "
            "'rdw_big_endian', 'rdw_little_endian', 'fixed_length', or a "
            "dotted path to a RecordHeaderParser subclass "
            "(e.g. 'my_pkg.my_module.MyParser').")
    try:
        module = importlib.import_module(module_name)
    except ImportError as exc:
        raise ValueError(
            f"Custom record header parser '{name}': module "
            f"'{module_name}' could not be imported ({exc}).") from exc
    try:
        cls = getattr(module, class_name)
    except AttributeError:
        raise ValueError(
            f"Custom record header parser '{name}': module "
            f"'{module_name}' has no attribute '{class_name}'.") from None
    instance = cls()
    if not isinstance(instance, RecordHeaderParser):
        raise TypeError(
            f"Custom record header parser {name} must subclass RecordHeaderParser")
    return instance
