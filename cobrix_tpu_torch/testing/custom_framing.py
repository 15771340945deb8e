"""A custom record header parser and a custom record extractor for the
5-byte record header of `generators.generate_custom_rdw` (the reference's
TestDataGen11CustomRDW): byte 0 a validity flag, bytes 3-4 the
little-endian payload length.

They are written against the port's base classes and named by dotted
path in `read_cobol(record_header_parser=...)` or
`read_cobol(record_extractor=...)`; ``chip_smoke.py`` and the tests read
``generate_custom_rdw`` files through them. Both keep the additional
info string the read passes (`rhp_additional_info`,
`re_additional_info`) in the class attribute `additional_info`.
"""
from __future__ import annotations

from ..reader.header_parsers import RecordHeaderParser, RecordMetadata
from ..reader.raw_extractors import RawRecordContext, RawRecordExtractor

HEADER_LENGTH = 5


class CustomRdw5ByteParser(RecordHeaderParser):
    """The 5-byte header: records whose flag is not 1 are framed and
    skipped (invalid); a zero length raises ValueError, which a
    permissive read resyncs past."""

    additional_info = ""

    @property
    def header_length(self) -> int:
        return HEADER_LENGTH

    @property
    def is_header_defined_in_copybook(self) -> bool:
        return False

    def get_record_metadata(self, header: bytes, file_offset: int,
                            file_size: int, record_num: int
                            ) -> RecordMetadata:
        if len(header) < HEADER_LENGTH:
            return RecordMetadata(-1, False)
        length = header[3] + 256 * header[4]
        if length <= 0:
            raise ValueError(f"Custom RDW headers should never be zero "
                             f"at {file_offset}.")
        return RecordMetadata(length, header[0] == 1)

    def on_receive_additional_info(self, additional_info: str) -> None:
        CustomRdw5ByteParser.additional_info = additional_info


class CustomRdw5ByteExtractor(RawRecordExtractor):
    """The same framing as a record extractor: each call returns the
    payload of the next record whose flag is 1 (the records read ahead to
    find it are held; `offset` is the stream offset after the record
    returned last)."""

    additional_info = ""

    def __init__(self, ctx: RawRecordContext):
        self.ctx = ctx
        CustomRdw5ByteExtractor.additional_info = ctx.additional_info
        self._offset = ctx.input_stream.offset
        self._next = self._fetch()

    def _fetch(self):
        stream = self.ctx.input_stream
        while True:
            header = stream.next(HEADER_LENGTH)
            if len(header) < HEADER_LENGTH:
                return None
            payload = stream.next(header[3] + 256 * header[4])
            if header[0] == 1:
                return payload, stream.offset

    @property
    def offset(self) -> int:
        return self._offset

    def has_next(self) -> bool:
        return self._next is not None

    def __next__(self) -> bytes:
        if self._next is None:
            raise StopIteration
        (record, self._offset), self._next = self._next, self._fetch()
        return record
