"""Raw record extractors: record-boundary discovery when neither the
copybook's fixed size nor RDW headers give the record length.

Port copy of ``cobrix_tpu.reader.raw_extractors``; a custom extractor
must subclass THIS module's `RawRecordExtractor` (the port imports
nothing of the JAX package). One change: `TextRecordExtractor` starts a
shard from the line end before it, where the JAX package's starts every
shard as if after an LF, so a shard that opens on an over-long line
after a CRLF line cut it a byte later than the whole-file read
(ROADMAP C8). Mirrors the reference trait and
implementations
(raw/RawRecordExtractor.scala:22, raw/TextRecordExtractor.scala:27-103,
raw/VarOccursRecordExtractor.scala:30-154, raw/RawRecordContext.scala:27,
raw/RawRecordExtractorFactory.scala:22).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.copybook import Copybook
from .stream import SimpleStream


@dataclass
class RawRecordContext:
    starting_record_number: int
    input_stream: SimpleStream
    copybook: Copybook
    additional_info: str = ""


class RawRecordExtractor:
    """Iterator of raw record byte strings + the current stream offset."""

    def __iter__(self) -> Iterator[bytes]:
        return self

    def __next__(self) -> bytes:
        raise NotImplementedError

    @property
    def offset(self) -> int:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError


def _footer_before(before: bytes) -> int:
    """The line-end size of the record that ends where a text stream
    starts, from the bytes just before it: 2 after CR LF, 1 after LF or
    at the file's start, 0 after the cut piece of an over-long line."""
    if not before:
        return 1
    if before.endswith(b"\r\n"):
        return 2
    return 1 if before.endswith(b"\n") else 0


class TextRecordExtractor(RawRecordExtractor):
    """CR/LF record boundaries with a copybook-size+2 look-ahead buffer;
    an over-long line is split at the buffer boundary like the reference.
    The previous record's line-end size, by which the split falls, starts
    from the bytes before the stream's offset (`_footer_before`), so a
    shard of the file splits its lines as the whole-file read does."""

    def __init__(self, ctx: RawRecordContext):
        self.ctx = ctx
        self.max_record_size = ctx.copybook.record_size + 2
        self._buf = b""
        self._last_footer_size = _footer_before(
            ctx.input_stream.preceding(2))

    def has_next(self) -> bool:
        return not self.ctx.input_stream.is_end_of_stream or len(self._buf) > 0

    @property
    def offset(self) -> int:
        return self.ctx.input_stream.offset - len(self._buf)

    def __next__(self) -> bytes:
        if not self.has_next():
            raise StopIteration
        self._ensure(self.max_record_size)
        buf = self._buf
        record_length = 0
        payload = 0
        for i, b in enumerate(buf):
            if b == 0x0D:
                if i + 1 < self.max_record_size and i + 1 < len(buf) and buf[i + 1] == 0x0A:
                    record_length = i + 2
                    payload = i
                    break
            elif b == 0x0A:
                record_length = i + 1
                payload = i
                break
        if record_length > 0:
            record = buf[:payload]
        else:
            if self.ctx.input_stream.is_end_of_stream:
                record_length = payload = len(buf)
            else:
                record_length = payload = len(buf) - self._last_footer_size
            record = buf[:record_length]
        self._buf = buf[record_length:]
        self._last_footer_size = record_length - payload
        return record

    def _ensure(self, n: int) -> None:
        need = n - len(self._buf)
        if need > 0:
            self._buf += self.ctx.input_stream.next(need)


class VarOccursRecordExtractor(RawRecordExtractor):
    """Computes each record's true length by walking the AST and decoding
    only DEPENDING ON fields (variable_size_occurs layouts)."""

    def __init__(self, ctx: RawRecordContext):
        self.ctx = ctx
        self.max_record_size = ctx.copybook.record_size
        self.has_var_occurs = any(
            st.occurs is not None and st.depending_on is not None
            for st in ctx.copybook.ast.walk())
        from .extractors import DecodeOptions
        self._options = DecodeOptions.from_copybook(ctx.copybook)

    def has_next(self) -> bool:
        return self.ctx.input_stream.offset < self.ctx.input_stream.size()

    @property
    def offset(self) -> int:
        return self.ctx.input_stream.offset

    def __next__(self) -> bytes:
        if not self.has_next():
            raise StopIteration
        if not self.has_var_occurs:
            return self.ctx.input_stream.next(self.max_record_size)
        return self._extract_var_occurs_record()

    def _extract_var_occurs_record(self) -> bytes:
        buf = bytearray()
        depend_fields: Dict[str, object] = {}
        cb = self.ctx.copybook

        def ensure(n: int) -> None:
            need = n - len(buf)
            if need > 0:
                buf.extend(self.ctx.input_stream.next(need))

        def array_size(field: Statement) -> int:
            max_size = field.array_max_size
            if field.depending_on is None:
                return max_size
            value = depend_fields.get(field.depending_on, max_size)
            if isinstance(value, str):
                value = field.depending_on_handlers.get(value, max_size)
            if field.array_min_size <= value <= max_size:
                return value
            return max_size

        def walk_group(group: Group, use_offset: int) -> int:
            offset = use_offset
            for field in group.children:
                if field.is_array:
                    n = array_size(field)
                    size = 0
                    if isinstance(field, Group):
                        pos = offset
                        for _ in range(n):
                            pos += walk_group(field, pos)
                        size = pos - offset
                    else:
                        size = field.binary_properties.data_size * n
                    if not field.is_redefined:
                        offset += size
                else:
                    if isinstance(field, Group):
                        size = walk_group(field, offset)
                    else:
                        if field.is_dependee:
                            end = offset + field.binary_properties.actual_size
                            ensure(end)
                            from .extractors import _decode_primitive
                            value = _decode_primitive(
                                field, offset, bytes(buf), self._options)
                            if value is not None:
                                if isinstance(value, str):
                                    depend_fields[field.name] = value
                                else:
                                    depend_fields[field.name] = int(value)
                        size = field.binary_properties.actual_size
                    if not field.is_redefined:
                        offset += size
            return offset - use_offset

        next_offset = 0
        for record in cb.ast.children:
            if isinstance(record, Group):
                next_offset += walk_group(record, next_offset)
        ensure(next_offset)
        return bytes(buf[:next_offset])


def create_raw_record_extractor(name: str,
                                ctx: RawRecordContext) -> RawRecordExtractor:
    """Instantiate a custom extractor by dotted Python path (the equivalent
    of the reference's reflection factory, RawRecordExtractorFactory.scala:22)."""
    module_name, _, class_name = name.rpartition(".")
    if not module_name:
        raise ValueError(
            f"Invalid record extractor class '{name}'; expected a dotted path")
    cls = getattr(importlib.import_module(module_name), class_name)
    instance = cls(ctx)
    if not isinstance(instance, RawRecordExtractor):
        raise TypeError(
            f"Custom record extractor {name} must subclass RawRecordExtractor")
    return instance
