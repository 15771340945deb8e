"""Copybook-driven record/file encoder — the inverse of the readers.

`RecordEncoder` walks the copybook AST with the SAME traversal rules as the
host extractor (`reader/extractors.py:extract_record`): dynamic offsets,
OCCURS (incl. DEPENDING ON with the clamp + string-handler resolution of
`_resolve_occurs`), REDEFINES advance rules (`is_redefined` members don't
advance, the cluster tail advances by the shared max size), segment-redefine
gating (a None group value = inactive branch), and filler skipping. Values
are consumed in the exact shape `to_rows()` produces them (groups are
sequences over non-filler children, arrays are lists), so a decoded row can
be re-encoded without any name mapping.

Framing writers mirror the readers' header parsers: fixed-length records
padded to the copybook record size, and RDW/VRL records with BDW-less
4-byte RDW headers (big/little endian, `rdw_adjustment`,
`is_rdw_part_of_record_length`) truncated to each record's used length so
multisegment and DEPENDING ON files get genuine variable record lengths.
"""
from __future__ import annotations

import io
from typing import Dict, Iterable, List, Optional, Sequence, Union

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.copybook import Copybook, parse_copybook
from ..copybook.datatypes import (
    AlphaNumeric,
    EBCDIC_SPACE,
    Encoding,
    SchemaRetentionPolicy,
)
from .fields import EncodeError, encode_field


def _resolve_occurs_count(st: Statement, depend_fields: Dict[str, object]) -> int:
    """Mirror of reader.columnar._resolve_occurs / extract_array."""
    max_size = st.array_max_size
    if st.depending_on is None:
        return max_size
    value = depend_fields.get(st.depending_on, max_size)
    if value is None:
        return max_size
    if isinstance(value, str):
        value = st.depending_on_handlers.get(value, max_size)
    else:
        value = int(value)
    if st.array_min_size <= value <= max_size:
        return value
    return max_size


class RecordEncoder:
    """Encodes `to_rows()`-shaped record bodies against a copybook."""

    def __init__(self, copybook: Union[Copybook, str], *,
                 variable_size_occurs: bool = False,
                 policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL,
                 fill_byte: Optional[int] = None,
                 **parse_options):
        if isinstance(copybook, str):
            copybook = parse_copybook(copybook, **parse_options)
        self.copybook = copybook
        self.variable_size_occurs = variable_size_occurs
        self.policy = policy
        self.record_size = copybook.record_size
        if fill_byte is None:
            fill_byte = (0x20 if self._is_ascii_layout() else EBCDIC_SPACE)
        self.fill_byte = fill_byte
        # used length of the most recent encode_record (before padding)
        self.last_used_length = 0

    def _is_ascii_layout(self) -> bool:
        for st in self.copybook.ast.walk_primitives():
            enc = getattr(st.dtype, "enc", None) or Encoding.EBCDIC
            if enc is Encoding.EBCDIC:
                return False
        return True

    # -- body shaping --------------------------------------------------------

    def _root_groups(self) -> List[Group]:
        return [g for g in self.copybook.ast.children if isinstance(g, Group)]

    def rewrap_collapsed(self, flat_body: Sequence[object]) -> List[object]:
        """COLLAPSE_ROOT bodies are the concatenated non-filler fields of
        every root group; regroup them into the KEEP_ORIGINAL shape."""
        body: List[object] = []
        i = 0
        for grp in self._root_groups():
            n = sum(1 for c in grp.children if not c.is_filler)
            body.append(tuple(flat_body[i:i + n]))
            i += n
        if i != len(flat_body):
            raise EncodeError(
                f"collapsed body has {len(flat_body)} values, root groups "
                f"hold {i} non-filler fields")
        return body

    # -- record encode -------------------------------------------------------

    def encode_record(self, body: Sequence[object], *,
                      pad: bool = True) -> bytes:
        """Encode one record body (KEEP_ORIGINAL shape unless the encoder
        was built with COLLAPSE_ROOT, matching `to_rows()`). With
        `pad=True` the record is padded with the fill byte to the full
        copybook record size; otherwise it is truncated to the used
        length (`last_used_length` holds it either way)."""
        if self.policy is SchemaRetentionPolicy.COLLAPSE_ROOT:
            body = self.rewrap_collapsed(body)
        buf = bytearray([self.fill_byte]) * self.record_size
        depend_fields: Dict[str, object] = {}
        used = [0]
        cb = self.copybook

        def note_depend(field: Primitive, value) -> None:
            if value is None or not field.is_dependee:
                return
            if isinstance(value, str):
                depend_fields[field.name] = value
            else:
                depend_fields[field.name] = int(value)

        def put_primitive(field: Primitive, offset: int, value) -> None:
            data = encode_field(
                field.dtype, value,
                ebcdic_code_page=cb.ebcdic_code_page,
                ascii_charset=cb.ascii_charset,
                is_utf16_big_endian=cb.is_utf16_big_endian,
                floating_point_format=cb.floating_point_format)
            end = offset + len(data)
            if end > len(buf):
                buf.extend(bytes([self.fill_byte]) * (end - len(buf)))
            buf[offset:end] = data
            used[0] = max(used[0], end)
            note_depend(field, value)

        def encode_array(field: Statement, use_offset: int, value) -> int:
            count = _resolve_occurs_count(field, depend_fields)
            items = list(value) if value is not None else []
            if len(items) > count:
                raise EncodeError(
                    f"{field.name}: {len(items)} items for an OCCURS "
                    f"resolved to {count} (check the DEPENDING ON value)")
            offset = use_offset
            if isinstance(field, Group):
                for k in range(count):
                    item = items[k] if k < len(items) else None
                    size = encode_group(field, offset, item)
                    offset += size
            else:
                step = field.binary_properties.data_size
                for k in range(count):
                    if k < len(items):
                        put_primitive(field, offset, items[k])
                    offset += step
            if self.variable_size_occurs:
                return offset - use_offset
            return field.binary_properties.actual_size

        def encode_group(group: Group, offset: int, value) -> int:
            """Returns the walked size of the group at `offset`. A None
            value leaves the area as fill (inactive redefine branch)."""
            bit_offset = offset
            non_filler = [c for c in group.children if not c.is_filler]
            values: Sequence[object]
            if value is None:
                values = [None] * len(non_filler)
            else:
                values = list(value)
                if len(values) != len(non_filler):
                    raise EncodeError(
                        f"group {group.name}: body has {len(values)} "
                        f"values, group has {len(non_filler)} non-filler "
                        f"fields")
            it = iter(values)
            for field in group.children:
                fval = None if field.is_filler else next(it)
                if field.is_array:
                    size = encode_array(field, bit_offset, fval)
                    if not field.is_redefined:
                        bit_offset += size
                else:
                    if isinstance(field, Group):
                        skip = (field.is_segment_redefine or
                                field.redefines is not None or
                                field.is_redefined) and fval is None
                        if skip:
                            size = field.binary_properties.actual_size
                        else:
                            size = encode_group(field, bit_offset, fval)
                            if value is not None and fval is not None:
                                used[0] = max(used[0], bit_offset + size)
                    else:
                        if not (field.is_filler and fval is None):
                            put_primitive(field, bit_offset, fval)
                        size = field.binary_properties.actual_size
                    if not field.is_redefined:
                        bit_offset += (field.binary_properties.actual_size
                                       if field.redefines is not None
                                       else size)
            return bit_offset - offset

        body = list(body)
        roots = self._root_groups()
        if len(body) != len(roots):
            raise EncodeError(
                f"record body has {len(body)} root values, copybook has "
                f"{len(roots)} root groups")
        next_offset = 0
        for grp, gval in zip(roots, body):
            size = encode_group(grp, next_offset, gval)
            next_offset += size
        walked = next_offset
        self.last_used_length = used[0] if used[0] > 0 else walked
        if pad:
            if len(buf) < self.record_size:
                buf.extend(bytes([self.fill_byte])
                           * (self.record_size - len(buf)))
            return bytes(buf[:max(self.record_size, walked)])
        return bytes(buf[:self.last_used_length])

    # -- framing -------------------------------------------------------------

    @staticmethod
    def rdw_header(payload_len: int, *, big_endian: bool = False,
                   adjustment: int = 0,
                   part_of_record_length: bool = False) -> bytes:
        """Inverse of RdwHeaderParser: the parsed value plus
        `rdw_adjustment` (minus 4 when the RDW counts itself) must equal
        the payload length."""
        raw = payload_len - adjustment
        if part_of_record_length:
            raw += 4
        if not 0 < raw <= 0xFFFF:
            raise EncodeError(f"RDW value {raw} out of range for payload "
                              f"of {payload_len} bytes")
        if big_endian:
            return bytes([raw >> 8, raw & 0xFF, 0, 0])
        return bytes([0, 0, raw & 0xFF, raw >> 8])

    def encode_fixed(self, bodies: Iterable[Sequence[object]],
                     out: Optional[io.BufferedIOBase] = None) -> bytes:
        sink = out or io.BytesIO()
        for body in bodies:
            sink.write(self.encode_record(body, pad=True))
        return b"" if out is not None else sink.getvalue()

    def encode_rdw(self, bodies: Iterable[Sequence[object]],
                   out: Optional[io.BufferedIOBase] = None, *,
                   big_endian: bool = False, adjustment: int = 0,
                   part_of_record_length: bool = False,
                   truncate: bool = True) -> bytes:
        sink = out or io.BytesIO()
        for body in bodies:
            payload = self.encode_record(body, pad=not truncate)
            sink.write(self.rdw_header(
                len(payload), big_endian=big_endian, adjustment=adjustment,
                part_of_record_length=part_of_record_length))
            sink.write(payload)
        return b"" if out is not None else sink.getvalue()


def encode_file(copybook: Union[Copybook, str],
                bodies: Iterable[Sequence[object]],
                path: Optional[str] = None, *,
                framing: str = "fixed",
                policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL,
                variable_size_occurs: bool = False,
                rdw_big_endian: bool = False,
                rdw_adjustment: int = 0,
                rdw_part_of_record_length: bool = False,
                truncate: bool = True,
                fill_byte: Optional[int] = None,
                **parse_options) -> Optional[bytes]:
    """One-shot encode of record bodies to bytes (or to `path`)."""
    enc = RecordEncoder(copybook, policy=policy,
                        variable_size_occurs=variable_size_occurs,
                        fill_byte=fill_byte, **parse_options)
    if framing not in ("fixed", "rdw"):
        raise ValueError(f"Unknown framing '{framing}' (fixed|rdw)")

    def _write(sink) -> None:
        if framing == "fixed":
            enc.encode_fixed(bodies, sink)
        else:
            enc.encode_rdw(bodies, sink, big_endian=rdw_big_endian,
                           adjustment=rdw_adjustment,
                           part_of_record_length=rdw_part_of_record_length,
                           truncate=truncate)

    if path is not None:
        with open(path, "wb") as f:
            _write(f)
        return None
    buf = io.BytesIO()
    _write(buf)
    return buf.getvalue()
