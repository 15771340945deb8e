"""Host-side record extraction: AST walk over one record's bytes.

Port copy of ``cobrix_tpu.reader.extractors``, unchanged: the
exact-semantics row assembler mirroring the reference hot loop
(reader/extractors/record/RecordExtractors.scala:49 extractRecord,
:211 extractHierarchicalRecord): OCCURS with DEPENDING ON, REDEFINES,
segment-redefine gating, filler skipping, and generated-field
post-processing.

In the port this is the host row walk of the reads that have no static
columnar plan, exactly where the JAX package takes it
(``reader.var_len_reader.VarLenReader.iter_rows``): variable-size OCCURS
layouts whose DEPENDING ON arrays shift later fields, and hierarchical
(segment-children) reads that leave the decode-once route. It decodes on
the host by design, as the JAX package does; the decode-once
hierarchical route's nesting walk reuses `_apply_post_processing`.
`DecodeOptions` and `_decode_primitive` also serve the variable-size
OCCURS extractor, which reads its DEPENDING ON counters with them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.datatypes import (
    FloatingPointFormat,
    Integral,
    SchemaRetentionPolicy,
    TrimPolicy,
)
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


def extract_record(ast: Group,
                   data: bytes,
                   offset_bytes: int = 0,
                   policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL,
                   variable_length_occurs: bool = False,
                   generate_record_id: bool = False,
                   segment_level_ids: Sequence[object] = (),
                   file_id: int = 0,
                   record_id: int = 0,
                   active_segment_redefine: str = "",
                   generate_input_file_field: bool = False,
                   input_file_name: str = "",
                   options: Optional[DecodeOptions] = None,
                   handler: Optional["RecordHandler"] = None) -> List[object]:
    """Decode one record into a flat list of root-level values
    (each root group -> handler-created record of its non-filler field
    values; the default handler builds tuples). `handler` is the
    target-agnostic seam of the reference (RecordHandler.scala:21)."""
    from .handlers import DEFAULT_HANDLER

    handler = handler or DEFAULT_HANDLER
    options = options or DecodeOptions()
    depend_fields: Dict[str, object] = {}

    def extract_array(field: Statement, use_offset: int) -> Tuple[int, list]:
        array_size = field.array_max_size
        actual_size = array_size
        if field.depending_on is not None:
            depend_value = depend_fields.get(field.depending_on, array_size)
            if isinstance(depend_value, str):
                depend_value = field.depending_on_handlers.get(depend_value, array_size)
            if field.array_min_size <= depend_value <= array_size:
                actual_size = depend_value
        offset = use_offset
        values = []
        if isinstance(field, Group):
            for _ in range(actual_size):
                size, value = get_group_values(offset, field)
                offset += size
                values.append(value)
        else:
            for _ in range(actual_size):
                values.append(_decode_primitive(field, offset, data, options))
                offset += field.binary_properties.data_size
        if variable_length_occurs:
            return offset - use_offset, values
        return field.binary_properties.actual_size, values

    def extract_value(field: Statement, use_offset: int) -> Tuple[int, object]:
        if isinstance(field, Group):
            if (field.is_segment_redefine
                    and field.name.upper() != active_segment_redefine.upper()):
                return field.binary_properties.actual_size, None
            return get_group_values(use_offset, field)
        value = _decode_primitive(field, use_offset, data, options)
        if value is not None and field.is_dependee:
            if isinstance(value, bool):
                raise ValueError(
                    f"Field {field.name} is a DEPENDING ON field of an OCCURS, "
                    f"should be integral, found {type(value).__name__}.")
            if isinstance(value, str):
                depend_fields[field.name] = value
            elif isinstance(value, (int, float)) or hasattr(value, "__int__"):
                depend_fields[field.name] = int(value)
            else:
                raise ValueError(
                    f"Field {field.name} is a DEPENDING ON field of an OCCURS, "
                    f"should be integral, found {type(value).__name__}.")
        return field.binary_properties.actual_size, value

    def get_group_values(offset: int, group: Group) -> Tuple[int, object]:
        bit_offset = offset
        fields = []
        for field in group.children:
            if field.is_array:
                size, value = extract_array(field, bit_offset)
                if not field.is_redefined:
                    bit_offset += size
            else:
                size, value = extract_value(field, bit_offset)
                if not field.is_redefined:
                    bit_offset += (field.binary_properties.actual_size
                                   if field.redefines is not None else size)
            if not field.is_filler:
                fields.append(value)
        return bit_offset - offset, handler.create(fields, group)

    next_offset = offset_bytes
    records = []
    for record in ast.children:
        if isinstance(record, Group):
            size, values = get_group_values(next_offset, record)
            next_offset += size
            records.append(values)
    return _apply_post_processing(
        records, policy, generate_record_id, list(segment_level_ids),
        file_id, record_id, generate_input_file_field, input_file_name,
        handler=handler)


def extract_hierarchical_record(
        ast: Group,
        segments_data: Sequence[Tuple[str, bytes]],
        segment_id_redefine_map: Dict[str, Group],
        parent_child_map: Dict[str, Sequence[Group]],
        offset_bytes: int = 0,
        policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL,
        variable_length_occurs: bool = False,
        generate_record_id: bool = False,
        file_id: int = 0,
        record_id: int = 0,
        generate_input_file_field: bool = False,
        input_file_name: str = "",
        options: Optional[DecodeOptions] = None,
        handler: Optional["RecordHandler"] = None) -> List[object]:
    """Assemble one hierarchical row from a buffered root record and its child
    segment records (reference extractHierarchicalRecord,
    RecordExtractors.scala:211-385)."""
    from .handlers import DEFAULT_HANDLER

    handler = handler or DEFAULT_HANDLER
    options = options or DecodeOptions()
    depend_fields: Dict[str, object] = {}

    def extract_array(field: Statement, use_offset: int, data: bytes,
                      current_index: int, parent_segment_ids: List[str]):
        array_size = field.array_max_size
        actual_size = array_size
        if field.depending_on is not None:
            depend_value = depend_fields.get(field.depending_on, array_size)
            if isinstance(depend_value, str):
                depend_value = field.depending_on_handlers.get(depend_value, array_size)
            if field.array_min_size <= depend_value <= array_size:
                actual_size = depend_value
        offset = use_offset
        values = []
        if isinstance(field, Group):
            for _ in range(actual_size):
                size, value = get_group_values(offset, field, data, current_index,
                                               parent_segment_ids)
                offset += size
                values.append(value)
        else:
            for _ in range(actual_size):
                values.append(_decode_primitive(field, offset, data, options))
                offset += field.binary_properties.data_size
        if variable_length_occurs:
            return offset - use_offset, values
        return field.binary_properties.actual_size, values

    def extract_value(field: Statement, use_offset: int, data: bytes,
                      current_index: int, parent_segment_ids: List[str]):
        if isinstance(field, Group):
            return get_group_values(use_offset, field, data, current_index,
                                    parent_segment_ids)
        value = _decode_primitive(field, use_offset, data, options)
        if value is not None and field.is_dependee:
            if isinstance(value, str):
                depend_fields[field.name] = value
            else:
                depend_fields[field.name] = int(value)
        return field.binary_properties.actual_size, value

    def extract_children(field: Group, current_index: int,
                         parent_segment_ids: List[str]) -> list:
        children = []
        i = current_index
        while i < len(segments_data):
            segment_id, segment_bytes = segments_data[i]
            redefine = segment_id_redefine_map.get(segment_id)
            if redefine is not None and redefine.name == field.name:
                _, child = get_group_values(
                    field.binary_properties.offset, field, segment_bytes, i,
                    [segment_id] + parent_segment_ids)
                children.append(child)
            elif segment_id in parent_segment_ids:
                break
            i += 1
        return children

    def get_group_values(offset: int, group: Group, data: bytes,
                         current_index: int,
                         parent_segment_ids: List[str]) -> Tuple[int, tuple]:
        bit_offset = offset
        fields = []
        for field in group.children:
            if field.is_array:
                size, value = extract_array(field, bit_offset, data,
                                            current_index, parent_segment_ids)
                if not field.is_redefined:
                    bit_offset += size
            else:
                size, value = extract_value(field, bit_offset, data,
                                            current_index, parent_segment_ids)
                if not field.is_redefined:
                    bit_offset += (field.binary_properties.actual_size
                                   if field.redefines is not None else size)
            if not field.is_filler and not field.is_child_segment:
                fields.append(value)
        if group.is_segment_redefine:
            for child in parent_child_map.get(group.name, ()):
                fields.append(extract_children(child, current_index + 1,
                                               parent_segment_ids))
        # value order differs from declaration order here (child-segment
        # records append after the parent's own fields) — hand the handler
        # the matching names so dict-like targets stay aligned
        names = [f.name for f in group.children
                 if not f.is_filler and not f.is_child_segment]
        if group.is_segment_redefine:
            names += [c.name for c in parent_child_map.get(group.name, ())]
        return bit_offset - offset, handler.create_named(fields, names,
                                                         group)

    next_offset = offset_bytes
    records = []
    for record in ast.children:
        if isinstance(record, Group) and record.parent_segment is None:
            size, values = get_group_values(
                next_offset, record, segments_data[0][1], 0, [segments_data[0][0]])
            next_offset += size
            records.append(values)
    return _apply_post_processing(
        records, policy, generate_record_id, [], file_id, record_id,
        generate_input_file_field, input_file_name, handler=handler)


def _apply_post_processing(records: List[object],
                           policy: SchemaRetentionPolicy,
                           generate_record_id: bool,
                           segment_level_ids: List[object],
                           file_id: int,
                           record_id: int,
                           generate_input_file_field: bool,
                           input_file_name: str,
                           handler=None) -> List[object]:
    """reference applyRecordPostProcessing (RecordExtractors.scala:409-451).

    NB: the reference places the file-name field *after* segment ids when
    record ids are off, but *before* them when record ids are on — replicated
    verbatim since golden outputs pin this ordering."""
    if policy is SchemaRetentionPolicy.COLLAPSE_ROOT:
        body: List[object] = []
        for record in records:
            body.extend(handler.to_seq(record) if handler is not None
                        else record)
    else:
        body = list(records)
    seg = list(segment_level_ids)
    if generate_record_id and generate_input_file_field:
        return [file_id, record_id, input_file_name] + seg + body
    if generate_record_id:
        return [file_id, record_id] + seg + body
    if generate_input_file_field:
        return seg + [input_file_name] + body
    return seg + body
