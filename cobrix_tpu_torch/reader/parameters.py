"""Typed reader configuration.

Port copy of ``cobrix_tpu.reader.parameters``, reduced to the fields that
``api.parse_options`` sets: the code page, float format, trimming and
schema policy, RDW framing, record and file offsets, the multisegment
options and record ids, plus `input_file_name_column` and
`corrupt_record_column`, which ``schema.output_schema_for`` reads and
which stay empty. Every other field of the JAX package belongs to an
option the port refuses by name (``api.read_cobol``); a field comes back
with the slice that takes its option.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from ..copybook.datatypes import (
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
)

DEFAULT_FILE_RECORD_ID_INCREMENT = 2 ** 32      # reference reader Constants.scala:28
DEFAULT_INDEX_ENTRY_SIZE_MB = 100
MEGABYTE = 1024 * 1024


@dataclass
class MultisegmentParameters:
    segment_id_field: str = ""
    segment_id_filter: Optional[List[str]] = None
    segment_level_ids: List[str] = dc_field(default_factory=list)
    segment_id_prefix: str = ""
    segment_id_redefine_map: Dict[str, str] = dc_field(default_factory=dict)


@dataclass
class ReaderParameters:
    """Flattened reader configuration (the options the port takes)."""

    ebcdic_code_page: str = "common"
    floating_point_format: FloatingPointFormat = FloatingPointFormat.IBM
    is_record_sequence: bool = False
    is_rdw_big_endian: bool = False
    is_rdw_part_of_record_length: bool = False
    rdw_adjustment: int = 0
    start_offset: int = 0
    file_start_offset: int = 0
    file_end_offset: int = 0
    generate_record_id: bool = False
    schema_policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL
    string_trimming_policy: TrimPolicy = TrimPolicy.BOTH
    multisegment: Optional[MultisegmentParameters] = None
    input_file_name_column: str = ""
    corrupt_record_column: str = ""

    @property
    def rdw_length_adjustment(self) -> int:
        """The adjustment added to every header length: `rdw_adjustment`,
        less the header's own 4 bytes when they count in the length
        (``VarLenReader.record_header_parser``)."""
        adjustment = self.rdw_adjustment
        if self.is_rdw_part_of_record_length:
            adjustment -= 4
        return adjustment
