"""Typed reader configuration.

Port copy of ``cobrix_tpu.reader.parameters``, reduced to the fields that
``api.parse_options`` sets: the data encoding, code page (and custom
code-page class), ASCII charset, UTF-16 byte order, float format,
trimming and schema policy, the copybook shaping (comments, fillers,
non-terminals, debug fields, OCCURS mappings), RDW framing, the
record-length override, record and file offsets, the multisegment
options and record ids, the input-file-name column, the generic
per-record framings (text, a record-length field, custom header parsers
and record extractors, variable-size OCCURS), the record error policies
with their resync window, ledger cap and corrupt-record column, the
pipeline's options, the column projection (`select`), the filter
(`filter`, the canonical wire JSON of a ``query`` expression) and the
observability options (`trace_file`, `trace_id`, `request_id`,
`progress_interval_s`, `field_costs`). Every other
field of the JAX package belongs to an option the port refuses by name
(``api.read_cobol``); a field comes back with the slice that takes its
option.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence

from ..copybook.datatypes import (
    CommentPolicy,
    DebugFieldsPolicy,
    Encoding,
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
)
from .diagnostics import (DEFAULT_LEDGER_CAP, DEFAULT_RESYNC_WINDOW,
                          RecordErrorPolicy, ShardErrorPolicy)

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
    field_parent_map: Dict[str, str] = dc_field(default_factory=dict)


@dataclass
class ReaderParameters:
    """Flattened reader configuration (the options the port takes)."""

    is_ebcdic: bool = True
    is_text: bool = False
    ebcdic_code_page: str = "common"
    ebcdic_code_page_class: Optional[str] = None
    ascii_charset: str = "us-ascii"
    is_utf16_big_endian: bool = True
    floating_point_format: FloatingPointFormat = FloatingPointFormat.IBM
    variable_size_occurs: bool = False
    length_field_name: Optional[str] = None
    is_record_sequence: bool = False
    is_rdw_big_endian: bool = False
    is_rdw_part_of_record_length: bool = False
    rdw_adjustment: int = 0
    record_length_override: Optional[int] = None
    is_index_generation_needed: bool = False
    input_split_records: Optional[int] = None
    input_split_size_mb: Optional[float] = None
    start_offset: int = 0
    end_offset: int = 0
    file_start_offset: int = 0
    file_end_offset: int = 0
    generate_record_id: bool = False
    schema_policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL
    string_trimming_policy: TrimPolicy = TrimPolicy.BOTH
    multisegment: Optional[MultisegmentParameters] = None
    comment_policy: CommentPolicy = dc_field(default_factory=CommentPolicy)
    drop_group_fillers: bool = False
    drop_value_fillers: bool = True
    non_terminals: Sequence[str] = ()
    occurs_mappings: Dict[str, Dict[str, int]] = dc_field(default_factory=dict)
    debug_fields_policy: DebugFieldsPolicy = DebugFieldsPolicy.NONE
    record_header_parser: Optional[str] = None
    record_extractor: Optional[str] = None
    rhp_additional_info: Optional[str] = None
    re_additional_info: str = ""
    input_file_name_column: str = ""
    # -- fault tolerance (Spark parse-mode analogue; not a reference
    # option — the reference is fail-fast only) --------------------------
    record_error_policy: RecordErrorPolicy = RecordErrorPolicy.FAIL_FAST
    # bounded forward search for the next plausible header after a corrupt
    # run (permissive policies only)
    resync_window_bytes: int = DEFAULT_RESYNC_WINDOW
    # cap on detailed ledger entries (counts are always exact)
    max_corrupt_ledger_entries: int = DEFAULT_LEDGER_CAP
    # name of the optional per-row debug column holding the corruption
    # reason for malformed-but-kept rows ('' = no column)
    corrupt_record_column: str = ""
    # -- IO retry (stream.RetryPolicy inputs) ----------------------------
    io_retry_attempts: int = 3          # total attempts per storage read
    io_retry_base_delay: float = 0.05   # seconds; doubles per attempt
    io_retry_max_delay: float = 2.0     # per-sleep cap, seconds
    io_retry_deadline: float = 30.0     # overall budget per read, seconds
    # -- remote storage and compressed feeds (cobrix_tpu_torch.io) -------
    # on-disk cache root for the persistent block cache, the inflate
    # index and the sparse-index store ('' = all three planes off). Safe
    # to share across processes; entries are keyed by file fingerprint
    # (etag/size/mtime) and invalidate structurally when the file changes
    cache_dir: str = ""
    # LRU budget for the block cache, in MB (0 = unbounded)
    cache_max_mb: float = 1024.0
    # read-ahead depth: how many blocks a bounded pool fetches ahead of
    # the consumer of a backend source (0 = no prefetch)
    prefetch_blocks: int = 2
    # block granularity (MB) shared by the cache and the prefetcher
    io_block_mb: float = 8.0
    # input compression: 'auto' sniffs every input, 'none'/'off'/'raw'
    # read the raw bytes, a codec name pins it (io/compress.py)
    compression: str = "auto"
    # decompressed-plane granularity (MB): the inflate-index checkpoint
    # stride and the post-decompression block-cache entry size
    compress_block_mb: float = 4.0
    # -- chunked pipeline executor (cobrix_tpu_torch.engine) -------------
    # worker threads overlapping read -> frame -> decode across chunks.
    # 0 = the sequential path; < 0 = auto-size to the machine
    # (min(8, cpu_count))
    pipeline_workers: int = 0
    # target chunk size for fixed-length byte strides AND the default
    # sparse-index split size for variable-length reads when pipelining
    # is on and no explicit input_split option is set (fractional MB
    # accepted — tests force multi-chunk plans on tiny files)
    pipeline_chunk_mb: float = 16.0
    # backpressure bound: chunks concurrently held in flight (staged
    # bytes). 0 = workers + 2
    pipeline_max_inflight: int = 0
    # what a chunk-level failure (error after its one re-queue, deadline)
    # does to the scan: fail_fast raises, partial returns the completed
    # chunks plus a ShardFailureInfo ledger
    shard_error_policy: ShardErrorPolicy = ShardErrorPolicy.FAIL_FAST
    # per-chunk wall deadline; 0 = none
    shard_timeout_s: float = 0.0
    # re-dispatches allowed per chunk (the pipeline re-queues at most
    # once: min(1, shard_max_retries))
    shard_max_retries: int = 2
    # whole-scan wall deadline; 0 = none
    scan_deadline_s: float = 0.0
    # column projection: only these fields (or the fields under these
    # groups) are decoded, and every other leaf is None
    select: Optional[Sequence[str]] = None
    # predicate pushdown: the canonical wire-JSON form of a
    # cobrix_tpu_torch.query filter expression (query/expr.py), as the
    # option parser normalizes it. None = no filter. Bound to the
    # copybook per reader (query/pushdown.BoundFilter); rows failing it
    # are dropped before the full decode wherever a static columnar plan
    # exists
    filter: Optional[str] = None
    # -- observability (obs/) ----------------------------------------------
    # Chrome-trace/Perfetto JSON output path: when set, the read records
    # trace spans on every execution path (scan -> shard -> chunk ->
    # stage, supervisor events) and writes the file at read end. '' =
    # tracing off (the ~zero-overhead default)
    trace_file: str = ""
    # inbound trace context: a request-scoped trace id propagated from
    # an upstream caller. '' = mint a fresh id when tracing is on. The
    # id lands in every trace export, so one request stitches across
    # processes
    trace_id: str = ""
    # caller-assigned request id carried on the trace root span ('' =
    # none); purely identifying, never behavioral
    request_id: str = ""
    # minimum seconds between progress_callback invocations (the final
    # done=True snapshot always fires)
    progress_interval_s: float = 0.5
    # per-field/kernel-group cost attribution (obs.fieldcost): a timed
    # region around each batch's device decode and card assembly,
    # surfaced as ReadMetrics.field_costs and the explain cost table.
    # Off by default — the disabled path takes zero timestamps;
    # `read_cobol(..., explain=True)` forces it on for that read
    field_costs: bool = False

    def resolved_pipeline_workers(self) -> int:
        """Effective worker count: 0 = sequential, negative = auto."""
        if self.pipeline_workers >= 0:
            return self.pipeline_workers
        import os

        return min(8, os.cpu_count() or 1)

    @property
    def is_permissive(self) -> bool:
        """True when malformed records are tolerated (resync + ledger
        instead of a raised error)."""
        return self.record_error_policy is not RecordErrorPolicy.FAIL_FAST

    def new_diagnostics(self):
        """A fresh per-read/shard error ledger sized by this config."""
        from .diagnostics import ReadDiagnostics

        return ReadDiagnostics(max_entries=self.max_corrupt_ledger_entries)

    @property
    def data_encoding(self) -> Encoding:
        return Encoding.EBCDIC if self.is_ebcdic else Encoding.ASCII

    @property
    def is_variable_length(self) -> bool:
        """The option-validation predicate for per-record input-file
        tracking (reference CobolParametersParser.scala:576-581 —
        generate_record_id alone does NOT enable it), over the options
        the port takes."""
        return bool(self.is_record_sequence or self.is_text
                    or self.variable_size_occurs or self.length_field_name
                    or self.record_extractor or self.file_start_offset > 0
                    or self.file_end_offset > 0)

    @property
    def needs_var_len_reader(self) -> bool:
        """True when the configuration routes through the variable-length
        reader: `is_variable_length`, or generate_record_id alone, which
        makes the reference's variableLengthParams Some(...), so that
        fixed-length records are framed by the variable-length reader
        (CobolParametersParser.parseVariableLengthParameters:~253-262,
        DefaultSource.buildEitherReader:72-81)."""
        return self.is_variable_length or self.generate_record_id

    def fixed_record_size(self, copybook) -> int:
        """On-disk size of a fixed-length record: the record-length
        override (the full record, offsets not re-added), else the
        copybook's size with the record start and end offsets
        (``FixedLenReader.record_size``)."""
        return (self.record_length_override or copybook.record_size
                + self.start_offset + self.end_offset)

    @property
    def supports_fast_framing(self) -> bool:
        """True when whole-shard vectorized RDW framing applies (no custom
        extractors/parsers, no text mode, no length fields, no variable
        OCCURS): the port frames such reads on the device; the others take
        the generic per-record reader. Also the gate for pipeline
        auto-splitting."""
        return bool(self.is_record_sequence
                    and not (self.record_extractor
                             or self.record_header_parser
                             or self.is_text or self.length_field_name
                             or self.variable_size_occurs))

    @property
    def rdw_length_adjustment(self) -> int:
        """The adjustment added to every header length: `rdw_adjustment`,
        less the header's own 4 bytes when they count in the length
        (``VarLenReader.record_header_parser``)."""
        adjustment = self.rdw_adjustment
        if self.is_rdw_part_of_record_length:
            adjustment -= 4
        return adjustment
