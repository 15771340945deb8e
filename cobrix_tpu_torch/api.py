"""`read_cobol`: fixed-length and RDW variable-length files, decoding on
the device.

Port of ``cobrix_tpu.api.read_cobol`` for two routes, chosen as the JAX
package chooses its reader (``ReaderParameters.needs_var_len_reader``):

* fixed-length files (``_read_fixed_len_chunked`` and
  ``FixedLenReader.read_result``): the file is read in 64 MiB
  record-aligned chunks; each chunk is framed on the host as an
  [n, record_size] uint8 matrix (the record start and end offsets cut
  off), moved to the device, decoded by `ColumnarDecoder` (one fused
  kernel launch for every numeric group) and kept as a `DecodedBatch` of
  host planes, or as a `FileResult` of one batch per active segment when
  a segment field routes the records to segment redefines;
* RDW files (``is_record_sequence`` or ``is_xcom``), single- or
  multisegment, and fixed-length files with a file header or footer,
  record ids or the input-file-name column:
  ``reader.var_len_reader.VarLenReader`` frames each file on the device,
  window by window, and decodes the records of each active segment
  there, one `FileResult` per file (per shard where a permissive read
  met a malformed record in a file the JAX package splits);
* the generic framings (``is_text``, ``record_length_field``,
  ``record_header_parser``, ``record_extractor``,
  ``variable_size_occurs``): the same reader frames the records on the
  host, one at a time, and decodes them on the device;
* hierarchical reads (``segment-children:N``, with the redefine map):
  RDW records are framed on the device and decoded there once, at the
  full plan, and their nesting (which child belongs to which root) is
  built on the host; where the JAX package walks the records on the
  host instead (a variable-size OCCURS layout that shifts later fields,
  or a hierarchical read with ``select``, a record start offset or
  another framing), so does the port.

Under a permissive ``record_error_policy`` malformed records are
resynced past, kept with their reason (``corrupt_record_column``) or
dropped, and recorded in the read's ledger, `CobolData.diagnostics`,
whose JSON the Arrow table carries as the JAX package's does.

With ``pipeline_workers`` > 0 (or -1: min(8, cpu_count)) either route
runs through the chunk pipeline (``engine.pipeline``): a reader thread
reads record-aligned chunks (``chunk_size_mb``) or sparse-index shards
into a bounded pool of pinned host buffers, worker threads, each on its
own CUDA stream, move them to the card, frame and decode them, and one
assembler thread builds each chunk's Arrow table; the results come back
in file and chunk order, equal to the sequential read's.
``pipeline_workers=0``, the default, is the sequential path.

`CobolData` gives the decoded records as rows, dicts, JSON lines, a
pyarrow Table (``reader.arrow_out``: its buffers built on the device
from the decoded planes, ``ops.arrow_assemble``) or a pandas DataFrame;
`batch_callback` receives each chunk's table.

Every input is sniffed for a compression codec (the JAX package's
``compression`` detection; ``compression="none"`` reads the raw bytes, a
codec name pins one): a gzip, bz2, xz, zlib or zstd input is inflated on
the host as it is read (``io.compress.DecompressingSource``), and
everything downstream — chunks, windows, shards, offsets, record ids,
the ledger — addresses its decompressed bytes, on the same device path
as a raw file. ``file://`` paths are local files; any other scheme
resolves through the storage backend registry (``register_stream_backend``,
or fsspec for a scheme it knows), read under the ``io_retry_*`` policy,
with the persistent block cache (``cache_dir``, ``cache_max_mb``,
``io_block_mb``) and read-ahead (``prefetch_blocks``) stacked on
(``io.config.wrap_source``). With a ``cache_dir`` a compressed input's
inflate index and decompressed blocks persist, so a warm re-read
inflates nothing, and an RDW file's sparse index persists
(``io.index_store``), so a warm re-read makes no index pass on the
card. Without one a compressed input is read as one shard, streamed in
the usual chunks or windows through one decompressing stream.

The options below are parsed with the JAX package's spellings and error
messages (``parse_options``). Every other option of the JAX package's
reader raises ValueError naming it; a key neither package knows is, as
in the JAX package, ignored, unless ``pedantic`` is true: then the
unused-key audit names it. ``parallelism`` (default min(16, cpu_count))
is how many threads read a file's index shards and build
`CobolData.to_arrow`'s parts' tables.
`CobolData.metrics` is the read's `profiling.ReadMetrics`.

With a `filter` (``query``), a fixed-length chunk or an RDW window is
read in two stages on the device: the filter columns alone are decoded
(stage 1) and the predicate evaluated over their Arrow arrays; the kept
records are packed from the same device image and decoded with the
selected plan (stage 2). Hierarchical and row-walk reads filter the
assembled table (``BoundFilter.filter_result_generic``).

With ``collect_stats`` (and a ``cache_dir``) a profiling pass runs after
the read, on its device (``stats.collect``): each file's per-chunk zone
maps, null counts, sums and segment histograms persist in the cache's
stats plane, and ``CobolData.stats_profiles`` holds their summaries.
With ``use_stats`` and a filter a warm profile arms a chunk skipper
(``stats.skip``): a fixed-length chunk on the profile grid
(``stats_chunk_mb``) or an RDW index shard that the profile proves
holds no matching record is never read; the table equals the stats-off
read's.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import replace as _dc_replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .copybook.ast import transform_identifier
from .device import resolve_device
from .engine.chunks import (auto_split_mb, plan_fixed_chunks,
                            plan_var_len_chunks)
from .engine.pipeline import pipelined_fixed_scan, pipelined_var_len_scan
from .io.compress import active_codec, codec_by_name
from .io.config import IoConfig
from .obs.context import ObsContext
from .obs.context import activate as obs_activate
from .obs.context import carry
from .obs.context import current as obs_current
from .obs.fieldcost import FieldCostAccumulator
from .copybook.datatypes import (
    CommentPolicy,
    DebugFieldsPolicy,
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
)
from .profiling import ReadMetrics, StageTimes, stage, timed_stage
from .reader.diagnostics import (DEFAULT_LEDGER_CAP, DEFAULT_RESYNC_WINDOW,
                                 ReadDiagnostics, RecordErrorPolicy,
                                 ShardErrorPolicy, ShardFailureInfo)
from .reader.fixed_len_reader import FixedLenReader
from .reader.json_out import rows_to_json
from .reader.parameters import MultisegmentParameters, ReaderParameters
from .reader.result import FileResult
from .reader.schema import CobolOutputSchema, output_schema_for
from .reader.stream import RetryPolicy, open_input, path_scheme, source_size
from .reader.var_len_reader import (VarLenReader, default_segment_id_prefix,
                                    file_record_id_base)
from .utils.file_utils import list_input_files

# fixed-length files stream through bounded chunk reads: peak host memory
# stays about one chunk plus its decoded columns
FIXED_READ_CHUNK_BYTES = 64 * 1024 * 1024

# options of the JAX package's reader the port does not take yet: each
# raises, naming it (any other key is the pedantic audit's)
_NOT_PORTED = frozenset((
    "hosts", "speculative_quantile", "heartbeat_interval_s",
    "stream_batch_rows"))
# the framing options a custom record extractor is refused beside, and
# (from the third on, with is_text) `record_length`, in the JAX package's
# order
_RDW_ISH = ("is_text", "record_length", "is_record_sequence", "is_xcom",
            "is_rdw_big_endian", "is_rdw_part_of_record_length",
            "rdw_adjustment", "record_length_field",
            "record_header_parser", "rhp_additional_info")

_ENUMS = {
    "schema_retention_policy": {
        "keep_original": SchemaRetentionPolicy.KEEP_ORIGINAL,
        "collapse_root": SchemaRetentionPolicy.COLLAPSE_ROOT,
    },
    "string_trimming_policy": {
        "none": TrimPolicy.NONE, "left": TrimPolicy.LEFT,
        "right": TrimPolicy.RIGHT, "both": TrimPolicy.BOTH,
    },
    "floating_point_format": {
        "ibm": FloatingPointFormat.IBM,
        "ibm_little_endian": FloatingPointFormat.IBM_LE,
        "ieee754": FloatingPointFormat.IEEE754,
        "ieee754_little_endian": FloatingPointFormat.IEEE754_LE,
    },
    "debug": {
        "false": DebugFieldsPolicy.NONE, "none": DebugFieldsPolicy.NONE,
        "true": DebugFieldsPolicy.HEX, "hex": DebugFieldsPolicy.HEX,
        "raw": DebugFieldsPolicy.RAW,
    },
}


def _normalize_filter_option(value: Optional[str]) -> Optional[str]:
    """The `filter` option (grammar text, wire JSON, or the str() of a
    query.Expr — all strings by the time the option layer sees them)
    -> canonical wire JSON. Raises ValueError with the parse position
    on malformed input, BEFORE any data is read."""
    if not value:
        return None
    from .query.expr import normalize_filter

    try:
        return normalize_filter(value)
    except (ValueError, TypeError) as exc:
        raise ValueError(f"Invalid 'filter' option: {exc}") from exc


def _parse_enum(key: str, value: str):
    parsed = _ENUMS[key].get(str(value).strip().lower())
    if parsed is None:
        raise ValueError(f"Invalid value '{value}' for '{key}' option.")
    return parsed


class Options:
    """String-keyed option map tracking key usage for the pedantic
    audit (``cobrix_tpu.api.Options``, reference Parameters.scala:27-98).
    Values arrive as strings, as from the reference's ``.option()`` map;
    structured values carry as JSON, and ``query.Expr`` filters by their
    canonical wire form (the grammar spelling cannot express fields
    named like its own keywords)."""

    def __init__(self, options: Dict[str, object]):
        self._map = {str(k): (json.dumps(v) if isinstance(v, (dict, list))
                              else v.canonical() if hasattr(v, "canonical")
                              else str(v))
                     for k, v in options.items()}
        self._used = set()

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        if key in self._map:
            self._used.add(key)
            return self._map[key]
        return default

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def mark_used(self, key: str) -> None:
        self._used.add(key)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("true", "1", "yes")

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key)
        return default if v is None else int(v)

    def keys(self):
        return self._map.keys()

    def unused_keys(self) -> List[str]:
        return [k for k in self._map if k not in self._used]


def _parse_segment_levels(opts: Options) -> List[str]:
    levels = []
    i = 0
    while True:
        name = f"segment_id_level{i}"
        if name in opts:
            levels.append(opts.get(name))
        elif i == 0 and "segment_id_root" in opts:
            levels.append(opts.get("segment_id_root"))
        else:
            return levels
        i += 1


def _parse_prefixed_map(opts: Options,
                        prefixes: Tuple[str, ...]) -> Dict[str, str]:
    """Parse 'redefine-segment-id-map:N' / 'segment-children:N' options
    ('FIELD => A,B') into {item: field} (segment id -> redefine name, or
    child -> parent respectively)."""
    out: Dict[str, str] = {}
    for key in list(opts.keys()):
        k = key.lower()
        if any(k.startswith(p) for p in prefixes):
            value = opts.get(key)
            parts = value.split("=>")
            if len(parts) != 2:
                raise ValueError(
                    f"Illegal argument for the '{prefixes[0]}' option: '{value}'.")
            field = transform_identifier(parts[0].strip())
            for item in (transform_identifier(s.strip())
                         for s in parts[1].split(",")):
                out[item] = field
    return out


def parse_options(options: Dict[str, object],
                  ebcdic_code_page: str = "common",
                  schema_retention_policy: str = "keep_original",
                  string_trimming_policy: str = "both",
                  floating_point_format: str = "ibm",
                  streaming: bool = False) -> ReaderParameters:
    """Options -> typed ReaderParameters, as ``cobrix_tpu.api
    .parse_options`` builds them for the options the port takes, with
    its checks and messages, the pedantic audit of unused keys last.
    Raises ValueError naming the first option of the JAX package's
    reader that the port does not take. `streaming`: the micro-batch
    and continuous-ingest surfaces (``streaming``), which let
    ``with_input_file_name_col`` through on fixed-length records, as
    the JAX package's ``streaming=True`` does, and take the code page
    and the three policies among the options, as the JAX package's
    surfaces take them (``read_cobol`` names them as arguments)."""
    if streaming:
        options = dict(options)
        named = {k: str(options.pop(k)) for k in (
            "ebcdic_code_page", "schema_retention_policy",
            "string_trimming_policy", "floating_point_format")
            if k in options}
        ebcdic_code_page = named.get("ebcdic_code_page", ebcdic_code_page)
        schema_retention_policy = named.get("schema_retention_policy",
                                            schema_retention_policy)
        string_trimming_policy = named.get("string_trimming_policy",
                                           string_trimming_policy)
        floating_point_format = named.get("floating_point_format",
                                          floating_point_format)
    for name in sorted(options):
        if name in _NOT_PORTED:
            raise ValueError(
                f"Option '{name}' is not supported by cobrix_tpu_torch."
                f"read_cobol yet")
    opts = Options(options)
    encoding = (opts.get("encoding", "") or "").strip().lower()
    if encoding not in ("", "ebcdic", "ascii"):
        raise ValueError(f"Invalid value '{encoding}' for 'encoding' option. "
                         "Should be either 'EBCDIC' or 'ASCII'.")
    comment_policy = CommentPolicy(
        truncate_comments=opts.get_bool("truncate_comments", True),
        comments_up_to_char=opts.get_int("comments_lbound", 6),
        comments_after_char=opts.get_int("comments_ubound", 72))
    if not comment_policy.truncate_comments and (
            "comments_lbound" in opts or "comments_ubound" in opts):
        raise ValueError(
            "When 'truncate_comments=false' the following parameters cannot be "
            "used: 'comments_lbound', 'comments_ubound'.")
    is_record_sequence = (opts.get_bool("is_xcom") or
                          opts.get_bool("is_record_sequence"))
    if "record_length_field" in opts and (
            "is_record_sequence" in opts or "is_xcom" in opts):
        raise ValueError("Option 'record_length_field' cannot be used together "
                         "with 'is_record_sequence' or 'is_xcom'.")
    multisegment = None
    if "segment_field" in opts:
        filter_str = opts.get("segment_filter")
        multisegment = MultisegmentParameters(
            segment_id_field=opts.get("segment_field"),
            segment_id_filter=filter_str.split(",") if filter_str else None,
            segment_level_ids=_parse_segment_levels(opts),
            segment_id_prefix=opts.get("segment_id_prefix", ""),
            segment_id_redefine_map=_parse_prefixed_map(
                opts, ("redefine-segment-id-map", "redefine_segment_id_map")),
            field_parent_map=_parse_prefixed_map(
                opts, ("segment-children", "segment_children")))
    occurs_mappings = {}
    # the reference README documents the singular key (`occurs_mapping`);
    # both spellings are accepted, but not together
    occurs_keys = [k for k in ("occurs_mappings", "occurs_mapping")
                   if k in opts]
    if len(occurs_keys) > 1:
        raise ValueError(
            "Options 'occurs_mappings' and 'occurs_mapping' cannot be "
            "specified at the same time")
    if occurs_keys:
        occurs_mappings = {
            k: {sk: int(sv) for sk, sv in v.items()}
            for k, v in json.loads(opts.get(occurs_keys[0])).items()}
    params = ReaderParameters(
        is_ebcdic=encoding in ("", "ebcdic"),
        is_text=opts.get_bool("is_text"),
        ebcdic_code_page=ebcdic_code_page,
        ebcdic_code_page_class=opts.get("ebcdic_code_page_class"),
        ascii_charset=opts.get("ascii_charset", "") or "us-ascii",
        is_utf16_big_endian=opts.get_bool("is_utf16_big_endian", True),
        floating_point_format=_parse_enum("floating_point_format",
                                          floating_point_format),
        variable_size_occurs=opts.get_bool("variable_size_occurs"),
        length_field_name=opts.get("record_length_field"),
        is_record_sequence=is_record_sequence,
        is_rdw_big_endian=opts.get_bool("is_rdw_big_endian"),
        is_rdw_part_of_record_length=opts.get_bool(
            "is_rdw_part_of_record_length"),
        rdw_adjustment=opts.get_int("rdw_adjustment", 0),
        record_length_override=opts.get_int("record_length"),
        is_index_generation_needed=opts.get_bool("enable_indexes", True),
        input_split_records=opts.get_int("input_split_records"),
        input_split_size_mb=opts.get_int("input_split_size_mb"),
        start_offset=opts.get_int("record_start_offset", 0),
        end_offset=opts.get_int("record_end_offset", 0),
        file_start_offset=opts.get_int("file_start_offset", 0),
        file_end_offset=opts.get_int("file_end_offset", 0),
        generate_record_id=opts.get_bool("generate_record_id"),
        schema_policy=_parse_enum("schema_retention_policy",
                                  schema_retention_policy),
        string_trimming_policy=_parse_enum("string_trimming_policy",
                                           string_trimming_policy),
        multisegment=multisegment,
        comment_policy=comment_policy,
        drop_group_fillers=opts.get_bool("drop_group_fillers"),
        drop_value_fillers=opts.get_bool("drop_value_fillers", True),
        non_terminals=tuple(
            s for s in (opts.get("non_terminals", "") or "").split(",") if s),
        occurs_mappings=occurs_mappings,
        debug_fields_policy=_parse_enum("debug", opts.get("debug", "false")),
        record_header_parser=opts.get("record_header_parser"),
        record_extractor=opts.get("record_extractor"),
        rhp_additional_info=opts.get("rhp_additional_info"),
        re_additional_info=opts.get("re_additional_info", ""),
        input_file_name_column=opts.get("with_input_file_name_col", ""),
        record_error_policy=RecordErrorPolicy.parse(
            opts.get("record_error_policy", "fail_fast")),
        resync_window_bytes=opts.get_int("resync_window",
                                         DEFAULT_RESYNC_WINDOW),
        max_corrupt_ledger_entries=opts.get_int(
            "max_corrupt_ledger_entries", DEFAULT_LEDGER_CAP),
        corrupt_record_column=opts.get("corrupt_record_column", ""),
        io_retry_attempts=opts.get_int("io_retry_attempts", 3),
        io_retry_base_delay=float(
            opts.get_int("io_retry_base_delay_ms", 50)) / 1000.0,
        io_retry_max_delay=float(
            opts.get_int("io_retry_max_delay_ms", 2000)) / 1000.0,
        io_retry_deadline=float(
            opts.get_int("io_retry_deadline_ms", 30000)) / 1000.0,
        cache_dir=opts.get("cache_dir", "") or "",
        cache_max_mb=float(opts.get("cache_max_mb", "") or 1024.0),
        prefetch_blocks=opts.get_int("prefetch_blocks", 2),
        io_block_mb=float(opts.get("io_block_mb", "") or 8.0),
        compression=(opts.get("compression", "auto") or "auto").lower(),
        compress_block_mb=float(
            opts.get("compress_block_mb", "") or 4.0),
        pipeline_workers=opts.get_int("pipeline_workers", 0),
        pipeline_chunk_mb=float(opts.get("chunk_size_mb", "") or 16.0),
        pipeline_max_inflight=opts.get_int("max_inflight_chunks", 0),
        shard_error_policy=ShardErrorPolicy.parse(
            opts.get("shard_error_policy", "fail_fast")),
        shard_timeout_s=float(opts.get("shard_timeout_s", "") or 0.0),
        shard_max_retries=opts.get_int("shard_max_retries", 2),
        scan_deadline_s=float(opts.get("scan_deadline_s", "") or 0.0),
        select=tuple(s.strip() for s in opts.get("select", "").split(",")
                     if s.strip()) or None,
        filter=_normalize_filter_option(opts.get("filter")),
        trace_file=opts.get("trace_file", "") or "",
        trace_id=opts.get("trace_id", "") or "",
        request_id=opts.get("request_id", "") or "",
        progress_interval_s=float(
            opts.get("progress_interval_s", "") or 0.5),
        field_costs=opts.get_bool("field_costs"),
        collect_stats=opts.get_bool("collect_stats"),
        use_stats=opts.get_bool("use_stats"),
        stats_chunk_mb=float(opts.get("stats_chunk_mb", "") or 4.0))
    # recognized keys consumed later by read_cobol — mark used before the
    # pedantic unused-key audit runs
    opts.get_bool("debug_ignore_file_size")
    opts.get_int("parallelism", 0)
    # HDFS-locality knobs (LocalityParameters.scala:21-30): accepted for
    # workload compatibility and dropped, as the JAX package drops them:
    # a local read has no block topology to place shards by
    opts.get_bool("improve_locality", True)
    opts.get_bool("optimize_allocation")
    _validate(params, opts, streaming)
    return params


def parallelism_of(options: Dict[str, object]) -> int:
    """The `parallelism` option: threads for a file's index shards and
    for `CobolData.to_arrow`'s parts; the JAX package's default, min(16,
    cpu_count), when it is absent or 0."""
    return Options(options).get_int("parallelism", 0) or min(
        16, os.cpu_count() or 1)


def _validate(params: ReaderParameters, opts: Options,
              streaming: bool = False) -> None:
    """The JAX package's checks (``cobrix_tpu.api._validate_options``)
    of the options the port takes, same messages; `streaming` lets the
    input-file-name column through on fixed-length records."""
    if "record_extractor" in opts:
        bad = [k for k in _RDW_ISH if k in opts]
        if bad:
            raise ValueError(
                f"Option 'record_extractor' and {', '.join(bad)} cannot be "
                "used together.")
    if "record_length" in opts:
        bad = [k for k in _RDW_ISH[2:] if k in opts] \
            + (["is_text"] if "is_text" in opts else [])
        if bad:
            raise ValueError(
                f"Option 'record_length' and {', '.join(bad)} cannot be "
                "used together.")
    if (params.input_file_name_column and not streaming
            and not params.is_variable_length):
        raise ValueError(
            "Option 'with_input_file_name_col' is supported only when "
            "one of this holds: 'is_record_sequence' = true or "
            "'variable_size_occurs' = true or one of these options is "
            "set: 'record_length_field', 'file_start_offset', "
            "'file_end_offset' or a custom record extractor is specified")
    if params.corrupt_record_column and not params.is_permissive:
        raise ValueError(
            "Option 'corrupt_record_column' requires "
            "record_error_policy='permissive' or 'drop_malformed' "
            "(under 'fail_fast' the first malformed record raises instead "
            "of being recorded).")
    if params.resync_window_bytes <= 0:
        raise ValueError(
            f"Invalid 'resync_window' of {params.resync_window_bytes} "
            "bytes; it must be a positive byte count.")
    if params.io_retry_attempts < 1:
        raise ValueError(
            f"Invalid 'io_retry_attempts' of {params.io_retry_attempts}; "
            "at least one attempt is required.")
    if params.cache_max_mb < 0:
        raise ValueError(
            f"Invalid 'cache_max_mb' of {params.cache_max_mb}; it must "
            "be >= 0 (0 = unbounded).")
    if params.prefetch_blocks < 0:
        raise ValueError(
            f"Invalid 'prefetch_blocks' of {params.prefetch_blocks}; it "
            "must be >= 0 (0 disables read-ahead).")
    if params.io_block_mb <= 0:
        raise ValueError(
            f"Invalid 'io_block_mb' of {params.io_block_mb}; it must be "
            "a positive block size in megabytes.")
    if params.compression not in ("auto", "none", "off", "raw"):
        try:
            codec_by_name(params.compression)
        except ValueError as exc:
            raise ValueError(f"Invalid 'compression' option: {exc}")
    if params.compress_block_mb <= 0:
        raise ValueError(
            f"Invalid 'compress_block_mb' of {params.compress_block_mb}; "
            "it must be a positive block size in megabytes.")
    if params.cache_dir:
        cache_parent = os.path.dirname(
            os.path.abspath(params.cache_dir)) or "."
        if not os.path.isdir(cache_parent):
            raise ValueError(
                f"Invalid 'cache_dir' '{params.cache_dir}': parent "
                f"directory '{cache_parent}' does not exist.")
    if params.pipeline_chunk_mb <= 0:
        raise ValueError(
            f"Invalid 'chunk_size_mb' of {params.pipeline_chunk_mb}; "
            "it must be a positive size in megabytes.")
    if params.pipeline_max_inflight < 0:
        raise ValueError(
            f"Invalid 'max_inflight_chunks' of "
            f"{params.pipeline_max_inflight}; it must be >= 0 "
            "(0 sizes it from the worker count).")
    if params.shard_timeout_s < 0:
        raise ValueError(
            f"Invalid 'shard_timeout_s' of {params.shard_timeout_s}; "
            "it must be >= 0 (0 disables the per-shard deadline).")
    if params.scan_deadline_s < 0:
        raise ValueError(
            f"Invalid 'scan_deadline_s' of {params.scan_deadline_s}; "
            "it must be >= 0 (0 disables the whole-scan deadline).")
    if params.shard_max_retries < 0:
        raise ValueError(
            f"Invalid 'shard_max_retries' of {params.shard_max_retries}; "
            "it must be >= 0 (0 means a failed shard is never "
            "re-dispatched).")
    if params.progress_interval_s < 0:
        raise ValueError(
            f"Invalid 'progress_interval_s' of "
            f"{params.progress_interval_s}; it must be >= 0 "
            "(0 invokes the callback on every completed chunk).")
    if (params.collect_stats or params.use_stats) \
            and not params.cache_dir:
        raise ValueError(
            "Options 'collect_stats'/'use_stats' require 'cache_dir': "
            "profiles persist in (and load from) the cache directory's "
            "stats plane.")
    if params.stats_chunk_mb <= 0:
        raise ValueError(
            f"Invalid 'stats_chunk_mb' of {params.stats_chunk_mb}; it "
            "must be a positive size in megabytes.")
    if params.trace_file:
        # fail BEFORE the scan, not after minutes of decode: the trace is
        # written at read end, so an unwritable destination would
        # otherwise discard a fully successful read
        trace_dir = os.path.dirname(params.trace_file) or "."
        if not os.path.isdir(trace_dir):
            raise ValueError(
                f"Invalid 'trace_file' '{params.trace_file}': directory "
                f"'{trace_dir}' does not exist.")
        if not os.access(trace_dir, os.W_OK):
            raise ValueError(
                f"Invalid 'trace_file' '{params.trace_file}': directory "
                f"'{trace_dir}' is not writable.")
    seg = params.multisegment
    if seg and seg.field_parent_map and seg.segment_level_ids:
        raise ValueError(
            "Options 'segment_id_level*'/'segment_id_root' and "
            "'segment-children:*' cannot be used together.")
    if seg and seg.field_parent_map and not seg.segment_id_redefine_map:
        raise ValueError(
            "Option 'segment-children:*' requires 'redefine-segment-id-map:*' "
            "to be set as well.")
    pedantic = opts.get_bool("pedantic")  # marks the key used
    unused = opts.unused_keys()
    if unused and pedantic:
        raise ValueError("Redundant or unrecognized option(s) to 'spark-cobol': "
                         + ", ".join(sorted(unused)) + ".")


def load_copybook_contents(copybook, copybook_contents):
    """Exactly one of `copybook` (path or list of paths) and
    `copybook_contents` (text), with the JAX package's error messages."""
    if copybook is not None and copybook_contents is not None:
        raise ValueError("Both 'copybook' and 'copybook_contents' options "
                         "cannot be specified at the same time")
    if copybook_contents is not None:
        return copybook_contents
    if copybook is None:
        raise ValueError(
            "COPYBOOK is not provided. Please, provide either 'copybook' "
            "path or 'copybook_contents'.")
    books = [copybook] if isinstance(copybook, str) else list(copybook)
    contents = []
    for b in books:
        if os.path.exists(b) and not os.path.isfile(b):
            raise ValueError(f"The copybook path '{b}' is not a file.")
        with open(b, encoding="utf-8") as f:
            contents.append(f.read())
    return contents if len(contents) > 1 else contents[0]


class CobolData:
    """Decoded result of a read: the fixed-length route's `DecodedBatch`
    per chunk, or `FileResult` per file (per shard on a pipelined read,
    per chunk for multisegment fixed-length records), in record order,
    plus the output schema and the read's metrics; materializable as
    rows, dicts, JSON lines, a pyarrow Table or a pandas DataFrame."""

    def __init__(self, batches: List[DecodedBatch],
                 schema: CobolOutputSchema,
                 results: Optional[List[FileResult]] = None,
                 metrics: Optional[ReadMetrics] = None,
                 shard_failures: Optional[List[ShardFailureInfo]] = None,
                 parallelism: int = 1, device=None):
        self.batches = batches
        # threads that build the parts' tables in `to_arrow`, on the
        # read's device
        self.parallelism = parallelism
        self.device = resolve_device("cpu" if device is None else device)
        self.results = results or []
        self.output_schema = schema
        self.metrics = metrics
        # chunks a pipelined read lost under shard_error_policy='partial'
        self.shard_failures = shard_failures or []
        # the read's error ledger (permissive policies, or lost shards;
        # None otherwise), set by read_cobol
        self.diagnostics: Optional[ReadDiagnostics] = None
        # {file: FileProfile.summary()} of a read that collected
        # statistics (collect_stats=true), set by read_cobol; None
        # otherwise
        self.stats_profiles: Optional[Dict[str, dict]] = None
        # digest of the copybook text and its parse options
        # (`plan.cache.parse_fingerprint`), set by read_cobol on every
        # route: the copybook half of a sink dataset's identity
        self.plan_fingerprint: str = ""
        self._rows: Optional[List[List[object]]] = None

    @property
    def schema(self):
        return self.output_schema.schema

    @property
    def parts(self) -> list:
        """The read's decoded parts in record order: each has
        `to_arrow(output_schema)`."""
        return self.batches + self.results

    def __len__(self) -> int:
        return (sum(b.n_records for b in self.batches)
                + sum(r.n_rows for r in self.results))

    def to_rows(self) -> List[List[object]]:
        if self._rows is None:
            rows: List[List[object]] = []
            for b in self.batches:
                rows.extend(b.to_rows(policy=self.output_schema.policy))
            for r in self.results:
                rows.extend(r.to_rows())
            self._rows = rows
        return self._rows

    def to_dicts(self) -> List[dict]:
        names = self.schema.field_names()
        return [dict(zip(names, row)) for row in self.to_rows()]

    def to_json_lines(self) -> List[str]:
        return rows_to_json(self.to_rows(), self.schema)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_dataset(self, dataset_dir: str, file_format: str = "parquet",
                   partition_by=(), target_file_mb: float = 64.0,
                   retry=None):
        """One-shot atomic export into a transactional sink dataset
        (`cobrix_tpu_torch.sink`): `to_arrow()` (built by the assembly
        kernels on the read's device) is staged and finalized as
        Parquet or Arrow-IPC files of about `target_file_mb`, hive-style
        under `partition_by` columns, then ONE manifest record commits
        them all — a crash at any instant leaves the dataset exactly as
        it was. Re-exporting into the same dataset appends a new commit;
        a dataset written under a different copybook/schema fingerprint
        (or format, or partition spec) is refused (`SinkSchemaError`).
        The fingerprint is the JAX package's for the same copybook and
        options, so either package reads and appends to the other's
        datasets. Returns the `DatasetSink` (its ``recovery`` report and
        ``to_table()`` read-back included)."""
        from .reader.arrow_out import arrow_schema as _arrow_schema
        from .sink import DatasetSink, schema_fingerprint

        schema = _arrow_schema(self.schema)
        sink = DatasetSink(
            dataset_dir, arrow_schema=schema,
            schema_fp=schema_fingerprint(schema, self.plan_fingerprint),
            file_format=file_format, partition_by=partition_by,
            target_file_mb=target_file_mb, retry=retry)
        sink.commit_table(self.to_arrow(), source="read_cobol")
        return sink

    def to_ebcdic(self, path: Optional[str] = None, *,
                  framing: str = "fixed",
                  rdw_big_endian: bool = False,
                  rdw_adjustment: int = 0,
                  rdw_part_of_record_length: bool = False,
                  variable_size_occurs: bool = False,
                  truncate: bool = True,
                  fill_byte: Optional[int] = None):
        """Encode the decoded records back to mainframe binary (the write
        half of the bridge: `to_dataset` emits Parquet, this emits
        fixed-length or RDW-framed EBCDIC/ASCII consumable by the same
        copybook). Generated columns (File_Id/Record_Id/Seg_Id*/input
        file name/corrupt-record) are stripped; the data columns of
        `to_rows()` are re-encoded on the host through
        `cobrix_tpu_torch.encode` against this read's copybook, byte for
        byte as the JAX package's ``to_ebcdic``. `framing` is ``fixed``
        (records padded with `fill_byte` to the copybook's size) or
        ``rdw`` (4-byte RDW headers with `rdw_big_endian`,
        `rdw_adjustment` and `rdw_part_of_record_length`; each record
        cut to its used length unless `truncate` is false). Returns the
        bytes, or writes to `path` and returns None."""
        import io as _io

        from .encode.encoder import RecordEncoder

        if framing not in ("fixed", "rdw"):
            raise ValueError(f"Unknown framing '{framing}' (fixed|rdw)")
        schema = self.output_schema
        enc = RecordEncoder(schema.copybook, policy=schema.policy,
                            variable_size_occurs=variable_size_occurs,
                            fill_byte=fill_byte)
        # the generated columns lead (File_Id and Record_Id, the input
        # file name, the Seg_Id levels); the corrupt-record column trails
        lead = (2 if schema.generate_record_id else 0) \
            + (1 if schema.input_file_name_field else 0) \
            + schema.generate_seg_id_field_count
        tail = -1 if schema.corrupt_record_field else None
        bodies = (row[lead:tail] for row in self.to_rows())
        sink = _io.BytesIO() if path is None else open(path, "wb")
        try:
            if framing == "fixed":
                enc.encode_fixed(bodies, sink)
            else:
                enc.encode_rdw(
                    bodies, sink, big_endian=rdw_big_endian,
                    adjustment=rdw_adjustment,
                    part_of_record_length=rdw_part_of_record_length,
                    truncate=truncate)
        finally:
            if path is not None:
                sink.close()
        return sink.getvalue() if path is None else None

    def to_arrow(self):
        """pyarrow Table with the schema's declared types, built from the
        decoded planes without row materialization: one table per part
        (its Arrow buffers built on the part's device; cached by the
        pipelined read's assemble stage), concatenated in part order.
        With `parallelism` above 1 the parts' tables are built on that
        many threads (the JAX package's parallel finalize), each on its
        own CUDA stream, after `warm_pyarrow` (ROADMAP C4).
        A read with a ledger (a permissive policy, or shards lost under
        shard_error_policy='partial') carries its JSON in the schema
        metadata (``cobrix_tpu.read_diagnostics``), as the JAX package's
        does. An attributed and traced read's trace file is rewritten
        with the assemble plane's costs
        (``ReadMetrics.refresh_trace_field_costs``)."""
        table = self._to_arrow_impl()
        if (self.metrics is not None
                and self.metrics.field_costs_acc is not None):
            # sequential assembly ran after the trace was written; fold
            # its accrued per-field costs back into the artifact
            self.metrics.refresh_trace_field_costs()
        return table

    def _to_arrow_impl(self):
        import pyarrow as pa

        from .reader.arrow_out import arrow_schema, warm_pyarrow

        parts = self.parts
        width = min(self.parallelism, len(parts))
        if width > 1:
            from concurrent.futures import ThreadPoolExecutor

            from .engine.staging import worker_stream

            def build(part):
                with worker_stream(self.device):
                    return part.to_arrow(self.output_schema)
            warm_pyarrow()
            with ThreadPoolExecutor(max_workers=width) as ex:
                # a read's context (when one is active) rides the threads
                tables = list(ex.map(carry(build), parts))
        else:
            tables = [part.to_arrow(self.output_schema) for part in parts]
        if not tables:
            table = arrow_schema(self.schema).empty_table()
        else:
            table = tables[0] if len(tables) == 1 else pa.concat_tables(
                tables)
        if self.diagnostics is None:
            return table
        metadata = dict(table.schema.metadata or {})
        metadata[b"cobrix_tpu.read_diagnostics"] = \
            self.diagnostics.to_json().encode()
        return table.replace_schema_metadata(metadata)


def _aggregate_diagnostics(params: ReaderParameters, parts, io_retries: int,
                           shard_failures: List[ShardFailureInfo]
                           ) -> Optional[ReadDiagnostics]:
    """The read's ledger (``cobrix_tpu.api._aggregate_diagnostics``): the
    parts' ledgers merged by ``ReadDiagnostics.merged`` (entries sorted by
    file and offset, then capped), so the sequential and the pipelined
    reads of the same bytes give the same ledger, the storage reads the
    IO layer retried counted, and the lost shards recorded. None under
    fail_fast with no retried read and no lost shard."""
    if not params.is_permissive and io_retries == 0 and not shard_failures:
        return None
    merged = ReadDiagnostics.merged(
        (getattr(p, "diagnostics", None) for p in parts),
        max_entries=params.max_corrupt_ledger_entries)
    merged.io_retries += io_retries
    for failure in shard_failures:
        merged.record_shard_failure(failure)
    return merged


class _BatchTap:
    """Adapter between the pipeline's `on_batch(index, table)` hook and a
    user `batch_callback`: counts deliveries so read_cobol knows whether
    the pipelined path already streamed, and delivers a finished read's
    tables otherwise."""

    __slots__ = ("callback", "count")

    def __init__(self, callback):
        self.callback = callback
        self.count = 0

    def emit(self, index: int, table) -> None:
        if table is not None:
            # failed-chunk signals (table=None) forward but don't count
            # as deliveries: an all-chunks-failed pipelined scan still
            # takes the whole-result delivery below
            self.count += 1
        self.callback(index, table)

    def emit_data(self, data: CobolData) -> None:
        """Per-part tables of a finished read, in record order."""
        for i, part in enumerate(data.parts):
            self.emit(i, part.to_arrow(data.output_schema))


def read_cobol(path=None,
               copybook: Optional[str] = None,
               copybook_contents=None,
               device=None,
               ebcdic_code_page: str = "common",
               schema_retention_policy: str = "keep_original",
               string_trimming_policy: str = "both",
               floating_point_format: str = "ibm",
               batch_callback=None,
               progress_callback=None,
               explain: bool = False,
               tracer=None,
               **options):
    """Read fixed-length or RDW mainframe file(s) into decoded columns.

    `copybook` is a path (or list of paths) to copybook file(s);
    `copybook_contents` passes the text directly. `device=None` decodes
    on the CUDA device and raises RuntimeError when there is none;
    ``device="cpu"`` runs the plain PyTorch versions. The other keyword
    arguments take the JAX package's option names and values, on any
    file: RDW framing (``is_record_sequence="true"`` or ``is_xcom``,
    header endianness and adjustment), the record-length override, file
    and record offsets, ``debug_ignore_file_size``, the segment field,
    filter, levels, prefix and redefine map, the parent of each child
    segment (``segment-children``), record ids, the
    input-file-name column, sparse-index splits, the data encoding
    (``encoding``, ``ascii_charset``, ``is_utf16_big_endian``,
    ``ebcdic_code_page_class``), copybook shaping (filler dropping,
    ``non_terminals``, ``debug`` fields, comment bounds,
    ``occurs_mappings``), the generic framings (``is_text``,
    ``record_length_field``, ``record_header_parser`` with
    ``rhp_additional_info``, ``record_extractor`` with
    ``re_additional_info``, ``variable_size_occurs``), the record error
    policy (``record_error_policy``, ``resync_window``,
    ``max_corrupt_ledger_entries``, ``corrupt_record_column``), the I/O
    plane's options (`compression`, `compress_block_mb`, `cache_dir`,
    `cache_max_mb`, `io_block_mb`, `prefetch_blocks`,
    `io_retry_attempts`, `io_retry_base_delay_ms`, `io_retry_max_delay_ms`,
    `io_retry_deadline_ms`), the pipeline's options (`pipeline_workers`, `chunk_size_mb`,
    `max_inflight_chunks`, `shard_error_policy`, `shard_timeout_s`,
    `shard_max_retries`, `scan_deadline_s`), `select`
    (comma-separated field or group names: only those leaves, and the
    DEPENDING ON counters, are decoded; every other leaf is None),
    `filter` (a ``query`` expression, its grammar text or its wire JSON:
    a record it drops is dropped before the full decode where the read
    has a static columnar plan, ``query.pushdown``, and after it on the
    hierarchical and row-walk reads; `metrics.pushdown` counts what was
    pruned), `collect_stats` / `use_stats` / `stats_chunk_mb` (the
    statistics plane: a profiling pass after the read, billed apart in
    ``metrics.timings_s["collect_stats"]``, and zone-map chunk skipping
    before framing; both need `cache_dir`),
    `parallelism` (threads for a file's index shards and for
    `to_arrow`'s parts; min(16, cpu_count) by default), `copybooks`
    (comma-separated copybook paths, in place of `copybook`),
    `pedantic` (the unused-key audit), `improve_locality` /
    `optimize_allocation` (taken and dropped), and the observability
    options (``obs``): `trace_file` (a Chrome-trace / Perfetto JSON of
    the scan's host spans, scan -> shard or chunk -> stage, written at
    the read's end, and again by `to_arrow` with the assemble plane's
    costs), `trace_id` / `request_id` (identity on the trace),
    `field_costs` (per-field decode and assemble seconds, bytes and
    values: `metrics.field_costs`) and `progress_interval_s`.

    `progress_callback` receives monotonic ``obs.ScanProgress``
    snapshots while the scan runs (throttled by `progress_interval_s`;
    the final ``done=True`` snapshot always fires; a callback that
    raises never breaks the scan). `tracer` (an ``obs.Tracer``) records
    the scan's spans into the caller's tracer (``metrics.spans``; the
    file only with `trace_file`). `explain=True` turns `field_costs` on
    and returns an ``explain.ScanReport`` (the field plan, the execution
    plan, the cache planes, the measured per-field costs) with the data
    on ``report.data``. A failed read still writes its partial trace and
    its final progress snapshot, then raises.

    `batch_callback(chunk_index, table)` receives each chunk's pyarrow
    Table: on a pipelined read as soon as it is assembled (in completion
    order; `(chunk_index, None)` for a chunk lost under the partial
    shard policy), otherwise each part's table after the read, in
    order. The tables in index order concatenate to `to_arrow()` minus
    its diagnostics metadata; a callback exception fails the read (or
    the chunk, under the partial policy)."""
    if tracer is not None and not hasattr(tracer, "record_span"):
        raise ValueError("'tracer' must be an obs.Tracer (it receives "
                         "scan spans).")
    if progress_callback is not None and not callable(progress_callback):
        raise ValueError("'progress_callback' must be callable (it "
                         "receives ScanProgress snapshots).")
    if batch_callback is not None and not callable(batch_callback):
        raise ValueError("'batch_callback' must be callable (it receives "
                         "(chunk_index, pyarrow.Table) pairs).")
    tap = _BatchTap(batch_callback) if batch_callback else None
    # exclusive-source validation before any option is consumed: only
    # 'copybooks' arrives as an option key (the JAX package's checks)
    has_multi = "copybooks" in options
    if copybook is not None and copybook_contents is not None:
        raise ValueError("Both 'copybook' and 'copybook_contents' options "
                         "cannot be specified at the same time")
    if has_multi and copybook_contents is not None:
        raise ValueError("Both 'copybooks' and 'copybook_contents' options "
                         "cannot be specified at the same time")
    if copybook is not None and has_multi:
        raise ValueError("Both 'copybook' and 'copybooks' options "
                         "cannot be specified at the same time")
    if has_multi:
        copybook = str(options.pop("copybooks")).split(",")
    params = parse_options(options, ebcdic_code_page,
                           schema_retention_policy, string_trimming_policy,
                           floating_point_format)
    if explain and not params.field_costs:
        # explain wants the measured cost table; flip attribution on
        params = _dc_replace(params, field_costs=True)
    ignore_file_size = Options(options).get_bool("debug_ignore_file_size")
    parallelism = parallelism_of(options)
    contents = load_copybook_contents(copybook, copybook_contents)
    if path is None:
        raise ValueError("'path' must be specified for read_cobol.")
    files = list_input_files(path)
    if not files:
        raise FileNotFoundError(f"No input files found for path {path}")
    device = resolve_device(device)
    metrics = ReadMetrics(files=len(files), device=str(device))
    if params.field_costs:
        metrics.field_costs_acc = FieldCostAccumulator()
    # the read's observability context (its IoStats and cache scope
    # always; tracer, progress and field costs when asked for) is active
    # on this thread for the whole read and carried onto every thread the
    # read starts (obs.context.carry)
    obs_ctx = _build_obs_context(params, metrics, progress_callback,
                                 tracer=tracer)
    try:
        with obs_activate(obs_ctx):
            data = _read(files, contents, params, device, metrics, tap,
                         ignore_file_size, parallelism)
            metrics.finalize(data)
    except BaseException:
        # a failed scan still flushes its telemetry: the final done=True
        # progress snapshot fires and the PARTIAL trace is written;
        # nothing here catches the scan's own exception
        _abort_obs(obs_ctx, params)
        raise
    _finish_obs(obs_ctx, params, data)
    if tap is not None and tap.count == 0:
        # a sequential read, or a pipelined one that delivered nothing:
        # the parts' tables go out now, in record order
        tap.emit_data(data)
    if params.collect_stats:
        # the profiling pass runs AFTER the read, on its device, billed
        # apart from the scan (metrics.timings_s["collect_stats"]);
        # warm profiles load instead of rebuilding. Gated on the option
        # so a stats-off read never imports the stats package
        from .stats.collect import build_and_store_profiles

        t0 = time.perf_counter()
        profiles = build_and_store_profiles(files, contents, params, device,
                                            io=_io_config(params))
        metrics.timings_s["collect_stats"] = time.perf_counter() - t0
        data.stats_profiles = {url: profile.summary()
                               for url, profile in profiles.items()}
    from .plan.cache import parse_fingerprint

    data.plan_fingerprint = parse_fingerprint(contents, params)
    if explain:
        from .explain import build_scan_report

        return build_scan_report(params, files=files, data=data,
                                 device=device)
    return data


def _build_obs_context(params: ReaderParameters, metrics: ReadMetrics,
                       progress_callback, tracer=None) -> ObsContext:
    """The read's ObsContext: a tracer when `trace_file` is set (or one
    was passed in), a progress tracker when a callback was passed, the
    default metrics registry's scan metric set, and the metrics object's
    per-read cache scope, IoStats and field-cost accumulator."""
    from .obs.metrics import scan_metrics

    if tracer is None and params.trace_file:
        from .obs.trace import Tracer

        tracer = Tracer(trace_id=params.trace_id or None)
    if tracer is not None:
        if params.request_id:
            tracer.meta.setdefault("request_id", params.request_id)
        metrics.tracer = tracer
    progress = None
    if progress_callback is not None:
        from .obs.progress import ProgressTracker

        progress = ProgressTracker(
            progress_callback, min_interval_s=params.progress_interval_s)
    return ObsContext(tracer=tracer, metrics=scan_metrics(),
                      progress=progress, cache_scope=metrics.cache_scope,
                      io_stats=metrics.io_stats,
                      field_costs=metrics.field_costs_acc)


def _finish_obs(obs_ctx: ObsContext, params: ReaderParameters,
                data: CobolData) -> None:
    """End-of-read observability: the final done=True progress snapshot
    and the Chrome-trace artifact (metrics.finalize already closed the
    scan-root span and captured the span list)."""
    if obs_ctx.progress is not None:
        obs_ctx.progress.finish(records_total=len(data))
    if obs_ctx.tracer is not None and params.trace_file:
        # `to_arrow` refreshes the artifact with the assemble plane's
        # costs (ReadMetrics.refresh_trace_field_costs)
        data.metrics._trace_file = params.trace_file
        try:
            obs_ctx.tracer.write_chrome_trace(params.trace_file)
        except OSError:
            # the destination was validated up front, but it can still
            # vanish (or the disk fill) during a long scan — a lost
            # trace must not discard a fully successful read
            import logging

            logging.getLogger(__name__).warning(
                "failed to write trace_file %r; the read succeeded",
                params.trace_file, exc_info=True)


def _abort_obs(obs_ctx: ObsContext, params: ReaderParameters) -> None:
    """Best-effort telemetry flush when the scan raised: every step is
    individually guarded so nothing here can shadow the real error."""
    if obs_ctx.progress is not None:
        try:
            obs_ctx.progress.finish()
        except Exception:
            pass
    if obs_ctx.tracer is not None and params.trace_file:
        try:
            obs_ctx.tracer.write_chrome_trace(params.trace_file)
        except Exception:
            pass


def _retry_policy(params: ReaderParameters) -> RetryPolicy:
    """The read's IO retry policy for registry-backed storage."""
    return RetryPolicy(max_attempts=params.io_retry_attempts,
                       base_delay=params.io_retry_base_delay,
                       max_delay=params.io_retry_max_delay,
                       deadline=params.io_retry_deadline)


def _io_config(params: ReaderParameters) -> Optional[IoConfig]:
    """The read's remote-IO configuration (None = all features off)."""
    return IoConfig.from_params(params)


def _total_input_bytes(files: List[str], io=None,
                       retry: Optional[RetryPolicy] = None,
                       on_retry=None) -> int:
    """LOGICAL input bytes across local AND backend-resolved files
    (decompressed bytes for compressed feeds, since every downstream
    offset lives in that space); sizing failures never fail the read —
    an unknown size just reports as 0. Runs inside the read's IoStats
    scope, so remote sizes, codec sniffs and inflate-discovery results
    seed the read's metadata memo for the planners downstream, under
    the read's retry policy."""
    total = 0
    for f in files:
        try:
            if path_scheme(f) in (None, "file"):
                if active_codec(f, io) is not None:
                    total += source_size(f, io=io, retry=retry,
                                         on_retry=on_retry)
                elif os.path.exists(f):
                    total += os.path.getsize(f)
            else:
                total += source_size(f, io=io, retry=retry,
                                     on_retry=on_retry)
        except Exception:
            continue
    return total


def _read(files: List[str], contents, params: ReaderParameters, device,
          metrics: ReadMetrics, tap: Optional[_BatchTap],
          ignore_file_size: bool, parallelism: int) -> CobolData:
    """`read_cobol`'s read of the listed `files`, inside its
    observability context: sizing, the route's reader (the
    "parse_copybook" phase), the sequential or pipelined scan (the
    "scan" phase), the ledger."""
    on_batch = tap.emit if tap is not None else None
    io = _io_config(params)
    retry = _retry_policy(params)
    retries_seen: List[int] = []  # list.append is GIL-atomic across threads

    def on_retry():
        retries_seen.append(1)

    metrics.bytes_read = _total_input_bytes(files, io=io, retry=retry,
                                            on_retry=on_retry)
    obs = obs_current()
    progress = obs.progress if obs is not None else None
    if progress is not None:
        progress.set_plan(bytes_total=metrics.bytes_read)
    workers = params.resolved_pipeline_workers()
    use_pipeline = workers > 0
    is_var_len = params.needs_var_len_reader
    if use_pipeline and is_var_len:
        split_mb = auto_split_mb(params)
        if split_mb is not None:
            # default the sparse-index split to the pipeline chunk size
            # so mid-size files produce several shards (explicit
            # input_split options always win)
            params = _dc_replace(params, input_split_size_mb=split_mb)
    failures: List[ShardFailureInfo] = []
    batches: List[DecodedBatch] = []
    results: List[FileResult] = []
    tracer = obs.tracer if obs is not None else None
    # a traced or attributed sequential read times its stages too: the
    # per-field decode costs anchor against the decode stage's busy time
    timed = tracer is not None or metrics.field_costs_acc is not None
    with stage(metrics, "parse_copybook"):
        reader = (VarLenReader(contents, params, device=device) if is_var_len
                  else FixedLenReader(contents, params, device=device))
    if params.use_stats:
        # arm zone-map chunk skipping from warm profiles (stats/skip.py);
        # gated on the option so a stats-off read never imports the
        # stats package at all
        from .stats.skip import maybe_attach_skipper

        maybe_attach_skipper(reader, files, params)
    schema = output_schema_for(reader.copybook, params,
                               is_var_len=is_var_len)
    with stage(metrics, "scan"):
        if is_var_len:
            reader.parallelism = parallelism
            reader.io, reader.retry, reader.on_retry = io, retry, on_retry
            seg = params.multisegment
            prefix = (seg.segment_id_prefix if seg and seg.segment_id_prefix
                      else default_segment_id_prefix())
            if use_pipeline:
                with stage(metrics, "plan_index"):
                    shards = plan_var_len_chunks(reader, files, params,
                                                 retry, on_retry, io=io)
                metrics.shards = len(shards)
                results, failures = pipelined_var_len_scan(
                    reader, shards, prefix, workers, schema, metrics,
                    on_batch=on_batch)
            else:
                reader.stage_times = metrics.framing = StageTimes(
                    tracer=tracer)
                if timed:
                    metrics.stage_busy = metrics.framing
                if progress is not None:
                    progress.set_plan(chunks_total=len(files))
                    progress.stage_times = metrics.framing
                results = [r for file_order, file_path in enumerate(files)
                           for r in reader.read_result(
                               file_path, file_id=file_order,
                               segment_id_prefix=prefix,
                               start_record_id=file_record_id_base(
                                   file_order))]
                metrics.shards = len(results)
        else:
            if use_pipeline:
                parts, failures = pipelined_fixed_scan(
                    reader, files, params, workers, schema, metrics,
                    ignore_file_size=ignore_file_size, on_batch=on_batch,
                    retry=retry, on_retry=on_retry, io=io)
            else:
                stage_times = None
                if metrics.field_costs_acc is not None:
                    stage_times = metrics.stage_busy = StageTimes()
                parts = _read_fixed_sequential(
                    reader, files, ignore_file_size, retry, on_retry, io,
                    stage_times=stage_times, progress=progress)
                metrics.shards = len(parts)
            # one kind of part per read: batches, or (multisegment
            # records) results
            for part in parts:
                if isinstance(part, FileResult):
                    results.append(part)
                elif part is not None:
                    batches.append(part)
    data = CobolData(batches, schema,
                     [r for r in results if r is not None], metrics,
                     failures, parallelism=parallelism, device=device)
    data.diagnostics = _aggregate_diagnostics(params, data.parts,
                                              len(retries_seen), failures)
    if reader.pushdown is not None:
        metrics.pushdown = reader.pushdown.stats.as_dict()
    return data


def _part_rows(part) -> int:
    """Rows of a decoded part (a DecodedBatch or a FileResult)."""
    return (part.n_rows if isinstance(part, FileResult)
            else part.n_records)


def _read_fixed_sequential(reader: FixedLenReader, files: List[str],
                           ignore_file_size: bool,
                           retry: Optional[RetryPolicy] = None,
                           on_retry=None, io=None,
                           stage_times: Optional[StageTimes] = None,
                           progress=None) -> list:
    """The sequential fixed-length read: each file in record-aligned
    chunks of FIXED_READ_CHUNK_BYTES, read into a fresh host buffer and
    decoded in turn (`FixedLenReader.read_chunk`); a compressed or
    backend-served file is read the same way through its `open_input`
    reader (one decompressing stream a file), so the fused kernel
    launches once a chunk, as on a raw file. Under debug_ignore_file_size
    a torn tail is left unread; under a permissive policy the last chunk
    carries it (`FixedLenReader.read_torn_chunk`) and every part is a
    FileResult with its ledger. A source that serves fewer bytes than
    its size promised (a truncated backend object) ends the file there,
    as the JAX package's whole-file read of the served bytes does.
    `stage_times` times each chunk's decode ("decode"); `progress` (an
    ``obs.ProgressTracker``) hears of each chunk done, with its bytes.
    With a chunk skipper armed (``use_stats``) a file is read as
    `_read_fixed_kept` reads it."""
    rs = reader.record_size
    permissive = reader.params.is_permissive
    keep_tail = permissive and not ignore_file_size
    chunk_bytes = max(rs, FIXED_READ_CHUNK_BYTES // rs * rs)
    parts: list = []
    for file_path in files:
        size = source_size(file_path, retry=retry, on_retry=on_retry, io=io)
        reader.check_binary_data_validity(
            size, ignore_file_size or permissive, file_path)
        if reader.chunk_skipper is not None:
            kept = _read_fixed_kept(reader, file_path, ignore_file_size,
                                    retry, on_retry, io, stage_times,
                                    progress)
            if kept is not None:
                parts.extend(kept)
                continue
        rem = size % rs if keep_tail else 0
        whole = size - size % rs
        done = 0
        first = True  # a file of a torn record alone is one chunk of it
        with open_input(file_path, retry=retry, on_retry=on_retry,
                        io=io) as f:
            while done < whole or (first and rem):
                first = False
                n = min(chunk_bytes, whole - done)
                torn = bool(rem) and done + n == whole
                buf = np.empty(n + (rem if torn else 0), dtype=np.uint8)
                got = f.readinto(memoryview(buf))
                short = got != len(buf)
                if short:
                    size = done + got
                    reader.check_binary_data_validity(
                        size, ignore_file_size or permissive, file_path)
                    rem = size % rs if keep_tail else 0
                    n = size - size % rs - done
                    torn = bool(rem)
                    buf = buf[:n + rem]
                    if n == 0 and not torn:
                        break
                with timed_stage(stage_times, "decode"):
                    if torn:
                        part = reader.read_torn_chunk(
                            buf, rem, file_path, done // rs, size)
                    elif permissive:
                        part = reader.permissive_part(reader.read_chunk(buf))
                    else:
                        part = reader.read_chunk(buf)
                parts.append(part)
                if progress is not None:
                    progress.chunk_started()
                    progress.chunk_done(bytes_done=len(buf),
                                        records=_part_rows(part))
                done += n
                if short:
                    break
    return parts


def _read_fixed_kept(reader: FixedLenReader, file_path: str,
                     ignore_file_size: bool,
                     retry: Optional[RetryPolicy], on_retry, io,
                     stage_times: Optional[StageTimes], progress
                     ) -> Optional[list]:
    """The sequential read of one fixed-length file under the read's
    chunk skipper (the JAX package's ``_read_fixed_len_chunked`` with a
    skipper): the file planned as the pipelined read plans it
    (`engine.chunks.plan_fixed_chunks` with the skipper: record-aligned
    chunks on the profile grid, at most FIXED_READ_CHUNK_BYTES, the
    proven ones left out), and each kept chunk read through its own
    bounded `open_input` from its offset and decoded (`FixedLenReader
    .read_chunk`), so a skipped range's bytes are never read. None when
    the plan keeps the file whole: it is then read as a stats-off read
    reads it."""
    rs = reader.record_size
    params = reader.params
    chunks = plan_fixed_chunks(rs, [file_path], params,
                               FIXED_READ_CHUNK_BYTES, ignore_file_size,
                               retry, on_retry, io,
                               skipper=reader.chunk_skipper)
    if len(chunks) == 1 and chunks[0].whole_file:
        return None
    parts: list = []
    for chunk in chunks:
        done = chunk.offset
        # a torn tail (debug_ignore_file_size) is left unread
        n = chunk.nbytes - chunk.nbytes % rs
        if not n:
            continue
        buf = np.empty(n, dtype=np.uint8)
        with open_input(file_path, done, n, retry=retry, on_retry=on_retry,
                        io=io) as f:
            f.seek(done)
            if f.readinto(memoryview(buf)) != n:
                raise IOError(f"Short read from {file_path} at {done}")
        with timed_stage(stage_times, "decode"):
            part = reader.read_chunk(buf)
            if params.is_permissive:
                part = reader.permissive_part(part)
        parts.append(part)
        if progress is not None:
            progress.chunk_started()
            progress.chunk_done(bytes_done=n, records=_part_rows(part))
    return parts

