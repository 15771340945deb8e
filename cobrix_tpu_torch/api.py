"""`read_cobol`: fixed-length and RDW variable-length files, decoding on
the device.

Port of ``cobrix_tpu.api.read_cobol`` for two routes:

* fixed-length files (``_read_fixed_len_chunked`` and
  ``FixedLenReader.read_result``): the file is read in 64 MiB
  record-aligned chunks; each chunk is framed on the host as an
  [n, record_size] uint8 matrix, moved to the device, decoded by
  `ColumnarDecoder` (one fused kernel launch for every numeric group) and
  kept as a `DecodedBatch` of host planes;
* RDW files (``is_record_sequence`` or ``is_xcom``), single- or
  multisegment: ``reader.var_len_reader.VarLenReader`` frames each file on
  the device, window by window, and decodes the records of each active
  segment there, one `FileResult` per file.

With ``pipeline_workers`` > 0 (or -1: min(8, cpu_count)) either route
runs through the chunk pipeline (``engine.pipeline``): a reader thread
reads record-aligned chunks (``chunk_size_mb``) or sparse-index shards
into a bounded pool of pinned host buffers, and worker threads, each on
its own CUDA stream, move them to the card, frame and decode them; the
results come back in file and chunk order, equal to the sequential
read's. ``pipeline_workers=0``, the default, is the sequential path.

Every input is sniffed for a compression codec first (the JAX
package's ``compression`` detection): the port does not inflate yet
(ROADMAP A4f), so a compressed input raises ValueError naming it, unless
``compression="none"`` asks for its raw bytes. ``file://`` paths are
local files; any other scheme raises ValueError naming it.

Rows are materialized only when asked for. The options below are parsed
with the JAX package's spellings and error messages
(``parse_options``); the RDW ones are taken for RDW files only. Every
other option of the JAX package's reader raises ValueError naming it:
none is silently ignored. `CobolData.metrics` is the read's
`profiling.ReadMetrics`.
"""
from __future__ import annotations

import glob as _glob
import os
from dataclasses import replace as _dc_replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .copybook.ast import transform_identifier
from .device import resolve_device
from .engine.chunks import (auto_split_mb, check_fixed_size,
                            plan_var_len_chunks)
from .engine.pipeline import pipelined_fixed_scan, pipelined_var_len_scan
from .io.compress import active_codec, codec_by_name
from .copybook.datatypes import (
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
)
from .plan.cache import copybook_for_params
from .profiling import ReadMetrics
from .reader.columnar import ColumnarDecoder, DecodedBatch
from .reader.diagnostics import ShardErrorPolicy, ShardFailureInfo
from .reader.parameters import MultisegmentParameters, ReaderParameters
from .reader.result import FileResult
from .reader.schema import CobolOutputSchema, output_schema_for
from .reader.stream import normalize_local, path_scheme
from .reader.var_len_reader import (VarLenReader, default_segment_id_prefix,
                                    file_record_id_base)

# fixed-length files stream through bounded chunk reads: peak host memory
# stays about one chunk plus its decoded columns
FIXED_READ_CHUNK_BYTES = 64 * 1024 * 1024

# options of RDW reads, taken with is_record_sequence / is_xcom only
_RDW_OPTIONS = frozenset((
    "is_rdw_big_endian", "is_rdw_part_of_record_length", "rdw_adjustment",
    "file_start_offset", "file_end_offset", "record_start_offset",
    "segment_field", "segment_filter", "segment_id_root",
    "segment_id_prefix", "generate_record_id", "input_split_records",
    "input_split_size_mb", "enable_indexes"))
# options of every read: the pipeline's, its supervision's, the input's
# compression mode and the column projection (`filter` and `use_stats`
# are not taken yet)
_READ_OPTIONS = frozenset((
    "pipeline_workers", "chunk_size_mb", "max_inflight_chunks",
    "shard_timeout_s", "scan_deadline_s", "shard_error_policy",
    "shard_max_retries", "compression", "select"))
_RDW_OPTION_PREFIXES = ("segment_id_level", "redefine-segment-id-map",
                        "redefine_segment_id_map")
_FRAMING_OPTIONS = ("is_record_sequence", "is_xcom")

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
}


def _parse_enum(key: str, value: str):
    parsed = _ENUMS[key].get(str(value).strip().lower())
    if parsed is None:
        raise ValueError(f"Invalid value '{value}' for '{key}' option.")
    return parsed


class Options:
    """String-keyed option map (``cobrix_tpu.api.Options``, without its
    usage tracking: the port refuses unknown keys instead of auditing
    them). Values arrive as strings, as from the reference's ``.option()``
    map."""

    def __init__(self, options: Dict[str, object]):
        self._map = {str(k): str(v) for k, v in options.items()}

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._map.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._map

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
    """Parse 'redefine-segment-id-map:N' options ('FIELD => A,B') into
    {segment id: redefine name}."""
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


def _is_rdw_option(name: str) -> bool:
    return name in _RDW_OPTIONS or name.lower().startswith(
        _RDW_OPTION_PREFIXES)


def parse_options(options: Dict[str, object],
                  ebcdic_code_page: str = "common",
                  schema_retention_policy: str = "keep_original",
                  string_trimming_policy: str = "both",
                  floating_point_format: str = "ibm") -> ReaderParameters:
    """Options -> typed ReaderParameters, as ``cobrix_tpu.api
    .parse_options`` builds them for the options the port takes. Raises
    ValueError naming the first option the port does not take, and naming
    an RDW option given for a file that is not RDW-framed."""
    for name in sorted(options):
        if name not in _FRAMING_OPTIONS and name not in _READ_OPTIONS \
                and not _is_rdw_option(name):
            raise ValueError(
                f"Option '{name}' is not supported by cobrix_tpu_torch."
                f"read_cobol, which reads fixed-length and RDW "
                f"(is_record_sequence) files")
    opts = Options(options)
    is_record_sequence = (opts.get_bool("is_xcom") or
                          opts.get_bool("is_record_sequence"))
    if not is_record_sequence:
        for name in sorted(options):
            if _is_rdw_option(name):
                raise ValueError(
                    f"Option '{name}' is supported by cobrix_tpu_torch."
                    f"read_cobol for RDW files only "
                    f"(is_record_sequence=true)")
    multisegment = None
    if "segment_field" in opts:
        filter_str = opts.get("segment_filter")
        multisegment = MultisegmentParameters(
            segment_id_field=opts.get("segment_field"),
            segment_id_filter=filter_str.split(",") if filter_str else None,
            segment_level_ids=_parse_segment_levels(opts),
            segment_id_prefix=opts.get("segment_id_prefix", ""),
            segment_id_redefine_map=_parse_prefixed_map(
                opts, ("redefine-segment-id-map", "redefine_segment_id_map")))
    params = ReaderParameters(
        ebcdic_code_page=ebcdic_code_page,
        floating_point_format=_parse_enum("floating_point_format",
                                          floating_point_format),
        is_record_sequence=is_record_sequence,
        is_rdw_big_endian=opts.get_bool("is_rdw_big_endian"),
        is_rdw_part_of_record_length=opts.get_bool(
            "is_rdw_part_of_record_length"),
        rdw_adjustment=opts.get_int("rdw_adjustment", 0),
        is_index_generation_needed=opts.get_bool("enable_indexes", True),
        input_split_records=opts.get_int("input_split_records"),
        input_split_size_mb=opts.get_int("input_split_size_mb"),
        start_offset=opts.get_int("record_start_offset", 0),
        file_start_offset=opts.get_int("file_start_offset", 0),
        file_end_offset=opts.get_int("file_end_offset", 0),
        generate_record_id=opts.get_bool("generate_record_id"),
        schema_policy=_parse_enum("schema_retention_policy",
                                  schema_retention_policy),
        string_trimming_policy=_parse_enum("string_trimming_policy",
                                           string_trimming_policy),
        multisegment=multisegment,
        compression=(opts.get("compression", "auto") or "auto").lower(),
        pipeline_workers=opts.get_int("pipeline_workers", 0),
        pipeline_chunk_mb=float(opts.get("chunk_size_mb", "") or 16.0),
        pipeline_max_inflight=opts.get_int("max_inflight_chunks", 0),
        shard_error_policy=ShardErrorPolicy.parse(
            opts.get("shard_error_policy", "fail_fast")),
        shard_timeout_s=float(opts.get("shard_timeout_s", "") or 0.0),
        shard_max_retries=opts.get_int("shard_max_retries", 2),
        scan_deadline_s=float(opts.get("scan_deadline_s", "") or 0.0),
        select=tuple(s.strip() for s in opts.get("select", "").split(",")
                     if s.strip()) or None)
    _validate(params)
    return params


def _validate(params: ReaderParameters) -> None:
    """The JAX package's checks (``cobrix_tpu.api.parse_options``) of
    the compression, pipeline and supervision options, same messages."""
    if params.compression not in ("auto", "none", "off", "raw"):
        try:
            codec_by_name(params.compression)
        except ValueError as exc:
            raise ValueError(f"Invalid 'compression' option: {exc}")
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


def list_input_files(path) -> List[str]:
    """Local files under `path` (a file, directory or glob, or a list of
    them; ``file://`` or plain), recursively, skipping hidden names, in a
    stable order (reference FileUtils.scala:54-228,
    getListFilesWithOrder). Any other scheme raises ValueError naming it:
    the port reads no storage backend yet (ROADMAP A4f)."""
    paths = [path] if isinstance(path, str) else list(path)
    out: List[str] = []
    for p in paths:
        scheme = path_scheme(p)
        if scheme not in (None, "file"):
            raise ValueError(
                f"Input path '{p}' uses the '{scheme}://' scheme; "
                f"cobrix_tpu_torch.read_cobol reads local files only "
                f"(plain or file:// paths)")
        # file:// never propagates past listing: downstream os.path
        # consumers see plain local paths
        p = normalize_local(p)
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if not d.startswith((".", "_")))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith((".", "_")))
        elif os.path.isfile(p):
            out.append(p)
        else:
            matched = sorted(_glob.glob(p))
            if not matched:
                raise FileNotFoundError(f"Input path does not exist: {p}")
            for m in matched:
                out.extend(list_input_files(m))
    return out


class CobolData:
    """Decoded result of a read: the fixed-length route's `DecodedBatch`
    per chunk, or the RDW route's `FileResult` per file (per shard on a
    pipelined read), in record order, plus the output schema and the
    read's metrics."""

    def __init__(self, batches: List[DecodedBatch],
                 schema: CobolOutputSchema,
                 results: Optional[List[FileResult]] = None,
                 metrics: Optional[ReadMetrics] = None,
                 shard_failures: Optional[List[ShardFailureInfo]] = None):
        self.batches = batches
        self.results = results or []
        self.output_schema = schema
        self.metrics = metrics
        # chunks a pipelined read lost under shard_error_policy='partial'
        self.shard_failures = shard_failures or []
        self._rows: Optional[List[List[object]]] = None

    @property
    def schema(self):
        return self.output_schema.schema

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


def read_cobol(path=None,
               copybook: Optional[str] = None,
               copybook_contents=None,
               device=None,
               ebcdic_code_page: str = "common",
               schema_retention_policy: str = "keep_original",
               string_trimming_policy: str = "both",
               floating_point_format: str = "ibm",
               **options) -> CobolData:
    """Read fixed-length or RDW mainframe file(s) into decoded columns.

    `copybook` is a path (or list of paths) to copybook file(s);
    `copybook_contents` passes the text directly. `device=None` decodes
    on the CUDA device and raises RuntimeError when there is none;
    ``device="cpu"`` runs the plain PyTorch versions. The other keyword
    arguments take the JAX package's option names and values: with
    ``is_record_sequence="true"`` (or ``is_xcom``) the files are RDW
    framed, and the RDW options (header endianness and adjustment, file
    and record offsets, segment field, filter, levels, prefix and
    redefine map, record ids, sparse-index splits) apply. Every read
    takes `compression`, the pipeline's options (`pipeline_workers`,
    `chunk_size_mb`, `max_inflight_chunks`, `shard_error_policy`,
    `shard_timeout_s`, `shard_max_retries`, `scan_deadline_s`) and
    `select` (comma-separated field or group names: only those leaves,
    and the DEPENDING ON counters, are decoded; every other leaf is
    None)."""
    params = parse_options(options, ebcdic_code_page,
                           schema_retention_policy, string_trimming_policy,
                           floating_point_format)
    contents = load_copybook_contents(copybook, copybook_contents)
    if path is None:
        raise ValueError("'path' must be specified for read_cobol.")
    files = list_input_files(path)
    if not files:
        raise FileNotFoundError(f"No input files found for path {path}")
    for file_path in files:
        codec = active_codec(file_path, params.compression)
        if codec is not None:
            raise ValueError(
                f"Input file '{file_path}' is {codec.name}-compressed "
                f"(compression='{params.compression}'); "
                f"cobrix_tpu_torch.read_cobol does not inflate compressed "
                f"inputs yet. Decompress it first, or pass "
                f"compression='none' to read its raw bytes.")
    device = resolve_device(device)
    workers = params.resolved_pipeline_workers()
    use_pipeline = workers > 0
    if use_pipeline and params.is_record_sequence:
        split_mb = auto_split_mb(params)
        if split_mb is not None:
            # default the sparse-index split to the pipeline chunk size
            # so mid-size files produce several shards (explicit
            # input_split options always win)
            params = _dc_replace(params, input_split_size_mb=split_mb)
    metrics = ReadMetrics(files=len(files), bytes_read=sum(
        os.path.getsize(f) for f in files))
    failures: List[ShardFailureInfo] = []
    if params.is_record_sequence:
        reader = VarLenReader(contents, params, device=device)
        seg = params.multisegment
        prefix = (seg.segment_id_prefix if seg and seg.segment_id_prefix
                  else default_segment_id_prefix())
        if use_pipeline:
            shards = plan_var_len_chunks(reader, files, params)
            metrics.shards = len(shards)
            results, failures = pipelined_var_len_scan(
                reader, shards, prefix, workers, metrics)
            results = [r for r in results if r is not None]
        else:
            results = [reader.read_result(
                file_path, file_id=file_order, segment_id_prefix=prefix,
                start_record_id=file_record_id_base(file_order))
                for file_order, file_path in enumerate(files)]
            metrics.shards = len(results)
        data = CobolData([], output_schema_for(reader.copybook, params,
                                               is_var_len=True), results,
                         metrics, failures)
    else:
        cb = copybook_for_params(contents, params)
        decoder = ColumnarDecoder(cb, select=params.select, device=device)
        if use_pipeline:
            batches, failures = pipelined_fixed_scan(
                decoder, files, params, workers, metrics)
            batches = [b for b in batches if b is not None]
        else:
            batches = _read_fixed_sequential(decoder, cb.record_size,
                                             files)
            metrics.shards = len(batches)
        data = CobolData(batches, output_schema_for(cb, params,
                                                    is_var_len=False),
                         None, metrics, failures)
    metrics.records = len(data)
    return data


def _read_fixed_sequential(decoder: ColumnarDecoder, rs: int,
                           files: List[str]) -> List[DecodedBatch]:
    """The sequential fixed-length read: each file in record-aligned
    chunks of FIXED_READ_CHUNK_BYTES, read into a fresh host buffer and
    decoded in turn."""
    chunk_bytes = max(rs, FIXED_READ_CHUNK_BYTES // rs * rs)
    batches: List[DecodedBatch] = []
    for file_path in files:
        size = os.path.getsize(file_path)
        check_fixed_size(file_path, size, rs)
        with open(file_path, "rb") as f:
            done = 0
            while done < size:
                buf = bytearray(min(chunk_bytes, size - done))
                got = f.readinto(buf)
                if got != len(buf):
                    raise IOError(f"Short read from {file_path} at {done}")
                matrix = np.frombuffer(buf, dtype=np.uint8).reshape(-1, rs)
                batches.append(decoder.decode(matrix))
                done += got
    return batches
