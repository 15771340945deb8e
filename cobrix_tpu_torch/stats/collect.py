"""The profiler: a standalone deterministic decode pass that builds
:class:`~cobrix_tpu_torch.stats.profile.FileProfile` artifacts.

Determinism across execution modes is BY CONSTRUCTION: the profiler
never rides the scan's own execution plan. It builds its own reader
(filter/select stripped, generated columns off) and walks a canonical
chunk grid — fixed files in ``stats_chunk_mb`` record-aligned strides,
variable-length files along a sparse index generated at
``stats_chunk_mb`` splits — so a profile collected during a sequential
scan is byte-identical to one collected during a pipelined scan of the
same bytes.

Zero-overhead contract: a read with both stats options off never
imports this module (api.py gates the import on the option flags), and
``overhead_events()`` counts every entry into the stats machinery so
tests can assert exactly that.

Port copy of ``cobrix_tpu.stats.collect``. The pass runs on the read's
device: a fixed-length chunk is read into a host buffer and decoded by
``FixedLenReader.read_chunk`` (one fused-kernel launch a chunk), a
variable-length chunk is one sparse-index shard read through
``VarLenReader._read_file_shards`` (the scan, pack and fused kernels),
and every chunk becomes Arrow through ``to_arrow`` (the assembly
kernels). The zone maps, sums, distinct sketches and segment histograms
are pyarrow compute over that table on the host, as in the JAX
package, so the payloads are equal value for value. Changes: the
eligibility check takes no backend (the port has no host backend; its
row-walk reads are profiled as the JAX package's columnar reads are);
every file is sized by its logical (decompressed) size, and a
fixed-length one read through `open_input`, so a compressed file's
profile is of the decompressed records the reads skip on (the JAX
package sizes a fixed-length file by its compressed bytes); a
variable-length file's shards are read `parallelism` at a time; and only
a data or I/O error leaves a file unprofiled.
`leaf_columns` lives here, as in the JAX package.
"""
from __future__ import annotations

import logging
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .profile import (
    LENGTH_HISTOGRAM_LIMIT,
    SKETCH_LIMIT,
    ChunkStats,
    FieldStats,
    FileProfile,
)
from .store import StatsStore, local_fingerprint, stats_config_fingerprint

# names of generated/bookkeeping columns that never carry record data
_GENERATED = ("Record_Id", "File_Id", "Record_Byte_Length")

_overhead_events = 0


def overhead_events() -> int:
    """How many times any stats machinery ran in this process — the
    zero-overhead assertion's witness (reads with stats off must leave
    it unchanged, which the tier-1 suite checks)."""
    return _overhead_events


def bump_overhead() -> None:
    global _overhead_events
    _overhead_events += 1


def _kind_of(arrow_type) -> Optional[str]:
    import pyarrow as pa

    if pa.types.is_boolean(arrow_type):
        return "bool"
    if pa.types.is_integer(arrow_type):
        return "int"
    if pa.types.is_floating(arrow_type):
        return "float"
    if pa.types.is_decimal(arrow_type):
        return "decimal"
    if (pa.types.is_string(arrow_type)
            or pa.types.is_large_string(arrow_type)):
        return "string"
    return None  # binary / nested / anything else: not profiled


def leaf_columns(table) -> Dict[str, Tuple[str, object]]:
    """{leaf name -> (kind, column)} for every profilable column of an
    assembled table: structs flattened, lists and generated columns
    dropped, DUPLICATE leaf names dropped entirely (a filter name that
    is ambiguous in the copybook must not consult either column's zone
    map)."""
    import pyarrow as pa

    while any(pa.types.is_struct(f.type) for f in table.schema):
        table = table.flatten()
    out: Dict[str, Tuple[str, object]] = {}
    dupes = set()
    for name, col in zip(table.column_names, table.columns):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _GENERATED or leaf.startswith("Seg_Id"):
            continue
        kind = _kind_of(col.type)
        if kind is None:
            continue
        if leaf in dupes or leaf in out:
            out.pop(leaf, None)
            dupes.add(leaf)
            continue
        out[leaf] = (kind, col)
    return out


def _field_stats(kind: str, col) -> FieldStats:
    import pyarrow.compute as pc

    n = len(col)
    nulls = col.null_count
    fs = FieldStats(kind, null_count=nulls)
    if nulls == n:
        # all-null: the zone map is vacuously empty, the sum of no
        # values folds as 0 for the exact kinds (the aggregate layer
        # reports SQL NULL when the grand non-null count is zero)
        if kind in ("int", "decimal"):
            fs.sum = 0
        if kind == "string":
            fs.distinct = ()
        return fs
    if kind == "float":
        try:
            if bool(pc.any(pc.is_nan(col)).as_py()):
                return fs  # NaN taint: min/max unknown for this chunk
        except Exception:
            return fs
    try:
        mm = pc.min_max(col)
        fs.min = mm["min"].as_py()
        fs.max = mm["max"].as_py()
    except Exception:
        fs.min = fs.max = None
    if kind in ("int", "decimal"):
        try:
            fs.sum = pc.sum(col).as_py()
        except Exception:
            fs.sum = None  # overflow: inexact, never wrong
    if kind == "string":
        try:
            uniq = pc.unique(pc.drop_null(col))
            if len(uniq) <= SKETCH_LIMIT:
                fs.distinct = tuple(sorted(uniq.to_pylist()))
        except Exception:
            pass
    return fs


def _segment_hist(table, seg_leaf: str) -> Dict[str, int]:
    """Complete per-chunk segment-id histogram (every record counted —
    nulls and empties under ''), or {} when the column is absent."""
    import pyarrow as pa
    import pyarrow.compute as pc

    while any(pa.types.is_struct(f.type) for f in table.schema):
        table = table.flatten()
    col = None
    for name in table.column_names:
        if name.rsplit(".", 1)[-1] == seg_leaf:
            col = table.column(name)
            break
    if col is None:
        return {}
    hist: Dict[str, int] = {}
    for row in pc.value_counts(col):
        value = row["values"].as_py()
        key = str(value).strip() if value is not None else ""
        hist[key] = hist.get(key, 0) + row["counts"].as_py()
    return hist


def profile_table(table, seg_leaf: str = "") -> Tuple[
        Dict[str, FieldStats], Dict[str, str], Dict[str, int]]:
    """One decoded chunk's (field stats, field kinds, segment
    histogram) — shared by the batch profiler here and the streaming
    drift accumulator."""
    fields = {}
    kinds = {}
    for leaf, (kind, col) in leaf_columns(table).items():
        fields[leaf] = _field_stats(kind, col)
        kinds[leaf] = kind
    segments = _segment_hist(table, seg_leaf) if seg_leaf else {}
    return fields, kinds, segments


def segment_leaf_name(copybook, params) -> str:
    """The Arrow leaf name of the configured segment-id field (''
    when the read is not multisegment)."""
    seg = params.multisegment
    if seg is None or not seg.segment_id_field:
        return ""
    try:
        return copybook.get_field_by_name(seg.segment_id_field).name
    except (KeyError, ValueError):
        return ""


def profiling_eligibility(files, params) -> Optional[str]:
    """None when profiles can be collected for this read, else a short
    human reason (surfaced through explain)."""
    from ..reader.stream import path_scheme

    if not params.cache_dir:
        return "no cache_dir to persist profiles in"
    if params.is_text:
        return "text mode is not profiled"
    if params.file_start_offset or params.file_end_offset:
        return "file byte trims shift chunk offsets"
    for path in files:
        if path_scheme(path) not in (None, "file"):
            return f"non-local file {path!r} (profiles are local-only)"
    return None


def _bare_params(params):
    """The profiler's decode configuration: the scan's parameters minus
    everything that changes WHICH rows/columns come back (the profile
    must describe the whole file) and minus generated columns."""
    return replace(params, filter=None, select=None,
                   generate_record_id=False, input_file_name_column="",
                   corrupt_record_column="")


def _profile_fixed(reader, path: str, params, schema,
                   io=None) -> FileProfile:
    """The fixed-length pass: `stats_chunk_mb` record-aligned strides of
    the file's logical bytes (a compressed file's decompressed ones, the
    offsets every read of it plans and skips on), each read into a host
    buffer through `open_input`, decoded on the reader's device
    (`FixedLenReader.read_chunk`) and assembled (`to_arrow`)."""
    from ..reader.parameters import MEGABYTE
    from ..reader.stream import open_input, source_size

    rs = reader.record_size
    size = source_size(path, io=io)
    if rs <= 0 or size % rs:
        raise ValueError(
            f"{path!r}: size {size} is not a multiple of the "
            f"{rs}-byte record (not profiled)")
    stride = max(rs, (int(params.stats_chunk_mb * MEGABYTE) // rs) * rs)
    seg_leaf = segment_leaf_name(reader.copybook, params)
    chunks: List[ChunkStats] = []
    kinds: Dict[str, str] = {}
    done = 0
    with open_input(path, io=io) as f:
        while done < size:
            buf = np.empty(min(stride, size - done), dtype=np.uint8)
            if f.readinto(memoryview(buf)) != len(buf):
                raise IOError(f"Short read from {path} at {done}")
            table = reader.read_chunk(buf).to_arrow(schema)
            fields, chunk_kinds, segments = profile_table(table, seg_leaf)
            kinds.update(chunk_kinds)
            lengths = {rs: table.num_rows}
            if len(lengths) > LENGTH_HISTOGRAM_LIMIT:  # pragma: no cover
                lengths = {-1: table.num_rows}
            chunks.append(ChunkStats(done, len(buf), table.num_rows,
                                     fields, segments, lengths))
            done += len(buf)
    return FileProfile(path, "fixed", rs,
                       sum(c.records for c in chunks), size, kinds,
                       chunks)


def _profile_var_len(reader, path: str, params, schema) -> FileProfile:
    """The variable-length pass: one chunk a sparse-index entry (the
    whole file when the index does not apply), each read on the
    reader's device as one shard (`VarLenReader._read_file_shards`:
    the scan, pack and fused kernels) and assembled (`to_arrow`)."""
    from ..reader.index import SparseIndexEntry, file_index_entries
    from ..reader.var_len_reader import default_segment_id_prefix

    size = reader.input_size(path)
    entries = file_index_entries(reader, path, 0, params, reader.retry,
                                 reader.on_retry, io=reader.io)
    if not entries:
        entries = [SparseIndexEntry(0, -1, 0, 0)]  # too small to index
    seg = params.multisegment
    prefix = (seg.segment_id_prefix if seg and seg.segment_id_prefix
              else default_segment_id_prefix())
    seg_leaf = segment_leaf_name(reader.copybook, params)
    chunks: List[ChunkStats] = []
    kinds: Dict[str, str] = {}
    # `parallelism` shards at a time, so the pass holds no more decoded
    # shards than the read's threads decode together
    width = max(1, reader.parallelism)
    for at in range(0, len(entries), width):
        group = entries[at:at + width]
        results = reader._read_file_shards(path, size, group, 0, 0, prefix)
        for e, result in zip(group, results):
            end = size if e.offset_to == -1 else e.offset_to
            table = result.to_arrow(schema)
            fields, chunk_kinds, segments = profile_table(table, seg_leaf)
            kinds.update(chunk_kinds)
            # per-record lengths are not recovered here: the unbucketed
            # count keys on -1 (drift compares the bytes/records average)
            chunks.append(ChunkStats(e.offset_from, end - e.offset_from,
                                     table.num_rows, fields, segments,
                                     {-1: table.num_rows}))
        del results
    return FileProfile(path, "vrl", 0, sum(c.records for c in chunks),
                       size, kinds, chunks)


def build_and_store_profiles(files, copybook_contents, params, device,
                             io=None) -> Dict[str, FileProfile]:
    """Profile every eligible file of a read (``collect_stats=true``) on
    `device`: warm entries load from the store, cold files run the
    canonical profiling pass and persist. Returns {path: profile};
    files that cannot be profiled (a data or I/O error: ValueError,
    OSError) are skipped with a warning, best-effort, as in the JAX
    package; any other error, such as a kernel's failure on the card,
    propagates."""
    from ..plan.cache import parse_fingerprint
    from ..reader.fixed_len_reader import FixedLenReader
    from ..reader.schema import output_schema_for
    from ..reader.stream import normalize_local
    from ..reader.var_len_reader import VarLenReader

    bump_overhead()
    profiles: Dict[str, FileProfile] = {}
    if profiling_eligibility(files, params) is not None:
        return profiles
    bare = _bare_params(params)
    is_var_len = bare.needs_var_len_reader
    if is_var_len:
        # the profiling grid: the caller's explicit split options when
        # given, else a sparse index at stats_chunk_mb splits (clamped
        # to the index validator's 1 MB floor). Any grid is safe — the
        # config fingerprint excludes split knobs and the skipper's
        # union-coverage rule tolerates grid mismatches — so explicit
        # options just make the profile match the scan's granularity
        if (params.input_split_records is None
                and params.input_split_size_mb is None):
            bare = replace(
                bare, input_split_records=None,
                input_split_size_mb=max(1.0,
                                        float(params.stats_chunk_mb)))
        bare = replace(bare, is_index_generation_needed=True)
        reader = VarLenReader(copybook_contents, bare, device=device)
        if reader.copybook.is_hierarchical:
            return profiles  # no flat chunk/record model to profile
        reader.io = io
    else:
        reader = FixedLenReader(copybook_contents, bare, device=device)
    schema = output_schema_for(reader.copybook, bare, is_var_len)
    store = StatsStore(params.cache_dir)
    config_fp = stats_config_fingerprint(
        parse_fingerprint(copybook_contents, params), params)
    for path in files:
        local = normalize_local(path)
        fingerprint = local_fingerprint(local)
        if fingerprint is None:
            continue
        cached = store.load(local, fingerprint, config_fp)
        if cached is not None:
            profiles[path] = cached
            continue
        try:
            if is_var_len:
                profile = _profile_var_len(reader, local, bare, schema)
            else:
                profile = _profile_fixed(reader, local, bare, schema, io)
        except (ValueError, OSError):
            # a file the pass cannot frame or read is left unprofiled;
            # anything else (a kernel's launch or runtime error on the
            # card) is a fault and fails the read
            logging.getLogger(__name__).warning(
                "stats profiling failed for %s; the read is unaffected",
                path, exc_info=True)
            continue
        store.save_for_local_path(local, config_fp, profile)
        profiles[path] = profile
    if profiles:
        from .service import note_profiles

        note_profiles(profiles)
    return profiles
