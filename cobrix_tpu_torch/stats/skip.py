"""Zone-map chunk skipping: the fourth pushdown depth, BEFORE framing.

With ``use_stats=true`` and a warm profile, the chunk planners consult
a :class:`ChunkSkipper` before emitting each planned byte range. A
range is skipped only when the profiled chunks PROVE no record in it
can satisfy the filter:

* **Union coverage** — the scan's chunk grid need not match the
  profile's. A planned range ``[a, b)`` skips iff the profiled chunks
  jointly cover it with no gaps AND every overlapping profiled chunk is
  a proven no-match. Both grids are record-aligned on the same record
  stream, so any record in the range lies fully inside one overlapping
  profile chunk — safe under any grid mismatch.
* **Tri-state evaluation** — each (chunk, expression) pair evaluates to
  "provably no match" or "maybe"; anything unknown (missing field,
  NaN-tainted zone map, type mismatch, a NOT node) is "maybe" and the
  chunk scans normally. Null comparison results DROP rows (the
  BoundFilter contract), which is what makes all-null chunks provable
  no-matches for value predicates.

A missing, stale, or corrupt profile is just "no proof": the planners
see every chunk, and results stay byte-identical to a stats-off scan.

Port copy of ``cobrix_tpu.stats.skip``. The skipper is consulted by the
port's planners (``engine/chunks.py``), its sequential fixed-length read
(``api._read_fixed_sequential``) and its sequential RDW read
(``VarLenReader.read_result``); a skipped range is never read, framed or
decoded. Change: `maybe_attach_skipper` takes no `io` (it never read
through it) and the eligibility check no backend.
"""
from __future__ import annotations

from bisect import bisect_right
from decimal import Decimal
from typing import Dict, Optional, Tuple

from ..query.expr import And, Comparison, IsIn, Not, Or, SegmentIs
from .profile import ChunkStats, FieldStats, FileProfile


def _coerce(kind: str, value):
    """The filter literal as a value comparable against `kind` zone
    maps, or the sentinel None for "not provable" (booleans only match
    the bool kind; floats never consult decimal maps — their cast
    rounding at boundaries is the scan's business, not ours)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return value if kind == "bool" else None
    if kind in ("int", "float"):
        return value if isinstance(value, (int, float)) else None
    if kind == "decimal":
        if isinstance(value, int):
            return Decimal(value)
        if isinstance(value, Decimal):
            return value
        return None
    if kind == "string":
        return value if isinstance(value, str) else None
    return None


def _cmp_no_match(op: str, fs: FieldStats, records: int, value) -> bool:
    """True iff ``field <op> value`` provably matches no record of a
    chunk with these field stats."""
    if value is None:
        # is-null tests: null rows are exactly counted
        if op == "==":
            return fs.null_count == 0
        return fs.null_count == records  # "!="
    if fs.null_count == records:
        # all null: every comparison result is null, every row drops
        return True
    coerced = _coerce(fs.kind, value)
    if coerced is None:
        return False
    if op == "!=":
        # nulls never match anyway; non-null rows all fail only when
        # the chunk is constant at exactly this value
        return (fs.min is not None and fs.min == fs.max
                and fs.min == coerced)
    if fs.min is None:
        return False  # unknown zone map (NaN taint)
    try:
        if op == "==":
            if coerced < fs.min or coerced > fs.max:
                return True
            return (fs.kind == "string" and fs.distinct is not None
                    and coerced not in fs.distinct)
        if op == "<":
            return fs.min >= coerced
        if op == "<=":
            return fs.min > coerced
        if op == ">":
            return fs.max <= coerced
        if op == ">=":
            return fs.max < coerced
    except TypeError:
        return False
    return False


class ChunkSkipper:
    """Per-read skip oracle: loaded profiles + the bound filter,
    memoizing each profiled chunk's tri-state verdict."""

    def __init__(self, profiles: Dict[str, FileProfile], value_expr,
                 name_map: Dict[str, str],
                 segment_values: Optional[Tuple[str, ...]], stats):
        self.profiles = profiles
        self.value_expr = value_expr      # query.expr node or None
        self.name_map = dict(name_map)    # filter name -> profile leaf
        self.segment_values = (tuple(v.strip() for v in segment_values)
                               if segment_values is not None else None)
        self.stats = stats                # the read's PushdownStats
        self._verdicts: Dict[Tuple[int, int], bool] = {}

    # -- per-profiled-chunk tri-state ---------------------------------

    def _segment_no_match(self, chunk: ChunkStats) -> bool:
        if self.segment_values is None or not chunk.segments:
            return False
        # only a COMPLETE histogram (every record counted) is proof
        if sum(chunk.segments.values()) != chunk.records:
            return False
        present = {k.strip() for k in chunk.segments}
        return not present.intersection(self.segment_values)

    def _expr_no_match(self, expr, chunk: ChunkStats) -> bool:
        if isinstance(expr, And):
            return any(self._expr_no_match(a, chunk) for a in expr.args)
        if isinstance(expr, Or):
            return all(self._expr_no_match(a, chunk) for a in expr.args)
        if isinstance(expr, Not):
            return False  # negations prove nothing from zone maps
        if isinstance(expr, SegmentIs):  # defense: rejected at bind
            return False
        if isinstance(expr, Comparison):
            fs = self._field(expr.field, chunk)
            return (fs is not None
                    and _cmp_no_match(expr.op, fs, chunk.records,
                                      expr.value))
        if isinstance(expr, IsIn):
            fs = self._field(expr.field, chunk)
            return (fs is not None
                    and all(_cmp_no_match("==", fs, chunk.records, v)
                            for v in expr.values))
        return False

    def _field(self, filter_name: str,
               chunk: ChunkStats) -> Optional[FieldStats]:
        leaf = self.name_map.get(filter_name)
        return chunk.fields.get(leaf) if leaf else None

    def _chunk_no_match(self, chunk: ChunkStats) -> bool:
        key = (id(chunk), chunk.offset)
        cached = self._verdicts.get(key)
        if cached is None:
            cached = (chunk.records == 0
                      or self._segment_no_match(chunk)
                      or (self.value_expr is not None
                          and self._expr_no_match(self.value_expr,
                                                  chunk)))
            self._verdicts[key] = cached
        return cached

    # -- the planner-facing query -------------------------------------

    def should_skip(self, file_path: str, start: int,
                    end: int = -1) -> bool:
        """True iff the planned byte range ``[start, end)`` of
        `file_path` (end=-1: to EOF) provably frames no matching
        record. Counts one considered chunk (and, on True, one skipped
        chunk + its bytes) on the read's pushdown stats."""
        if self.stats is not None:
            self.stats.note(chunks_considered=1)
        profile = self.profiles.get(file_path)
        if profile is None:
            return False
        if end == -1:
            end = profile.total_bytes
        if end <= start:
            return False
        pos = start
        chunks = profile.chunks
        offsets = [c.offset for c in chunks]
        # first profiled chunk that could overlap [start, end)
        i = max(bisect_right(offsets, start) - 1, 0)
        for chunk in chunks[i:]:
            if chunk.offset >= end:
                break
            if chunk.end <= pos:
                continue
            if chunk.offset > pos:
                return False  # coverage gap: no proof
            if not self._chunk_no_match(chunk):
                return False
            pos = chunk.end
            if pos >= end:
                break
        if pos < end:
            return False  # range runs past the profiled bytes
        if self.stats is not None:
            self.stats.note(chunks_skipped=1, bytes_skipped=end - start)
        return True


def maybe_attach_skipper(reader, files, params) -> None:
    """Load warm profiles for `files` and arm ``reader.chunk_skipper``
    (``use_stats=true``). No filter, no profiles, or an ineligible read
    → no skipper, and the scan proceeds exactly as before."""
    from .collect import bump_overhead, profiling_eligibility

    bump_overhead()
    bound = getattr(reader, "pushdown", None)
    if bound is None:
        return  # nothing to prove against
    if profiling_eligibility(files, params) is not None:
        return
    from ..reader.stream import normalize_local
    from .store import StatsStore, local_fingerprint

    try:
        store = StatsStore(params.cache_dir)
    except OSError:
        return  # unusable cache volume: stats must never fail a scan
    config_fp = stats_config_fingerprint_for(reader, params)
    profiles: Dict[str, FileProfile] = {}
    for path in files:
        local = normalize_local(path)
        fingerprint = local_fingerprint(local)
        if fingerprint is None:
            continue
        profile = store.load(local, fingerprint, config_fp)
        if profile is not None:
            profiles[path] = profile
            profiles[local] = profile
    if not profiles:
        return
    name_map = {name: st.name for name, st in bound.statements.items()}
    reader.chunk_skipper = ChunkSkipper(
        profiles, bound.value_expr, name_map, bound.segment_values,
        bound.stats)


def stats_config_fingerprint_for(reader, params) -> str:
    from .store import stats_config_fingerprint

    return stats_config_fingerprint(
        getattr(reader, "copybook_fingerprint", None), params)
