"""Filter binding + evaluation against the device decode.

Port copy of ``cobrix_tpu.query.pushdown``. ``BoundFilter`` binds a
parsed expression (expr.py) to one reader configuration: it resolves
field references against the copybook, splits the expression into the
segment-id conjuncts (applied to the records' raw segment ids, before
ANY decode) and the value predicate (evaluated by a narrow **stage-1
decode** of only the filter columns, through the same Arrow assembly
the output table uses, so pushed-down results equal post-hoc filtering
by construction), and carries the per-read pruning counters.

The two-stage shape per chunk, window or shard, on the reader's device:

    frame -> [segment-conjunct mask on the raw segment ids]
          -> stage 1: pack + fused decode of ONLY the filter columns,
             Arrow arrays, predicate -> keep mask (host)
          -> stage 2: pack the KEPT records from the same device image
             and decode the selected plan on them

Dropped records never reach the full decode or assembly; filter-only
columns never reach the output (late materialization) because the
stage-2 plan does not contain them.

Generic fallback (hierarchical assemblies, row-backed paths): the
whole expression evaluates post-decode on the assembled table —
correct everywhere, pruned nowhere (`filter_result_generic`).

Changes from the JAX package: the stage-1 helper takes the reader's
decoder cache and device in place of the reader and a backend, and runs
on a record image already on the device (`mask_raw`); the JAX package's
``mask_matrix`` over a host matrix has no caller here, since the
fixed-length readers upload a chunk once and run both stages on that
image. `_arrays_from_batch` requests the leaves, assembles them in one
pass on the batch's device and then makes the arrays, as the port's
``ArrowBatchBuilder`` does. ``describe_pushdown`` feeds only
``explain``, which the port does not have yet (ROADMAP A8), and is
left out.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..copybook.ast import Group, Primitive
from .expr import (
    And,
    Comparison,
    Expr,
    IsIn,
    Not,
    Or,
    SegmentIs,
    from_wire,
)


class PushdownStats:
    """Per-read pruning counters (thread-safe: the shard pool and the
    pipeline workers bump one shared instance)."""

    __slots__ = ("_lock", "records_scanned", "records_pruned_segment",
                 "records_pruned_filter", "records_pruned_residual",
                 "bytes_skipped", "chunks_considered", "chunks_skipped")

    def __init__(self):
        self._lock = threading.Lock()
        self.records_scanned = 0
        self.records_pruned_segment = 0
        self.records_pruned_filter = 0
        self.records_pruned_residual = 0
        self.bytes_skipped = 0
        # the fourth pushdown depth (stats/skip.py): chunks the planners
        # asked the zone maps about, and how many never reached framing
        self.chunks_considered = 0
        self.chunks_skipped = 0

    def note(self, scanned: int = 0, pruned_segment: int = 0,
             pruned_filter: int = 0, pruned_residual: int = 0,
             bytes_skipped: int = 0, chunks_considered: int = 0,
             chunks_skipped: int = 0) -> None:
        with self._lock:
            self.records_scanned += int(scanned)
            self.records_pruned_segment += int(pruned_segment)
            self.records_pruned_filter += int(pruned_filter)
            self.records_pruned_residual += int(pruned_residual)
            self.bytes_skipped += int(bytes_skipped)
            self.chunks_considered += int(chunks_considered)
            self.chunks_skipped += int(chunks_skipped)

    @property
    def records_pruned(self) -> int:
        return (self.records_pruned_segment + self.records_pruned_filter
                + self.records_pruned_residual)

    def as_dict(self) -> dict:
        with self._lock:
            scanned = self.records_scanned
            pruned = (self.records_pruned_segment
                      + self.records_pruned_filter
                      + self.records_pruned_residual)
            out = {
                "records_scanned": scanned,
                "records_pruned": pruned,
                "records_pruned_segment": self.records_pruned_segment,
                "records_pruned_filter": self.records_pruned_filter,
                "records_pruned_residual": self.records_pruned_residual,
                "bytes_skipped": self.bytes_skipped,
                "chunks_considered": self.chunks_considered,
                "chunks_skipped": self.chunks_skipped,
            }
        out["selectivity"] = (round((scanned - pruned) / scanned, 6)
                              if scanned else None)
        return out


def split_segment_conjuncts(expr: Expr
                            ) -> Tuple[Optional[Tuple[str, ...]],
                                       Optional[Expr]]:
    """(segment id values, residual expression) for the top-level AND
    decomposition. ``segment()`` anywhere else (under OR/NOT) is
    rejected at bind time — it names the multisegment plumbing, not a
    column, and only a conjunct can drop records unconditionally."""
    conjuncts = list(expr.args) if isinstance(expr, And) else [expr]
    seg_values: List[str] = []
    rest: List[Expr] = []
    for c in conjuncts:
        if isinstance(c, SegmentIs):
            seg_values.extend(c.values)
        else:
            _reject_nested_segment(c)
            rest.append(c)
    residual: Optional[Expr] = None
    if rest:
        residual = rest[0] if len(rest) == 1 else And(*rest)
    values = tuple(dict.fromkeys(seg_values)) if seg_values else None
    return values, residual


def _reject_nested_segment(expr: Expr) -> None:
    if isinstance(expr, SegmentIs):
        raise ValueError(
            "segment(...) must be a top-level AND conjunct of the "
            "filter (it drops records before decode; under or/not it "
            "cannot)")
    for child in getattr(expr, "args", ()) or ():
        _reject_nested_segment(child)
    arg = getattr(expr, "arg", None)
    if arg is not None:
        _reject_nested_segment(arg)


def _inside_array(st: Primitive) -> bool:
    node = st
    while node is not None:
        if node.is_array:
            return True
        node = getattr(node, "parent", None)
    return False


class BoundFilter:
    """One filter expression bound to one (copybook, parameters)."""

    def __init__(self, expr: Expr, copybook, params):
        self.expr = expr
        self.copybook = copybook
        self.segment_values, self.value_expr = \
            split_segment_conjuncts(expr)
        if self.segment_values is not None:
            seg = params.multisegment
            if seg is None or not seg.segment_id_field:
                raise ValueError(
                    "filter uses segment(...) but no 'segment_field' "
                    "option is configured")
        # field references resolve to non-array primitives with static
        # offsets — the shapes both stage-1 decode and the post-hoc
        # comparison agree on
        self.statements: Dict[str, Primitive] = {}
        names = (self.value_expr.fields()
                 if self.value_expr is not None else [])
        for name in names:
            st = copybook.get_field_by_name(name)
            if isinstance(st, Group):
                raise ValueError(
                    f"filter field '{name}' is a group; filters apply "
                    "to primitive fields")
            if _inside_array(st):
                raise ValueError(
                    f"filter field '{name}' is (inside) an OCCURS "
                    "array; array elements cannot be filtered on")
            self.statements[name] = st
        # stage-1 projection: exactly the filter columns, by LEAF name
        # (dotted disambiguations resolve to their leaf; the slot map
        # still binds the exact statement). The plan/decoder caches key
        # on this tuple, so stage-1 programs are shared and never
        # contaminate differently-selected plans
        self.filter_select: Optional[Tuple[str, ...]] = (
            tuple(sorted({st.name for st in self.statements.values()}))
            or None)
        self.stats = PushdownStats()

    @classmethod
    def build(cls, wire: Optional[str], copybook,
              params) -> Optional["BoundFilter"]:
        if not wire:
            return None
        return cls(from_wire(wire), copybook, params)

    # -- evaluation --------------------------------------------------------

    def _arrays_from_batch(self, batch, active: Optional[str],
                           redefine_masks: Optional[dict]) -> dict:
        """{field name -> pa.Array} for the referenced columns, built
        through the SAME assembly path the output table uses
        (ArrowBatchBuilder: the leaves are requested, assembled in one
        pass on the batch's device, then made) — the parity anchor: a
        value the table would show is the value the predicate sees."""
        from ..reader.arrow_out import ArrowBatchBuilder

        builder = ArrowBatchBuilder(batch, active, redefine_masks)
        thunks = {name: builder._leaf_array(st, ())
                  for name, st in self.statements.items()}
        builder.assemble()
        return {name: thunk() for name, thunk in thunks.items()}

    def eval_batch(self, batch, active: Optional[str] = None,
                   redefine_masks: Optional[dict] = None) -> np.ndarray:
        """Keep-mask over a (stage-1) decoded batch. Null predicate
        results drop the row — identical to ``table.filter``."""
        if self.value_expr is None:
            return np.ones(batch.n_records, dtype=bool)
        arrays = self._arrays_from_batch(batch, active, redefine_masks)
        return self._mask(self.value_expr, arrays, batch.n_records)

    def eval_table(self, table) -> np.ndarray:
        """Keep-mask over an assembled table (generic fallback paths:
        hierarchical assemblies, row-backed results, dataset scans of
        pre-built tables). Fields missing from the table evaluate as
        null (dropped), matching a post-hoc filter on the same table."""
        if self.value_expr is None:
            return np.ones(table.num_rows, dtype=bool)
        import pyarrow as pa

        arrays = {}
        for name, st in self.statements.items():
            col = _resolve_table_column(table, st)
            arrays[name] = (col if col is not None
                            else pa.nulls(table.num_rows))
        return self._mask(self.value_expr, arrays, table.num_rows)

    def _mask(self, expr: Expr, arrays: dict, n: int) -> np.ndarray:
        import pyarrow.compute as pc

        datum = self._eval(expr, arrays, n)
        filled = pc.fill_null(datum, False)
        if hasattr(filled, "combine_chunks"):
            filled = filled.combine_chunks()
        return np.asarray(filled)

    def _eval(self, expr: Expr, arrays: dict, n: int):
        import pyarrow as pa
        import pyarrow.compute as pc

        if isinstance(expr, Comparison):
            arr = arrays[expr.field]
            if expr.value is None:
                null = pc.is_null(arr)
                return null if expr.op == "==" else pc.invert(null)
            scalar = _literal_for(arr, expr.value)
            fn = {"==": pc.equal, "!=": pc.not_equal, "<": pc.less,
                  "<=": pc.less_equal, ">": pc.greater,
                  ">=": pc.greater_equal}[expr.op]
            try:
                return fn(arr, scalar)
            except pa.ArrowInvalid:
                # decimal-vs-float style mismatches: compare in float64
                return fn(pc.cast(arr, pa.float64()),
                          pa.scalar(float(expr.value)))
        if isinstance(expr, IsIn):
            arr = arrays[expr.field]
            return pc.is_in(arr, value_set=_value_set(arr,
                                                     expr.values))
        if isinstance(expr, And):
            out = self._eval(expr.args[0], arrays, n)
            for a in expr.args[1:]:
                out = pc.and_kleene(out, self._eval(a, arrays, n))
            return out
        if isinstance(expr, Or):
            out = self._eval(expr.args[0], arrays, n)
            for a in expr.args[1:]:
                out = pc.or_kleene(out, self._eval(a, arrays, n))
            return out
        if isinstance(expr, Not):
            return pc.invert(self._eval(expr.arg, arrays, n))
        raise TypeError(f"cannot evaluate filter node {expr!r}")

    # -- stage-1 decode helper (the reader call sites) ---------------------

    def _stage1_decoder(self, cache: dict, device, active: str):
        """The stage-1 decoder of segment `active` on `device`, from the
        reader's decoder cache (keyed on the projection, so it never
        serves the selected plan)."""
        from ..reader.columnar import decoder_for_segment

        return decoder_for_segment(cache, self.copybook, active, device,
                                   select=self.filter_select)

    def mask_raw(self, cache: dict, device, active: str, image,
                 offsets, lengths: np.ndarray,
                 start_offset: int = 0) -> np.ndarray:
        """Stage 1 straight off a record image on the reader's device
        (`image`: a uint8 tensor; `offsets`: int64 payload offsets into
        it, a device tensor or a host array; `lengths`: host record
        lengths): the pack kernel gathers only the bytes up to the last
        filter field, one fused launch decodes the filter columns, and
        the predicate is evaluated over their Arrow arrays on the host.
        Returns the keep mask."""
        if self.value_expr is None:
            return np.ones(len(lengths), dtype=bool)
        decoder = self._stage1_decoder(cache, device, active)
        batch = decoder.decode_raw(image, offsets, lengths,
                                   start_offset=start_offset)
        return self.eval_batch(batch, active or None)

    def filter_result_generic(self, result, output_schema) -> None:
        """Post-decode fallback for shapes without a static columnar
        plan (hierarchical assemblies, row-backed results): ONE mask
        from the assembled table filters the table and the row view
        consistently. The table materializes eagerly (the kept row
        count must be known); Python rows stay lazy — an Arrow-only
        consumer of a filtered hierarchical read never pays the
        per-row object materialization."""
        if self.segment_values is not None:
            raise ValueError(
                "segment(...) filters are not supported on "
                "hierarchical/row-assembled reads; filter on the "
                "segment id field itself instead")
        table = result.to_arrow(output_schema)
        n = table.num_rows
        if n == 0:
            self.stats.note(scanned=0)
            return
        mask = self.eval_table(table)
        keep = np.nonzero(mask)[0]
        orig_rows = result.rows
        orig_factory = result.rows_factory
        if orig_rows is not None:
            result.rows = [orig_rows[int(i)] for i in keep]
        elif orig_factory is not None:
            def filtered_rows(factory=orig_factory, keep=keep):
                rows = factory()
                return [rows[int(i)] for i in keep]

            result.rows_factory = filtered_rows
        else:
            # segment-backed result that somehow reached the generic
            # path: materialize once, then filter
            rows = result.to_rows()
            result.rows = [rows[int(i)] for i in keep]
        result.n_rows = len(keep)
        result._arrow_cache = table.filter(mask)
        result._arrow_cache_schema = output_schema
        result.arrow_factory = None
        result.segments = []
        self.stats.note(scanned=n, pruned_residual=n - len(keep))


def _resolve_table_column(table, st):
    """The table column (possibly nested in structs) holding statement
    `st`'s values: walk the statement's group path from the outermost
    component that is a top-level column, drilling struct fields. A
    path crossing a list (OCCURS/child segments) or missing entirely
    resolves to None -> the predicate sees nulls. A null parent struct
    yields null values, matching post-hoc nested-field filtering."""
    import pyarrow as pa
    import pyarrow.compute as pc

    parts: List[str] = []
    node = st
    while node is not None:
        parts.append(node.name)
        node = getattr(node, "parent", None)
    parts.reverse()
    top = set(table.schema.names)
    for i, head in enumerate(parts):
        if head not in top:
            continue
        col = table.column(head)
        ok = True
        for nm in parts[i + 1:]:
            t = col.type
            if pa.types.is_struct(t) and t.get_field_index(nm) >= 0:
                col = pc.struct_field(col, nm)
            else:
                ok = False
                break
        if ok:
            return col
    return None


def _literal_for(arr, value):
    """A pyarrow scalar for `value`, coerced toward the column type
    where that is lossless (int/float literals against decimal
    columns; everything else infers)."""
    import decimal
    import pyarrow as pa

    t = arr.type
    if pa.types.is_decimal(t) and isinstance(value, (int, float)):
        return pa.scalar(decimal.Decimal(str(value)))
    return pa.scalar(value)


def _value_set(arr, values):
    import decimal
    import pyarrow as pa

    t = arr.type
    if pa.types.is_decimal(t):
        return pa.array([decimal.Decimal(str(v)) for v in values])
    try:
        return pa.array(list(values), type=t)
    except (pa.ArrowInvalid, pa.ArrowTypeError):
        return pa.array(list(values))
