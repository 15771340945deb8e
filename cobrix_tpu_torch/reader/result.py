"""Read results: decoded batches carried to the API boundary.

Port copy of ``cobrix_tpu.reader.result``: a `FileResult` holds the
`SegmentBatch`es of one file (each a `DecodedBatch` of host planes plus
the positions, record ids and Seg_Id levels of its rows) and
materializes rows or an Arrow table only when asked for; the pipelined
read's assemble stage builds the table early and caches it
(``_arrow_cache``).

A result carries its part of the read's error ledger (`diagnostics`)
and, under a permissive policy, the reason of each malformed row it kept
(`corrupt_row_reasons`, keyed by row position), which the optional
corrupt-record column (`corrupt_record_field`) gives in rows and
tables.

A FileResult is either columnar (segments of DecodedBatches with record
positions) or row-backed (`rows`: the host row walk of shapes with no
static columnar plan), or lazy (`rows_factory` / `arrow_factory`: a
hierarchical read decoded once, whose rows and table are built only when
asked for, each factory dropped after its first use).

Changes from the JAX package: the decode-once batches' redefine masks
ride only the hierarchical factories, since the port decodes each
active segment of a flat read on its own. `FileResult.to_rows` orders
the rows of its segments by their positions with `_record_order_indices`
(an O(n) scatter) in place of a sort.
`SegLevelColumns.arrow_level` formats the Seg_Id strings with Arrow's
compute kernels in place of ``native.format_seg_id_level``, and returns
the Arrow array.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence

import numpy as np

from ..copybook.datatypes import SchemaRetentionPolicy
from .columnar import DecodedBatch


class SegLevelColumns:
    """Seg_Id0..N level columns (None = level not shown for that row), in
    the JAX package's coded form: per-row root record ids, child counters
    and visibility masks. The per-level object arrays materialize lazily
    (the JAX package's other form, materialized `levels` given to the
    constructor, is not built by the port)."""

    def __init__(self, coded: dict):
        self.coded = coded
        self._levels: Optional[List[np.ndarray]] = None
        self._arrow_root = None  # level 0's Arrow strings, all rows

    @property
    def levels(self) -> List[np.ndarray]:
        if self._levels is None:
            self._levels = self._materialize()
        return self._levels

    def _materialize(self) -> List[np.ndarray]:
        c = self.coded
        root_rid = c["root_rid"]
        prefix = c["prefix"]
        rid_str = root_rid.astype("U20")
        root_u = np.where(root_rid >= 0,
                          np.char.add(np.asarray(prefix, dtype="U"),
                                      rid_str), "")
        levels: List[np.ndarray] = []
        for k in range(c["level_count"]):
            valid = c["valids"][k]
            if k == 0:
                col = root_u.astype(object)
            else:
                cnt_str = c["counters"][k].astype("U20")
                col = np.char.add(np.char.add(root_u, f"_L{k}_"),
                                  cnt_str).astype(object)
            col[~valid] = None
            levels.append(col)
        return levels

    def arrow_level(self, k: int):
        """Level k as an Arrow string array (null where the level is not
        shown), formatted by Arrow's compute kernels (integer to decimal
        text, as Python's str), with no Python string per row."""
        import pyarrow as pa
        import pyarrow.compute as pc

        c = self.coded
        if self._arrow_root is None:
            rid = pa.array(c["root_rid"])
            self._arrow_root = pc.if_else(
                pc.greater_equal(rid, 0),
                pc.binary_join_element_wise(
                    c["prefix"], pc.cast(rid, pa.string()), ""), "")
        text = self._arrow_root
        if k > 0:
            text = pc.binary_join_element_wise(
                text, f"_L{k}_",
                pc.cast(pa.array(c["counters"][k]), pa.string()), "")
        return pc.if_else(pa.array(c["valids"][k]), text,
                          pa.scalar(None, pa.string()))

    def __len__(self) -> int:
        return len(self.coded["root_rid"])

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i: int) -> List[object]:
        return [lvl[i] for lvl in self.levels]

    def __eq__(self, other) -> bool:
        if isinstance(other, SegLevelColumns):
            other = [other[i] for i in range(len(other))]
        return [self[i] for i in range(len(self))] == other

    def take(self, positions: np.ndarray) -> "SegLevelColumns":
        c = self.coded
        return SegLevelColumns(dict(
            c,
            root_rid=c["root_rid"][positions],
            counters=[None if cnt is None else cnt[positions]
                      for cnt in c["counters"]],
            valids=[v[positions] for v in c["valids"]]))


@dataclass
class SegmentBatch:
    """One decoded batch of a file read: the rows of one active segment
    (`active`, None for records of no redefine)."""

    batch: DecodedBatch
    active: Optional[str]                 # active segment redefine, or None
    positions: np.ndarray                 # output position of each row
    record_ids: Optional[np.ndarray]      # Record_Id per row (None: positions)
    # per-row Seg_Id lists, or a SegLevelColumns view
    seg_level_ids: Optional[Sequence[Sequence[object]]] = None


@dataclass
class FileResult:
    """Decoded result of one input file (or one shard of it)."""

    n_rows: int
    file_id: int = 0
    input_file_name: str = ""
    policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL
    generate_record_id: bool = False
    generate_input_file_field: bool = False
    segments: List[SegmentBatch] = dc_field(default_factory=list)
    # the rows of a row-backed result, or the cache of to_rows
    rows: Optional[List[List[object]]] = None
    # records the framer CONSUMED (and numbered) producing this result —
    # >= n_rows when segment filters / level gating drop rows after
    # numbering
    records_framed: Optional[int] = None
    # fault-tolerance surface: the result's error ledger, the name of the
    # optional per-row debug column ('' = none), and the reason per kept
    # malformed row keyed by record POSITION within this result
    diagnostics: Optional[object] = None
    corrupt_record_field: str = ""
    corrupt_row_reasons: Optional[dict] = None
    # lazy producers (hierarchical decode-once reads): rows and Arrow are
    # materialized only when actually asked for; each factory is dropped
    # after first use so the captured decode batch can be released once
    # both products (cached) exist
    rows_factory: Optional[object] = None
    arrow_factory: Optional[object] = None
    # the table the pipelined read's assemble stage (or the arrow
    # factory) built, and the output schema it was built for
    _arrow_cache: Optional[object] = dc_field(default=None, repr=False)
    _arrow_cache_schema: Optional[object] = dc_field(default=None,
                                                     repr=False)
    _corrupt_col_added: bool = dc_field(default=False, repr=False)

    def _append_corrupt_column(self, rows: List[List[object]]) -> None:
        """Trailing debug-column values of row-backed rows (a row walk
        attributes no reason to a row: None each), appended once."""
        if not self.corrupt_record_field or self._corrupt_col_added:
            return
        reasons = self.corrupt_row_reasons or {}
        for p, row in enumerate(rows):
            row.append(reasons.get(p))
        self._corrupt_col_added = True

    def to_rows(self) -> List[List[object]]:
        if self.rows is None and self.rows_factory is not None:
            self.rows = self.rows_factory()
            self.rows_factory = None
        if self.rows is not None:
            self._append_corrupt_column(self.rows)
            return self.rows
        rows: List[List[object]] = []
        order = []
        for seg in self.segments:
            n = len(seg.positions)
            record_ids = (seg.record_ids if seg.record_ids is not None
                          else seg.positions)
            rows.extend(seg.batch.to_rows(
                policy=self.policy,
                generate_record_id=self.generate_record_id,
                file_id=self.file_id,
                record_ids=[int(r) for r in record_ids],
                generate_input_file_field=self.generate_input_file_field,
                input_file_name=self.input_file_name,
                segment_level_ids=seg.seg_level_ids,
                active_segments=[seg.active] * n))
            order.append(np.asarray(seg.positions, dtype=np.int64))
        positions = (np.concatenate(order) if order
                     else np.zeros(0, dtype=np.int64))
        if order:
            take = _record_order_indices(positions)
            rows = [rows[k] for k in take.tolist()]
            positions = positions[take]
        if self.corrupt_record_field:
            # the trailing debug column: the reason of a malformed row
            # kept, None otherwise
            reasons = self.corrupt_row_reasons or {}
            for p, row in zip(positions.tolist(), rows):
                row.append(reasons.get(p))
        self._corrupt_col_added = True
        self.rows = rows
        return self.rows

    def to_arrow(self, output_schema):
        """pyarrow Table in record order: one table per segment batch
        (``arrow_out.segment_table``), concatenated and put in record
        order; a table the assemble stage cached for an equal schema is
        returned as it is. A lazy result builds its table with its arrow
        factory, or from its rows when the factory gives none (a shape
        the columnar assembly does not build); a row-backed result from
        its rows (``arrow_out.rows_to_table``)."""
        import pyarrow as pa

        from .arrow_out import (arrow_schema, cached_table, rows_to_table,
                                segment_table)

        table = cached_table(self, output_schema)
        if table is not None:
            return table
        if not self.segments:
            if self.arrow_factory is not None:
                table = self.arrow_factory(output_schema)
                if table is not None:
                    self._arrow_cache = table
                    self._arrow_cache_schema = output_schema
                    self.arrow_factory = None
                    return table
            if self.rows is None and self.rows_factory is not None:
                self.rows = self.rows_factory()
                self.rows_factory = None
            if self.rows is not None:
                return rows_to_table(self.to_rows(), output_schema.schema)
            return arrow_schema(output_schema.schema).empty_table()
        reasons = (self.corrupt_row_reasons
                   if self.corrupt_record_field else None)
        tables = [segment_table(
            seg.batch, seg.active, output_schema, file_id=self.file_id,
            record_ids=np.asarray(seg.record_ids if seg.record_ids
                                  is not None else seg.positions,
                                  dtype=np.int64),
            seg_level_ids=seg.seg_level_ids,
            input_file_name=self.input_file_name,
            corrupt_reasons=([reasons.get(int(p)) for p in seg.positions]
                             if reasons else None))
            for seg in self.segments]
        table = tables[0] if len(tables) == 1 else pa.concat_tables(tables)
        pos = np.concatenate([np.asarray(seg.positions, dtype=np.int64)
                              for seg in self.segments])
        # batches that tile the positions in ascending order are in
        # record order already: no gather
        if len(pos) == 0 or bool(np.all(np.diff(pos) > 0)):
            return table
        return table.take(_record_order_indices(pos))


def _record_order_indices(pos: np.ndarray) -> np.ndarray:
    """Take-indices that order rows by their (unique) record positions:
    an O(n) scatter instead of an argsort."""
    if not len(pos):
        return pos
    slots = np.full(int(pos.max()) + 1, -1, dtype=np.int64)
    slots[pos] = np.arange(len(pos), dtype=np.int64)
    return slots[slots >= 0]
