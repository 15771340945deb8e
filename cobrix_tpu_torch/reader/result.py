"""Read results: decoded batches carried to the API boundary.

Port copy of ``cobrix_tpu.reader.result`` for rows and dicts: a
`FileResult` holds the `SegmentBatch`es of one file (each a
`DecodedBatch` of host planes plus the positions, record ids and Seg_Id
levels of its rows) and materializes rows only when asked for.

Changes from the JAX package: there is no Arrow output (ROADMAP A2), so
`SegLevelColumns.arrow_level` and `FileResult.to_arrow` are not carried
over, nor are the row-backed, lazy-factory, input-file-name,
corrupt-record and diagnostics fields, whose options the port refuses;
`FileResult.to_rows` orders the rows of its segments by their positions
with `_record_order_indices` (an O(n) scatter) in place of a sort.
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
    """Decoded result of one input file."""

    n_rows: int
    file_id: int = 0
    policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL
    generate_record_id: bool = False
    segments: List[SegmentBatch] = dc_field(default_factory=list)
    rows: Optional[List[List[object]]] = None   # cache of to_rows
    # records the framer CONSUMED (and numbered) producing this result —
    # >= n_rows when segment filters / level gating drop rows after
    # numbering
    records_framed: Optional[int] = None

    def to_rows(self) -> List[List[object]]:
        if self.rows is not None:
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
                segment_level_ids=seg.seg_level_ids,
                active_segments=[seg.active] * n))
            order.append(np.asarray(seg.positions, dtype=np.int64))
        if order:
            take = _record_order_indices(np.concatenate(order))
            rows = [rows[k] for k in take.tolist()]
        self.rows = rows
        return self.rows


def _record_order_indices(pos: np.ndarray) -> np.ndarray:
    """Take-indices that order rows by their (unique) record positions:
    an O(n) scatter instead of an argsort."""
    if not len(pos):
        return pos
    slots = np.full(int(pos.max()) + 1, -1, dtype=np.int64)
    slots[pos] = np.arange(len(pos), dtype=np.int64)
    return slots[slots >= 0]
