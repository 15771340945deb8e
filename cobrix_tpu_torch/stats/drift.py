"""Ingest drift: successive-generation profile comparison.

The continuous-ingest tailer (streaming/ingest.py) folds every decoded
batch of the LIVE generation into a :class:`GenerationProfile`
(``collect_stats=true``); when the feed rotates, the finished
generation is compared against its predecessor and material shifts
become drift records:

* ``segment_mix``   — L1 distance between normalized segment-id
  distributions above :data:`SEGMENT_MIX_L1`,
* ``null_rate``     — a field's null rate rising by more than
  :data:`NULL_RATE_RISE` (absolute),
* ``out_of_range``  — a field's observed min/max escaping the previous
  generation's envelope,
* ``record_length`` — the average record length shifting by more than
  :data:`RECORD_LENGTH_SHIFT` (relative).

Drift records are observability, not enforcement: they land on the
stream metrics (``cobrix_stats_drift_events_total{kind=...}``), the
stats service registry (the sidecar's ``/stats``), and a JSONL audit
trail under ``<cache_dir>/stats/drift.jsonl`` — the feed itself is
never blocked.

Port copy of ``cobrix_tpu.stats.drift``, unchanged. Its caller, the
continuous-ingest tailer, comes with the port's streaming slice
(ROADMAP A8); until then the comparison is held as a unit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .profile import FieldStats, _encode_value

SEGMENT_MIX_L1 = 0.2
NULL_RATE_RISE = 0.1
RECORD_LENGTH_SHIFT = 0.1


class GenerationProfile:
    """One feed generation's rolled-up statistics, folded batch by
    batch (bounded state: one merged FieldStats per leaf)."""

    def __init__(self, name: str, seg_leaf: str = ""):
        self.name = name
        self.seg_leaf = seg_leaf
        self.records = 0
        self.bytes = 0
        self.fields: Dict[str, FieldStats] = {}
        self.segments: Dict[str, int] = {}

    def fold(self, table, nbytes: int = 0) -> None:
        from .collect import profile_table

        fields, _kinds, segments = profile_table(table, self.seg_leaf)
        self.records += table.num_rows
        self.bytes += int(nbytes)
        for leaf, fs in fields.items():
            prev = self.fields.get(leaf)
            self.fields[leaf] = fs if prev is None else prev.merge(fs)
        for seg, count in segments.items():
            self.segments[seg] = self.segments.get(seg, 0) + count

    def segment_mix(self) -> Dict[str, float]:
        total = sum(self.segments.values())
        if not total:
            return {}
        return {seg: count / total
                for seg, count in self.segments.items()}

    def mean_record_length(self) -> Optional[float]:
        if not self.records or not self.bytes:
            return None
        return self.bytes / self.records

    def summary(self) -> dict:
        out = {"generation": self.name, "records": self.records}
        if self.bytes:
            out["bytes"] = self.bytes
        if self.segments:
            out["segments"] = dict(sorted(self.segments.items()))
        return out


def compare_generations(prev: GenerationProfile,
                        cur: GenerationProfile) -> List[dict]:
    """Material shifts between two finished generations, as drift
    records. Empty generations prove nothing and compare clean."""
    if not prev.records or not cur.records:
        return []
    events: List[dict] = []

    def emit(kind: str, **detail) -> None:
        record = {"kind": kind, "prev_generation": prev.name,
                  "generation": cur.name}
        record.update(detail)
        events.append(record)

    prev_mix, cur_mix = prev.segment_mix(), cur.segment_mix()
    if prev_mix or cur_mix:
        l1 = sum(abs(cur_mix.get(seg, 0.0) - prev_mix.get(seg, 0.0))
                 for seg in set(prev_mix) | set(cur_mix))
        if l1 > SEGMENT_MIX_L1:
            emit("segment_mix", distance=round(l1, 6),
                 prev={k: round(v, 6)
                       for k, v in sorted(prev_mix.items())},
                 cur={k: round(v, 6)
                      for k, v in sorted(cur_mix.items())})

    for leaf in sorted(set(prev.fields) & set(cur.fields)):
        pf, cf = prev.fields[leaf], cur.fields[leaf]
        prev_rate = pf.null_count / prev.records
        cur_rate = cf.null_count / cur.records
        if cur_rate - prev_rate > NULL_RATE_RISE:
            emit("null_rate", field=leaf,
                 prev=round(prev_rate, 6), cur=round(cur_rate, 6))
        if (pf.kind == cf.kind and pf.min is not None
                and cf.min is not None):
            try:
                low = cf.min < pf.min
                high = cf.max > pf.max
            except TypeError:
                continue
            if low or high:
                emit("out_of_range", field=leaf,
                     prev_min=_encode_value(pf.kind, pf.min),
                     prev_max=_encode_value(pf.kind, pf.max),
                     cur_min=_encode_value(cf.kind, cf.min),
                     cur_max=_encode_value(cf.kind, cf.max))

    prev_len, cur_len = prev.mean_record_length(), \
        cur.mean_record_length()
    if prev_len and cur_len:
        shift = abs(cur_len - prev_len) / prev_len
        if shift > RECORD_LENGTH_SHIFT:
            emit("record_length", prev=round(prev_len, 2),
                 cur=round(cur_len, 2), shift=round(shift, 6))
    return events
