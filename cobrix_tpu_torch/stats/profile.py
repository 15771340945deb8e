"""The profile data model: per-chunk, per-field scan statistics.

A :class:`FileProfile` describes ONE version of one input file under
ONE decode configuration: an ordered list of :class:`ChunkStats`
covering the file's byte range, each carrying per-field
:class:`FieldStats` (min/max zone maps, null counts, exact sums where
the type allows, a bounded distinct-value sketch for low-cardinality
strings), a segment-id histogram, and a record-length histogram.

Values serialize by the field's declared kind so the JSON round-trip
is lossless: ints and strings natively, Decimals as strings (exact),
floats as floats. A field whose chunk carried NaNs drops its zone map
and sum for that chunk (``min``/``max``/``sum`` = None) — consumers
treat None as "unknown", never as "empty".

Port copy of ``cobrix_tpu.stats.profile``, unchanged: a profile the
port collects serializes to the JAX package's payload value for value.
"""
from __future__ import annotations

from decimal import Decimal
from typing import Dict, List, Optional

# payload layout version: old entries become clean store misses
PROFILE_FORMAT = 1

# distinct-value sketch bound: above this many distinct non-null values
# the sketch overflows to None ("high cardinality, no membership info")
SKETCH_LIMIT = 32

# record-length histogram bound: above this many distinct lengths the
# remainder folds into the "other" bucket (zone maps stay exact)
LENGTH_HISTOGRAM_LIMIT = 64

_NUMERIC_KINDS = ("int", "float", "decimal")
_EXACT_SUM_KINDS = ("int", "decimal")


def _encode_value(kind: str, value):
    if value is None:
        return None
    if kind == "decimal":
        return str(value)
    return value


def _decode_value(kind: str, raw):
    if raw is None:
        return None
    if kind == "decimal":
        return Decimal(raw)
    return raw


class FieldStats:
    """One field's statistics over one chunk's records."""

    __slots__ = ("kind", "min", "max", "null_count", "sum", "distinct")

    def __init__(self, kind: str, min=None, max=None, null_count: int = 0,
                 sum=None, distinct=None):
        self.kind = kind            # int | float | decimal | string | bool
        self.min = min              # None = unknown (all-null or NaN-tainted)
        self.max = max
        self.null_count = int(null_count)
        self.sum = sum              # exact sum; None = unknown/inexact
        # tuple of distinct non-null values, or None (overflowed / not
        # sketched for this kind)
        self.distinct = tuple(distinct) if distinct is not None else None

    def to_row(self) -> list:
        return [
            _encode_value(self.kind, self.min),
            _encode_value(self.kind, self.max),
            self.null_count,
            _encode_value(self.kind, self.sum),
            (list(self.distinct) if self.distinct is not None else None),
        ]

    @classmethod
    def from_row(cls, kind: str, row) -> "FieldStats":
        vmin, vmax, nulls, total, distinct = row
        return cls(kind,
                   min=_decode_value(kind, vmin),
                   max=_decode_value(kind, vmax),
                   null_count=int(nulls),
                   sum=_decode_value(kind, total),
                   distinct=distinct)

    def merge(self, other: "FieldStats") -> "FieldStats":
        """Fold two chunks' stats into one (file-level rollups, drift)."""
        if self.kind != other.kind:
            raise ValueError(
                f"cannot merge field kinds {self.kind!r}/{other.kind!r}")
        # a None zone map means "all null" for the exactly-summable and
        # string kinds (fold skips it), but for floats it can also mean
        # NaN taint — there None must poison the merged map, because the
        # tainted chunk may carry values outside the other side's range
        if self.kind == "float" and (self.min is None
                                     or other.min is None):
            vmin = vmax = None
        else:
            pairs = [(self.min, self.max), (other.min, other.max)]
            known = [(lo, hi) for lo, hi in pairs if lo is not None]
            vmin = min((lo for lo, _ in known), default=None)
            vmax = max((hi for _, hi in known), default=None)
        total = (None if self.sum is None or other.sum is None
                 else self.sum + other.sum)
        if self.distinct is None or other.distinct is None:
            distinct = None
        else:
            merged = tuple(dict.fromkeys(self.distinct + other.distinct))
            distinct = merged if len(merged) <= SKETCH_LIMIT else None
        return FieldStats(self.kind, vmin, vmax,
                          self.null_count + other.null_count, total,
                          distinct)


class ChunkStats:
    """Statistics over one record-aligned byte range of one file."""

    __slots__ = ("offset", "nbytes", "records", "fields", "segments",
                 "lengths")

    def __init__(self, offset: int, nbytes: int, records: int,
                 fields: Dict[str, FieldStats],
                 segments: Optional[Dict[str, int]] = None,
                 lengths: Optional[Dict[int, int]] = None):
        self.offset = int(offset)
        self.nbytes = int(nbytes)
        self.records = int(records)
        self.fields = dict(fields)
        self.segments = dict(segments or {})
        # {record length -> count}; the overflow bucket keys on -1
        self.lengths = dict(lengths or {})

    @property
    def end(self) -> int:
        return self.offset + self.nbytes

    def to_payload(self) -> dict:
        return {
            "offset": self.offset,
            "nbytes": self.nbytes,
            "records": self.records,
            "fields": {name: fs.to_row()
                       for name, fs in sorted(self.fields.items())},
            "segments": dict(sorted(self.segments.items())),
            "lengths": {str(k): v
                        for k, v in sorted(self.lengths.items())},
        }

    @classmethod
    def from_payload(cls, doc: dict,
                     field_kinds: Dict[str, str]) -> "ChunkStats":
        fields = {name: FieldStats.from_row(field_kinds[name], row)
                  for name, row in doc["fields"].items()
                  if name in field_kinds}
        return cls(doc["offset"], doc["nbytes"], doc["records"], fields,
                   {str(k): int(v)
                    for k, v in (doc.get("segments") or {}).items()},
                   {int(k): int(v)
                    for k, v in (doc.get("lengths") or {}).items()})


class FileProfile:
    """The persisted per-file statistics artifact."""

    __slots__ = ("url", "record_kind", "record_size", "total_records",
                 "total_bytes", "field_kinds", "chunks")

    def __init__(self, url: str, record_kind: str, record_size: int,
                 total_records: int, total_bytes: int,
                 field_kinds: Dict[str, str],
                 chunks: List[ChunkStats]):
        self.url = url
        self.record_kind = record_kind      # "fixed" | "vrl"
        self.record_size = int(record_size)  # 0 for vrl
        self.total_records = int(total_records)
        self.total_bytes = int(total_bytes)
        self.field_kinds = dict(field_kinds)
        self.chunks = sorted(chunks, key=lambda c: c.offset)

    def to_payload(self) -> dict:
        return {
            "profile_format": PROFILE_FORMAT,
            "url": self.url,
            "record_kind": self.record_kind,
            "record_size": self.record_size,
            "total_records": self.total_records,
            "total_bytes": self.total_bytes,
            "field_kinds": dict(sorted(self.field_kinds.items())),
            "chunks": [c.to_payload() for c in self.chunks],
        }

    @classmethod
    def from_payload(cls, doc: dict) -> "FileProfile":
        if doc.get("profile_format") != PROFILE_FORMAT:
            raise ValueError("unsupported profile format")
        kinds = {str(k): str(v)
                 for k, v in (doc.get("field_kinds") or {}).items()}
        return cls(doc["url"], doc["record_kind"],
                   doc.get("record_size", 0), doc["total_records"],
                   doc["total_bytes"], kinds,
                   [ChunkStats.from_payload(c, kinds)
                    for c in doc["chunks"]])

    # -- rollups (drift detection, /stats, explain) ---------------------

    def merged_field(self, name: str) -> Optional[FieldStats]:
        """File-level fold of one field's chunk stats; None when no
        chunk carries the field."""
        out: Optional[FieldStats] = None
        for chunk in self.chunks:
            fs = chunk.fields.get(name)
            if fs is None:
                continue
            out = fs if out is None else out.merge(fs)
        return out

    def segment_totals(self) -> Dict[str, int]:
        totals: Dict[str, int] = {}
        for chunk in self.chunks:
            for seg, count in chunk.segments.items():
                totals[seg] = totals.get(seg, 0) + count
        return totals

    def length_totals(self) -> Dict[int, int]:
        totals: Dict[int, int] = {}
        for chunk in self.chunks:
            for length, count in chunk.lengths.items():
                totals[length] = totals.get(length, 0) + count
        return totals

    def summary(self) -> dict:
        """The compact /stats + explain view (no per-chunk detail)."""
        fields = {}
        for name in sorted(self.field_kinds):
            fs = self.merged_field(name)
            if fs is None:
                continue
            row = {"kind": fs.kind, "nulls": fs.null_count}
            if fs.min is not None:
                row["min"] = _encode_value(fs.kind, fs.min)
                row["max"] = _encode_value(fs.kind, fs.max)
            if fs.distinct is not None:
                row["distinct"] = len(fs.distinct)
            fields[name] = row
        out = {
            "url": self.url,
            "record_kind": self.record_kind,
            "chunks": len(self.chunks),
            "records": self.total_records,
            "bytes": self.total_bytes,
            "fields": fields,
        }
        segments = self.segment_totals()
        if segments:
            out["segments"] = dict(sorted(segments.items()))
        return out
