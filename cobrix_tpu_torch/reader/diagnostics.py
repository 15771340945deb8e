"""Fault-tolerant read diagnostics: corrupt-record policies + error ledger.

Port copy of ``cobrix_tpu.reader.diagnostics``, whole: the record error
policies (``fail_fast``, ``permissive``, ``drop_malformed``), the
shard-level policy of the pipeline's watchdog, `hex_snapshot`,
`FramingError`, `CorruptRecordInfo`, `ShardFailureInfo` and the per-read
error ledger `ReadDiagnostics` (its deterministic `merged`, `as_dict`,
`to_json` and `from_json` included).

The JAX package's policies:

  * ``fail_fast``      — first malformed record aborts the read (default,
                         reference behavior) with an actionable error
                         (file, offset, hex header snapshot).
  * ``permissive``     — malformed records are kept where decodable
                         (fields past a truncated tail come back null),
                         corrupt byte ranges are skipped via bounded
                         header resynchronization, and every incident is
                         recorded in the read's :class:`ReadDiagnostics`.
  * ``drop_malformed`` — like permissive, but malformed records are
                         dropped from the output entirely.

Added in the port: `framing_error`, the copy of
``cobrix_tpu.native._framing_error``, so that a malformed RDW header
found by the device scan raises the JAX package's exception class,
message, offset and reason (the reasons the ledger records).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import List, Optional


class RecordErrorPolicy(Enum):
    FAIL_FAST = "fail_fast"
    PERMISSIVE = "permissive"
    DROP_MALFORMED = "drop_malformed"

    @classmethod
    def parse(cls, value: "str | RecordErrorPolicy") -> "RecordErrorPolicy":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).strip().lower())
        except ValueError:
            valid = ", ".join(repr(p.value) for p in cls)
            raise ValueError(
                f"Invalid value '{value}' for 'record_error_policy' option. "
                f"Valid policies: {valid}.") from None

    @property
    def is_fail_fast(self) -> bool:
        return self is RecordErrorPolicy.FAIL_FAST

    @property
    def keeps_malformed(self) -> bool:
        return self is RecordErrorPolicy.PERMISSIVE


class ShardErrorPolicy(Enum):
    """What a *shard-level* failure (worker crash, deadline, exhausted
    re-dispatch) does to a distributed scan. Orthogonal to
    :class:`RecordErrorPolicy`, which governs malformed records *within*
    a healthy shard."""

    FAIL_FAST = "fail_fast"
    PARTIAL = "partial"

    @classmethod
    def parse(cls, value: "str | ShardErrorPolicy") -> "ShardErrorPolicy":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).strip().lower())
        except ValueError:
            valid = ", ".join(repr(p.value) for p in cls)
            raise ValueError(
                f"Invalid value '{value}' for 'shard_error_policy' option. "
                f"Valid policies: {valid}.") from None

    @property
    def is_partial(self) -> bool:
        return self is ShardErrorPolicy.PARTIAL


DEFAULT_RESYNC_WINDOW = 64 * 1024
DEFAULT_LEDGER_CAP = 100


def hex_snapshot(header, limit: int = 16) -> str:
    """Hex dump of a header/byte prefix for error messages and ledger
    entries ('00 00 0a 00'); empty input renders as '<empty>'."""
    data = bytes(header[:limit])
    if not data:
        return "<empty>"
    out = " ".join(f"{b:02x}" for b in data)
    return out + (" .." if len(header) > limit else "")


class FramingError(ValueError):
    """A malformed record header/length with structured location info.

    Subclasses ValueError so existing fail-fast callers (and their tests)
    keep working; permissive framers catch it to drive resynchronization.
    """

    def __init__(self, message: str, offset: int = -1, reason: str = "",
                 header: bytes = b"", file_name: str = ""):
        super().__init__(message)
        self.offset = offset
        self.reason = reason or message
        self.header = bytes(header)
        self.file_name = file_name


def framing_error(header: bytes, pos: int, kind: str) -> FramingError:
    """The FramingError of a zero (`kind` "zero") or oversized ("big")
    RDW header: `header` holds the header's bytes, `pos` its file offset.
    Messages keep the reference wording plus a hex header snapshot."""
    header = bytes(header[:4])
    hdr = ",".join(str(b) for b in header)
    if kind == "zero":
        message = (f"RDW headers should never be zero ({hdr}). "
                   f"Found zero size record at {pos} "
                   f"(header bytes: {hex_snapshot(header)}).")
        reason = "zero-length RDW header"
    else:
        message = (f"RDW headers too big at {pos} "
                   f"(header bytes: {hex_snapshot(header)}).")
        reason = "oversized RDW header"
    return FramingError(message, offset=int(pos), reason=reason,
                        header=header)


@dataclass(frozen=True)
class CorruptRecordInfo:
    """One ledger entry: where the corruption was and what was done."""

    file: str
    offset: int            # byte offset of the corrupt region in the file
    length: int            # bytes skipped (0 for kept-but-truncated records)
    reason: str
    header_snapshot: str   # hex dump of the bytes at `offset`
    record_index: Optional[int] = None  # in-shard record position when kept

    def as_dict(self) -> dict:
        return {
            "file": self.file,
            "offset": self.offset,
            "length": self.length,
            "reason": self.reason,
            "header_snapshot": self.header_snapshot,
            "record_index": self.record_index,
        }


@dataclass(frozen=True)
class ShardFailureInfo:
    """One shard the supervised distributed scan could not complete.

    Produced by the shard supervisor (parallel/supervisor.py) and the
    pipeline watchdog (engine/pipeline.py) under
    ``shard_error_policy='partial'`` — the rows of this byte range are
    MISSING from the returned tables, and this entry says which bytes,
    why, and after how many attempts."""

    file: str
    offset_from: int
    offset_to: int         # -1 = to end of file
    record_index: int      # Record_Id seed of the lost shard
    attempts: int          # dispatch attempts consumed (speculation incl.)
    reason: str            # 'crash' | 'timeout' | 'error' | 'scan_deadline'
    error: str = ""        # last error message observed for the shard

    def as_dict(self) -> dict:
        return {
            "file": self.file,
            "offset_from": self.offset_from,
            "offset_to": self.offset_to,
            "record_index": self.record_index,
            "attempts": self.attempts,
            "reason": self.reason,
            "error": self.error,
        }


@dataclass
class ReadDiagnostics:
    """Per-read error ledger: counts always, entries up to `max_entries`."""

    corrupt_records: int = 0    # malformed records kept or dropped
    records_dropped: int = 0    # records excluded by drop_malformed
    bytes_skipped: int = 0      # bytes discarded by resynchronization
    resyncs: int = 0            # successful header resynchronizations
    io_retries: int = 0         # storage reads retried by the IO layer
    shards_failed: int = 0      # shards lost by the distributed scan
    max_entries: int = DEFAULT_LEDGER_CAP
    entries: List[CorruptRecordInfo] = dc_field(default_factory=list)
    shard_failures: List[ShardFailureInfo] = dc_field(default_factory=list)

    @property
    def entries_truncated(self) -> bool:
        return self.corrupt_records > len(self.entries)

    def record(self, info: CorruptRecordInfo, dropped: bool = False) -> None:
        self.corrupt_records += 1
        if dropped:
            self.records_dropped += 1
        if len(self.entries) < self.max_entries:
            self.entries.append(info)

    def record_skip(self, file: str, offset: int, length: int, reason: str,
                    header: bytes = b"") -> None:
        """A corrupt byte range skipped by resynchronization."""
        self.resyncs += 1
        self.bytes_skipped += length
        self.record(CorruptRecordInfo(file, offset, length, reason,
                                      hex_snapshot(header)))

    def record_shard_failure(self, info: ShardFailureInfo) -> None:
        """A shard the distributed scan gave up on (partial policy)."""
        self.shards_failed += 1
        if len(self.shard_failures) < self.max_entries:
            self.shard_failures.append(info)

    def merge(self, other: Optional["ReadDiagnostics"]) -> "ReadDiagnostics":
        if other is None:
            return self
        self.corrupt_records += other.corrupt_records
        self.records_dropped += other.records_dropped
        self.bytes_skipped += other.bytes_skipped
        self.resyncs += other.resyncs
        self.io_retries += other.io_retries
        self.shards_failed += other.shards_failed
        room = self.max_entries - len(self.entries)
        if room > 0:
            self.entries.extend(other.entries[:room])
        room = self.max_entries - len(self.shard_failures)
        if room > 0:
            self.shard_failures.extend(other.shard_failures[:room])
        return self

    @classmethod
    def merged(cls, ledgers, max_entries: int = DEFAULT_LEDGER_CAP
               ) -> "ReadDiagnostics":
        """Deterministic multi-shard merge: counters sum in any order;
        entries from EVERY shard are collected, sorted by
        (file, offset, record_index), then cap-truncated — so the merged
        ledger is identical whether shards were scanned sequentially or
        raced through the pipeline executor, and the entries kept under
        the cap are always the earliest incidents, not the first shards
        to finish."""
        out = cls(max_entries=max_entries)
        entries: List[CorruptRecordInfo] = []
        failures: List[ShardFailureInfo] = []
        for ledger in ledgers:
            if ledger is None:
                continue
            out.corrupt_records += ledger.corrupt_records
            out.records_dropped += ledger.records_dropped
            out.bytes_skipped += ledger.bytes_skipped
            out.resyncs += ledger.resyncs
            out.io_retries += ledger.io_retries
            out.shards_failed += ledger.shards_failed
            entries.extend(ledger.entries)
            failures.extend(ledger.shard_failures)
        entries.sort(key=lambda e: (
            e.file, e.offset,
            -1 if e.record_index is None else e.record_index))
        out.entries = entries[:max_entries]
        failures.sort(key=lambda f: (f.file, f.offset_from))
        out.shard_failures = failures[:max_entries]
        return out

    @property
    def is_clean(self) -> bool:
        return (self.corrupt_records == 0 and self.bytes_skipped == 0
                and self.io_retries == 0 and self.shards_failed == 0)

    def as_dict(self) -> dict:
        return {
            "corrupt_records": self.corrupt_records,
            "records_dropped": self.records_dropped,
            "bytes_skipped": self.bytes_skipped,
            "resyncs": self.resyncs,
            "io_retries": self.io_retries,
            "shards_failed": self.shards_failed,
            "entries_truncated": self.entries_truncated,
            "entries": [e.as_dict() for e in self.entries],
            "shard_failures": [f.as_dict() for f in self.shard_failures],
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: "str | bytes") -> "ReadDiagnostics":
        """Inverse of to_json (worker shards ship their ledgers to the
        parent as schema metadata on the Arrow IPC stream)."""
        d = json.loads(raw)
        diag = cls(corrupt_records=d.get("corrupt_records", 0),
                   records_dropped=d.get("records_dropped", 0),
                   bytes_skipped=d.get("bytes_skipped", 0),
                   resyncs=d.get("resyncs", 0),
                   io_retries=d.get("io_retries", 0),
                   shards_failed=d.get("shards_failed", 0))
        diag.entries = [
            CorruptRecordInfo(
                file=e.get("file", ""), offset=e.get("offset", -1),
                length=e.get("length", 0), reason=e.get("reason", ""),
                header_snapshot=e.get("header_snapshot", ""),
                record_index=e.get("record_index"))
            for e in d.get("entries", [])]
        diag.shard_failures = [
            ShardFailureInfo(
                file=f.get("file", ""),
                offset_from=f.get("offset_from", 0),
                offset_to=f.get("offset_to", -1),
                record_index=f.get("record_index", 0),
                attempts=f.get("attempts", 0),
                reason=f.get("reason", ""), error=f.get("error", ""))
            for f in d.get("shard_failures", [])]
        return diag
