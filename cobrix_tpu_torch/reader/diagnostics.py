"""Structured framing errors.

Port copy of ``cobrix_tpu.reader.diagnostics``, reduced to `hex_snapshot`
and `FramingError`, plus `framing_error`, the copy of
``cobrix_tpu.native._framing_error``: a malformed RDW header raises the
same exception class, message, offset and reason as the JAX package; and the shard-level policy of the pipeline's watchdog,
`ShardErrorPolicy` and `ShardFailureInfo`, copied as they are; and
`read_diagnostics_json`, the JSON that the JAX package's
``ReadDiagnostics.to_json`` gives for a read whose only incidents are
the shards it lost, which ``CobolData.to_arrow`` stamps on the table's
schema. The port reads malformed records under the fail-fast policy
only, so the error ledger, the corrupt-record entries and the record
error policies are not carried over.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from enum import Enum
from typing import Sequence

# entries a ledger keeps (the JAX package's DEFAULT_LEDGER_CAP)
DEFAULT_LEDGER_CAP = 100


class ShardErrorPolicy(Enum):
    """What a *shard-level* failure (worker crash, deadline, exhausted
    re-dispatch) does to a pipelined scan."""

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


def hex_snapshot(header, limit: int = 16) -> str:
    """Hex dump of a header/byte prefix for error messages
    ('00 00 0a 00'); empty input renders as '<empty>'."""
    data = bytes(header[:limit])
    if not data:
        return "<empty>"
    out = " ".join(f"{b:02x}" for b in data)
    return out + (" .." if len(header) > limit else "")


class FramingError(ValueError):
    """A malformed record header/length with structured location info.

    Subclasses ValueError, as the JAX package's does, so fail-fast callers
    that catch ValueError keep working.
    """

    def __init__(self, message: str, offset: int = -1, reason: str = "",
                 header: bytes = b""):
        super().__init__(message)
        self.offset = offset
        self.reason = reason or message
        self.header = bytes(header)


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
class ShardFailureInfo:
    """One shard the supervised scan could not complete.

    Produced by the pipeline watchdog (engine/pipeline.py) under
    ``shard_error_policy='partial'`` — the rows of this byte range are
    MISSING from the result, and this entry says which bytes, why, and
    after how many attempts."""

    file: str
    offset_from: int
    offset_to: int         # -1 = to end of file
    record_index: int      # Record_Id seed of the lost shard
    attempts: int          # dispatch attempts consumed
    reason: str            # 'error' | 'timeout' | 'scan_deadline'
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


def read_diagnostics_json(shard_failures: Sequence[ShardFailureInfo],
                          max_entries: int = DEFAULT_LEDGER_CAP) -> str:
    """``ReadDiagnostics.to_json`` of a read that lost `shard_failures`
    and had no other incident, key for key."""
    return json.dumps({
        "corrupt_records": 0,
        "records_dropped": 0,
        "bytes_skipped": 0,
        "resyncs": 0,
        "io_retries": 0,
        "shards_failed": len(shard_failures),
        "entries_truncated": False,
        "entries": [],
        "shard_failures": [f.as_dict()
                           for f in shard_failures[:max_entries]],
    }, separators=(",", ":"))
