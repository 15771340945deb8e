"""Durable ingestion checkpoints: the exactly-once watermark store.

Port copy of ``cobrix_tpu.streaming.checkpoint`` over the port's
``io.integrity`` and ``utils.atomic``. The payload (`_FORMAT` and the
fields of `StreamCheckpoint.to_payload`) is the JAX package's, with no
package tag: a checkpoint holds source watermarks, the file order, the
consumer's ``app_state`` and the indexers' state, nothing that depends
on the package that wrote it, so a checkpoint directory written by
either package resumes in the other.

One `CheckpointStore` owns the recovery state of one continuous-ingest
stream: per-source watermarks (byte offset, record count, generation,
content fingerprint), the stream-wide delivery count, the consumer's
opaque ``app_state``, and the incremental-indexer state. The contract:

* **atomic + durable** — every commit is a temp+rename+fsync write
  (`utils.atomic.write_atomic`): a SIGKILL at ANY instant leaves either
  the previous complete checkpoint or the new one, never a torn file;
* **self-verifying, self-healing** — payloads carry a CRC-32 over their
  canonical JSON (`io.integrity.stamp_json_payload`) and TWO slots
  (``.a`` / ``.b``) alternate, so a checkpoint corrupted on disk (bit
  flip, torn tail, garbage) is quarantined, counted on
  ``cobrix_cache_corruption_total{plane="checkpoint"}``, and recovery
  falls back to the other slot's older-but-valid watermark — re-driving
  a few batches (which the ack protocol de-duplicates) instead of
  either crashing or silently trusting wrong offsets;
* **exactly-once with the consumer's help** — `commit(..., app_state=)`
  persists an opaque consumer token atomically WITH the watermark. A
  consumer that records its output position in ``app_state`` and
  truncates its output back to it on restart gets end-to-end
  exactly-once across arbitrary kill points (see the README's
  "Continuous ingestion" section for the recipe;
  ``python -m cobrix_tpu_torch.testing.streamcheck`` is the executable
  proof).

The store is a directory, safe to place on the same volume as the data
or a cache dir; `verify_checkpoint_file` checks one slot offline.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..io.integrity import (
    note_corruption,
    quarantine,
    stamp_json_payload,
    verify_json_payload,
)
from ..utils.atomic import write_atomic

# bump when the payload layout changes: old checkpoints are refused
# (a format change must restart the stream explicitly, never misread
# offsets)
_FORMAT = 1

CHECKPOINT_SUFFIX = ".ckpt"


@dataclass
class StreamCheckpoint:
    """One committed recovery point (the JSON payload, typed)."""

    seq: int = 0                      # monotonic commit counter
    delivered_records: int = 0        # records acked across the stream
    delivered_batches: int = 0
    # per-source watermarks (sources.SourceState.to_dict payloads),
    # keyed by source path
    sources: Dict[str, dict] = field(default_factory=dict)
    # file_id assignment order: position = file_id (stable across
    # restarts so Record_Id bases never shift)
    order: List[str] = field(default_factory=list)
    # opaque consumer state committed atomically with the watermark
    app_state: object = None
    # incremental sparse-index state per source path
    # (reader.index.IncrementalIndexer.state_dict payloads)
    indexers: Dict[str, dict] = field(default_factory=dict)
    errors_total: int = 0             # cumulative ledgered record errors
    updated_unix: float = 0.0

    def to_payload(self) -> dict:
        return {
            "format": _FORMAT,
            "seq": self.seq,
            "delivered_records": self.delivered_records,
            "delivered_batches": self.delivered_batches,
            "sources": self.sources,
            "order": self.order,
            "app_state": self.app_state,
            "indexers": self.indexers,
            "errors_total": self.errors_total,
            "updated_unix": self.updated_unix,
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "StreamCheckpoint":
        return cls(
            seq=int(payload.get("seq", 0)),
            delivered_records=int(payload.get("delivered_records", 0)),
            delivered_batches=int(payload.get("delivered_batches", 0)),
            sources=dict(payload.get("sources") or {}),
            order=[str(p) for p in (payload.get("order") or [])],
            app_state=payload.get("app_state"),
            indexers=dict(payload.get("indexers") or {}),
            errors_total=int(payload.get("errors_total", 0)),
            updated_unix=float(payload.get("updated_unix", 0.0)),
        )


class CheckpointStore:
    """Two-slot checkpoint persistence for one ingest stream.

    ``stream_id`` namespaces several streams sharing one directory.
    `load()` returns the newest VALID checkpoint (corrupt slots are
    quarantined + counted, the other slot answers); `commit()` writes
    the next checkpoint into the slot NOT holding the latest valid one,
    so a crash mid-write can never destroy the only good recovery
    point."""

    def __init__(self, checkpoint_dir: str, stream_id: str = "stream"):
        if not checkpoint_dir:
            raise ValueError("checkpoint_dir must be a directory path")
        self.root = checkpoint_dir
        self.stream_id = stream_id
        os.makedirs(self.root, exist_ok=True)
        self.quarantine_root = os.path.join(self.root, "quarantine")
        self._last_seq = -1
        self._last_slot: Optional[str] = None

    def slot_paths(self) -> List[str]:
        return [os.path.join(
            self.root, f"{self.stream_id}.{slot}{CHECKPOINT_SUFFIX}")
            for slot in ("a", "b")]

    def _read_slot(self, path: str) -> Optional[StreamCheckpoint]:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            payload = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self._corrupt(path, "undecodable JSON checkpoint")
            return None
        if not isinstance(payload, dict) \
                or payload.get("format") != _FORMAT:
            # an older/newer format is refused, loudly distinct from
            # corruption: offsets written under other layout rules must
            # not be trusted, and must not LOOK like disk damage
            return None
        if not verify_json_payload(payload):
            self._corrupt(path, "checkpoint checksum mismatch")
            return None
        try:
            return StreamCheckpoint.from_payload(payload)
        except (TypeError, ValueError):
            self._corrupt(path, "checkpoint fields failed to deserialize")
            return None

    def _corrupt(self, path: str, detail: str) -> None:
        quarantine(path, self.quarantine_root)
        note_corruption("checkpoint", path, detail)

    def load(self) -> Optional[StreamCheckpoint]:
        """The newest valid checkpoint, or None (fresh stream — or both
        slots corrupt, which restarts from zero: with the app_state ack
        protocol that is still exactly-once, just a full re-drive)."""
        best = None
        best_path = None
        for path in self.slot_paths():
            ckpt = self._read_slot(path)
            if ckpt is not None and (best is None or ckpt.seq > best.seq):
                best, best_path = ckpt, path
        if best is not None:
            self._last_seq = best.seq
            self._last_slot = best_path
        return best

    def commit(self, checkpoint: StreamCheckpoint) -> None:
        """Persist `checkpoint` durably (fsync) into the non-latest
        slot. Assigns the next seq; raises OSError on write failure —
        a checkpoint that cannot be made durable must NOT be treated as
        acked (unlike cache planes, this state is correctness, so it
        does not degrade silently)."""
        checkpoint.seq = max(self._last_seq, checkpoint.seq) + 1
        checkpoint.updated_unix = time.time()
        paths = self.slot_paths()
        target = paths[checkpoint.seq % 2]
        if target == self._last_slot:
            target = paths[(checkpoint.seq + 1) % 2]
        payload = stamp_json_payload(checkpoint.to_payload())
        write_atomic(target, json.dumps(payload), fsync=True)
        self._last_seq = checkpoint.seq
        self._last_slot = target


def checkpoint_files(root: str) -> List[str]:
    """Every checkpoint slot file under `root` (offline fsck surface)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in sorted(names):
        if name.endswith(CHECKPOINT_SUFFIX):
            out.append(os.path.join(root, name))
    return out


def verify_checkpoint_file(path: str) -> Optional[str]:
    """None when `path` holds a structurally valid checkpoint; else a
    human-readable defect description (the offline check)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        return f"unreadable: {exc}"
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return "undecodable JSON"
    if not isinstance(payload, dict):
        return "payload is not an object"
    if payload.get("format") != _FORMAT:
        return None  # foreign format: not corruption
    if not verify_json_payload(payload):
        return "checksum mismatch"
    return None
