"""Live scan progress: monotonic `ScanProgress` snapshots pushed to a
user callback while the scan runs.

The pipeline executor and the multihost supervisor report chunk/shard
completions into one `ProgressTracker`; the tracker throttles callback
invocations (`min_interval_s`) and guarantees the done counters never
decrease — a progress bar driven from these snapshots can only move
forward. Callback exceptions are swallowed after the first (a broken
progress bar must never kill a scan).

Port copy of ``cobrix_tpu.obs.progress``, unchanged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class ScanProgress:
    """One monotonic snapshot handed to `progress_callback`."""

    bytes_total: int = 0
    bytes_done: int = 0
    records_done: int = 0
    chunks_total: int = 0
    chunks_done: int = 0
    chunks_failed: int = 0
    chunks_inflight: int = 0
    elapsed_s: float = 0.0
    # byte-rate ETA over what's left; None until enough bytes have moved
    eta_s: Optional[float] = None
    # per-stage busy seconds so far (read/frame/decode/assemble)
    stage_busy_s: Dict[str, float] = field(default_factory=dict)
    done: bool = False
    # continuous-ingest follow streams only: stable source bytes not
    # yet delivered (None on ordinary bounded scans)
    lag_bytes: Optional[int] = None

    @property
    def fraction(self) -> Optional[float]:
        if self.bytes_total > 0:
            return min(1.0, self.bytes_done / self.bytes_total)
        if self.chunks_total > 0:
            return min(1.0, (self.chunks_done + self.chunks_failed)
                       / self.chunks_total)
        return None

    def as_dict(self) -> dict:
        """JSON-safe form — the wire shape of a serving-tier progress
        frame (serve/protocol.py); `from_dict` round-trips it."""
        return {
            "bytes_total": self.bytes_total,
            "bytes_done": self.bytes_done,
            "records_done": self.records_done,
            "chunks_total": self.chunks_total,
            "chunks_done": self.chunks_done,
            "chunks_failed": self.chunks_failed,
            "chunks_inflight": self.chunks_inflight,
            "elapsed_s": self.elapsed_s,
            "eta_s": self.eta_s,
            "stage_busy_s": dict(self.stage_busy_s),
            "done": self.done,
            "lag_bytes": self.lag_bytes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScanProgress":
        """Rebuild a snapshot from `as_dict()` output. Unknown keys from
        a newer server are dropped so mixed client/server versions keep
        rendering progress instead of raising."""
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


class ProgressTracker:
    """Thread-safe accumulation + throttled callback dispatch.

    The executor/supervisor call `chunk_started` / `chunk_done` /
    `chunk_failed` from their own threads; `finish` fires one final
    snapshot with `done=True` regardless of throttling."""

    def __init__(self, callback: Callable[[ScanProgress], None],
                 bytes_total: int = 0, chunks_total: int = 0,
                 min_interval_s: float = 0.5, stage_times=None):
        self.callback = callback
        self.bytes_total = int(bytes_total)
        self.chunks_total = int(chunks_total)
        self.min_interval_s = max(0.0, float(min_interval_s))
        self.stage_times = stage_times
        self._lock = threading.Lock()
        # serializes callback delivery and orders it against finish():
        # a thread that passed the _finished check re-checks under this
        # lock, so no done=False snapshot can land AFTER the final
        # done=True one. Separate from _lock so a callback may call
        # snapshot() without deadlocking.
        self._emit_lock = threading.Lock()
        self._t0 = time.monotonic()
        self._last_emit = 0.0
        self._bytes_done = 0
        self._records_done = 0
        self._chunks_done = 0
        self._chunks_failed = 0
        self._inflight = 0
        self._warned = False
        self._finished = False

    def set_plan(self, bytes_total: Optional[int] = None,
                 chunks_total: Optional[int] = None) -> None:
        """Late plan info (chunk counts are known only after planning)."""
        with self._lock:
            if bytes_total is not None:
                self.bytes_total = max(self.bytes_total, int(bytes_total))
            if chunks_total is not None:
                self.chunks_total = max(self.chunks_total,
                                        int(chunks_total))

    def chunk_started(self) -> None:
        with self._lock:
            self._inflight += 1

    def chunk_done(self, bytes_done: int = 0, records: int = 0) -> None:
        with self._lock:
            self._bytes_done += max(0, int(bytes_done))
            self._records_done += max(0, int(records))
            self._chunks_done += 1
            self._inflight = max(0, self._inflight - 1)
        self._maybe_emit()

    def chunk_failed(self) -> None:
        with self._lock:
            self._chunks_failed += 1
            self._inflight = max(0, self._inflight - 1)
        self._maybe_emit()

    def add_records(self, records: int) -> None:
        """Late record counts (multihost rows are only countable at
        reassembly)."""
        with self._lock:
            self._records_done += max(0, int(records))

    def snapshot(self, done: bool = False) -> ScanProgress:
        with self._lock:
            elapsed = time.monotonic() - self._t0
            eta = None
            if (not done and self.bytes_total > 0 and self._bytes_done > 0
                    and elapsed > 0):
                rate = self._bytes_done / elapsed
                remaining = max(0, self.bytes_total - self._bytes_done)
                eta = remaining / rate if rate > 0 else None
            return ScanProgress(
                bytes_total=self.bytes_total,
                bytes_done=self._bytes_done,
                records_done=self._records_done,
                chunks_total=self.chunks_total,
                chunks_done=self._chunks_done,
                chunks_failed=self._chunks_failed,
                chunks_inflight=self._inflight,
                elapsed_s=round(elapsed, 6),
                eta_s=round(eta, 3) if eta is not None else None,
                stage_busy_s=(self.stage_times.as_dict()
                              if self.stage_times is not None else {}),
                done=done)

    def _maybe_emit(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._finished:
                return
            if now - self._last_emit < self.min_interval_s:
                return
            self._last_emit = now
        with self._emit_lock:
            if self._finished:
                # finish() won the race and already delivered the final
                # done=True snapshot — stay silent
                return
            self._emit(self.snapshot(done=False))

    def _emit(self, progress: ScanProgress) -> None:
        try:
            self.callback(progress)
        except Exception:
            if not self._warned:
                self._warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "progress_callback raised; further errors suppressed",
                    exc_info=True)

    def finish(self, records_total: Optional[int] = None) -> None:
        """Final snapshot (`done=True`), bypassing the throttle. Fires
        exactly once, strictly after any in-flight done=False delivery."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            if records_total is not None:
                self._records_done = max(self._records_done,
                                         int(records_total))
            self._inflight = 0
        with self._emit_lock:
            self._emit(self.snapshot(done=True))
