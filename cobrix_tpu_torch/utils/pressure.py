"""Process-wide memory-pressure watermark: degrade, then shed.

An overloaded scan server has exactly one unrecoverable failure mode:
the kernel OOM-killer, which takes every tenant's in-flight scan down
at once. This module turns that cliff into two graceful steps, keyed on
the process RSS against a configurable budget:

* **DEGRADED** (RSS >= ``degrade_fraction`` of budget) — consumers of
  memory-shaped knobs shrink themselves: the pipeline executor halves
  its in-flight chunk window, the serving session halves
  ``prefetch_blocks``. Scans get slower, none fail.
* **SHED** (RSS >= ``shed_fraction``) — the serving tier stops taking
  on new work: queued scans are rejected lowest-weight-first with a
  structured ``overloaded`` reason (no SLO burn — admission doing its
  job is not the scan plane failing), and new requests are refused
  until the level drops. Running scans keep running; healthy tenants'
  admitted work completes.

One monitor per process (`set_process_budget` installs it; the serve
CLI's ``--memory-budget-mb`` is the usual writer), consulted from the
engine's reader loop and the admission path through `current_level()` —
a cached /proc read re-probed at most every `interval_s`, so the hot
path cost is a monotonic-clock compare. No budget configured = always
OK: the default is exactly today's behavior.

`rss_fn` is injectable so the shed/degrade behaviors are testable with
a deterministic fake RSS instead of allocating real gigabytes.

Port copy of ``cobrix_tpu.utils.pressure``, unchanged. The port's
pipeline executor (engine/pipeline.py) reads it in its reader loop; the
serving tier that sheds waits for ROADMAP A8. The RSS is the host
process's: pinned staging buffers count, device memory does not.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

LEVEL_OK = 0
LEVEL_DEGRADED = 1
LEVEL_SHED = 2

_LEVEL_NAMES = {LEVEL_OK: "ok", LEVEL_DEGRADED: "degraded",
                LEVEL_SHED: "shed"}


def _default_rss() -> Optional[int]:
    from ..obs.metrics import _rss_bytes

    return _rss_bytes()


class MemoryPressure:
    """Watermark evaluation over a cached RSS probe."""

    def __init__(self, budget_bytes: int,
                 degrade_fraction: float = 0.75,
                 shed_fraction: float = 0.9,
                 interval_s: float = 0.25,
                 rss_fn: Optional[Callable[[], Optional[int]]] = None):
        if budget_bytes <= 0:
            raise ValueError("memory budget must be positive")
        if not 0.0 < degrade_fraction <= shed_fraction <= 1.5:
            raise ValueError(
                "want 0 < degrade_fraction <= shed_fraction")
        self.budget_bytes = int(budget_bytes)
        self.degrade_fraction = float(degrade_fraction)
        self.shed_fraction = float(shed_fraction)
        self.interval_s = max(0.0, float(interval_s))
        self._rss_fn = rss_fn or _default_rss
        self._lock = threading.Lock()
        self._cached_level = LEVEL_OK
        self._cached_rss: Optional[int] = None
        self._probed_at = 0.0

    def level(self) -> int:
        """The current pressure level, re-probing RSS at most once per
        `interval_s` (thread-safe; stale-by-a-tick is fine — pressure
        is a trend, not an edge)."""
        now = time.monotonic()
        with self._lock:
            if (self._probed_at
                    and now - self._probed_at < self.interval_s):
                return self._cached_level
            self._probed_at = now
        rss = self._rss_fn()
        level = LEVEL_OK
        if rss is not None:
            if rss >= self.budget_bytes * self.shed_fraction:
                level = LEVEL_SHED
            elif rss >= self.budget_bytes * self.degrade_fraction:
                level = LEVEL_DEGRADED
        with self._lock:
            self._cached_level = level
            self._cached_rss = rss
        return level

    def snapshot(self) -> dict:
        level = self.level()
        with self._lock:
            rss = self._cached_rss
        return {
            "level": _LEVEL_NAMES[level],
            "rss_bytes": rss,
            "budget_bytes": self.budget_bytes,
            "degrade_at_bytes": int(self.budget_bytes
                                    * self.degrade_fraction),
            "shed_at_bytes": int(self.budget_bytes
                                 * self.shed_fraction),
        }


_MONITOR_LOCK = threading.Lock()
_MONITOR: Optional[MemoryPressure] = None


def set_process_budget(budget_bytes: int,
                       degrade_fraction: float = 0.75,
                       shed_fraction: float = 0.9,
                       interval_s: float = 0.25,
                       rss_fn: Optional[Callable] = None
                       ) -> Optional[MemoryPressure]:
    """Install (or with ``budget_bytes=0`` remove) the process-wide
    monitor; returns it. The serving CLI calls this from
    ``--memory-budget-mb``; embedders may call it directly."""
    global _MONITOR
    with _MONITOR_LOCK:
        if budget_bytes <= 0:
            _MONITOR = None
        else:
            _MONITOR = MemoryPressure(
                budget_bytes, degrade_fraction=degrade_fraction,
                shed_fraction=shed_fraction, interval_s=interval_s,
                rss_fn=rss_fn)
        return _MONITOR


def process_pressure() -> Optional[MemoryPressure]:
    """The installed monitor, or None (no budget configured)."""
    with _MONITOR_LOCK:
        return _MONITOR


def current_level() -> int:
    """The process pressure level; LEVEL_OK when no budget is set.
    The cheap always-callable form hot loops use."""
    monitor = process_pressure()
    return LEVEL_OK if monitor is None else monitor.level()


def level_name(level: int) -> str:
    return _LEVEL_NAMES.get(level, "ok")
