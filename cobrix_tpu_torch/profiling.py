"""Profiling hooks: torch.profiler traces, NVTX ranges, read metrics.

Port of ``cobrix_tpu.profiling``:

- `profile_trace(dir)`: a context manager wrapping any read or decode in
  a ``torch.profiler`` session over the CPU and, when the device is
  there, CUDA; on exit it writes a Chrome trace JSON into `dir` (the
  kernels, copies and their streams on the device timeline). The JAX
  package's ``jax.profiler.trace`` writes a TensorBoard artifact.
- `annotate(name, device)`: a named span (``record_function``) on the
  profiler timeline, plus an NVTX range when `device` is a CUDA device.
- `ReadMetrics`: per-read counters attached to every CobolData as
  ``.metrics``.
- `StageTimes`, `timed_stage` and `PassCounters`: copied as they are.

Changes from the JAX package: `ReadMetrics` is reduced to files,
shards, records, bytes, the stage busy times, the executor's report,
the supervision counters and the read's I/O counters (`io_stats`, an
``io.stats.IoStats``, published on ``as_dict()["io"]`` with the JAX
package's keys by `finalize`). Its compile-cache scope, trace spans,
pushdown counters, field costs, roofline and metrics registry wait for
the observability slice (ROADMAP A8), as does the
tracer hook of `StageTimes`, which is kept as a plain attribute.
PyTorch is a hard dependency here, so nothing turns into a no-op on an
import error.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(output_dir: str):
    """Capture a torch.profiler trace of everything inside the block and
    write it to ``output_dir/trace.json`` (Chrome trace format). CUDA
    activity is traced when a CUDA device is available. Yields the
    profiler, whose events can be read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(output_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(output_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str, device: Optional[torch.device] = None):
    """Named span on the profiler timeline (``record_function``; cheap
    when no profiler runs), and an NVTX range when `device` is CUDA."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimes:
    """Per-stage busy-time accumulator shared by pipeline worker threads.

    `busy_s[stage]` is the SUM of time any thread spent inside that stage
    (read / frame / decode / assemble), so with N-way overlap the busy
    total exceeds the pipeline wall time — the ratio is the overlap
    factor reported in ReadMetrics. A plain dict read-modify-write races
    across threads; the lock makes each accumulation atomic."""

    __slots__ = ("_lock", "busy_s", "tracer")

    def __init__(self, tracer=None):
        self._lock = threading.Lock()
        self.busy_s: Dict[str, float] = {}
        # the JAX package's scan-timeline tracer hook; the port has no
        # tracer yet (ROADMAP A8), so it stays None
        self.tracer = tracer

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.busy_s[name] = self.busy_s.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.add(name, t1 - t0)
            if self.tracer is not None:
                self.tracer.record_span(name, "stage", t0, t1)

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return {k: round(v, 6) for k, v in self.busy_s.items()}


def timed_stage(stage_times: Optional[StageTimes], name: str):
    """`stage_times.timed(name)` or a no-op when no accumulator is wired
    (sequential reads pass None through the reader hot paths)."""
    if stage_times is None:
        return contextlib.nullcontext()
    return stage_times.timed(name)


class PassCounters:
    """Thread-safe named counters for pass accounting: each increment
    records that one pass actually ran."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


@dataclass
class ReadMetrics:
    """Structured per-read metrics."""

    files: int = 0
    shards: int = 0
    records: int = 0
    bytes_read: int = 0
    # pipelined execution: per-stage busy times (thread-summed) and the
    # executor's shape/overlap report ({workers, chunks, max_inflight,
    # peak_queue, wall_s, busy_s, overlap}); None on sequential reads
    stage_busy: Optional[StageTimes] = None
    pipeline: Optional[dict] = None
    # pipeline watchdog events (re-queued, failed and timed-out chunks,
    # respawned workers); None when the read ran unsupervised
    supervision: Optional[dict] = None
    # a sequential variable-length read's split: seconds spent framing
    # (the host walk of a generic framing; the window reads and scans of
    # an RDW file) and decoding ({"frame": s, "decode": s}); None on
    # other reads
    framing: Optional[StageTimes] = None
    # the read's io counters (`io_stats.as_dict()` plus
    # prefetch_utilization), set by `finalize` when any counted; None
    # when the read touched no io layer
    io: Optional[dict] = None

    def __post_init__(self):
        from .io.stats import IoStats

        # per-read remote-IO counter bag, active on every thread working
        # for this read (io.stats.activate / carry)
        self.io_stats = IoStats()

    def finalize(self, data) -> None:
        """Record the finished read's row count and publish its io
        counters."""
        self.records = len(data)
        if not self.io_stats.is_zero:
            self.io = self.io_stats.as_dict()
            self.io["prefetch_utilization"] = round(
                self.io_stats.prefetch_utilization, 3)

    def as_dict(self) -> dict:
        """The metrics as a dict; "io" only when the read counted any io
        (as in the JAX package, a plain local read has none)."""
        out = {
            "files": self.files, "shards": self.shards,
            "records": self.records, "bytes_read": self.bytes_read,
            "stage_busy": (self.stage_busy.as_dict()
                           if self.stage_busy is not None else None),
            "pipeline": self.pipeline, "supervision": self.supervision,
            "framing": (self.framing.as_dict()
                        if self.framing is not None else None)}
        if self.io is not None:
            out["io"] = self.io
        return out
