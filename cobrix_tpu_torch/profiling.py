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
  ``.metrics``: the JAX package's, with its compile-cache scope
  (``plan_cache``), I/O counters (``io``), trace spans, field costs,
  roofline and metrics-registry publication (`_publish_registry`,
  `refresh_trace_field_costs`).
- `StageTimes` (each stage timer doubles as a span when a tracer is
  wired), `timed_stage`, `stage` and `PassCounters`: copied as they are.

The host-side scan timeline (trace spans, Chrome-trace export, metrics
registry, live progress) lives in ``cobrix_tpu_torch.obs``; NVTX ranges
stay separate from it: a tracer span is a host span, and a range is
pushed and popped on the same thread by `annotate`.

Changes from the JAX package: `ReadMetrics` names the read's `device`
where the JAX package names its backend, and keeps the port's keys
besides the JAX package's: ``stage_busy`` (the executor's busy times, or
a sequential read's when it is traced or attributed; the JAX package
calls it ``stage_busy_s``) and ``framing`` (a sequential var-len read's
frame / decode split). It has no native-pass counters, which count
passes of a native library the port does not have. PyTorch is a hard
dependency here, so nothing turns into a no-op on an import error.
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
        # optional obs.Tracer: when set, every timed stage also lands on
        # the scan timeline as a span (parent = the thread's current
        # chunk/shard span). None costs one attribute check per stage.
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
    # the device the read decoded on (the JAX package's `backend`)
    device: str = ""
    hosts: int = 1
    # wall seconds of the read's phases (parse_copybook, plan_index,
    # scan), accumulated by `stage`
    timings_s: Dict[str, float] = field(default_factory=dict)
    # per-stage busy times (thread-summed): the pipelined executor's, or
    # a sequential read's when it is traced or attributed; and the
    # executor's shape/overlap report ({workers, chunks, max_inflight,
    # peak_queue, wall_s, busy_s, overlap}); None on untraced
    # sequential reads
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
    # compile-cache activity DURING this read (copybook parse / field-plan
    # / code-page LUT / decoder hits and misses), counted through a
    # per-read CacheStatsScope that every thread working for the read
    # activates (obs.context)
    plan_cache: Optional[dict] = None
    # the read's io counters (`io_stats.as_dict()` plus
    # prefetch_utilization), set by `finalize` when any counted; None
    # when the read touched no io layer
    io: Optional[dict] = None
    # finished obs.Tracer span records when the read traced (trace_file
    # or an explicitly attached tracer); None otherwise
    spans: Optional[list] = None
    # query-pushdown pruning counters (records_scanned/records_pruned
    # by depth, bytes_skipped, selectivity — query/pushdown.
    # PushdownStats.as_dict); None when the read carried no filter
    pushdown: Optional[dict] = None

    def __post_init__(self):
        from .io.stats import IoStats
        from .plan.cache import CacheStatsScope

        self._timings_lock = threading.Lock()
        self.cache_scope = CacheStatsScope()
        # per-read remote-IO counter bag, activated alongside the cache
        # scope on every thread working for this read (obs.context)
        self.io_stats = IoStats()
        # optional obs.Tracer for the read (set by read_cobol when
        # tracing is on); stage() timers double as scan-level spans
        self.tracer = None
        # per-field/kernel-group cost attribution
        # (obs.fieldcost.FieldCostAccumulator) — set by read_cobol when
        # the `field_costs` option (or explain=True) enables it; None
        # keeps every attribution timer site a no-op. Snapshots are
        # taken LIVE (field_costs/as_dict), not frozen at finalize:
        # sequential reads assemble Arrow after the read returns, and
        # the snapshot must include that work like the pipelined path's
        self.field_costs_acc = None
        # root-span args dict + trace destination, kept so lazy
        # post-read assembly can fold its costs back into an already
        # written trace artifact (refresh_trace_field_costs)
        self._trace_root_args = None
        self._trace_file = ""

    def add_timing(self, name: str, seconds: float) -> None:
        """Accumulate wall time for one named phase. Locked: pipelined
        reads hit the same metrics object from multiple stage threads."""
        with self._timings_lock:
            self.timings_s[name] = (self.timings_s.get(name, 0.0)
                                    + seconds)

    def finalize(self, data) -> None:
        """Record the finished read's row count, cache events and io
        counters, close the trace's root span, and publish the read into
        the metrics registry."""
        self.records = len(data)
        self.plan_cache = dict(self.cache_scope.stats)
        if not self.io_stats.is_zero:
            self.io = self.io_stats.as_dict()
            self.io["prefetch_utilization"] = round(
                self.io_stats.prefetch_utilization, 3)
        if self.tracer is not None:
            root_args = {
                "files": self.files, "shards": self.shards,
                "records": self.records, "bytes": self.bytes_read,
                "device": self.device, "hosts": self.hosts}
            fc = self.field_costs
            if fc:
                # the trace artifact carries the cost table too, so
                # `tools/traceview.py --fields` works on a trace file
                # alone, no separate metrics dump needed
                root_args["field_costs"] = fc
            self.tracer.finish_root(args=root_args)
            self._trace_root_args = root_args
            self.spans = list(self.tracer.spans)
        self._publish_registry()
        data.metrics = self

    def refresh_trace_field_costs(self) -> None:
        """Fold the now-complete cost table back into the trace artifact.

        Sequential reads assemble Arrow AFTER finalize wrote the trace,
        so a traced read would otherwise ship a trace whose field_costs
        is missing its assemble plane. Called from `to_arrow` when both
        attribution and `trace_file` were on: the root-span args dict is
        shared by reference with the recorded span, so updating it and
        rewriting (atomic) brings the artifact up to date. No-op for
        untraced / unattributed reads and safely repeatable."""
        if (self.tracer is None or not self._trace_file
                or self._trace_root_args is None):
            return
        fc = self.field_costs
        if not fc:
            return
        self._trace_root_args["field_costs"] = fc
        self.spans = list(self.tracer.spans)
        try:
            self.tracer.write_chrome_trace(self._trace_file)
        except OSError:
            import logging

            logging.getLogger(__name__).warning(
                "failed to refresh trace_file %r with field costs",
                self._trace_file, exc_info=True)

    @property
    def field_costs(self) -> Optional[dict]:
        """Live per-field cost table ({field -> kernel/decode_s/
        assemble_s/bytes/values}); None when attribution is off or
        nothing was attributed yet."""
        acc = self.field_costs_acc
        if acc is None or acc.is_zero:
            return None
        return acc.as_dict()

    def roofline(self) -> Optional[dict]:
        """Achieved scan bytes/s anchored to the calibrated host memory
        bandwidth (obs.roofline); None until both a calibration and a
        finished 'scan' timing exist. Never triggers a calibration."""
        from .obs.roofline import roofline_summary

        scan_s = self.timings_s.get("scan", 0.0)
        return roofline_summary(self.bytes_read, scan_s)

    def _publish_registry(self) -> None:
        """Fold this read into the process-global metrics registry
        (obs.metrics.default_registry): scan/bytes/records totals plus
        the read's cache events, so a Prometheus scrape sees the fleet
        aggregate without touching per-read objects."""
        from .obs.metrics import scan_metrics

        m = scan_metrics()
        m["scans"].inc()
        m["bytes"].inc(self.bytes_read)
        m["records"].inc(self.records)
        for key, count in (self.plan_cache or {}).items():
            if count:
                cache, _, result = key.rpartition("_")
                m["cache"].labels(cache=cache, result=result).inc(count)
        io = self.io or {}
        for plane in ("block", "index", "compress"):
            for result, label in (("hits", "hit"), ("misses", "miss")):
                count = io.get(f"{plane}_{result}", 0)
                if count:
                    m["io_cache"].labels(
                        plane=plane, result=label).inc(count)
            corrupt = io.get(f"{plane}_corrupt", 0)
            if corrupt:
                # detections ride IoStats during a read and reach
                # Prometheus here, exactly once per detection
                m["cache_corruption"].labels(plane=plane).inc(corrupt)
        for result, label in (("issued", "issued"), ("hits", "hit"),
                              ("waits", "wait"), ("unused", "unused")):
            count = io.get(f"prefetch_{result}", 0)
            if count:
                m["prefetch"].labels(result=label).inc(count)
        if io.get("bytes_fetched"):
            m["remote_bytes"].labels(source="backend").inc(
                io["bytes_fetched"])
        if io.get("bytes_from_cache"):
            m["remote_bytes"].labels(source="cache").inc(
                io["bytes_from_cache"])
        if io.get("compressed_bytes_in"):
            m["inflate_bytes"].labels(direction="in").inc(
                io["compressed_bytes_in"])
        if io.get("decompressed_bytes_out"):
            m["inflate_bytes"].labels(direction="out").inc(
                io["decompressed_bytes_out"])
        if io.get("inflate_s"):
            m["inflate_seconds"].inc(io["inflate_s"])
        if io.get("inflate_skipped"):
            m["inflate_skipped"].inc(io["inflate_skipped"])
        pd = self.pushdown or {}
        for depth in ("segment", "filter", "residual"):
            count = pd.get(f"records_pruned_{depth}", 0)
            if count:
                m["records_pruned"].labels(depth=depth).inc(count)
        if pd.get("bytes_skipped"):
            m["bytes_skipped"].inc(pd["bytes_skipped"])
        if pd.get("chunks_skipped"):
            m["chunks_skipped"].inc(pd["chunks_skipped"])
        roof = self.roofline()
        if roof is not None:
            m["roofline"].set(roof["fraction"])

    def as_dict(self) -> dict:
        """The metrics as a dict; "io" only when the read counted any io
        (as in the JAX package, a plain local read has none), "pushdown"
        only when the read carried a filter, "field_costs" only when
        attribution was on, "roofline" only on a calibrated machine,
        "span_count" only when the read traced."""
        out = {
            "files": self.files, "shards": self.shards,
            "records": self.records, "bytes_read": self.bytes_read,
            "device": self.device, "hosts": self.hosts,
            "timings_s": {k: round(v, 6)
                          for k, v in self.timings_s.items()},
            "stage_busy": (self.stage_busy.as_dict()
                           if self.stage_busy is not None else None),
            "pipeline": self.pipeline, "supervision": self.supervision,
            "framing": (self.framing.as_dict()
                        if self.framing is not None else None)}
        if self.plan_cache is not None:
            out["plan_cache"] = self.plan_cache
        if self.io is not None:
            out["io"] = self.io
        if self.pushdown is not None:
            out["pushdown"] = self.pushdown
        fc = self.field_costs
        if fc is not None:
            out["field_costs"] = fc
        roof = self.roofline()
        if roof is not None:
            out["roofline"] = roof
        if self.spans is not None:
            out["span_count"] = len(self.spans)
        return out


class _Stage:
    def __init__(self, metrics: ReadMetrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        # locked accumulation: the pipelined executor runs stages of the
        # same read on multiple threads, and a bare dict read-modify-write
        # here loses increments under that interleaving
        self.metrics.add_timing(self.name, t1 - self._t0)
        tracer = self.metrics.tracer
        if tracer is not None:
            tracer.record_span(self.name, "phase", self._t0, t1)


def stage(metrics: Optional[ReadMetrics], name: str):
    """Accumulating wall-clock timer for one phase of a read."""
    if metrics is None:
        return contextlib.nullcontext()
    return _Stage(metrics, name)
