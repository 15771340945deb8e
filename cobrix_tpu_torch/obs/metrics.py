"""Metrics registry with Prometheus text exposition.

Counters, gauges, and histograms covering the scan plane: bytes and
records scanned, chunk latency quantiles, backpressure queue depth
samples, record-length distribution, compile-cache hits, and supervision
events. One process-global default registry feeds a standard
Prometheus text exposition (`prometheus_text()`), so an operator can
serve it from any HTTP handler; per-read deltas stay on
`ReadMetrics.as_dict()` as before.

Design constraints: no external client library (the container pins
dependencies), thread-safe under one registry lock (metric updates are
per-chunk / per-read, never per-record — the only per-record data, the
record-length histogram, is batch-observed from numpy arrays), and
labels kept to the counter type where the scan actually needs them
(supervision/cache events by name).

Port copy of ``cobrix_tpu.obs.metrics``: the same metric names, types,
help texts and labels. One change: `Counter.value` also takes the label
values positionally, in ``label_names`` order
(``corruption_counter().value("block")``, io/integrity.py).
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Counter:
    """Monotonic counter, optionally labeled. `labels(**kv)` returns the
    child for one label combination; unlabeled counters inc directly."""

    kind = "counter"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._registry = registry
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        if not self.label_names:
            self._values[()] = 0.0

    def labels(self, **kv) -> "_CounterChild":
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"counter {self.name} expects labels "
                f"{self.label_names}, got {tuple(kv)}")
        key = tuple((k, str(kv[k])) for k in self.label_names)
        return _CounterChild(self, key)

    def inc(self, v: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(
                f"counter {self.name} is labeled; use .labels(...).inc()")
        with self._registry._lock:
            self._values[()] += v

    def _inc_key(self, key, v: float) -> None:
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def value(self, *positional, **kv) -> float:
        kv = dict(zip(self.label_names, positional), **kv)
        key = tuple((k, str(kv[k])) for k in self.label_names)
        with self._registry._lock:
            return self._values.get(key, 0.0)

    def items(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Snapshot of every label combination -> value (the fleet
        heartbeat reads cache/admission counters through this instead
        of re-parsing its own exposition)."""
        with self._registry._lock:
            return dict(self._values)

    def _samples(self) -> Iterable[str]:
        for key in sorted(self._values):
            yield (f"{self.name}{_label_str(key)} "
                   f"{_fmt(self._values[key])}")


class _CounterChild:
    __slots__ = ("_parent", "_key")

    def __init__(self, parent: Counter, key):
        self._parent = parent
        self._key = key

    def inc(self, v: float = 1.0) -> None:
        self._parent._inc_key(self._key, v)


class Gauge:
    """Last-written value (queue depth, in-flight chunks)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._registry._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._registry._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def value(self) -> float:
        with self._registry._lock:
            return self._value

    def _samples(self) -> Iterable[str]:
        yield f"{self.name} {_fmt(self._value)}"


# default latency-ish buckets (seconds); record-length callers pass
# byte-scaled buckets instead
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative buckets,
    `_sum`, `_count`) with an approximate quantile read-back for the
    progress/summary paths."""

    kind = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self._registry = registry
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.buckets, v)
        with self._registry._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values) -> None:
        """Batch observation from a numpy array (the record-length path:
        one searchsorted over the shard's lengths, never a Python loop
        per record)."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.buckets, arr, side="left")
        binned = np.bincount(idx, minlength=len(self.buckets) + 1)
        total = float(arr.sum())
        with self._registry._lock:
            for i, c in enumerate(binned):
                self._counts[i] += int(c)
            self._sum += total
            self._count += int(arr.size)

    def observe_repeat(self, v: float, count: int) -> None:
        """`count` observations of the same value (fixed-length records:
        one bucket add instead of materializing n identical samples)."""
        if count <= 0:
            return
        idx = bisect.bisect_left(self.buckets, v)
        with self._registry._lock:
            self._counts[idx] += count
            self._sum += v * count
            self._count += count

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile from bucket boundaries (upper bound of
        the bucket containing the q-th observation); None when empty."""
        with self._registry._lock:
            if self._count == 0:
                return None
            target = q * self._count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target and c:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self.buckets[-1])
            return self.buckets[-1]

    def snapshot(self) -> dict:
        with self._registry._lock:
            return {"count": self._count, "sum": self._sum}

    def state(self) -> tuple:
        """(bucket counts, sum, count) — the picklable form a forked
        multihost worker ships home so its observations reach the
        parent's registry."""
        with self._registry._lock:
            return (list(self._counts), self._sum, self._count)

    def merge_state(self, state: tuple) -> None:
        """Fold a worker's `state()` into this histogram (same metric,
        same bucket layout by construction — both sides build it from
        scan_metrics)."""
        counts, total, n = state
        if len(counts) != len(self._counts):
            return  # bucket layouts diverged (mixed versions): drop
        with self._registry._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += total
            self._count += n

    def _samples(self) -> Iterable[str]:
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self._counts[i]
            yield f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}'
        cum += self._counts[-1]
        yield f'{self.name}_bucket{{le="+Inf"}} {cum}'
        yield f"{self.name}_sum {_fmt(self._sum)}"
        yield f"{self.name}_count {self._count}"


class MetricsRegistry:
    """Named metric collection with idempotent registration (the scan
    paths call `counter(...)` per read; the first call creates, later
    calls return the same metric object)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "Dict[str, object]" = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{type(m).__name__}")
                if cls is Histogram and "buckets" in kw:
                    # the fleet-federation invariant: one metric name =
                    # ONE bucket layout, asserted at registration so a
                    # drifted call site fails at import/first-use, not
                    # as a cross-replica bucket-merge error at scrape
                    want = tuple(sorted(float(b) for b in kw["buckets"]))
                    if want != m.buckets:
                        raise ValueError(
                            f"histogram {name} already registered with "
                            f"buckets {m.buckets}; re-registration with "
                            f"{want} would break cross-replica "
                            "federation (bucket-wise merge needs one "
                            "pinned layout per metric name)")
                return m
            m = cls(name, help, self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help,
                                   label_names=label_names)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4 of every metric. The
        whole render holds the registry lock (reentrant) so a scrape
        racing concurrent observe() calls still sees each histogram's
        buckets/_sum/_count from one instant — never a +Inf bucket that
        disagrees with its own _count."""
        lines: List[str] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(m._samples())
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every read reports into."""
    return _default


def prometheus_text() -> str:
    """Exposition of the default registry (serve this from /metrics)."""
    return _default.exposition()


# -- the scan plane's standard metrics (created on first use) --------------

RECORD_LENGTH_BUCKETS = (32, 64, 128, 256, 512, 1024, 4096, 16384,
                         65536, 1 << 20)
QUEUE_DEPTH_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


def scan_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The named metric set the execution paths update; one dict so call
    sites don't repeat names/help text."""
    r = registry or _default
    return {
        "scans": r.counter(
            "cobrix_scans_total", "Completed read_cobol scans"),
        "bytes": r.counter(
            "cobrix_scan_bytes_total", "Input bytes scanned"),
        "records": r.counter(
            "cobrix_scan_records_total", "Records decoded"),
        "chunk_latency": r.histogram(
            "cobrix_chunk_latency_seconds",
            "Per-chunk wall latency through the pipeline executor"),
        "queue_depth": r.histogram(
            "cobrix_queue_depth",
            "Backpressure queue depth samples (pipeline executor)",
            buckets=QUEUE_DEPTH_BUCKETS),
        "inflight": r.gauge(
            "cobrix_inflight_chunks",
            "Chunks currently in flight in the pipeline executor"),
        "record_length": r.histogram(
            "cobrix_record_length_bytes",
            "Framed record length distribution",
            buckets=RECORD_LENGTH_BUCKETS),
        "cache": r.counter(
            "cobrix_plan_cache_events_total",
            "Compile-cache lookups by cache and outcome",
            label_names=("cache", "result")),
        "supervision": r.counter(
            "cobrix_supervision_events_total",
            "Distributed-supervision events by type",
            label_names=("event",)),
        # -- remote-storage io (cobrix_tpu.io) --------------------------
        "io_cache": r.counter(
            "cobrix_io_cache_events_total",
            "Persistent-cache lookups by plane (block/index) and outcome",
            label_names=("plane", "result")),
        "cache_corruption": r.counter(
            "cobrix_cache_corruption_total",
            "Persistent-state entries that failed checksum/structure "
            "verification on read, by plane (block/index/roofline); "
            "every count is a corrupt entry that was quarantined and "
            "rebuilt instead of being served",
            label_names=("plane",)),
        "prefetch": r.counter(
            "cobrix_io_prefetch_total",
            "Read-ahead prefetches by outcome "
            "(issued/hit/wait/unused)",
            label_names=("result",)),
        "remote_bytes": r.counter(
            "cobrix_io_remote_bytes_total",
            "Bytes fetched from remote storage backends",
            label_names=("source",)),
        # -- streaming decompression plane (cobrix_tpu.io.compress) ------
        "inflate_bytes": r.counter(
            "cobrix_io_inflate_bytes_total",
            "Streaming-decompression byte volume by direction "
            "(in = compressed bytes consumed, out = decompressed bytes "
            "produced); warm cached scans move neither",
            label_names=("direction",)),
        "inflate_seconds": r.counter(
            "cobrix_io_inflate_seconds_total",
            "Wall seconds spent inside streaming decompressors"),
        "inflate_skipped": r.counter(
            "cobrix_io_inflate_skipped_total",
            "Decompressed blocks served from the post-decompression "
            "block cache instead of re-inflating the compressed feed"),
        # -- peer block-cache tier (cobrix_tpu.io.peercache) -------------
        # distinct from cobrix_io_cache_events_total on purpose: a peer
        # hit is still a LOCAL miss, and capacity planning needs the two
        # planes separable on /metrics
        "peer_cache": r.counter(
            "cobrix_io_peer_cache_events_total",
            "Peer block-cache fetch attempts by outcome (hit/miss/"
            "timeout/corrupt/error/coalesced); every non-hit degrades "
            "to a backend fetch, never an error",
            label_names=("result",)),
        "peer_bytes": r.counter(
            "cobrix_io_peer_bytes_total",
            "Block bytes served out of warm peer caches instead of the "
            "storage backend"),
        # -- query pushdown (cobrix_tpu.query) --------------------------
        "records_pruned": r.counter(
            "cobrix_records_pruned_total",
            "Records dropped by filter pushdown before the full "
            "decode, by depth (segment = raw-byte segment-id "
            "conjuncts, filter = stage-1 predicate decode, residual "
            "= post-decode fallback paths)",
            label_names=("depth",)),
        "bytes_skipped": r.counter(
            "cobrix_bytes_skipped_total",
            "Record bytes that never reached the full decode because "
            "filter pushdown dropped their records"),
        # -- scan-time data profiler (cobrix_tpu.stats) -----------------
        "chunks_skipped": r.counter(
            "cobrix_chunks_skipped_total",
            "Planned chunks dropped before framing because a persisted "
            "profile proved no record in them can match the filter"),
        # achieved scan bytes/s of the most recent read as a fraction
        # of the calibrated host memory bandwidth (obs.roofline) — the
        # decode-throughput-law view: a regression shows as a smaller
        # fraction of the hardware limit even across machine changes.
        # Stays 0 until a roofline calibration exists on the machine.
        "roofline": r.gauge(
            "cobrix_roofline_fraction",
            "Last scan's achieved bytes/s over the calibrated host "
            "memory bandwidth (0 = uncalibrated)"),
    }


# -- process-level liveness gauges ------------------------------------------

# module import is close enough to process start for an uptime trend
_PROCESS_T0 = time.monotonic()


def _rss_bytes() -> Optional[int]:
    """Current resident set size. /proc (exact, Linux) first; the
    ru_maxrss HIGH-WATER mark as the portable fallback (a peak, not a
    live value — fine for liveness trends, wrong for leak-recovery
    curves); None when neither is readable. ru_maxrss units differ by
    platform: bytes on macOS, kilobytes elsewhere."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return None


def process_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """Bare-liveness gauges: a scrape shows the process is up, how long,
    and how big — without parsing any scan counter. Call
    `update_process_metrics` before rendering an exposition (the HTTP
    sidecar does, per scrape; gauges are point-in-time by nature)."""
    r = registry or _default
    return {
        "uptime": r.gauge(
            "cobrix_process_uptime_seconds",
            "Seconds since this serving process started"),
        "rss": r.gauge(
            "cobrix_process_rss_bytes",
            "Resident set size of this process (0 = unreadable)"),
        "open_scans": r.gauge(
            "cobrix_serve_open_scans",
            "Scan requests currently open on this process "
            "(admitted and streaming)"),
    }


def update_process_metrics(open_scans: Optional[int] = None,
                           registry: Optional[MetricsRegistry] = None
                           ) -> None:
    m = process_metrics(registry)
    m["uptime"].set(time.monotonic() - _PROCESS_T0)
    rss = _rss_bytes()
    m["rss"].set(rss if rss is not None else 0)
    if open_scans is not None:
        m["open_scans"].set(open_scans)


def stream_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The continuous-ingestion metric set (cobrix_tpu.streaming): how
    far behind the live sources the consumer is, how stale the
    committed watermark is, and the rotation/truncation event counters
    an operator alerts on. Same idempotent-registration contract as
    `scan_metrics` — every ingestor (and every serve follow session) in
    the process reports into one set."""
    r = registry or _default
    return {
        "lag_bytes": r.gauge(
            "cobrix_stream_lag_bytes",
            "Stable source bytes not yet delivered to the consumer, "
            "summed over every tailed source of this process"),
        "watermark_age": r.gauge(
            "cobrix_stream_watermark_age_seconds",
            "Seconds since the delivery watermark last advanced while "
            "undelivered bytes existed (0 = fully caught up)"),
        "batches": r.counter(
            "cobrix_stream_batches_total",
            "Micro-batches delivered by continuous ingestion"),
        "records": r.counter(
            "cobrix_stream_records_total",
            "Records delivered by continuous ingestion"),
        "rotations": r.counter(
            "cobrix_stream_rotations_total",
            "Source rotations detected (same path, new content "
            "generation); every old generation was drained exactly "
            "once before the switch"),
        "truncations": r.counter(
            "cobrix_stream_truncations_total",
            "Sources that shrank below their committed watermark "
            "(structured source_truncated outcome or policy-driven "
            "generation restart; never silently wrong rows)"),
        "checkpoints": r.counter(
            "cobrix_stream_checkpoints_total",
            "Durable checkpoint commits (acks) by the ingest layer"),
        "stats_drift": r.counter(
            "cobrix_stats_drift_events_total",
            "Ingest drift records from successive-generation profile "
            "comparison, by kind (segment_mix, null_rate, "
            "out_of_range, record_length)",
            label_names=("kind",)),
        "stats_last_drift": r.gauge(
            "cobrix_stats_last_drift_events",
            "Drift records emitted by the most recent generation "
            "comparison (0 = the last rotation compared clean)"),
    }


def sink_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The lakehouse-sink metric set (cobrix_tpu.sink): what the
    transactional dataset writer durably committed, how far behind the
    live sources it is, and the crash-recovery counters an operator
    alerts on (a nonzero recovery count after a restart is NORMAL —
    it is the exactly-once protocol working; a growing corruption
    count under plane="sink" is not). Same idempotent-registration
    contract as `scan_metrics`."""
    r = registry or _default
    return {
        "batches": r.counter(
            "cobrix_sink_committed_batches_total",
            "Micro-batches durably committed to sink datasets "
            "(manifest record appended + fsync'd before the ack)"),
        "records": r.counter(
            "cobrix_sink_committed_records_total",
            "Rows durably committed to sink datasets"),
        "bytes": r.counter(
            "cobrix_sink_committed_bytes_total",
            "Serialized data-file bytes durably committed to sink "
            "datasets"),
        "files": r.counter(
            "cobrix_sink_committed_files_total",
            "Data files durably committed to sink datasets"),
        "lag_bytes": r.gauge(
            "cobrix_sink_lag_bytes",
            "Stable source bytes not yet committed to the sink "
            "dataset (set after every commit by sink_cobol)"),
        "recovered_commits": r.counter(
            "cobrix_sink_recovered_commits_total",
            "Uncommitted manifest records truncated at restart "
            "recovery; each one is a batch the checkpoint never acked "
            "and that re-drives exactly once"),
        "quarantined_files": r.counter(
            "cobrix_sink_quarantined_files_total",
            "Staged/orphaned/uncommitted data files moved to the "
            "dataset quarantine at recovery (inspect with "
            "tools/fsckcache.py --sink)"),
    }


# -- fleet federation merge policy -----------------------------------------

# How each GAUGE aggregates across replicas when fleet/federate.py rolls
# a cluster exposition up (counters always sum; histograms always merge
# bucket-wise). Declared HERE, next to the metric definitions, so adding
# a gauge forces the author to decide its fleet semantics: "sum" for
# capacity-like gauges (work in flight, backlog bytes), "max" for
# worst-of-fleet gauges (staleness ages, uptime) where a sum would be a
# meaningless total of unrelated clocks. Undeclared gauges fall back to
# "sum"; the fleet tests assert every gauge this module registers IS
# declared, so the fallback only ever covers third-party metrics.
FLEET_GAUGE_MERGE = {
    "cobrix_inflight_chunks": "sum",
    "cobrix_roofline_fraction": "max",
    "cobrix_stats_last_drift_events": "max",
    "cobrix_process_uptime_seconds": "max",
    "cobrix_process_rss_bytes": "sum",
    "cobrix_serve_open_scans": "sum",
    "cobrix_serve_active_scans": "sum",
    "cobrix_serve_queued_scans": "sum",
    "cobrix_stream_lag_bytes": "sum",
    "cobrix_stream_watermark_age_seconds": "max",
    "cobrix_sink_lag_bytes": "sum",
}


# queue-wait / first-batch latency buckets for the serving tier: finer
# at the low end than DEFAULT_BUCKETS (an admitted-without-queueing scan
# waits microseconds) but with the same multi-second tail
SERVE_WAIT_BUCKETS = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def serve_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The serving tier's metric set (cobrix_tpu.serve): per-tenant
    admission counters, streamed volume, and the queue-wait /
    first-batch histograms. Same idempotent-registration contract as
    `scan_metrics`, so every ScanServer in the process shares one set
    and `/metrics` serves the fleet aggregate."""
    r = registry or _default
    return {
        "admitted": r.counter(
            "cobrix_serve_scans_admitted_total",
            "Scans admitted past the admission controller, by tenant",
            label_names=("tenant",)),
        "rejected": r.counter(
            "cobrix_serve_scans_rejected_total",
            "Scans rejected by the admission controller, "
            "by tenant and reason",
            label_names=("tenant", "reason")),
        "completed": r.counter(
            "cobrix_serve_scans_completed_total",
            "Streamed scans finished, by tenant and outcome (ok/error)",
            label_names=("tenant", "outcome")),
        "active": r.gauge(
            "cobrix_serve_active_scans",
            "Scans currently admitted and running"),
        "queued": r.gauge(
            "cobrix_serve_queued_scans",
            "Scans waiting in the fair-share admission queue"),
        "streamed_bytes": r.counter(
            "cobrix_serve_streamed_bytes_total",
            "Arrow IPC bytes streamed to clients, by tenant",
            label_names=("tenant",)),
        "streamed_batches": r.counter(
            "cobrix_serve_streamed_batches_total",
            "Arrow record batches streamed to clients, by tenant",
            label_names=("tenant",)),
        "follow": r.counter(
            "cobrix_serve_follow_sessions_total",
            "Follow-mode subscriptions admitted (continuous-ingest "
            "streaming over the serve protocol), by tenant",
            label_names=("tenant",)),
        "resumed": r.counter(
            "cobrix_serve_scans_resumed_total",
            "Admitted scans that resumed an earlier interrupted stream "
            "(carried a resume token), by tenant",
            label_names=("tenant",)),
        "degraded": r.counter(
            "cobrix_serve_scans_degraded_total",
            "Scans started with degraded io/pipeline knobs because the "
            "process was over its memory degrade watermark, by tenant",
            label_names=("tenant",)),
        "queue_wait": r.histogram(
            "cobrix_serve_queue_wait_seconds",
            "Admission-queue wait per admitted scan",
            buckets=SERVE_WAIT_BUCKETS),
        "first_batch": r.histogram(
            "cobrix_serve_first_batch_seconds",
            "Time from admission to the first streamed batch",
            buckets=SERVE_WAIT_BUCKETS),
        "peer_served": r.counter(
            "cobrix_serve_peer_blocks_total",
            "peer_block requests answered by this replica, by outcome "
            "(hit = framed block shipped, miss = not in local cache)",
            label_names=("result",)),
    }


def route_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The routing front's metric set (cobrix_tpu.fleet.router): where
    scans were sent, why replicas were routed around, and whether the
    cache-affinity hint decided the pick. Counters only — a router
    process federates cleanly with replica expositions."""
    r = registry or _default
    return {
        "decisions": r.counter(
            "cobrix_route_decisions_total",
            "Routing decisions by the replica chosen first",
            label_names=("replica",)),
        "around": r.counter(
            "cobrix_route_around_total",
            "Replicas excluded from routing, by replica and reason "
            "(stale_heartbeat/draining/memory_shed/slo_fast_burn/"
            "recent_failure)",
            label_names=("replica", "reason")),
        "affinity": r.counter(
            "cobrix_route_affinity_total",
            "Routing decisions by affinity outcome (hot = a heartbeat "
            "heat hint chose the head replica, cold = rendezvous hash "
            "only)",
            label_names=("result",)),
    }
