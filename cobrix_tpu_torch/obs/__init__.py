"""cobrix_tpu_torch.obs — unified scan telemetry.

Process-scoped planes over every execution path (sequential, threaded
shard scan, chunked pipeline, forked multihost):

* **trace** — `Tracer` spans (scan -> shard -> chunk -> stage) with
  Chrome-trace/Perfetto JSON export (`trace_file=` read option) and
  cross-process merge with clock-offset correction;
* **metrics** — `MetricsRegistry` counters/gauges/histograms with
  Prometheus text exposition (`prometheus_text()`);
* **progress** — monotonic `ScanProgress` snapshots pushed to a
  `progress_callback` while the scan runs.

Request-scoped planes for the serving tier (and any embedder):

* **audit** — one `ScanRecord` per completed/failed/rejected scan in a
  size-rotated JSONL `AuditLog`, plus the `FlightRecorder` ring that
  dumps full trace + field-cost evidence for scans breaching a latency
  SLO or erroring;
* **slo** — declarative objectives (`first_batch_p99=0.5`, ...)
  evaluated per scan into Prometheus good/bad burn-rate counters.

`tools/traceview.py` summarizes a trace file (critical path, stage
utilization, straggler table); `tools/scanlog.py` tails/filters the
audit log and groups trace artifacts by trace_id.

Port copy of ``cobrix_tpu.obs`` with the same ``__all__``; each module
notes its changes. The trace spans are host spans, as in the JAX
package; the device timeline is ``profiling.profile_trace``'s
``torch.profiler`` trace and the NVTX ranges of ``profiling.annotate``.
Nothing here imports torch. The forked multihost read that ships worker
spans home (`Tracer.merge`, ``FieldCostAccumulator.merge``) and the
serving tier that drives `audit` and `slo` wait for ROADMAP A7 and A8.
"""
from .audit import AuditLog, FlightRecorder, ScanRecord, read_audit_log
from .context import ObsContext, activate, current
from .fieldcost import FieldCostAccumulator, top_fields
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    process_metrics,
    prometheus_text,
    scan_metrics,
    update_process_metrics,
)
from .progress import ProgressTracker, ScanProgress
from .roofline import (
    cached_bandwidth,
    measured_bandwidth,
    roofline_fraction,
    roofline_summary,
)
from .slo import Slo, SloTracker, parse_slo, parse_slos
from .trace import (
    Tracer,
    clock_sample,
    maybe_parent,
    maybe_span,
    new_trace_id,
)

__all__ = [
    "AuditLog",
    "FlightRecorder",
    "ScanRecord",
    "read_audit_log",
    "ObsContext",
    "activate",
    "current",
    "FieldCostAccumulator",
    "top_fields",
    "cached_bandwidth",
    "measured_bandwidth",
    "roofline_fraction",
    "roofline_summary",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "process_metrics",
    "prometheus_text",
    "scan_metrics",
    "update_process_metrics",
    "ProgressTracker",
    "ScanProgress",
    "Slo",
    "SloTracker",
    "parse_slo",
    "parse_slos",
    "Tracer",
    "clock_sample",
    "maybe_parent",
    "maybe_span",
    "new_trace_id",
]
