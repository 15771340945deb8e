"""Cross-process trace spans with Chrome-trace/Perfetto export.

The reference's only timeline is SLF4J log lines; PRs 1-3 produced
structured but siloed artifacts (ReadMetrics.timings_s, StageTimes busy
sums, supervision dicts) that cannot be correlated into one timeline.
`Tracer` closes that gap: every execution path emits timestamped spans
(scan -> shard -> chunk -> stage read/frame/decode/assemble, plus
supervisor instants: dispatch, heartbeat-miss, kill, re-dispatch,
speculation) carrying scan/shard/chunk identifiers, and one scan yields
ONE timeline even across forked worker processes:

* span timestamps are `time.perf_counter()` floats, cheap to take and
  monotonic within a process;
* each Tracer carries a `(wall, perf)` clock sample; a worker's spans
  are shifted onto the host's perf timeline with
  ``offset = (w_wall - w_perf) - (h_wall - h_perf)`` when merged
  (`Tracer.merge`), so processes whose monotonic clocks have different
  bases still land on one axis;
* span ids embed the emitting pid (``pid << 40 | counter``), so ids from
  concurrent processes can never collide and parent references made
  before a fork (the scan root) stay valid in the child.

Overhead discipline: when tracing is off every call site gates on a
plain ``tracer is None`` check and `maybe_span` returns a shared
null context manager — no allocation, no lock. With tracing on, a span
is one tuple append under the GIL (<1 us), far under the 2% budget.

The export target is the Chrome trace-event JSON format
(``chrome://tracing`` / https://ui.perfetto.dev): "X" complete events
for spans, "i" instants for supervisor events, with process/thread
metadata so each worker process and pipeline thread gets its own lane.
This complements (not replaces) the `torch.profiler` device traces from
profiling.profile_trace — the device kernels appear there, the host scan
topology here.

Port copy of ``cobrix_tpu.obs.trace``, unchanged but for this note and
the profiler it names (the JAX package's is ``jax.profiler``). On a CUDA
read a span closes where its host code ends: the decode spans of the
port close after the batch's one synchronize (``reader/columnar.py``),
so they cover the device work they launched.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

# span record layout (plain tuple — cheapest thing that pickles):
# (span_id, parent_id, name, cat, ph, t0, t1, pid, tid, args)
# ph: "X" = complete span, "i" = instant event
SpanRecord = Tuple[int, int, str, str, str, float, float, int, int,
                   Optional[dict]]

_NULL_CM = contextlib.nullcontext()

# process-wide span id counter, SHARED by every Tracer in the process:
# multihost workers build one Tracer per shard, and per-instance counters
# would mint colliding ids under the same pid (and inline-mode worker
# tracers would collide with the parent's). A fork child inherits the
# counter position, which is harmless — its ids carry its own pid.
_ID_COUNTER = itertools.count(1)


def maybe_span(tracer: Optional["Tracer"], name: str, cat: str = "span",
               args: Optional[dict] = None):
    """`tracer.span(...)` or the shared null context manager. The off
    path allocates nothing — the same singleton is returned every call."""
    if tracer is None:
        return _NULL_CM
    return tracer.span(name, cat, args=args)


def maybe_parent(tracer: Optional["Tracer"], span_id: int):
    """`tracer.parent(span_id)` or the shared null context manager —
    one `with` statement at call sites instead of an if/else per stage."""
    if tracer is None:
        return _NULL_CM
    return tracer.parent(span_id)


def clock_sample() -> Tuple[float, float]:
    """A (wall, perf) pair taken back-to-back; the basis for mapping one
    process's perf_counter timeline onto another's."""
    return (time.time(), time.perf_counter())


def new_trace_id() -> str:
    """A fresh request-scoped trace id: 32 hex chars, globally unique
    across clients/servers/processes. The serving tier threads ONE of
    these from the client's 'R' frame through admission, the scan
    tracer, the audit log, and back out on the trailer — so a slow
    request resolves to its exact trace and audit record."""
    return uuid.uuid4().hex


class Tracer:
    """Per-scan span collector. Thread-safe (one list append under the
    GIL per span; the lock only guards merge/export), fork-friendly (a
    worker creates its own Tracer and ships `export_state()` back)."""

    def __init__(self, process_name: str = "scan",
                 trace_id: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.pid = os.getpid()
        self.process_name = process_name
        # request-scoped identity: accept an inbound id (the serving
        # tier's client-minted id, or the `trace_id` read option) or
        # mint one — every export of this tracer carries it, so traces
        # from different processes serving ONE request group together
        self.trace_id = trace_id or new_trace_id()
        # extra root-span context (request_id, tenant): folded into the
        # root span's args at finish_root so the artifact is
        # self-describing
        self.meta: dict = dict(meta or {})
        self.clock = clock_sample()
        self.spans: List[SpanRecord] = []
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()
        # the scan root: parent of every top-level span; closed by
        # finish_root() just before export
        self.root_id = self.new_id()
        self._root_name = process_name
        self._root_closed = False

    # -- identity ----------------------------------------------------------

    def new_id(self) -> int:
        """Globally unique span id: the pid in the high bits separates
        forked workers, the process-wide counter separates every Tracer
        (and thread) within one process."""
        return (self.pid << 40) | next(_ID_COUNTER)

    # -- thread-local parent propagation -----------------------------------

    def current_parent(self) -> int:
        return getattr(self._tls, "parent", self.root_id)

    @contextlib.contextmanager
    def parent(self, span_id: int):
        """Pin the thread-local parent: spans recorded on this thread
        (e.g. StageTimes stage spans inside a chunk decode) nest under
        `span_id` without threading ids through every call."""
        prev = getattr(self._tls, "parent", self.root_id)
        self._tls.parent = span_id
        try:
            yield
        finally:
            self._tls.parent = prev

    # -- recording ---------------------------------------------------------

    def record_span(self, name: str, cat: str, t0: float, t1: float,
                    parent: Optional[int] = None,
                    args: Optional[dict] = None,
                    span_id: Optional[int] = None) -> int:
        sid = span_id if span_id is not None else self.new_id()
        self.spans.append((
            sid, parent if parent is not None else self.current_parent(),
            name, cat, "X", t0, t1, self.pid, threading.get_ident(), args))
        return sid

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span",
             parent: Optional[int] = None, args: Optional[dict] = None):
        sid = self.new_id()
        pid = parent if parent is not None else self.current_parent()
        t0 = time.perf_counter()
        prev = getattr(self._tls, "parent", self.root_id)
        self._tls.parent = sid
        try:
            yield sid
        finally:
            self._tls.parent = prev
            self.spans.append((sid, pid, name, cat, "X", t0,
                               time.perf_counter(), self.pid,
                               threading.get_ident(), args))

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict] = None,
                parent: Optional[int] = None) -> None:
        """Zero-duration event (supervisor dispatch / kill / re-dispatch
        / speculation / heartbeat-miss markers)."""
        t = time.perf_counter()
        self.spans.append((
            self.new_id(),
            parent if parent is not None else self.current_parent(),
            name, cat, "i", t, t, self.pid, threading.get_ident(), args))

    # -- cross-process merge -----------------------------------------------

    def export_state(self) -> Tuple[List[SpanRecord],
                                    Tuple[float, float]]:
        """(spans, clock) — everything a forked worker ships back over
        its result pipe. Plain tuples of primitives: pickles small."""
        with self._lock:
            return list(self.spans), self.clock

    def merge(self, spans: List[SpanRecord],
              clock: Tuple[float, float]) -> None:
        """Fold a worker's spans onto this tracer's timeline, correcting
        for the clock-base difference between the two processes:
        wall time is shared, so a worker perf stamp t maps to
        ``t + (w_wall - w_perf) - (h_wall - h_perf)`` on the host axis."""
        offset = ((clock[0] - clock[1])
                  - (self.clock[0] - self.clock[1]))
        with self._lock:
            for (sid, par, name, cat, ph, t0, t1, pid, tid,
                 args) in spans:
                self.spans.append((sid, par, name, cat, ph, t0 + offset,
                                   t1 + offset, pid, tid, args))

    # -- export ------------------------------------------------------------

    def finish_root(self, args: Optional[dict] = None) -> None:
        """Close the scan-root span (idempotent). The root args carry
        the trace id and any `meta` (request_id, tenant) in addition to
        whatever the caller passes."""
        if self._root_closed:
            return
        self._root_closed = True
        # mutate the caller's dict in place (callers keep a reference so
        # they can fold late data — field costs accrued after the trace
        # was written — back into the recorded span; see
        # ReadMetrics.refresh_trace_field_costs)
        root_args = args if args is not None else {}
        root_args.setdefault("trace_id", self.trace_id)
        for key, value in self.meta.items():
            root_args.setdefault(key, value)
        self.spans.append((
            self.root_id, 0, self._root_name, "scan", "X", self._t_start,
            time.perf_counter(), self.pid, threading.get_ident(),
            root_args))

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event dict (`traceEvents` array).
        Timestamps are microseconds relative to the earliest span, so the
        viewer opens at t=0 instead of hours into a perf_counter epoch."""
        with self._lock:
            spans = list(self.spans)
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "trace_id": self.trace_id}
        t_base = min(s[5] for s in spans)
        events: List[dict] = []
        seen_procs: Dict[int, str] = {}
        seen_threads = set()
        for sid, par, name, cat, ph, t0, t1, pid, tid, args in spans:
            if pid not in seen_procs:
                label = (self.process_name if pid == self.pid
                         else f"worker-{pid}")
                seen_procs[pid] = label
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": label}})
            if (pid, tid) not in seen_threads:
                seen_threads.add((pid, tid))
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": f"tid-{tid}"}})
            ev_args = {"span_id": sid, "parent_id": par}
            if args:
                ev_args.update(args)
            ev = {"name": name, "cat": cat, "ph": ph, "pid": pid,
                  "tid": tid, "ts": round((t0 - t_base) * 1e6, 3),
                  "args": ev_args}
            if ph == "X":
                ev["dur"] = round(max(0.0, t1 - t0) * 1e6, 3)
            else:
                ev["s"] = "g"  # global-scope instant: visible full-height
            events.append(ev)
        # trace_id at the top level: tools group per-request artifacts
        # (tools/scanlog.py traceview) without scanning every span's args
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "trace_id": self.trace_id}

    def write_chrome_trace(self, path: str) -> None:
        """Write the Chrome-trace JSON crash-safely: a process killed
        ANYWHERE during the write leaves either the old artifact or
        none — never a truncated/unparseable JSON — and a failed write
        never leaks its temp file. fsync because a watcher reads this
        artifact: durability must precede visibility."""
        from ..utils.atomic import write_atomic

        self.finish_root()
        write_atomic(path, json.dumps(self.chrome_trace()), fsync=True)
