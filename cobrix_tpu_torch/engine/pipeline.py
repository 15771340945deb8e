"""The chunked pipeline executor: overlap read, framing, decode and
Arrow assembly.

Port of ``cobrix_tpu.engine.pipeline``. A scan is split into chunks
(engine/chunks.py) and executed as a producer/consumer pipeline:

    reader thread:  chunk.read()  ──►  bounded queue  ──►  worker pool:
                    (into a staging    (backpressure)      H2D -> frame
                     buffer)                               -> decode -> D2H
                                                                 │
                    assembler thread: the chunk's Arrow table ◄──┘
                    (and ``on_batch``, the read's batch_callback)

Threads, not processes: the kernels are launched through ``ctypes``,
which releases the GIL for the call, and so do file reads and PyTorch's
copies and synchronizes. The bounded queue is the backpressure valve —
at most `max_inflight` chunks of raw bytes are held at once, so a fast
reader cannot balloon memory ahead of slow decoders.

Determinism: results are collected into a slot per chunk index and
returned in chunk order regardless of completion order, so per-chunk
results concatenate exactly like the sequential scan's.

Supervision: every queue wait and join is bounded; the run loop doubles
as a watchdog enforcing the per-chunk deadline (`shard_timeout_s`), the
whole-scan deadline (`scan_deadline_s`), and a no-progress stall limit;
a chunk whose stage raises is re-queued once; a worker thread wedged
past the chunk deadline is abandoned (its late result is discarded) and
a replacement thread restores pool capacity. Under
`shard_error_policy='partial'` an unrecoverable chunk becomes a
ShardFailureInfo ledger entry instead of aborting the scan.

Per-stage busy time accumulates in a shared `profiling.StageTimes`; the
executor reports wall time, busy total, their ratio (the overlap
factor), and the peak queue depth.

`PipelineExecutor` is the JAX package's, with its supervision, its
observability wiring (the stage threads enter the read's
``obs.context``; a span per chunk, the stage timers doubling as spans
under it; ``chunk_failed`` / ``chunk_retry`` / ``worker_respawn``
instants; progress per chunk from `chunk_meta`; the registry's chunk
latency, queue depth and in-flight gauge) and the memory-pressure
degrade (``utils.pressure``), unchanged but for ``_cap_omp_width``,
which caps a native OpenMP library the port does not load. `pipelined_fixed_scan` and
`pipelined_var_len_scan` drive it over the port's fixed-length and
variable-length readers with the device plumbing the JAX package leaves to XLA
(engine/staging.py): the reader thread reads each chunk or shard into a
buffer of a bounded pinned pool, each worker thread decodes on its own
CUDA stream, and each decoded batch crosses back in one copy
(``ColumnarDecoder``). A worker that cannot launch a kernel raises, and
the chunk fails under the read's policy: nothing falls back to the CPU.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

from ..obs.context import activate as obs_activate
from ..obs.context import current as obs_current
from ..obs.trace import maybe_parent
from ..profiling import ReadMetrics, StageTimes
from ..reader.stream import source_size
from ..reader.diagnostics import ShardErrorPolicy, ShardFailureInfo
from .chunks import (FixedChunk, WorkShard, plan_fixed_chunks,
                     shard_progress_bytes)
from .staging import StagingPool, worker_stream

# poll tick bounding every queue wait in the pipeline (so cancellation is
# cooperative and no thread ever blocks indefinitely)
_TICK_S = 0.1
# grace given to stage threads to exit after a stop/abort before they are
# declared stuck (they are daemons — a wedged stage cannot hang exit)
_JOIN_GRACE_S = 2.0
# catch-all stall limit when no explicit deadlines are configured: if NO
# chunk makes progress for this long the run aborts naming the stuck
# stage instead of hanging
DEFAULT_STALL_TIMEOUT_S = 300.0


class PipelineTimeoutError(RuntimeError):
    """A chunk or the whole scan exceeded its deadline (or the pipeline
    stalled with a stage stuck); the message names the stage."""


class PipelineExecutor:
    """Bounded-thread chunk pipeline with backpressure, ordered output,
    and watchdog supervision.

    `run(tasks)` takes (read_fn, process_fn[, finalize_fn]) tuples:

    * `read_fn()` produces the chunk's payload on the reader thread
      (stage "read");
    * `process_fn(payload)` frames/decodes on the worker pool (timing its
      own stages through the shared StageTimes);
    * `finalize_fn(result)` — optional — is the Arrow-assembly stage.
      Historically it ran on ONE dedicated stage thread: the Python
      numpy/pyarrow assembly glue was GIL-heavy and measurably
      ANTI-scaled across threads. With the fused native assembly
      (arrow_out: decode -> Arrow buffers in one GIL-released pass) that
      constraint no longer holds, so `parallel_finalize=True` lets
      assembly ride the decode workers — each worker finalizes the chunk
      it just decoded, and the dedicated assembler thread disappears.
      The port's assembly is numpy and pyarrow glue, so its scans keep
      the one assembler thread (``parallel_finalize`` stays off, as the
      JAX package leaves it for every backend but numpy with its native
      library).

    Results return in task order regardless of completion order. A chunk
    whose read/process raises is re-queued once before counting as
    failed; failure then aborts (fail_fast) or ledgers the chunk in
    `shard_failures` and continues (partial).
    """

    def __init__(self, workers: int, max_inflight: int = 0,
                 stage_times: Optional[StageTimes] = None,
                 chunk_timeout_s: float = 0.0,
                 scan_deadline_s: float = 0.0,
                 error_policy: ShardErrorPolicy = ShardErrorPolicy.FAIL_FAST,
                 chunk_retries: int = 1,
                 stall_timeout_s: float = DEFAULT_STALL_TIMEOUT_S,
                 failure_info: Optional[Callable] = None,
                 parallel_finalize: bool = False):
        self.workers = max(1, workers)
        self.max_inflight = max_inflight if max_inflight > 0 \
            else self.workers + 2
        self.stage_times = stage_times if stage_times is not None \
            else StageTimes()
        self.chunk_timeout_s = chunk_timeout_s
        self.scan_deadline_s = scan_deadline_s
        self.error_policy = error_policy
        self.chunk_retries = max(0, chunk_retries)
        self.stall_timeout_s = stall_timeout_s
        self.parallel_finalize = parallel_finalize
        # failure_info(index, attempts, reason, error) -> ShardFailureInfo
        self.failure_info = failure_info or _default_failure_info
        self.shard_failures: List[ShardFailureInfo] = []
        # on_chunk_failed(index): best-effort tap notified when a chunk
        # terminally fails under the partial policy — streaming
        # consumers holding later chunks in a reorder buffer need to
        # know the gap is PERMANENT, or they buffer against it forever
        # (serve.session.OrderedBatchEmitter). May fire from any stage
        # thread; exceptions are swallowed (the chunk already failed)
        self.on_chunk_failed: Optional[Callable] = None
        self.report: dict = {}
        # the read's observability context, captured on the constructing
        # thread (read_cobol activated it there) and re-activated on
        # every stage thread this executor spawns — spans, progress, and
        # cache counters all attribute across the pool
        self.obs = obs_current()
        if self.obs is not None and self.obs.tracer is not None:
            self.stage_times.tracer = self.obs.tracer

    def run(self, tasks: Sequence[tuple],
            chunk_meta: Optional[Sequence[dict]] = None) -> List[object]:
        n = len(tasks)
        results: List[object] = [None] * n
        if n == 0:
            self.report = {"workers": self.workers, "chunks": 0,
                           "max_inflight": self.max_inflight,
                           "peak_queue": 0, "wall_s": 0.0, "busy_s": 0.0,
                           "overlap": 0.0}
            return results
        has_finalize = any(len(t) > 2 and t[2] is not None for t in tasks)
        t_start = time.monotonic()
        scan_deadline = (t_start + self.scan_deadline_s
                         if self.scan_deadline_s > 0 else None)
        q: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        # decoded chunks waiting for the assembler; bounded so decode
        # cannot balloon RSS ahead of a slow assembly stage
        fq: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        retry_dq: "deque" = deque()   # failed-once chunks; workers re-read
        stop = threading.Event()      # cooperative cancel: drain and exit
        lock = threading.Lock()
        # chunk states: 'pending' -> 'running' -> 'decoded' -> 'done'
        #               (terminal: 'done' | 'failed')
        state = ["pending"] * n
        attempts = [0] * n
        # in-flight stage per chunk: i -> (stage_name, start_monotonic)
        inflight: dict = {}
        errors: List[Tuple[int, BaseException]] = []
        counters = {"chunk_retries": 0, "chunks_failed": 0,
                    "chunk_timeouts": 0, "respawned_workers": 0}
        progress_t = [time.monotonic()]
        peak_queue = [0]

        obs = self.obs
        tracer = obs.tracer if obs is not None else None
        progress = obs.progress if obs is not None else None
        scan_m = obs.metrics if obs is not None else None
        if progress is not None:
            progress.set_plan(chunks_total=n)
            if progress.stage_times is None:
                progress.stage_times = self.stage_times
        # per-chunk logical span (async across stage threads): id minted
        # at first dispatch, one "chunk" span recorded at terminal state
        chunk_span = [0] * n
        chunk_t0 = [0.0] * n

        def touch() -> None:
            progress_t[0] = time.monotonic()

        def terminal(i: int) -> bool:
            return state[i] in ("done", "failed")

        def chunk_terminal_obs(i: int, failed: bool) -> None:
            """Telemetry for a chunk reaching a terminal state (called
            outside the lock): span close, latency sample, progress."""
            t1 = time.perf_counter()
            if tracer is not None and chunk_span[i]:
                tracer.record_span(
                    "chunk", "chunk", chunk_t0[i], t1,
                    parent=tracer.root_id, span_id=chunk_span[i],
                    args={"chunk": i, "attempts": attempts[i],
                          "failed": failed})
            if scan_m is not None and chunk_t0[i]:
                scan_m["chunk_latency"].observe(t1 - chunk_t0[i])
            if progress is not None:
                if failed:
                    progress.chunk_failed()
                else:
                    meta = (chunk_meta[i] if chunk_meta is not None
                            else None)
                    progress.chunk_done(
                        bytes_done=(meta or {}).get("bytes", 0),
                        records=getattr(results[i], "n_rows", 0) or 0)

        def fail_chunk(i: int, reason: str, exc: BaseException) -> None:
            """Retry budget exhausted (or hard abort) for chunk i."""
            with lock:
                if terminal(i):
                    return
                state[i] = "failed"
                inflight.pop(i, None)
                counters["chunks_failed"] += 1
                if self.error_policy.is_partial:
                    self.shard_failures.append(self.failure_info(
                        i, attempts[i], reason,
                        f"{type(exc).__name__}: {exc}"))
                else:
                    errors.append((i, exc))
                    stop.set()
            if self.error_policy.is_partial \
                    and self.on_chunk_failed is not None:
                try:
                    self.on_chunk_failed(i)
                except Exception:
                    pass  # the chunk is already ledgered
            if tracer is not None:
                tracer.instant("chunk_failed", "supervision",
                               args={"chunk": i, "reason": reason})
            chunk_terminal_obs(i, failed=True)
            touch()

        def attempt_failed(i: int, reason: str,
                           exc: BaseException) -> None:
            requeue = False
            with lock:
                if terminal(i):
                    return
                inflight.pop(i, None)
                if (attempts[i] <= self.chunk_retries
                        and not stop.is_set()):
                    state[i] = "pending"
                    counters["chunk_retries"] += 1
                    requeue = True
            if requeue:
                if tracer is not None:
                    tracer.instant("chunk_retry", "supervision",
                                   args={"chunk": i, "reason": reason})
                retry_dq.append((i, tasks[i]))
                touch()
            else:
                fail_chunk(i, reason, exc)

        def chunk_decoded(i: int, result: object, finalize_fn) -> bool:
            """Record a finished decode; False if the chunk was already
            terminal (late result from an abandoned worker — discard)."""
            done = False
            with lock:
                if terminal(i) or stop.is_set():
                    return False
                results[i] = result
                if has_finalize and finalize_fn is not None:
                    state[i] = "decoded"
                else:
                    state[i] = "done"
                    inflight.pop(i, None)
                    done = True
            if done:
                chunk_terminal_obs(i, failed=False)
            touch()
            return True

        def bounded_put(dst: "queue.Queue", item) -> bool:
            while not stop.is_set():
                try:
                    dst.put(item, timeout=_TICK_S)
                    return True
                except queue.Full:
                    continue
            return False

        def run_read(i: int, task) -> object:
            first = False
            with lock:
                if terminal(i):
                    return None
                attempts[i] += 1
                state[i] = "running"
                inflight[i] = ("read", time.monotonic())
                # first-dispatch sentinel is chunk_t0, NOT the span id
                # (which only exists when tracing is on): a retried chunk
                # must neither re-count as started nor reset its latency
                # clock — the histogram is first-dispatch -> terminal in
                # both modes
                if chunk_t0[i] == 0.0:
                    first = True
                    chunk_t0[i] = time.perf_counter()
                if tracer is not None and chunk_span[i] == 0:
                    chunk_span[i] = tracer.new_id()
            if first and progress is not None:
                progress.chunk_started()
            with maybe_parent(tracer, chunk_span[i]):
                with self.stage_times.timed("read"):
                    return task[0]()

        degrade_events = [0]

        def pressure_wait() -> None:
            """Memory-pressure degrade (utils.pressure): while the
            process is past its degrade watermark, the reader holds new
            chunks until in-flight count drops under HALF the normal
            window — raw chunk bytes are the pipeline's dominant RSS,
            so halving the window sheds them fastest without failing
            anything. Checked per chunk: a cached probe, not a syscall
            per block. No budget configured = no-op."""
            from ..utils.pressure import LEVEL_DEGRADED, current_level

            shrunk = max(1, self.max_inflight // 2)
            waited = False
            while not stop.is_set():
                if current_level() < LEVEL_DEGRADED:
                    break
                with lock:
                    if len(inflight) < shrunk:
                        break
                if not waited:
                    waited = True
                    degrade_events[0] += 1
                time.sleep(_TICK_S)

        def reader_loop() -> None:
            for i, task in enumerate(tasks):
                if stop.is_set():
                    break
                pressure_wait()
                try:
                    payload = run_read(i, task)
                except BaseException as exc:
                    attempt_failed(i, "error", exc)
                    continue
                with lock:
                    if terminal(i):
                        _close_payload(payload)
                        continue
                    inflight[i] = ("queued", time.monotonic())
                # blocks (bounded) when max_inflight chunks are already
                # queued or being processed — the backpressure valve
                if not bounded_put(q, (i, task, payload)):
                    _close_payload(payload)
                    return
                touch()
                depth = q.qsize()
                if depth > peak_queue[0]:
                    peak_queue[0] = depth

        workers_exit = threading.Event()

        def next_item():
            """A retry first (unbounded deque — a full queue must never
            deadlock a re-dispatch), else a queued chunk, else None."""
            try:
                i, task = retry_dq.popleft()
                return ("retry", i, task, None)
            except IndexError:
                pass
            try:
                i, task, payload = q.get(timeout=_TICK_S)
                return ("fresh", i, task, payload)
            except queue.Empty:
                return None

        def run_finalize(i: int, finalize_fn, result) -> None:
            """One chunk's Arrow-assembly stage (on the dedicated
            assembler thread, or inline on a decode worker when
            parallel_finalize is on)."""
            with lock:
                if terminal(i) or stop.is_set():
                    return
                inflight[i] = ("assemble", time.monotonic())
            try:
                with maybe_parent(tracer, chunk_span[i]):
                    finalize_fn(result)
            except BaseException as exc:
                # assembly is deterministic — no retry
                attempts[i] = attempts[i] or 1
                fail_chunk(i, "error", exc)
                return
            done = False
            with lock:
                if not terminal(i):
                    state[i] = "done"
                    inflight.pop(i, None)
                    done = True
            if done:
                chunk_terminal_obs(i, failed=False)
            touch()

        def worker_loop() -> None:
            while not workers_exit.is_set():
                item = next_item()
                if item is None:
                    continue
                kind, i, task, payload = item
                if stop.is_set() or terminal(i):
                    # drain so the reader can unblock; payloads may be
                    # OPEN resources (var-len chunks carry streams whose
                    # close normally happens in process_fn)
                    _close_payload(payload)
                    continue
                try:
                    if kind == "retry":
                        # the original payload is consumed/closed; the
                        # re-dispatched attempt re-reads on this thread
                        payload = run_read(i, task)
                    with lock:
                        if terminal(i):
                            _close_payload(payload)
                            continue
                        inflight[i] = ("decode", time.monotonic())
                    with maybe_parent(tracer, chunk_span[i]):
                        result = task[1](payload)
                except BaseException as exc:
                    attempt_failed(i, "error", exc)
                    continue
                finalize_fn = task[2] if len(task) > 2 else None
                if not chunk_decoded(i, result, finalize_fn):
                    continue
                if has_finalize and finalize_fn is not None:
                    if self.parallel_finalize:
                        # GIL-free native assembly: finalize right here
                        # on the decode worker — no single-assembler
                        # bottleneck, no extra queue hop
                        run_finalize(i, finalize_fn, result)
                        continue
                    with lock:
                        inflight[i] = ("assemble_queued", time.monotonic())
                    if not bounded_put(fq, (i, finalize_fn, result)):
                        return
                    depth = fq.qsize()
                    if depth > peak_queue[0]:
                        peak_queue[0] = depth

        finalizer_exit = threading.Event()

        def finalizer_loop() -> None:
            while not finalizer_exit.is_set():
                try:
                    i, finalize_fn, result = fq.get(timeout=_TICK_S)
                except queue.Empty:
                    continue
                run_finalize(i, finalize_fn, result)

        def obs_target(fn):
            """Stage-thread entry: the read's ObsContext (tracer parentage,
            cache counters, progress) re-activated on this thread."""
            def entry():
                with obs_activate(obs):
                    fn()
            return entry

        wrapped_worker_loop = obs_target(worker_loop)
        reader = threading.Thread(target=obs_target(reader_loop),
                                  name="cobrix-pipe-read", daemon=True)
        workers = [threading.Thread(target=wrapped_worker_loop,
                                    name=f"cobrix-pipe-{k}", daemon=True)
                   for k in range(self.workers)]
        finalizer = None
        if has_finalize and not self.parallel_finalize:
            finalizer = threading.Thread(target=obs_target(finalizer_loop),
                                         name="cobrix-pipe-assemble",
                                         daemon=True)
            finalizer.start()
        reader.start()
        for t in workers:
            t.start()

        # -- the watchdog / supervision loop (runs on the caller's
        # thread): every wait below is bounded by _TICK_S ---------------
        deadline_exc: Optional[BaseException] = None
        last_depth_sample = 0.0
        # this run's last contribution to the (process-global) in-flight
        # gauge: updates are DELTAS so concurrent scans compose instead
        # of clobbering each other with absolute writes
        gauge_inflight = 0
        while True:
            if scan_m is not None:
                now_s = time.monotonic()
                # backpressure-queue depth samples at a coarse cadence
                # (the watchdog ticks at 25ms; sampling every tick would
                # just histogram the sampler)
                if now_s - last_depth_sample >= 0.2:
                    last_depth_sample = now_s
                    scan_m["queue_depth"].observe(q.qsize())
                    with lock:
                        now_inflight = len(inflight)
                    scan_m["inflight"].inc(now_inflight - gauge_inflight)
                    gauge_inflight = now_inflight
            with lock:
                all_terminal = all(terminal(i) for i in range(n))
                if errors:
                    break
            if all_terminal:
                break
            now = time.monotonic()
            if scan_deadline is not None and now > scan_deadline:
                deadline_exc = PipelineTimeoutError(
                    f"scan deadline of {self.scan_deadline_s}s expired "
                    f"with {sum(1 for i in range(n) if not terminal(i))} "
                    f"of {n} chunk(s) outstanding")
                break
            if self.chunk_timeout_s > 0:
                self._enforce_chunk_deadline(
                    now, lock, inflight, counters, fail_chunk, workers,
                    wrapped_worker_loop)
                with lock:
                    if errors:
                        break
            stall = self.stall_timeout_s
            if stall > 0 and now - progress_t[0] > stall:
                deadline_exc = PipelineTimeoutError(
                    "pipeline stalled: no chunk progressed for "
                    f"{stall:.0f}s; in-flight stages: "
                    f"{_inflight_desc(lock, inflight, now)}")
                break
            time.sleep(_TICK_S / 2)

        # -- cooperative shutdown: drain queues, join with deadlines ----
        stop.set()
        workers_exit.set()
        finalizer_exit.set()
        _drain(q)
        stuck = _join_bounded([reader] + workers, _JOIN_GRACE_S)
        if finalizer is not None:
            _drain_fq(fq)
            stuck += _join_bounded([finalizer], _JOIN_GRACE_S)

        if scan_m is not None:
            scan_m["inflight"].inc(-gauge_inflight)
        wall = time.monotonic() - t_start
        busy = sum(self.stage_times.busy_s.values())
        self.report = {
            "workers": self.workers,
            "chunks": n,
            "max_inflight": self.max_inflight,
            "peak_queue": peak_queue[0],
            "wall_s": round(wall, 6),
            "busy_s": round(busy, 6),
            "overlap": round(busy / wall, 3) if wall > 0 else 0.0,
        }
        if has_finalize:
            self.report["parallel_assembly"] = bool(self.parallel_finalize)
        if any(counters.values()):
            self.report.update(counters)
        if degrade_events[0]:
            self.report["pressure_degrades"] = degrade_events[0]
        if stuck:
            self.report["stuck_stages"] = stuck

        if errors:
            # deterministic-ish error choice: the failing chunk with the
            # lowest index among those observed before the stop. (A later
            # chunk may fail before an earlier one is reached — the
            # sequential scan would have surfaced the earlier failure
            # first; both surface A failure for the same corrupt input.)
            errors.sort(key=lambda e: e[0])
            raise errors[0][1]
        if deadline_exc is not None:
            if not self.error_policy.is_partial:
                if stuck:
                    deadline_exc = PipelineTimeoutError(
                        f"{deadline_exc} (stuck stage thread(s): "
                        f"{', '.join(stuck)})")
                raise deadline_exc
            # partial: every unfinished chunk becomes a ledger entry
            for i in range(n):
                if not terminal(i):
                    state[i] = "failed"
                    counters["chunks_failed"] += 1
                    self.shard_failures.append(self.failure_info(
                        i, attempts[i], "scan_deadline",
                        str(deadline_exc)))
                    results[i] = None
                    chunk_terminal_obs(i, failed=True)
            self.report.update(counters)
        return results

    def _enforce_chunk_deadline(self, now, lock, inflight, counters,
                                fail_chunk,
                                workers: List[threading.Thread],
                                worker_loop) -> None:
        """Kill-and-replace semantics for threads: a chunk stuck in one
        stage past the deadline is abandoned (late results discarded via
        the terminal-state check) and a fresh worker thread restores pool
        capacity; the chunk itself fails (no re-dispatch — a wedged chunk
        would wedge its retry too)."""
        expired = []
        with lock:
            for i, (stage_name, since) in list(inflight.items()):
                if stage_name in ("queued", "assemble_queued"):
                    continue  # waiting in a bounded queue, not wedged
                if now - since > self.chunk_timeout_s:
                    expired.append((i, stage_name, now - since))
        for i, stage_name, elapsed in expired:
            counters["chunk_timeouts"] += 1
            fail_chunk(i, "timeout", PipelineTimeoutError(
                f"chunk {i} exceeded shard_timeout_s="
                f"{self.chunk_timeout_s} in stage '{stage_name}' "
                f"({elapsed:.1f}s)"))
            if self.error_policy.is_partial:
                # the wedged thread still occupies a pool slot; top the
                # pool back up so surviving chunks keep flowing
                alive = sum(1 for t in workers if t.is_alive())
                if alive >= self.workers:
                    counters["respawned_workers"] += 1
                    if (self.obs is not None
                            and self.obs.tracer is not None):
                        self.obs.tracer.instant(
                            "worker_respawn", "supervision",
                            args={"chunk": i, "stage": stage_name})
                    t = threading.Thread(
                        target=worker_loop,
                        name=f"cobrix-pipe-r{counters['respawned_workers']}",
                        daemon=True)
                    workers.append(t)
                    t.start()

    def attach(self, metrics: Optional[ReadMetrics]) -> None:
        """Publish the run report + stage busy times on the read metrics."""
        if metrics is None:
            return
        metrics.stage_busy = self.stage_times
        supervision = {k: self.report[k]
                       for k in ("chunk_retries", "chunks_failed",
                                 "chunk_timeouts", "respawned_workers",
                                 "stuck_stages")
                       if k in self.report}
        if supervision:
            if metrics.supervision is None:
                metrics.supervision = supervision
            else:
                for k, v in supervision.items():
                    if isinstance(v, int):
                        metrics.supervision[k] = \
                            metrics.supervision.get(k, 0) + v
                    else:
                        metrics.supervision[k] = v
        if metrics.pipeline is None:
            metrics.pipeline = self.report
        else:
            # multiple pipelined phases in one read: keep the widest shape
            prev = metrics.pipeline
            merged = dict(self.report)
            merged["chunks"] += prev.get("chunks", 0)
            merged["peak_queue"] = max(merged["peak_queue"],
                                       prev.get("peak_queue", 0))
            merged["wall_s"] = round(merged["wall_s"]
                                     + prev.get("wall_s", 0.0), 6)
            merged["busy_s"] = round(merged["busy_s"]
                                     + prev.get("busy_s", 0.0), 6)
            if merged["wall_s"] > 0:
                merged["overlap"] = round(
                    merged["busy_s"] / merged["wall_s"], 3)
            metrics.pipeline = merged


def _default_failure_info(index: int, attempts: int, reason: str,
                          error: str) -> ShardFailureInfo:
    return ShardFailureInfo(file="", offset_from=index, offset_to=index,
                            record_index=index, attempts=attempts,
                            reason=reason, error=error)


def _close_payload(payload) -> None:
    """Release a chunk payload that will never be processed (open var-len
    streams leak an fd per chunk otherwise)."""
    close = getattr(payload, "close", None)
    if close is not None:
        try:
            close()
        except Exception:
            pass


def _drain(q: "queue.Queue") -> None:
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return
        if item is not None and len(item) > 2:
            _close_payload(item[2])


def _drain_fq(fq: "queue.Queue") -> None:
    while True:
        try:
            fq.get_nowait()
        except queue.Empty:
            return


def _join_bounded(threads: List[threading.Thread],
                  grace_s: float) -> List[str]:
    """Join each thread against one shared deadline; names of threads
    still alive after it (wedged stages — daemons, so the interpreter
    can still exit) are returned for the error/report."""
    deadline = time.monotonic() + grace_s
    stuck = []
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            stuck.append(t.name)
    return stuck


def _inflight_desc(lock, inflight, now) -> str:
    with lock:
        items = sorted(inflight.items())
    if not items:
        return "<none>"
    return ", ".join(f"chunk {i}: {stage_name} {now - since:.0f}s"
                     for i, (stage_name, since) in items[:8])


def _executor_for(params, workers: int,
                  failure_info: Callable) -> PipelineExecutor:
    """An executor wired with the read's supervision knobs."""
    return PipelineExecutor(
        workers, params.pipeline_max_inflight, stage_times=StageTimes(),
        chunk_timeout_s=params.shard_timeout_s,
        scan_deadline_s=params.scan_deadline_s,
        error_policy=params.shard_error_policy,
        chunk_retries=min(1, max(0, params.shard_max_retries)),
        failure_info=failure_info)


def _staged_read(pool: StagingPool, stage_times: StageTimes, open_input,
                 path: str, offset: int, nbytes: int):
    """A read stage: `nbytes` bytes of `path` from `offset` into a
    staging buffer, through the reader `open_input(path, offset,
    nbytes)` gives (a raw local file, or the seekable view of a
    compressed or backend source: its bytes — the inflater's output —
    are copied into the pinned buffer once). The first call takes a pool
    buffer (on the reader thread); a re-read after a failed attempt (on a
    worker) takes one outside the pool, so it never waits for buffers
    queued chunks hold.
    Time spent waiting for a free buffer is backpressure, like a wait on
    the full queue: it is taken out of the "read" stage's busy time and
    summed in ``pool.wait_s``."""
    calls = [0]

    def read():
        calls[0] += 1
        if calls[0] == 1:
            t0 = time.perf_counter()
            staged = pool.acquire(nbytes)
            waited = time.perf_counter() - t0
            stage_times.add("read", -waited)
            pool.add_wait(waited)
        else:
            staged = pool.fresh(nbytes)
        try:
            with open_input(path, offset, nbytes) as f:
                f.seek(offset)
                got = f.readinto(memoryview(staged.host().numpy()))
            if got != nbytes:
                raise IOError(f"Short read from {path} at {offset}")
        except BaseException:
            staged.close()
            raise
        return staged
    return read


def _assemble(result, output_schema, stage_times: StageTimes):
    """Stage 4: the chunk's Arrow table, built on the assembler thread
    and cached on the DecodedBatch or FileResult, so that
    CobolData.to_arrow concatenates without rebuilding. A chunk with no
    records (an empty file) gives the schema's empty table."""
    from ..reader.arrow_out import arrow_schema

    with stage_times.timed("assemble"):
        if result is None:
            return arrow_schema(output_schema.schema).empty_table()
        table = result.to_arrow(output_schema)
    result._arrow_cache = table
    result._arrow_cache_schema = output_schema
    return table


def _finalizers(count: int, output_schema, ex: PipelineExecutor, on_batch):
    """Per-chunk finalize closures (the assemble stage). With `on_batch`
    set, each assembled chunk's table is handed out as
    `on_batch(chunk_index, table)`: calls are serialized by the one
    assembler thread but arrive in chunk completion order. An on_batch
    exception fails the chunk like any assembly error: fail_fast aborts
    the scan, partial ledgers the chunk. A chunk that fails terminally
    under the partial policy is signalled as `(chunk_index, None)`."""
    from ..reader.arrow_out import warm_pyarrow

    warm_pyarrow()
    if on_batch is not None:
        ex.on_chunk_failed = lambda i: on_batch(i, None)

    def make(i: int):
        def finalize(result) -> None:
            table = _assemble(result, output_schema, ex.stage_times)
            if on_batch is not None:
                on_batch(i, table)
        return finalize

    return [make(i) for i in range(count)]


def pipelined_fixed_scan(reader, files, params, workers: int,
                         output_schema,
                         metrics: Optional[ReadMetrics] = None,
                         ignore_file_size: bool = False, on_batch=None,
                         retry=None, on_retry=None, io=None
                         ) -> Tuple[list, List[ShardFailureInfo]]:
    """Fixed-length files through the chunk pipeline: record-aligned byte
    strides read into staging buffers, decoded on the card (a chunk of
    the plain layout straight from the staging buffer,
    `ColumnarDecoder.decode_tensor`, or under a filter the two stages
    of `FixedLenReader.read_image` on that same device image; trimmed
    or multisegment records through `FixedLenReader.read_chunk` on a
    host copy), and assembled
    into a table per chunk; row-identical to the sequential chunked
    read. Returns (one DecodedBatch or FileResult per chunk, None for an
    empty file or a chunk that failed under the partial policy;
    failures). `on_batch(chunk_index, table)` taps each assembled chunk
    out (`_finalizers`). `retry`, `on_retry` and `io` are the read's
    (``reader.stream.open_input``)."""
    from ..reader.stream import open_input

    def open_fn(path, offset, nbytes):
        return open_input(path, offset, nbytes, retry=retry,
                          on_retry=on_retry, io=io)

    rs = reader.record_size
    device = reader.device
    # the plan's decoder, built before the first chunk (the JAX
    # package's `plan_decoder`)
    reader.decoder()
    permissive = params.is_permissive
    chunk_bytes = max(1, int(params.pipeline_chunk_mb * 1024 * 1024))
    chunks = plan_fixed_chunks(rs, files, params, chunk_bytes,
                               ignore_file_size, retry, on_retry, io,
                               skipper=reader.chunk_skipper)

    def failure_info(index, attempts, reason, error):
        c = chunks[index]
        return ShardFailureInfo(
            file=c.file_path, offset_from=c.offset,
            offset_to=c.offset + c.nbytes,
            record_index=c.first_record_id, attempts=attempts,
            reason=reason, error=error)

    ex = _executor_for(params, workers, failure_info)
    pool = StagingPool(ex.max_inflight, device)

    def read_fn(c: FixedChunk):
        if not c.whole_file:
            return _staged_read(pool, ex.stage_times, open_fn, c.file_path,
                                c.offset, c.nbytes)

        def read():
            size = source_size(c.file_path, retry=retry, on_retry=on_retry,
                               io=io)
            reader.check_binary_data_validity(
                size, ignore_file_size or permissive, c.file_path)
            return _staged_read(pool, ex.stage_times, open_fn, c.file_path,
                                0, size)()
        return read

    def process_fn(c: FixedChunk):
        def process(staged):
            with worker_stream(device):
                # whole records only: a torn tail is cut under
                # debug_ignore_file_size (and raised before under
                # fail_fast); a permissive read of a whole-file chunk
                # keeps or drops it (`FixedLenReader.read_torn_chunk`).
                # "frame": the chunk's records onto the card (or into a
                # host matrix), as the JAX package's frame stage cuts
                # them out of the chunk's bytes
                rem = (staged.nbytes % rs if permissive and c.whole_file
                       and not ignore_file_size else 0)
                part = reader.decode_staged(
                    staged, 0, staged.nbytes // rs * rs, rem, c.file_path,
                    staged.nbytes, ex.stage_times)
                if part is None or rem or not permissive:
                    return part
                with ex.stage_times.timed("decode"):
                    return reader.permissive_part(part)
        return process

    finalizers = _finalizers(len(chunks), output_schema, ex, on_batch)
    results = ex.run([(read_fn(c), process_fn(c), fin)
                      for c, fin in zip(chunks, finalizers)],
                     chunk_meta=[{"bytes": c.nbytes} for c in chunks])
    ex.report["staging"] = pool.report()
    ex.attach(metrics)
    if metrics is not None:
        metrics.shards = max(metrics.shards, len(chunks))
    return results, ex.shard_failures


def pipelined_var_len_scan(reader, shards: Sequence[WorkShard],
                           prefix: str, workers: int, output_schema,
                           metrics: Optional[ReadMetrics] = None,
                           on_batch=None
                           ) -> Tuple[list, List[ShardFailureInfo]]:
    """Variable-length shards (sparse-index byte ranges) through the
    pipeline: each shard is read into a staging buffer, framed and
    decoded from it (`VarLenReader.read_shard`) and assembled into a
    table. The shard plan is exactly the JAX package's, so record
    framing and Record_Ids match; the pipeline only overlaps stage
    execution. Returns (one FileResult per shard, None for a shard that
    failed under the partial policy; failures); `on_batch` taps the
    assembled shards out as `pipelined_fixed_scan` does."""
    params = reader.params
    device = reader.device
    sizes = {path: reader.input_size(path)
             for path in {s.file_path for s in shards}}

    def failure_info(index, attempts, reason, error):
        s = shards[index]
        return ShardFailureInfo(
            file=s.file_path, offset_from=s.offset_from,
            offset_to=s.offset_to, record_index=s.record_index,
            attempts=attempts, reason=reason, error=error)

    ex = _executor_for(params, workers, failure_info)
    pool = StagingPool(ex.max_inflight, device)

    def nbytes(shard: WorkShard) -> int:
        return shard_progress_bytes(shard, sizes[shard.file_path])

    def read_fn(shard: WorkShard):
        return _staged_read(pool, ex.stage_times, reader.open_input,
                            shard.file_path, shard.offset_from,
                            nbytes(shard))

    # the reader times its frame and decode stages into the executor's
    # StageTimes (spans under the chunk's span when tracing)
    reader.stage_times = ex.stage_times

    def process_fn(shard: WorkShard):
        def process(staged):
            with worker_stream(device):
                try:
                    return reader.read_shard(
                        staged, shard.file_order, shard.offset_from,
                        shard.record_index, sizes[shard.file_path],
                        prefix, path=shard.file_path)
                finally:
                    staged.close()
        return process

    finalizers = _finalizers(len(shards), output_schema, ex, on_batch)
    results = ex.run([(read_fn(s), process_fn(s), fin)
                      for s, fin in zip(shards, finalizers)],
                     chunk_meta=[{"bytes": nbytes(s)} for s in shards])
    ex.report["staging"] = pool.report()
    ex.attach(metrics)
    return results, ex.shard_failures
