"""Scan audit log + flight recorder: one record per request, forever.

Process-scoped telemetry (metrics.py aggregates, trace.py needs opt-in
per read) cannot answer the operator's first production question: *what
happened to THIS request?* This module keeps the request-scoped ledger:

* **ScanRecord** — one structured record per completed / failed /
  rejected scan: ids (request/trace/tenant), inputs, outcome, the three
  latencies that matter (queue wait, first batch, end-to-end), the
  roofline fraction, cache-plane hits, and the error string. Everything
  a support engineer greps for, as data.
* **AuditLog** — JSONL persistence with size-based rotation. Appends go
  through `utils.atomic.append_line` (one O_APPEND syscall per record),
  so concurrent writers interleave whole records; rotation renames
  ``audit.log`` -> ``audit.log.1`` -> ... under an in-process lock.
  `tools/scanlog.py` tails / filters / summarizes the output.
* **FlightRecorder** — an in-memory ring of the last N ScanRecords
  (the `/debug/recent` + `/debug/errors` source) that, for scans
  breaching a latency SLO or erroring, dumps the FULL per-request
  evidence (Chrome trace, field-cost table, the record itself) to
  ``dump_dir/<utc>-<request_id>/``. Post-hoc debuggability without
  writing a trace artifact per healthy request.

Nothing here runs per data record: one ScanRecord is built per request,
so the per-record decode hot path stays untouched (the zero-overhead
contract the tests counter-assert).

Port copy of ``cobrix_tpu.obs.audit``, unchanged.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

# NOTE: utils.atomic is imported lazily inside the writers — importing
# it at module scope would cycle through the package's utils -> api -> obs


@dataclass
class ScanRecord:
    """One scan's audit entry (the JSONL line, as a dataclass)."""

    request_id: str
    trace_id: str
    tenant: str
    # "ok" | "error" | "rejected" | "client_gone" (the peer hung up
    # mid-stream — not a scan-plane failure, so it neither burns SLOs
    # nor spends flight-recorder dumps)
    outcome: str
    ts: float = 0.0              # wall-clock unix seconds at completion
    files: List[str] = field(default_factory=list)
    rows: int = 0
    bytes_read: int = 0
    bytes_streamed: int = 0
    queue_wait_s: Optional[float] = None
    first_batch_s: Optional[float] = None
    e2e_s: Optional[float] = None
    roofline_fraction: Optional[float] = None
    # cache-plane hit counts for the warm/cold question: block/index
    # (persistent planes) and plan (compile caches), hits vs misses
    cache: Dict[str, int] = field(default_factory=dict)
    error: str = ""
    # SLO names this scan breached (obs.slo evaluation; empty = none)
    slo_breaches: List[str] = field(default_factory=list)
    # set when the flight recorder dumped this scan's evidence
    dump_path: str = ""
    # the ORIGINAL request_id when this scan resumed an interrupted
    # stream (replica failover): `tools/scanlog.py` groups the attempts
    # into one logical request by it, and SLO evaluation skips resumed
    # records entirely — the logical request's objectives were already
    # accounted once, a recovery attempt must never double-burn them
    resume_of: str = ""
    # True for continuous-ingest follow sessions (serve follow=true):
    # long-lived by design, so e2e latency objectives skip them
    follow: bool = False
    # query pushdown: records dropped before the full decode and the
    # scan's selectivity (kept/scanned; None when no filter ran) — a
    # tenant's filtered scans are distinguishable from tiny files
    records_pruned: int = 0
    selectivity: Optional[float] = None

    def as_dict(self) -> dict:
        out = asdict(self)
        # drop empty optionals so the JSONL stays grep-friendly
        return {k: v for k, v in out.items()
                if v not in (None, "", [], {})
                or k in ("request_id", "trace_id", "tenant", "outcome")}

    @classmethod
    def from_dict(cls, d: dict) -> "ScanRecord":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


def record_from_summary(request_id: str, trace_id: str, tenant: str,
                        files, summary: dict, outcome: str = "ok",
                        error: str = "",
                        queue_wait_s: Optional[float] = None,
                        first_batch_s: Optional[float] = None,
                        e2e_s: Optional[float] = None,
                        resume_of: str = "") -> ScanRecord:
    """Build a ScanRecord from a serving-session trailer summary (the
    rejected/failed paths pass a partial or empty summary)."""
    metrics = summary.get("metrics") or {}
    cache: Dict[str, int] = {}
    io = metrics.get("io") or {}
    for plane in ("block", "index"):
        for result in ("hits", "misses"):
            n = io.get(f"{plane}_{result}", 0)
            if n:
                cache[f"{plane}_{result}"] = int(n)
    plan = metrics.get("plan_cache") or {}
    for key, n in plan.items():
        if n and key.endswith("_hits"):
            cache[f"plan_{key}"] = int(n)
    roof = metrics.get("roofline") or {}
    pushdown = metrics.get("pushdown") or {}
    return ScanRecord(
        request_id=request_id, trace_id=trace_id, tenant=tenant,
        outcome=outcome, ts=time.time(),
        files=[str(f) for f in files],
        rows=int(summary.get("rows") or 0),
        bytes_read=int(metrics.get("bytes_read") or 0),
        bytes_streamed=int(summary.get("bytes") or 0),
        queue_wait_s=queue_wait_s, first_batch_s=first_batch_s,
        e2e_s=e2e_s,
        roofline_fraction=roof.get("fraction"),
        cache=cache, error=error,
        resume_of=resume_of or str(summary.get("resume_of") or ""),
        follow=bool(summary.get("follow")),
        records_pruned=int(pushdown.get("records_pruned") or 0),
        selectivity=pushdown.get("selectivity"))


class AuditLog:
    """Size-rotated JSONL scan log.

    ``AuditLog(path, max_mb=64, keep=3)`` keeps ``path`` under
    ``max_mb`` by renaming it to ``path.1`` (shifting ``.1`` -> ``.2``
    ... up to ``keep`` generations) before the append that would cross
    the budget. Appends are single O_APPEND writes; the rotation window
    is guarded by an in-process lock (multi-process deployments point
    each replica at its own file — the README runbook says so)."""

    def __init__(self, path: str, max_mb: float = 64.0, keep: int = 3):
        if not path:
            raise ValueError("AuditLog needs a file path")
        self.path = path
        self.max_bytes = int(max(0.0, float(max_mb)) * 1024 * 1024)
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self.records_written = 0
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    def append(self, record: ScanRecord) -> None:
        from ..utils.atomic import append_line

        line = json.dumps(record.as_dict(), sort_keys=True)
        with self._lock:
            if (self.max_bytes
                    and self._size + len(line) + 1 > self.max_bytes
                    and self._size > 0):
                self._rotate_locked()
            self._size += append_line(self.path, line)
            self.records_written += 1

    def _rotate_locked(self) -> None:
        # shift .1 -> .2 -> ... -> .keep; the replace into .keep
        # clobbers the oldest generation, so at most `keep` rotated
        # files ever exist
        for i in range(self.keep - 1, 0, -1):
            older = f"{self.path}.{i}"
            if os.path.exists(older):
                os.replace(older, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._size = 0

    def flush(self) -> None:
        """Durability point (graceful drain): fsync the file's bytes
        AND its directory entry, so both the appended records and the
        log's existence (O_CREAT / rotation renames) survive power
        loss. Appends are already syscalls — this is belt-and-braces
        for shutdown, not a per-record cost."""
        for target, flags in ((self.path, os.O_RDONLY),
                              (os.path.dirname(os.path.abspath(
                                  self.path)) or ".", os.O_RDONLY)):
            try:
                fd = os.open(target, flags)
            except OSError:
                continue
            try:
                os.fsync(fd)
            except OSError:
                pass
            finally:
                os.close(fd)


class FlightRecorder:
    """Ring of recent ScanRecords + on-breach evidence dumps.

    Every observed record lands in the ring (`recent()`, the `/debug`
    source). When a record carries SLO breaches or an error outcome AND
    a `dump_dir` is configured, the full evidence is written under
    ``dump_dir/<UTC>-<request_id>/``:

    * ``record.json``       — the ScanRecord
    * ``trace.json``        — the merged Chrome trace (when the scan
                              carried a tracer)
    * ``field_costs.json``  — the per-field cost table (when attribution
                              ran)

    Dump failures never propagate: losing evidence must not fail the
    scan whose evidence it was."""

    def __init__(self, ring_size: int = 64, dump_dir: str = "",
                 max_dumps: int = 200):
        self._ring: "deque[ScanRecord]" = deque(maxlen=max(1, ring_size))
        self._lock = threading.Lock()
        self.dump_dir = dump_dir
        # lifetime disk-fill guard, not a policy knob: a breach storm
        # must not fill the volume. Exhaustion is logged ONCE and
        # visible per record (BREACH with an empty dump_path)
        self.max_dumps = max(1, int(max_dumps))
        self.dumps_written = 0
        self._cap_logged = False

    def observe(self, record: ScanRecord, tracer=None,
                field_costs: Optional[dict] = None) -> Optional[str]:
        """Ring-append the record; dump evidence when it breached or
        errored. Returns the dump directory path when one was written
        (also recorded on ``record.dump_path``)."""
        dump = None
        if (self.dump_dir and record.outcome != "rejected"
                and (record.slo_breaches or record.outcome == "error")):
            try:
                dump = self._dump(record, tracer, field_costs)
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "flight-recorder dump failed for request %s",
                    record.request_id, exc_info=True)
        if dump:
            record.dump_path = dump
        with self._lock:
            self._ring.append(record)
        return dump

    def recent(self, n: int = 50,
               outcome: Optional[str] = None) -> List[ScanRecord]:
        """Latest-first slice of the ring, optionally by outcome."""
        with self._lock:
            records = list(self._ring)
        records.reverse()
        if outcome == "bad":
            records = [r for r in records if r.outcome != "ok"]
        elif outcome is not None:
            records = [r for r in records if r.outcome == outcome]
        return records[:max(0, n)]

    def _dump(self, record: ScanRecord, tracer,
              field_costs: Optional[dict]) -> Optional[str]:
        from ..utils.atomic import write_atomic

        with self._lock:  # check+claim atomically across handlers
            if self.dumps_written >= self.max_dumps:
                if not self._cap_logged:
                    self._cap_logged = True
                    import logging

                    logging.getLogger(__name__).warning(
                        "flight recorder reached its %d-dump lifetime "
                        "cap; further breaches keep their audit "
                        "records but no evidence dumps (raise "
                        "max_dumps or clear %s)",
                        self.max_dumps, self.dump_dir)
                return None
            self.dumps_written += 1
        try:
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            path = os.path.join(self.dump_dir,
                                f"{stamp}-{record.request_id}")
            os.makedirs(path, exist_ok=True)
            write_atomic(os.path.join(path, "record.json"),
                         json.dumps(record.as_dict(), indent=2,
                                    sort_keys=True))
            if tracer is not None:
                tracer.finish_root()  # idempotent; errored scans never
                write_atomic(         # got a finalize — root closes here
                    os.path.join(path, "trace.json"),
                    json.dumps(tracer.chrome_trace()))
            if field_costs:
                write_atomic(os.path.join(path, "field_costs.json"),
                             json.dumps(field_costs, indent=2,
                                        sort_keys=True))
        except BaseException:
            # a failed write (full/read-only volume) must not spend a
            # lifetime slot: refund it so capacity survives the outage
            with self._lock:
                self.dumps_written -= 1
            raise
        return path


def read_audit_log(path: str, include_rotated: bool = False):
    """Iterate ScanRecords from an audit log (oldest first). Malformed
    lines (a crash mid-rotation, a partial copy) are skipped, not
    fatal — an audit reader must work on the log you have."""
    paths = []
    if include_rotated:
        i = 1
        while os.path.exists(f"{path}.{i}"):
            paths.append(f"{path}.{i}")
            i += 1
        paths.reverse()  # oldest rotation first
    if os.path.exists(path):
        paths.append(path)
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield ScanRecord.from_dict(json.loads(line))
                except (ValueError, TypeError):
                    continue
