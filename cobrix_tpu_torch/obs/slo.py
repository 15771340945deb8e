"""Declarative service-level objectives over the scan audit stream.

An operator declares what "good" means ONCE — as machine-independent
thresholds where possible — and every completed scan is classified
good/bad per objective. Three kinds cover the serving tier:

* ``first_batch`` / ``e2e`` — latency: the scan is good when its
  first-batch (or end-to-end) latency is at or under the threshold.
  Declared as a percentile target (``first_batch_p99=0.5``: 99% of
  scans must see a first batch within 500 ms).
* ``roofline`` — throughput, machine-independently: the scan is good
  when its achieved bytes/s is at least ``threshold`` of the calibrated
  host memory bandwidth (obs.roofline, the decode-throughput-law
  anchor). "The service regressed" and "this machine is slower" stop
  being the same alert. Scans without a calibration are not counted.
* ``error_rate`` — availability: every finished scan is good iff it
  completed ok (``error_rate=0.01`` = 99% objective).

Classification feeds two surfaces:

* Prometheus **good/bad counters** (``cobrix_slo_good_total`` /
  ``cobrix_slo_bad_total``, labeled ``slo``/``tenant``) — the
  burn-rate-friendly shape: ``bad/(good+bad)`` over two windows is the
  standard multi-window burn-rate alert, no histogram quantile math.
* the **status document** (`SloTracker.status()`) served on `/healthz`
  and `/debug/slo`: per-objective totals, the observed good ratio, and
  whether the error budget is currently burning.

Evaluation is one comparison per objective per SCAN (never per record),
so SLO tracking adds nothing to the decode hot path.

Port copy of ``cobrix_tpu.obs.slo``, unchanged.
"""
from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import default_registry

_SLO_SYNTAX = re.compile(
    r"^(?:(first_batch|e2e)_p(\d{1,2}(?:\.\d+)?)"
    r"|(roofline)_min|(error)_rate)=([0-9.]+)$")


@dataclass(frozen=True)
class Slo:
    """One objective: `name` is the Prometheus label value, `kind` the
    classifier, `threshold` the per-scan good/bad cut, `objective` the
    target good ratio the error budget is measured against."""

    name: str
    kind: str           # "first_batch" | "e2e" | "roofline" | "error_rate"
    threshold: float
    objective: float = 0.99

    def evaluate(self, record) -> Optional[bool]:
        """True = good, False = bad, None = not applicable to this
        record. Only 'ok' and 'error' outcomes count: rejected means
        admission did its job, client_gone means the CLIENT hung up —
        neither is the scan plane failing its objective. Latency kinds
        also skip scans without the measurement."""
        if record.outcome not in ("ok", "error"):
            return None
        if getattr(record, "resume_of", ""):
            # a recovery attempt of an already-accounted logical
            # request (replica failover): evaluating it again would
            # double-burn latency objectives — a resumed scan's "first
            # batch" sits behind a skip of everything already delivered
            return None
        if getattr(record, "follow", False) \
                and self.kind in ("e2e", "roofline"):
            # a follow session streams a LIVE feed for as long as the
            # subscriber stays — wall-clock duration and aggregate
            # throughput measure the feed, not the server; first-batch
            # and error-rate objectives still apply
            return None
        if self.kind == "error_rate":
            return record.outcome == "ok"
        if record.outcome != "ok":
            # a failed scan has no honest latency sample, but it DID
            # burn the user's budget for this objective too
            return False
        if self.kind == "first_batch":
            v = record.first_batch_s
            return None if v is None else v <= self.threshold
        if self.kind == "e2e":
            v = record.e2e_s
            return None if v is None else v <= self.threshold
        if self.kind == "roofline":
            v = record.roofline_fraction
            return None if v is None else v >= self.threshold
        return None


def parse_slo(spec: str) -> Slo:
    """One CLI/config objective. Accepted shapes::

        first_batch_p99=0.5    99% of scans: first batch within 0.5 s
        e2e_p95=3.0            95% of scans: done within 3 s
        roofline_min=0.05      99% of scans: >= 5% of host bandwidth
        error_rate=0.01        error budget: 1% of scans may fail
    """
    m = _SLO_SYNTAX.match(spec.strip())
    if not m:
        raise ValueError(
            f"unrecognized SLO spec {spec!r}; expected one of "
            "'first_batch_pNN=SECONDS', 'e2e_pNN=SECONDS', "
            "'roofline_min=FRACTION', 'error_rate=FRACTION'")
    latency_kind, pct, roofline, error, value = m.groups()
    value = float(value)
    if latency_kind:
        return Slo(name=f"{latency_kind}_p{pct}", kind=latency_kind,
                   threshold=value, objective=float(pct) / 100.0)
    if roofline:
        if not 0.0 < value <= 1.0:
            raise ValueError(
                f"roofline_min wants a fraction in (0, 1], got {value}")
        return Slo(name="roofline_min", kind="roofline", threshold=value)
    if not 0.0 <= value < 1.0:
        raise ValueError(
            f"error_rate wants a fraction in [0, 1), got {value}")
    return Slo(name="error_rate", kind="error_rate", threshold=value,
               objective=1.0 - value)


def parse_slos(specs: Sequence[str]) -> List[Slo]:
    slos = [parse_slo(s) for s in specs]
    names = [s.name for s in slos]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate SLO name(s): {sorted(dupes)}")
    return slos


# multi-window burn rates: the standard fast/slow alert pair — the fast
# window catches a cliff (page), the slow window catches a leak
# (ticket). Events are bucketed so the memory is bounded: at most
# slow_window/bucket entries per (slo, tenant) ever exist.
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0
_BURN_BUCKET_S = 5.0


class SloTracker:
    """Per-scan evaluation + good/bad counters + status document.

    Besides lifetime totals, the tracker keeps time-bucketed good/bad
    counts per (slo, tenant) so `burn()` can answer "what fraction of
    the error budget is being spent RIGHT NOW" over a fast and a slow
    window — the multi-window burn-rate shape the fleet rollup
    (fleet/federate.py) aggregates across replicas. burn > 1.0 means
    the budget is being spent faster than the objective allows."""

    def __init__(self, slos: Sequence[Slo], registry=None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 clock=None):
        self.slos = list(slos)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._clock = clock or time.monotonic
        r = registry or default_registry()
        self._good = r.counter(
            "cobrix_slo_good_total",
            "Scans meeting the objective, by SLO and tenant "
            "(burn rate = bad / (good + bad))",
            label_names=("slo", "tenant"))
        self._bad = r.counter(
            "cobrix_slo_bad_total",
            "Scans violating the objective, by SLO and tenant",
            label_names=("slo", "tenant"))
        self._lock = threading.Lock()
        # in-process totals for status(): counter children are labeled
        # per tenant; the health view wants the cross-tenant aggregate
        self._totals: Dict[str, List[int]] = {
            s.name: [0, 0] for s in self.slos}
        # (slo, tenant) -> deque of [bucket_start_s, good, bad]
        self._windows: Dict[Tuple[str, str], deque] = {}

    def _note_window_locked(self, slo_name: str, tenant: str,
                            good: bool) -> None:
        now = self._clock()
        bucket = now - (now % _BURN_BUCKET_S)
        dq = self._windows.setdefault((slo_name, tenant), deque())
        if dq and dq[-1][0] == bucket:
            dq[-1][1 if good else 2] += 1
        else:
            dq.append([bucket, 1 if good else 0, 0 if good else 1])
        horizon = now - self.slow_window_s - _BURN_BUCKET_S
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def observe(self, record) -> List[str]:
        """Classify one ScanRecord against every objective; returns the
        names of the objectives it BREACHED (for the flight recorder).
        Also stamps ``record.slo_breaches``."""
        breaches: List[str] = []
        for slo in self.slos:
            good = slo.evaluate(record)
            if good is None:
                continue
            (self._good if good else self._bad).labels(
                slo=slo.name, tenant=record.tenant).inc()
            with self._lock:
                self._totals[slo.name][0 if good else 1] += 1
                self._note_window_locked(slo.name, record.tenant, good)
            if not good:
                breaches.append(slo.name)
        record.slo_breaches = breaches
        return breaches

    def _window_counts_locked(self, slo_name: str, window_s: float,
                              tenant: Optional[str] = None
                              ) -> Tuple[int, int]:
        now = self._clock()
        horizon = now - window_s - _BURN_BUCKET_S
        good = bad = 0
        for (name, t), dq in self._windows.items():
            if name != slo_name:
                continue
            if tenant is not None and t != tenant:
                continue
            for bucket, g, b in dq:
                if bucket >= horizon:
                    good += g
                    bad += b
        return good, bad

    def burn(self, slo: Slo, window_s: float,
             tenant: Optional[str] = None) -> dict:
        """Error-budget burn over a trailing window: ``ratio`` is the
        bad fraction of scans in the window, ``burn`` that ratio over
        the budget fraction ``1 - objective`` (the conventional burn
        rate: 1.0 = spending exactly at the objective's allowance).
        None fields when the window saw no evaluated scans."""
        with self._lock:
            good, bad = self._window_counts_locked(
                slo.name, window_s, tenant)
        seen = good + bad
        ratio = (bad / seen) if seen else None
        budget = 1.0 - slo.objective
        rate = (None if ratio is None
                else (ratio / budget if budget > 0
                      else (0.0 if ratio == 0 else float("inf"))))
        return {"window_s": window_s, "good": good, "bad": bad,
                "ratio": round(ratio, 6) if ratio is not None else None,
                "burn": round(rate, 4) if rate is not None else None}

    def status(self) -> dict:
        """Per-objective summary for /healthz + /debug/slo: lifetime
        totals plus the fast/slow window burn rates."""
        out = {}
        with self._lock:
            totals = {k: tuple(v) for k, v in self._totals.items()}
        for slo in self.slos:
            good, bad = totals[slo.name]
            seen = good + bad
            ratio = (good / seen) if seen else None
            out[slo.name] = {
                "kind": slo.kind,
                "threshold": slo.threshold,
                "objective": slo.objective,
                "good": good,
                "bad": bad,
                "ratio": round(ratio, 6) if ratio is not None else None,
                # burning: the observed ratio is under the objective —
                # the budget is being spent faster than allowed
                "burning": bool(seen and ratio < slo.objective),
                "burn_fast": self.burn(slo, self.fast_window_s),
                "burn_slow": self.burn(slo, self.slow_window_s),
            }
        return out
