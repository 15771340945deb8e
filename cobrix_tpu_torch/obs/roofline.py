"""Host memory-bandwidth roofline: STREAM-style triad calibration.

The decode-throughput law (arxiv 2606.22423, PAPERS.md) says a decode
kernel's ceiling is the memory system, so MB/s alone cannot say whether
a regression is real or the machine changed — achieved bytes/s must be
reported as a FRACTION of the measured bandwidth. This module measures
that bandwidth once per machine with a numpy STREAM triad
(``a = b + s * c`` over arrays far larger than cache; 24 bytes move
per element under the STREAM counting convention) and caches the result
on disk so every consumer — `ReadMetrics`, `bench.py`, the
``cobrix_roofline_fraction`` Prometheus gauge, `ScanReport` — anchors
against the same number.

Cache location: see below (one JSON object; written with
temp + atomic rename like io/blockcache.py). Reads NEVER trigger a
calibration implicitly — `cached_bandwidth()` only reads; a scan on an
uncalibrated machine simply reports no roofline. `bench.py` (and
`explain(..., calibrate=True)`) call `measured_bandwidth()` which
calibrates on a cold cache, paying the ~1s once.

Port copy of ``cobrix_tpu.obs.roofline``. It stays a HOST-memory
roofline, as in the JAX package: the card's own bounds are computed per
kernel by ``chip_smoke.py``. Change: the cache is the port's own file,
``$COBRIX_TPU_TORCH_ROOFLINE_CACHE`` when set, else
``~/.cache/cobrix_tpu_torch/roofline.json``, so the two packages never
read, write or quarantine each other's calibration.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

# Byte accounting for the numpy "triad": numpy cannot fuse
# ``a = b + s * c``, so the measurement is TWO passes —
# ``a = s * c`` (read c, write a: 16 B/elem) then ``a += b`` (read a,
# read b, write a: 24 B/elem) — 40 bytes moved per element, NOT the
# fused-kernel STREAM convention's 24 (write-allocate traffic stays
# uncounted either way, matching published STREAM practice). Counting
# 24 here would understate bandwidth ~40% and let scans report >100%
# "of the hardware limit".
_TRIAD_BYTES_PER_ELEM = 40

# cache records from a different method/accounting are stale and must
# recalibrate, not silently anchor fractions to a wrong basis
_METHOD = "numpy_stream_triad_2pass"

_lock = threading.Lock()
_memo: Optional[dict] = None  # in-process copy of the cache file


def cache_path() -> str:
    env = os.environ.get("COBRIX_TPU_TORCH_ROOFLINE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "cobrix_tpu_torch", "roofline.json")


def calibrate(size_mb: float = 128.0, repeats: int = 3) -> dict:
    """Run the triad and return the calibration record (does not touch
    the cache). `size_mb` is the per-array size; the default keeps each
    of the three arrays far beyond any L3."""
    n = max(1, int(size_mb * 1024 * 1024) // 8)
    b = np.full(n, 1.5, dtype=np.float64)
    c = np.full(n, 0.5, dtype=np.float64)
    a = np.empty(n, dtype=np.float64)
    s = 3.0
    best = float("inf")
    np.add(b, c, out=a)  # touch every page before timing
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        np.multiply(c, s, out=a)
        np.add(a, b, out=a)
        best = min(best, time.perf_counter() - t0)
    bw = _TRIAD_BYTES_PER_ELEM * n / best
    return {
        "bandwidth_bytes_per_s": round(bw, 1),
        "method": _METHOD,
        "array_mb": size_mb,
        "best_triad_s": round(best, 6),
        "calibrated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def _read_cache() -> Optional[dict]:
    """The on-disk calibration, verified (io/integrity.py): a corrupted
    record would silently re-anchor every roofline fraction on this
    machine to a wrong basis — benchgate comparisons, SLO roofline_min
    objectives, the Prometheus gauge. A record failing its checksum is
    quarantined (next to the cache file), counted on
    ``cobrix_cache_corruption_total{plane="roofline"}``, and treated as
    uncalibrated, so the next `measured_bandwidth()` rebuilds it."""
    path = cache_path()
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError:
        return None
    except ValueError:
        _quarantine_cache(path, "undecodable JSON")
        return None
    if not isinstance(doc, dict):
        _quarantine_cache(path, "non-object payload")
        return None
    if "crc" in doc:
        from ..io.integrity import verify_json_payload

        if not verify_json_payload(doc):
            _quarantine_cache(path, "checksum mismatch")
            return None
    elif doc.get("method") == _METHOD:
        # same method but no checksum: a pre-integrity record whose
        # bytes can no longer be trusted end to end — recalibrate once
        # rather than anchor a fleet of fractions on unverifiable data
        return None
    if doc.get("bandwidth_bytes_per_s") and doc.get("method") == _METHOD:
        return doc
    return None


def _quarantine_cache(path: str, detail: str) -> None:
    from ..io.integrity import note_corruption, quarantine

    quarantine(path, os.path.join(os.path.dirname(path) or ".",
                                  "quarantine"))
    note_corruption("roofline", path, detail)


def _write_cache(record: dict) -> None:
    from ..io.integrity import stamp_json_payload
    from ..utils.atomic import write_atomic

    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # fsync: the calibration anchors every roofline fraction on this
    # machine; a zero-length file after a crash must not be possible.
    # The crc stamp lets readers detect the subtler failure: a file
    # that IS valid JSON but no longer the bytes that were written
    write_atomic(path, json.dumps(stamp_json_payload(record)),
                 fsync=True)


def cached_bandwidth() -> Optional[float]:
    """The calibrated bandwidth in bytes/s, or None when this machine
    has never calibrated. Never calibrates; safe on any read path. A
    miss is NOT memoized — a long-running process (serving tier) picks
    up a calibration another process writes later; the re-probe is one
    open() per uncalibrated scan."""
    global _memo
    with _lock:
        if _memo is None:
            doc = _read_cache()
            if doc is None:
                return None
            _memo = doc
        bw = _memo.get("bandwidth_bytes_per_s")
    return float(bw) if bw else None


def measured_bandwidth(force: bool = False,
                       size_mb: float = 128.0) -> float:
    """The calibrated bandwidth, calibrating (and caching) when the
    cache is cold or `force` is set — the bench / explain entry point."""
    global _memo
    if not force:
        bw = cached_bandwidth()
        if bw:
            return bw
    record = calibrate(size_mb=size_mb)
    try:
        _write_cache(record)
    except OSError:
        pass  # an unwritable cache dir degrades to per-process memory
    with _lock:
        _memo = record
    return float(record["bandwidth_bytes_per_s"])


def roofline_fraction(bytes_per_s: float) -> Optional[float]:
    """Achieved bytes/s as a fraction of the cached calibration; None
    when uncalibrated or the rate is non-positive."""
    bw = cached_bandwidth()
    if not bw or bytes_per_s <= 0:
        return None
    return round(bytes_per_s / bw, 4)


def roofline_summary(bytes_count: int, seconds: float) -> Optional[dict]:
    """{'bandwidth_GBps', 'achieved_MBps', 'fraction'} for one measured
    transfer, or None when uncalibrated / unmeasurable."""
    bw = cached_bandwidth()
    if not bw or seconds <= 0 or bytes_count <= 0:
        return None
    rate = bytes_count / seconds
    return {
        "bandwidth_GBps": round(bw / 1e9, 2),
        "achieved_MBps": round(rate / (1024 * 1024), 1),
        "fraction": round(rate / bw, 4),
    }
