"""Self-verifying durable state: checksums, quarantine, crash sweep.

Port copy of ``cobrix_tpu.io.integrity``: `corruption_counter` is
``cobrix_cache_corruption_total{plane}`` on the port's own metrics
registry (``obs.metrics``), as in the JAX package. `tools/fsckcache.py`
is not ported yet.

Every persistent artifact the io planes trust across process lifetimes
— block-cache entries, sparse-index payloads, the roofline calibration
— is written with a checksum and verified on read. Disk is not RAM: a
bit flipped by a failing device, a torn tail from a crashed copy, or a
partially-synced page after power loss must surface as a cache MISS
(rebuild transparently), never as silently corrupted scan output and
never as a crash.

The contract every plane implements through this module:

* **verify on read** — a payload whose checksum/length disagrees with
  its header is treated exactly like an absent entry;
* **quarantine, don't destroy** — the corrupt file is MOVED into
  ``<cache_root>/quarantine/`` (bounded count; oldest dropped) so an
  operator or `tools/fsckcache.py` can inspect what the disk did, while
  the live cache tree stays clean;
* **count** — every detection bumps
  ``cobrix_cache_corruption_total{plane=...}`` and the per-read
  ``IoStats`` corruption counters, so corruption is an alertable signal
  instead of an invisible self-heal;
* **crash-consistency sweep** — opening a cache root removes stale
  ``.tmp-*`` files (a writer that died between mkstemp and rename) and
  obviously-truncated entries, so a crash cannot slowly fill the volume
  with orphans.

The checksum is CRC-32 (zlib — in every CPython build, SIMD-accelerated
in zlib itself): this layer defends against *storage* corruption, not
adversaries; a keyed hash would buy nothing here and cost decode-path
bandwidth on every warm hit (the decode-throughput law says the scan is
bandwidth-bound — the verify pass must stay cheap).
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from typing import Optional

_logger = logging.getLogger(__name__)

# block-entry on-disk format: MAGIC + crc32(payload) + payload.
# Bumping MAGIC (or the layout) must also bump the consumer's generation
# /format key so old entries invalidate structurally, not per-read.
BLOCK_MAGIC = b"CBX2"
BLOCK_HEADER = len(BLOCK_MAGIC) + 4  # magic + big-endian crc32

# temp files older than this are orphans (no atomic write takes minutes)
TMP_ORPHAN_AGE_S = 300.0

# bounded quarantine: corruption storms must not refill the volume the
# cache was evicted to protect
QUARANTINE_KEEP = 32

PLANES = ("block", "index", "roofline", "checkpoint", "fleet", "sink",
          "stats", "compress")


def checksum(data: bytes) -> int:
    """CRC-32 of `data` (the one checksum every plane uses)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def frame_block(payload: bytes) -> bytes:
    """A block-cache entry's on-disk bytes: header + payload."""
    return BLOCK_MAGIC + struct.pack(">I", checksum(payload)) + payload


def unframe_block(data: bytes, expect_len: int) -> Optional[bytes]:
    """Verify one block entry read off disk; the payload on success,
    None on ANY disagreement (bad magic, torn tail, wrong length, crc
    mismatch) — the caller quarantines and treats it as a miss."""
    if len(data) < BLOCK_HEADER or data[:len(BLOCK_MAGIC)] != BLOCK_MAGIC:
        return None
    payload = data[BLOCK_HEADER:]
    if len(payload) != expect_len:
        return None
    (crc,) = struct.unpack(
        ">I", data[len(BLOCK_MAGIC):BLOCK_HEADER])
    if checksum(payload) != crc:
        return None
    return payload


def note_corruption(plane: str, path: str, detail: str,
                    io_stats=None) -> None:
    """Record one detected corruption: the per-read IoStats bag when a
    read is active (so `ReadMetrics` shows WHICH read self-healed;
    `ReadMetrics.finalize` folds it into the Prometheus counter exactly
    once, including counts merged home from forked multihost workers),
    the Prometheus counter directly otherwise (roofline reads, offline
    fsck), and a warning log naming the file either way. Cold path only
    — this runs when a checksum already failed, never on healthy
    hits."""
    if plane not in PLANES:
        plane = "other"
    key = {"block": "block_corrupt", "index": "index_corrupt",
           "compress": "compress_corrupt"}.get(plane)
    if key:
        if io_stats is None:
            from .stats import current_io_stats

            io_stats = current_io_stats()
        if io_stats is not None:
            io_stats.bump(key)
        else:
            corruption_counter().labels(plane=plane).inc()
    else:
        corruption_counter().labels(plane=plane).inc()
    _logger.warning("cache corruption detected (plane=%s): %s — %s; "
                    "entry quarantined and rebuilt transparently",
                    plane, path, detail)


def corruption_counter():
    """``cobrix_cache_corruption_total{plane}`` on the default registry
    (resolved lazily: integrity runs below obs in the import graph)."""
    from ..obs.metrics import default_registry

    return default_registry().counter(
        "cobrix_cache_corruption_total",
        "Persistent-state entries that failed checksum/structure "
        "verification on read, by plane (block/index/roofline); every "
        "count is a corrupt entry that was quarantined and rebuilt "
        "instead of being served",
        label_names=("plane",))


_QUARANTINE_LOCK = threading.Lock()


def quarantine(path: str, quarantine_root: str) -> str:
    """Move a corrupt file into `quarantine_root` under a unique name;
    returns the destination ('' when the move failed — the file is then
    unlinked so the corrupt entry cannot be served again either way).
    The quarantine is bounded at QUARANTINE_KEEP files (oldest
    dropped)."""
    base = os.path.basename(path)
    with _QUARANTINE_LOCK:
        try:
            os.makedirs(quarantine_root, exist_ok=True)
            dest = os.path.join(
                quarantine_root,
                f"{int(time.time() * 1000):x}-{os.getpid()}-{base}")
            os.replace(path, dest)
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
            return ""
        try:
            names = sorted(os.listdir(quarantine_root))
            for stale in names[:max(0, len(names) - QUARANTINE_KEEP)]:
                try:
                    os.unlink(os.path.join(quarantine_root, stale))
                except OSError:
                    pass
        except OSError:
            pass
    return dest


def sweep_cache_root(root: str,
                     min_entry_bytes: int = BLOCK_HEADER) -> dict:
    """Startup crash-consistency sweep of one cache tree: remove orphaned
    ``.tmp-*`` files (a writer that died between mkstemp and rename —
    they are invisible to readers but leak disk forever) and entries too
    short to even hold a header (torn creations from pre-atomic-write
    crashes). Returns counts for logging/fsck. Best-effort: a sweep
    failure must never fail the scan that triggered it."""
    removed = {"tmp_orphans": 0, "truncated": 0}
    now = time.time()
    try:
        walker = os.walk(root)
    except OSError:
        return removed
    for dirpath, dirs, files in walker:
        if os.path.basename(dirpath) == "quarantine":
            dirs[:] = []
            continue
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                if name.startswith(".tmp-"):
                    # another LIVE process may be mid-write: only reap
                    # temps old enough that no atomic write explains them
                    if now - os.path.getmtime(path) > TMP_ORPHAN_AGE_S:
                        os.unlink(path)
                        removed["tmp_orphans"] += 1
                elif (name.endswith(".blk")
                      and os.path.getsize(path) < min_entry_bytes):
                    os.unlink(path)
                    removed["truncated"] += 1
            except OSError:
                continue
    if removed["tmp_orphans"] or removed["truncated"]:
        _logger.info("cache sweep of %s: removed %d orphaned temp "
                     "file(s), %d truncated entr(ies)", root,
                     removed["tmp_orphans"], removed["truncated"])
    return removed


def verify_json_payload(payload: dict) -> bool:
    """Verify a JSON artifact carrying its own ``crc`` field (the
    sparse-index store and the roofline cache): the crc covers the
    canonical serialization of every OTHER field. False = corrupt or
    unchecksummed (old format)."""
    import json

    if not isinstance(payload, dict) or "crc" not in payload:
        return False
    body = {k: v for k, v in payload.items() if k != "crc"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    try:
        return int(payload["crc"]) == checksum(canon.encode("utf-8"))
    except (TypeError, ValueError):
        return False


def stamp_json_payload(payload: dict) -> dict:
    """Return `payload` with its ``crc`` field stamped (the write-side
    twin of `verify_json_payload`)."""
    import json

    body = {k: v for k, v in payload.items() if k != "crc"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    out = dict(body)
    out["crc"] = checksum(canon.encode("utf-8"))
    return out
