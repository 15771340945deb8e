"""Per-read remote-IO counters.

Port copy of ``cobrix_tpu.io.stats``. One `IoStats` rides on each
read's ``obs.context.ObsContext``, exactly like the compile-cache scope:
every thread working for the read — the caller, the pipeline's stage
threads, the index-shard pool, the threads a source starts (read-ahead,
block-cache writers) through ``obs.context.carry`` — sees the same
object, and `ReadMetrics` publishes the totals on ``as_dict()["io"]``
and into the metrics registry. `merge`, which folds forked multihost
workers' counts home, waits for them (ROADMAP A7).
"""
from __future__ import annotations

import threading
from typing import Dict

# every counter the io layer emits; dict key order is reporting order
KEYS = (
    "block_hits",         # block-cache reads served from disk
    "block_misses",       # block-cache reads that went to storage
    "block_put_bytes",    # bytes written into the block cache
    "block_evictions",    # cache files removed by the LRU budget
    "block_corrupt",      # block entries failing verification (quarantined)
    "index_hits",         # sparse-index store loads (no sequential pass)
    "index_misses",       # store lookups that fell through to a scan
    "index_saves",        # freshly-computed indexes persisted
    "index_corrupt",      # index payloads failing verification (quarantined)
    "prefetch_issued",    # read-ahead fetches scheduled
    "prefetch_hits",      # consumer reads served by a finished prefetch
    "prefetch_waits",     # consumer reads that waited on an in-flight one
    "prefetch_unused",    # prefetched blocks never consumed
    "bytes_fetched",      # bytes actually pulled from the storage backend
    "bytes_from_cache",   # bytes served from the persistent block cache
    "peer_hits",          # local misses answered by a warm fleet peer
    "peer_misses",        # peer-tier attempts that fell through to backend
    "bytes_from_peer",    # bytes served out of a peer's block cache
    "compressed_bytes_in",     # wire bytes fed through the inflater
    "decompressed_bytes_out",  # bytes the inflater produced this read
    "inflate_s",               # seconds spent inside codec decompress
    "inflate_skipped",         # decompressed blocks served without inflating
    "compress_corrupt",        # compressed-plane damage (stream or index)
)


class IoStats:
    """Thread-safe counter bag for one read's remote-IO activity."""

    __slots__ = ("_lock", "counts", "memo")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = dict.fromkeys(KEYS, 0)
        # per-read remote-metadata memo keyed ('size'|'fingerprint', url):
        # a backend metadata probe (fs.size/fs.ukey — a network round
        # trip each) runs once per read, not once per open/plan/validate
        # pass. Per-READ scope on purpose: the next read must re-probe so
        # a changed file still invalidates the cache planes.
        self.memo: Dict[tuple, object] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] += n

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    @property
    def is_zero(self) -> bool:
        with self._lock:
            return not any(self.counts.values())

    @property
    def prefetch_utilization(self) -> float:
        """Fraction of issued prefetches the consumer actually used
        (hit or waited on); 0.0 when none were issued."""
        with self._lock:
            issued = self.counts["prefetch_issued"]
            if not issued:
                return 0.0
            used = issued - self.counts["prefetch_unused"]
            return max(0.0, min(1.0, used / issued))


def current_io_stats() -> "IoStats | None":
    """The active read's IoStats (None outside a read). One thread-local
    lookup — safe on hot paths."""
    from ..obs.context import current

    ctx = current()
    return ctx.io_stats if ctx is not None else None
