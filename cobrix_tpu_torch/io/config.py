"""IoConfig: one read's remote-IO knobs, and the source composition.

`open_stream` resolves a backend factory into a raw ByteRangeSource;
`wrap_source` stacks the io layers onto it:

    backend source  ->  CachingSource (persistent disk blocks)
                    ->  ReadAheadSource (in-memory read-ahead)

in that order, so prefetches warm the persistent cache and cache hits
never spend pool threads. Local files bypass the stack entirely —
FSStream already reads through the OS page cache, which IS the local
block cache.

The per-read IoStats sink is captured from the active read at wrap
time (open_stream runs on a thread the read activated), so counts from
the prefetch pool's internal threads still land on the right read.

Port copy of ``cobrix_tpu.io.config``; the active read's IoStats comes
from its observability context, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..reader.stream import ByteRangeSource

MEGABYTE = 1024 * 1024


@dataclass(frozen=True)
class IoConfig:
    """Remote-IO configuration for one read (reader.parameters carries
    the user-facing option spellings)."""

    cache_dir: str = ""              # '' = no persistent cache planes
    cache_max_bytes: int = 1024 * MEGABYTE
    prefetch_depth: int = 2          # blocks of read-ahead; 0 = off
    block_bytes: int = 8 * MEGABYTE  # cache + read-ahead granularity
    compression: str = "auto"        # codec name | 'auto' | 'none'
    compress_block_bytes: int = 4 * MEGABYTE  # decompressed-plane block
    permissive_errors: bool = False  # record_error_policy != fail_fast

    @classmethod
    def from_params(cls, params) -> Optional["IoConfig"]:
        """The read's IoConfig, or None when every io feature is off
        (plain buffered backend reads, exactly the pre-io behavior).
        A non-default compression option rides here too: the
        decompression plane needs a config even with cache/prefetch off
        (detection stays 'auto' either way — a None io still
        auto-detects with the default block size)."""
        cache_dir = getattr(params, "cache_dir", "") or ""
        prefetch = int(getattr(params, "prefetch_blocks", 0))
        compression = (getattr(params, "compression", "auto")
                       or "auto").lower()
        compress_block_mb = float(
            getattr(params, "compress_block_mb", 4.0) or 4.0)
        permissive = bool(getattr(params, "is_permissive", False))
        if (not cache_dir and prefetch <= 0 and compression == "auto"
                and compress_block_mb == 4.0 and not permissive):
            return None
        return cls(
            cache_dir=cache_dir,
            cache_max_bytes=int(
                float(getattr(params, "cache_max_mb", 1024.0)) * MEGABYTE),
            prefetch_depth=prefetch,
            block_bytes=max(1, int(
                float(getattr(params, "io_block_mb", 8.0)) * MEGABYTE)),
            compression=compression,
            compress_block_bytes=max(64 * 1024,
                                     int(compress_block_mb * MEGABYTE)),
            permissive_errors=permissive,
        )

    @property
    def cache_enabled(self) -> bool:
        return bool(self.cache_dir)

    @property
    def prefetch_enabled(self) -> bool:
        return self.prefetch_depth > 0


def wrap_source(source: ByteRangeSource, url: str,
                io: Optional[IoConfig],
                chunk_size: int,
                start_offset: int = 0,
                maximum_bytes: int = 0) -> Tuple[ByteRangeSource, int]:
    """Stack the configured io layers onto a backend source; returns
    (wrapped source, effective stream chunk size). With read-ahead on,
    the stream chunk shrinks to one block so the consumer's fills stay
    behind the prefetcher instead of swallowing the whole window in one
    giant read; the prefetch window stops at the consumer's byte-range
    bound so shard streams never fetch their neighbors' bytes."""
    if io is None:
        return source, chunk_size
    from .stats import current_io_stats

    io_stats = current_io_stats()
    if io.cache_enabled:
        from .blockcache import CachingSource, shared_block_cache

        # one fingerprint probe (a backend metadata round trip) per
        # read, not per chunk-stream open. Deliberately OUTSIDE the
        # degrade guard below: a failing BACKEND probe is a storage
        # error the caller must see, not a cache-volume problem
        key = ("fingerprint", url) if io_stats is not None else None
        fingerprint = io_stats.memo.get(key) if key else None
        if fingerprint is None:
            fingerprint = source.fingerprint()
            if key:
                io_stats.memo[key] = fingerprint
        try:
            cache = shared_block_cache(io.cache_dir, io.cache_max_bytes)
            source = CachingSource(source, url, cache, io.block_bytes,
                                   io_stats=io_stats,
                                   fingerprint=fingerprint)
        except OSError as exc:
            # an unusable cache VOLUME (read-only mount, full disk at
            # mkdir time) degrades to direct backend reads — a cache
            # must never be the reason a scan fails
            import logging

            logging.getLogger(__name__).warning(
                "block cache unavailable under %s (%s); reading "
                "without the persistent cache plane", io.cache_dir, exc)
    if io.prefetch_enabled:
        from .prefetch import ReadAheadSource

        limit = (start_offset + maximum_bytes) if maximum_bytes > 0 else 0
        source = ReadAheadSource(source, io.block_bytes,
                                 io.prefetch_depth, io_stats=io_stats,
                                 count_fetch_bytes=not io.cache_enabled,
                                 limit=limit)
        chunk_size = min(chunk_size, io.block_bytes)
    return source, chunk_size
