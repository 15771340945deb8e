"""Read-ahead prefetching for sequential byte-range consumers.

The scan engine consumes remote files almost perfectly sequentially
(BufferedSourceStream fills chunk after chunk; the pipeline's chunk
readers each walk one byte range) — which makes the access pattern
predictable enough to hide network latency entirely: while framing and
decode chew on block k, a small pool fetches blocks k+1..k+N. That is
the same overlap the chunked pipeline buys between *stages*, applied to
the network fetch itself — the decode-throughput papers' point that a
fast decoder leaves the scan bandwidth-bound is answered here, where
the bandwidth is produced.

`ReadAheadSource` wraps any ByteRangeSource (typically a CachingSource,
so prefetches also warm the persistent cache):

* reads are served block-aligned from an in-memory window of at most
  `depth + 2` blocks (bounded memory regardless of file size);
* after each consumer read, the next `depth` blocks are scheduled on
  the pool; consecutive missing blocks coalesce into ONE backend range
  request (`prefetch_issued` counts fetches, not blocks);
* a consumer read finding its block already fetched counts
  `prefetch_hits`; finding it in flight waits and counts
  `prefetch_waits`; blocks never consumed count `prefetch_unused` at
  close — utilization = issued minus unused over issued;
* a failed prefetch is re-raised on the consumer thread when the
  consumer reaches its block, where the stream's RetryPolicy already
  governs re-issue — the pool never retries on its own.

Port copy of ``cobrix_tpu.io.prefetch``. Change from the JAX package: a
failed prefetch stays in the window, its future holding the error, until
the consumer reaches its block; the consumer's read then re-raises it on
its own thread, under its retry policy, and drops the block, so the
re-issued read fetches it again. (The JAX package drops a failed block
at once, so the error reaches the consumer only when it was already
waiting, and a later read refetches it unseen, uncounted by
``io_retries``.)

The pool is created lazily on first read and torn down on close, so a
forked worker that inherited an un-started source builds its own
threads (and its own backend connection) after the fork — threads and
fds never cross process boundaries.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from ..obs.context import carry
from ..reader.stream import ByteRangeSource
from .stats import IoStats


class _Block:
    """One prefetch-window slot: a future (in flight) or bytes (done),
    plus whether the consumer ever read from it."""

    __slots__ = ("future", "data", "consumed", "prefetched")

    def __init__(self, future: Optional[Future] = None,
                 data: Optional[bytes] = None, prefetched: bool = False):
        self.future = future
        self.data = data
        self.consumed = False
        self.prefetched = prefetched


class ReadAheadSource(ByteRangeSource):
    def __init__(self, inner: ByteRangeSource, block_bytes: int,
                 depth: int, io_stats: Optional[IoStats] = None,
                 count_fetch_bytes: bool = False,
                 limit: int = 0):
        self._inner = inner
        self._block = max(1, int(block_bytes))
        self._depth = max(1, int(depth))
        self._io_stats = io_stats
        # True when this source sits directly on the backend (no
        # CachingSource below, which would already count bytes_fetched)
        self._count_fetch_bytes = count_fetch_bytes
        # the consumer's logical end (a byte-range shard stops at its
        # bound): read-ahead never schedules past it, so shard streams
        # don't fetch their neighbors' bytes. 0 = whole file
        self._limit = int(limit) if limit > 0 else 0
        self._size = inner.size()
        self._lock = threading.Lock()
        self._blocks: Dict[int, _Block] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False

    # -- ByteRangeSource surface ----------------------------------------

    def size(self) -> int:
        return self._size

    @property
    def name(self) -> str:
        return self._inner.name

    def fingerprint(self) -> str:
        return self._inner.fingerprint()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pool = self._pool
            self._pool = None
            unused = sum(1 for b in self._blocks.values()
                         if b.prefetched and not b.consumed)
            self._blocks.clear()
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        if unused and self._io_stats is not None:
            self._io_stats.bump("prefetch_unused", unused)
        self._inner.close()

    # -- internals -------------------------------------------------------

    def _block_range(self, idx: int) -> Tuple[int, int]:
        start = idx * self._block
        return start, min(start + self._block, self._size)

    def _last_block(self) -> int:
        end = min(self._size, self._limit) if self._limit else self._size
        return (end - 1) // self._block if end else -1

    def _fetch_range(self, first: int, last: int) -> Dict[int, bytes]:
        """One coalesced inner read covering blocks [first, last],
        re-issued on short reads, split per block."""
        from .blockcache import read_span

        start = first * self._block
        end = min((last + 1) * self._block, self._size)
        data = read_span(self._inner, start, end)
        if self._count_fetch_bytes and self._io_stats is not None:
            self._io_stats.bump("bytes_fetched", len(data))
        out = {}
        for idx in range(first, last + 1):
            bs, be = self._block_range(idx)
            out[idx] = data[bs - start:be - start]
        return out

    def _prefetch_task(self, first: int, last: int) -> None:
        try:
            blocks = self._fetch_range(first, last)
        except BaseException as exc:
            # the failed blocks stay in the window with the error: the
            # consumer re-raises it when it reaches them (`_get_block`)
            with self._lock:
                for idx in range(first, last + 1):
                    blk = self._blocks.get(idx)
                    if blk is not None and blk.data is None \
                            and blk.future is not None \
                            and not blk.future.done():
                        blk.future.set_exception(exc)
            return
        with self._lock:
            for idx, data in blocks.items():
                blk = self._blocks.get(idx)
                if blk is None:
                    continue
                blk.data = data
                if blk.future is not None and not blk.future.done():
                    blk.future.set_result(data)

    def _schedule_ahead(self, after: int) -> None:
        """Queue fetches for the `depth` blocks following `after`;
        consecutive unscheduled blocks go to the pool as one task."""
        last_wanted = min(after + self._depth, self._last_block())
        runs = []  # (first, last) of blocks needing a fetch
        with self._lock:
            if self._closed:
                return
            run_start = None
            for idx in range(after + 1, last_wanted + 1):
                if idx in self._blocks:
                    if run_start is not None:
                        runs.append((run_start, idx - 1))
                        run_start = None
                    continue
                self._blocks[idx] = _Block(future=Future(),
                                           prefetched=True)
                if run_start is None:
                    run_start = idx
            if run_start is not None:
                runs.append((run_start, last_wanted))
            if runs and self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._depth,
                    thread_name_prefix="cobrix-io-prefetch")
            pool = self._pool
        for first, last in runs:
            try:
                # the fetch runs in the read's observability context
                # (its IoStats, tracer and cache scope)
                pool.submit(carry(self._prefetch_task), first, last)
            except RuntimeError:  # closed between the lock and the submit
                with self._lock:
                    for idx in range(first, last + 1):
                        self._blocks.pop(idx, None)
                return
            if self._io_stats is not None:
                # counted per BLOCK (coalescing is an implementation
                # detail) so utilization = (issued - unused) / issued
                # stays in consistent units
                self._io_stats.bump("prefetch_issued", last - first + 1)

    def _evict_behind(self, before: int) -> None:
        """Drop completed blocks wholly before `before` (sequential
        consumers never look back; random access refetches)."""
        with self._lock:
            stale = [i for i, b in self._blocks.items()
                     if i < before and b.data is not None]
            # keep the window bounded even under pathological patterns
            if len(self._blocks) > self._depth + 2:
                done = sorted(i for i, b in self._blocks.items()
                              if b.data is not None and b.consumed)
                stale.extend(done[:len(self._blocks)
                                  - (self._depth + 2)])
            unused = 0
            for i in set(stale):
                blk = self._blocks.pop(i, None)
                if blk is not None and blk.prefetched \
                        and not blk.consumed:
                    unused += 1
        if unused and self._io_stats is not None:
            self._io_stats.bump("prefetch_unused", unused)

    def _get_block(self, idx: int) -> bytes:
        future: Optional[Future] = None
        with self._lock:
            blk = self._blocks.get(idx)
            if blk is not None and blk.data is not None:
                if self._io_stats is not None and blk.prefetched \
                        and not blk.consumed:
                    self._io_stats.bump("prefetch_hits")
                blk.consumed = True
                return blk.data
            if blk is not None and blk.future is not None:
                if self._io_stats is not None and blk.prefetched \
                        and not blk.consumed:
                    self._io_stats.bump("prefetch_waits")
                blk.consumed = True
                future = blk.future
            else:
                # sync fetch on the consumer thread (first touch, or a
                # re-read after a failed/evicted prefetch)
                blk = _Block()
                blk.consumed = True
                self._blocks[idx] = blk
        if future is not None:
            # wait outside the lock; a failed fetch leaves the window
            # here, so the caller's RetryPolicy re-read refetches it
            try:
                return future.result()
            except BaseException:
                with self._lock:
                    if self._blocks.get(idx) is blk:
                        del self._blocks[idx]
                raise
        data = self._fetch_range(idx, idx)[idx]
        with self._lock:
            cur = self._blocks.get(idx)
            if cur is not None:
                cur.data = data
        return data

    def read(self, offset: int, n: int) -> bytes:
        if self._closed:
            raise ValueError(f"read on closed source '{self.name}'")
        if offset >= self._size or n <= 0:
            return b""
        n = min(n, self._size - offset)
        first = offset // self._block
        last = (offset + n - 1) // self._block
        parts = []
        for idx in range(first, last + 1):
            part = self._get_block(idx)
            parts.append(part)
            bs, be = self._block_range(idx)
            if len(part) < be - bs:
                # short backend block (truncated object): joining later
                # blocks would misalign them — serve the short read
                break
        self._schedule_ahead(last)
        self._evict_behind(first)
        data = b"".join(parts)
        lead = offset - first * self._block
        return data[lead:lead + n]
