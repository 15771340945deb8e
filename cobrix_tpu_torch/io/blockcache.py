"""Persistent on-disk block cache for remote byte-range sources.

Layout under `<cache_dir>/blocks/`:

    <h(url)>-<h(fingerprint)>/          one *generation* per file version
        meta.json                       {url, fingerprint} (debuggability)
        <start>-<end>.blk               one cached block, aligned ranges

The fingerprint (etag / ukey / size+mtime — whatever the backend can
produce, `ByteRangeSource.fingerprint()`) keys the generation: a changed
remote file hashes to a NEW generation directory, and stale generations
of the same url are removed on open, so invalidation is structural, not
a TTL guess.

Cross-process safety: block writes go through a temp file + `os.replace`
(atomic on POSIX), readers treat a vanished file as a miss, and two
processes writing the same block converge on identical bytes (ranges are
deterministic slices of an immutable file version). LRU eviction is by
file mtime — hits re-touch their block — with a bounded rescan whenever
the tracked total passes the budget.

Integrity (io/integrity.py): every block is stored as
``magic + crc32(payload) + payload`` and VERIFIED on read — a
bit-flipped, truncated, or foreign file is quarantined under
``<cache_dir>/quarantine/``, counted on
``cobrix_cache_corruption_total{plane="block"}``, and served as a miss
(the caller refetches from storage), never decoded into wrong scan
output. The entry format is part of the generation key, so a format
bump invalidates old generations structurally; opening a cache root
also runs the crash-consistency sweep (orphaned temp files, torn
entries) once per process.

Port copy of ``cobrix_tpu.io.blockcache``. Change from the JAX package:
the peer tier (``io/peercache.py``: a warm fleet peer answering a local
miss over the serve wire protocol, and `raw_block_entry`, its on-disk
peek) is left out with the serve tier (ROADMAP A8), so a miss goes
straight to the backend and the ``peer_*`` counters stay 0.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

from ..reader.stream import ByteRangeSource
from ..utils.atomic import write_atomic
from .integrity import (
    frame_block,
    note_corruption,
    quarantine,
    sweep_cache_root,
    unframe_block,
)
from .stats import IoStats

_logger = logging.getLogger(__name__)

# entry-format generation token: folded into the generation-directory
# hash so a changed on-disk block layout invalidates every existing
# generation structurally (the stale-url sweep removes them) instead of
# failing verification entry by entry
_BLOCK_FORMAT = "blkv2"


def _h(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:20]


def read_span(inner: ByteRangeSource, start: int, end: int) -> bytes:
    """Read [start, end) from `inner`, re-issuing on short reads (the
    readFully loop shared by the block cache and the prefetcher —
    aligned cache blocks must only ever be written complete). Stops at
    storage EOF: the result may still be short when the backend serves
    fewer bytes than size() promised."""
    data = b""
    while len(data) < end - start:
        chunk = inner.read(start + len(data), end - start - len(data))
        if not chunk:
            break
        data += chunk
    return data


class BlockCache:
    """The on-disk store (one shared instance per cache root — see
    `shared_block_cache`). Counters land on whichever read is active
    when a write/eviction happens (`current_io_stats`), so one instance
    serves concurrent reads without cross-attributing."""

    def __init__(self, cache_dir: str, max_bytes: int = 0,
                 sweep: bool = True):
        self.root = os.path.join(cache_dir, "blocks")
        self.quarantine_root = os.path.join(cache_dir, "quarantine")
        self.max_bytes = max(0, int(max_bytes))  # 0 = unbounded
        self._lock = threading.Lock()
        self._approx_total = -1  # lazily measured on first budget check
        self._gen_resolved: set = set()  # generation dirs already swept
        os.makedirs(self.root, exist_ok=True)
        if sweep:
            # crash-consistency sweep once per instance (and
            # shared_block_cache keeps one instance per root per
            # process): orphaned .tmp-* writers, torn creations
            sweep_cache_root(self.root)

    # -- generation management ------------------------------------------

    def generation_dir(self, url: str, fingerprint: str) -> str:
        """This file version's directory, creating it and sweeping stale
        generations of the same url (the 'changed file invalidates the
        block plane' contract). Resolved once per (url, fingerprint):
        per-chunk stream opens skip the directory sweep."""
        url_h = _h(url)
        gen = os.path.join(
            self.root, f"{url_h}-{_h(f'{fingerprint}|{_BLOCK_FORMAT}')}")
        with self._lock:
            # isdir guards the revert case: a swept generation whose
            # fingerprint comes BACK (file restored) must be recreated
            if gen in self._gen_resolved and os.path.isdir(gen):
                return gen
        try:
            for name in os.listdir(self.root):
                stale = os.path.join(self.root, name)
                if name.startswith(url_h + "-") and stale != gen:
                    shutil.rmtree(stale, ignore_errors=True)
                    with self._lock:
                        self._gen_resolved.discard(stale)
        except OSError:
            pass
        if not os.path.isdir(gen):
            os.makedirs(gen, exist_ok=True)
            try:
                self._write_atomic(
                    os.path.join(gen, "meta.json"),
                    json.dumps({"url": url, "fingerprint": fingerprint},
                               sort_keys=True).encode())
            except OSError as exc:
                # meta.json is debuggability only: a full disk skips it
                # (block puts degrade the same way), never fails the scan
                _logger.warning("block cache meta write failed for %s: "
                                "%s", gen, exc)
        with self._lock:
            self._gen_resolved.add(gen)
        return gen

    # -- block IO --------------------------------------------------------

    @staticmethod
    def _block_path(gen_dir: str, start: int, end: int) -> str:
        return os.path.join(gen_dir, f"{start}-{end}.blk")

    def has(self, gen_dir: str, start: int, end: int) -> bool:
        """Cheap presence probe (no read, no LRU touch) — used by the
        coalescing scan to size one fetch over a run of missing blocks."""
        return os.path.exists(self._block_path(gen_dir, start, end))

    def get(self, gen_dir: str, start: int, end: int,
            io_stats: Optional[IoStats] = None) -> Optional[bytes]:
        path = self._block_path(gen_dir, start, end)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None  # missing OR evicted mid-race: a miss either way
        payload = unframe_block(data, end - start)
        if payload is None:
            # the disk lied: a torn tail, a flipped bit, a file shorter
            # than its aligned-range key, or a foreign format —
            # quarantine the entry and serve a MISS (the caller
            # refetches the true bytes from storage), never short or
            # wrong bytes into the record framer
            quarantine(path, self.quarantine_root)
            note_corruption(
                "block", path,
                f"{len(data)}B on disk for aligned range "
                f"[{start}, {end})", io_stats=io_stats)
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return payload

    def put(self, gen_dir: str, start: int, end: int, data: bytes,
            io_stats: Optional[IoStats] = None) -> None:
        """`io_stats` is the owning read's bag, passed by the caller:
        puts land on prefetch-pool threads where no obs context is
        active, so thread-local lookup would lose the counts."""
        if len(data) != end - start:
            return  # short tail reads are served but never cached
        path = self._block_path(gen_dir, start, end)
        if os.path.exists(path):
            return
        try:
            self._write_atomic(path, frame_block(data))
        except OSError as exc:  # a full cache disk must not fail the scan
            _logger.warning("block cache write failed for %s: %s", path, exc)
            return
        if io_stats is not None:
            io_stats.bump("block_put_bytes", len(data))
        self._account(len(data), io_stats)

    @staticmethod
    def _write_atomic(path: str, data: bytes) -> None:
        # no fsync: a lost-on-crash block simply re-fetches; the atomic
        # rename still guarantees no reader sees a partial block
        write_atomic(path, data)

    # -- LRU budget ------------------------------------------------------

    def _scan_blocks(self) -> List[Tuple[float, int, str]]:
        """(mtime, size, path) of every cached block under the root."""
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if not name.endswith(".blk"):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, path))
        return out

    def _account(self, added: int,
                 io_stats: Optional[IoStats] = None) -> None:
        if self.max_bytes <= 0:
            return
        with self._lock:
            if self._approx_total < 0:
                self._approx_total = sum(
                    s for _, s, _ in self._scan_blocks())
            else:
                self._approx_total += added
            if self._approx_total <= self.max_bytes:
                return
            # over budget: rescan (other processes write too) and evict
            # oldest-touched blocks until under
            blocks = sorted(self._scan_blocks())
            total = sum(s for _, s, _ in blocks)
            for _mtime, size, path in blocks:
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                if io_stats is not None:
                    io_stats.bump("block_evictions")
            self._approx_total = total


_SHARED_LOCK = threading.Lock()
_SHARED: Dict[str, "BlockCache"] = {}


def shared_block_cache(cache_dir: str, max_bytes: int) -> BlockCache:
    """ONE BlockCache per cache root per process: per-chunk stream opens
    reuse the instance (and its warm generation/size accounting) instead
    of re-sweeping the cache tree every open. Reads that configure
    different budgets for the same root share the instance — the
    last-configured budget wins, so accounting stays coherent (two
    instances with independent totals could not enforce either
    budget)."""
    root = os.path.abspath(cache_dir)
    with _SHARED_LOCK:
        cache = _SHARED.get(root)
        if cache is None:
            cache = BlockCache(cache_dir, max_bytes)
            _SHARED[root] = cache
        else:
            cache.max_bytes = max(0, int(max_bytes))
        return cache


class CachingSource(ByteRangeSource):
    """ByteRangeSource wrapper serving aligned blocks from a BlockCache,
    fetching misses from the inner source (consecutive missing blocks
    coalesce into ONE inner read) and writing them through."""

    def __init__(self, inner: ByteRangeSource, url: str, cache: BlockCache,
                 block_bytes: int, io_stats: Optional[IoStats] = None,
                 fingerprint: Optional[str] = None):
        self._inner = inner
        self._url = url
        self._cache = cache
        self._block = max(1, int(block_bytes))
        self._io_stats = io_stats
        self._size = inner.size()
        # the fingerprint probe pins the file version this cache
        # generation serves; a changed file opens a NEW generation.
        # Callers holding a per-read memo pass it in (one metadata round
        # trip per read, not per chunk open)
        self._fingerprint = fingerprint or inner.fingerprint()
        self._gen_dir = cache.generation_dir(url, self._fingerprint)

    def size(self) -> int:
        return self._size

    @property
    def name(self) -> str:
        return self._inner.name or self._url

    def fingerprint(self) -> str:
        # the pinned version, NOT a delegation: the sparse-index store
        # probes the stream's source, and re-probing the backend per
        # stream open would undo the per-read memo
        return self._fingerprint

    def close(self) -> None:
        self._inner.close()

    def _block_range(self, idx: int) -> Tuple[int, int]:
        start = idx * self._block
        return start, min(start + self._block, self._size)

    def _fetch_blocks(self, first: int, last: int) -> bytes:
        """One inner read spanning blocks [first, last] (coalesced),
        split and written through per aligned block."""
        start = first * self._block
        end = min((last + 1) * self._block, self._size)
        data = read_span(self._inner, start, end)
        if self._io_stats is not None:
            self._io_stats.bump("bytes_fetched", len(data))
        for idx in range(first, last + 1):
            bs, be = self._block_range(idx)
            piece = data[bs - start:be - start]
            if len(piece) == be - bs:
                self._cache.put(self._gen_dir, bs, be, piece,
                                io_stats=self._io_stats)
        return data

    def read(self, offset: int, n: int) -> bytes:
        if offset >= self._size or n <= 0:
            return b""
        n = min(n, self._size - offset)
        first = offset // self._block
        last = (offset + n - 1) // self._block
        parts: List[bytes] = []
        idx = first
        while idx <= last:
            bs, be = self._block_range(idx)
            cached = self._cache.get(self._gen_dir, bs, be,
                                     io_stats=self._io_stats)
            if cached is not None:
                if self._io_stats is not None:
                    self._io_stats.bump("block_hits")
                    self._io_stats.bump("bytes_from_cache", len(cached))
                parts.append(cached)
                idx += 1
                continue
            # coalesce the run of consecutive missing blocks
            run_end = idx
            while (run_end < last
                   and not self._cache.has(self._gen_dir,
                                           *self._block_range(run_end + 1))):
                run_end += 1
            if self._io_stats is not None:
                self._io_stats.bump("block_misses", run_end - idx + 1)
            fetched = self._fetch_blocks(idx, run_end)
            parts.append(fetched)
            span = (min((run_end + 1) * self._block, self._size)
                    - idx * self._block)
            if len(fetched) < span:
                # storage served less than size() promised (truncated
                # object under an unchanged fingerprint): STOP — joining
                # later cached blocks after a short part would shift
                # their bytes to wrong offsets. A short read is the
                # anomaly upper layers already know how to handle.
                break
            idx = run_end + 1
        data = b"".join(parts)
        lead = offset - first * self._block
        return data[lead:lead + n]
