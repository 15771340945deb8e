"""Persisted seekable inflate indexes: one discovery pass per
compressed file version.

A compressed input hides two things every planner needs: its
decompressed size and where inside the wire bytes a decoder can restart
(member/frame boundaries). The streaming discovery pass
(io/compress.py) learns both; this store persists them under
``<cache_dir>/compress/`` so a warm re-scan, a forked multihost worker,
or a failover replica sharing the cache volume seeks straight to the
right checkpoint instead of re-inflating the prefix.

Port copy of ``cobrix_tpu.io.compress_index``, unchanged.

Keying mirrors the sparse-index store (io/index_store.py): entries are
keyed by url + codec and validated against the **compressed file's
content fingerprint** (etag/ukey/size+mtime), so a re-uploaded feed can
never serve stale checkpoints. Payloads are CRC-32 stamped
(io/integrity.py) and verified on load; a corrupt entry is quarantined,
counted under the ``compress`` integrity plane, and treated as a miss —
the discovery pass simply re-runs. Writes are atomic so concurrent
processes share one cache directory safely.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..utils.atomic import write_atomic
from .integrity import (
    note_corruption,
    quarantine,
    stamp_json_payload,
    sweep_cache_root,
    verify_json_payload,
)

_logger = logging.getLogger(__name__)

# bump when the payload layout changes: old files become misses
_FORMAT = 1

_SWEPT_LOCK = threading.Lock()
_SWEPT_ROOTS: set = set()


@dataclass(frozen=True)
class InflateIndexEntry:
    """One compressed file version's seekable inflate index."""

    total: int        # decompressed byte size
    comp_size: int    # compressed byte size actually consumed
    # restartable (compressed_offset, decompressed_offset) checkpoints,
    # sorted by decompressed offset; always includes (0, 0) and the
    # final (comp_size, total) boundary
    checkpoints: Tuple[Tuple[int, int], ...]


class InflateIndexStore:
    def __init__(self, cache_dir: str):
        self.root = os.path.join(cache_dir, "compress")
        self.quarantine_root = os.path.join(cache_dir, "quarantine")
        os.makedirs(self.root, exist_ok=True)
        with _SWEPT_LOCK:
            swept = self.root in _SWEPT_ROOTS
            _SWEPT_ROOTS.add(self.root)
        if not swept:
            sweep_cache_root(self.root)

    def _path(self, url: str, codec: str) -> str:
        h = hashlib.sha256(
            f"{url}\x00{codec}".encode("utf-8", "replace"))
        return os.path.join(self.root, h.hexdigest()[:40] + ".json")

    def _corrupt(self, path: str, detail: str, io_stats=None) -> None:
        quarantine(path, self.quarantine_root)
        note_corruption("compress", path, detail, io_stats=io_stats)

    def load(self, url: str, codec: str, fingerprint: str,
             io_stats=None) -> Optional[InflateIndexEntry]:
        """The persisted index for this (url, codec, compressed file
        version) — or None (miss: absent, stale fingerprint, corrupt —
        corrupt payloads are additionally quarantined and counted)."""
        path = self._path(url, codec)
        try:
            with open(path, encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            payload = json.loads(raw)
        except ValueError:
            self._corrupt(path, "undecodable JSON payload", io_stats)
            return None
        if not isinstance(payload, dict) \
                or payload.get("format") != _FORMAT:
            return None  # older/newer format: a clean miss
        if not verify_json_payload(payload):
            # a bit-flipped checkpoint WOULD restart the decoder
            # mid-member and frame garbage — treat as a counted miss
            self._corrupt(path, "payload checksum mismatch", io_stats)
            return None
        if (payload.get("url") != url or payload.get("codec") != codec
                or payload.get("fingerprint") != fingerprint):
            return None
        try:
            checkpoints = tuple(sorted(
                (int(c), int(d)) for c, d in payload["checkpoints"]))
            entry = InflateIndexEntry(
                total=int(payload["total"]),
                comp_size=int(payload["comp_size"]),
                checkpoints=checkpoints)
        except (KeyError, TypeError, ValueError):
            self._corrupt(path, "checkpoint rows failed to deserialize",
                          io_stats)
            return None
        if entry.total < 0 or entry.comp_size < 0 or any(
                c < 0 or d < 0 or d > entry.total or c > entry.comp_size
                for c, d in entry.checkpoints):
            self._corrupt(path, "checkpoints out of range", io_stats)
            return None
        return entry

    def save(self, url: str, codec: str, fingerprint: str, total: int,
             comp_size: int,
             checkpoints: List[Tuple[int, int]]) -> None:
        """Persist one compressed file version's index (atomic;
        best-effort — a full disk degrades to re-discovery, never to a
        failed read)."""
        payload = stamp_json_payload({
            "format": _FORMAT,
            "url": url,
            "codec": codec,
            "fingerprint": fingerprint,
            "total": int(total),
            "comp_size": int(comp_size),
            "checkpoints": [[int(c), int(d)] for c, d in checkpoints],
        })
        path = self._path(url, codec)
        try:
            write_atomic(path, json.dumps(payload))
        except OSError as exc:
            _logger.warning("inflate-index save failed for %s: %s",
                            url, exc)
