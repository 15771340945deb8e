"""Persisted file profiles: the profiling pass runs once per file
version.

Mirrors the sparse-index store's contract (io/index_store.py) under a
sibling root, ``<cache_dir>/stats/``, plane="stats":

* keyed by the file's **content fingerprint** plus a **configuration
  fingerprint** covering everything that shapes what the profiler
  decodes — the copybook parse fingerprint and every framing parameter.
  Unlike the index store the split-grid knobs are deliberately
  EXCLUDED: the skip algorithm (stats/skip.py) reasons about byte-range
  coverage, so a profile collected on the canonical stats grid serves a
  scan planned on any other record-aligned grid.
* atomic writes, CRC-stamped payloads, quarantine + a
  ``cobrix_cache_corruption_total{plane="stats"}`` count on corruption,
  and a clean (uncounted) miss on format or key mismatch. A corrupt or
  stale entry can therefore never cause a wrong skip — the consumer
  simply sees "no profile" and scans everything.

Port copy of ``cobrix_tpu.stats.store``. Change from the JAX package:
the configuration fingerprint leads with the package's name, as the
port's sparse-index key does (``io/index_store.py``), so a ``cache_dir``
shared with the JAX package is a clean miss each way: neither package
ever reads the other's profile.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Optional

from ..utils.atomic import write_atomic
from ..io.integrity import (
    note_corruption,
    quarantine,
    stamp_json_payload,
    sweep_cache_root,
    verify_json_payload,
)
from .profile import PROFILE_FORMAT, FileProfile

_logger = logging.getLogger(__name__)

# bump when the envelope layout changes: old files become misses
# (PROFILE_FORMAT covers the inner profile payload separately)
_FORMAT = 1

# crash-consistency sweep once per root per process
_SWEPT_LOCK = threading.Lock()
_SWEPT_ROOTS: set = set()


def stats_config_fingerprint(copybook_fingerprint, params) -> str:
    """Digest of every input that shapes what the profiler decodes for
    one configuration. The index store's enumeration minus the
    split-grid knobs (input_split_records/input_split_size_mb and the
    stats grid itself): profiles are grid-independent by design, and
    filter/select/pipeline knobs never change decoded values."""
    seg = params.multisegment
    token = repr((
        "cobrix_tpu_torch",
        _FORMAT,
        copybook_fingerprint,
        params.is_record_sequence,
        params.is_rdw_big_endian,
        params.is_rdw_part_of_record_length,
        params.rdw_adjustment,
        params.record_length_override,
        params.length_field_name,
        params.is_text,
        params.variable_size_occurs,
        params.record_extractor,
        params.re_additional_info,
        params.record_header_parser,
        params.rhp_additional_info,
        params.start_offset,
        params.end_offset,
        params.file_start_offset,
        params.file_end_offset,
        params.record_error_policy,
        params.resync_window_bytes,
        (seg.segment_id_field, tuple(seg.segment_level_ids),
         tuple(sorted(seg.field_parent_map.items())),
         tuple(sorted(seg.segment_id_redefine_map.items())))
        if seg else None,
    ))
    return hashlib.sha256(token.encode("utf-8", "replace")).hexdigest()


def local_fingerprint(path: str) -> Optional[str]:
    """The ``local:<size>:<mtime_ns>`` content fingerprint for the
    CURRENT on-disk version of a local file, or None when it cannot be
    stat'd — matches ByteRangeSource.fingerprint() for local files."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f"local:{st.st_size}:{st.st_mtime_ns}"


class StatsStore:
    def __init__(self, cache_dir: str):
        self.root = os.path.join(cache_dir, "stats")
        self.quarantine_root = os.path.join(cache_dir, "quarantine")
        os.makedirs(self.root, exist_ok=True)
        with _SWEPT_LOCK:
            swept = self.root in _SWEPT_ROOTS
            _SWEPT_ROOTS.add(self.root)
        if not swept:
            sweep_cache_root(self.root)

    def _path(self, url: str, config_fp: str) -> str:
        h = hashlib.sha256(
            f"{url}\x00{config_fp}".encode("utf-8", "replace"))
        return os.path.join(self.root, h.hexdigest()[:40] + ".json")

    def _corrupt(self, path: str, detail: str) -> None:
        quarantine(path, self.quarantine_root)
        note_corruption("stats", path, detail)

    def load(self, url: str, fingerprint: str,
             config_fp: str) -> Optional[FileProfile]:
        """The persisted profile for this (url, file version, config) —
        or None (miss: absent, stale fingerprint, corrupt — corrupt
        payloads are additionally quarantined and counted). A miss is
        always safe: the scan falls back to reading every chunk."""
        path = self._path(url, config_fp)
        try:
            with open(path, encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return None
        except UnicodeDecodeError:
            self._corrupt(path, "non-UTF-8 payload bytes")
            return None
        try:
            payload = json.loads(raw)
        except ValueError:
            # not even JSON: a torn write or foreign bytes, not a stale
            # entry — wrong data wearing this key's name
            self._corrupt(path, "undecodable JSON payload")
            return None
        if not isinstance(payload, dict) \
                or payload.get("format") != _FORMAT:
            return None  # older/newer format: a clean miss
        if not verify_json_payload(payload):
            # structurally valid JSON whose checksum disagrees: the
            # classic bit-flip that WOULD have skipped chunks that
            # actually carry matching records
            self._corrupt(path, "payload checksum mismatch")
            return None
        if (payload.get("url") != url
                or payload.get("fingerprint") != fingerprint
                or payload.get("config") != config_fp):
            return None
        doc = payload.get("profile")
        if not isinstance(doc, dict) \
                or doc.get("profile_format") != PROFILE_FORMAT:
            return None  # inner-format bump: a clean miss
        try:
            return FileProfile.from_payload(doc)
        except (KeyError, TypeError, ValueError):
            self._corrupt(path, "profile payload failed to deserialize")
            return None

    def save_for_local_path(self, path: str, config_fp: str,
                            profile: FileProfile) -> bool:
        """Persist `profile` for the CURRENT on-disk version of a local
        file. False when the file cannot be stat'd (vanished between
        profiling and save)."""
        fingerprint = local_fingerprint(path)
        if fingerprint is None:
            return False
        self.save(path, fingerprint, config_fp, profile)
        return True

    def save(self, url: str, fingerprint: str, config_fp: str,
             profile: FileProfile) -> None:
        """Persist one file version's profile (atomic; best-effort — a
        full disk degrades to re-profiling, never to a failed read)."""
        payload = stamp_json_payload({
            "format": _FORMAT,
            "url": url,
            "fingerprint": fingerprint,
            "config": config_fp,
            "profile": profile.to_payload(),
        })
        path = self._path(url, config_fp)
        try:
            write_atomic(path, json.dumps(payload))
        except OSError as exc:
            _logger.warning("stats save failed for %s: %s", url, exc)
