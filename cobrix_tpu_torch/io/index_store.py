"""Persisted sparse indexes: the sequential VRL pass runs once per
file version.

The variable-length sparse index (reader/index.py) is the bridge from
an inherently-sequential record stream to parallel byte-range shards —
and it is the one pass that cannot be parallelized, so on a remote file
it costs a full sequential download before any shard decodes. This
store persists the computed entries under `<cache_dir>/index/`, keyed
by:

* the file's **content fingerprint** (`ByteRangeSource.fingerprint()` —
  etag/ukey/size+mtime), so a changed file can never serve a stale
  index, and
* a **configuration fingerprint** covering everything that shapes index
  generation: the copybook parse fingerprint (text + parse options) and
  every framing/split parameter — two reads with different split sizes
  or RDW settings key to different entries.

Entries are stored without their file_id: multi-file ordering is a
property of the *read*, not the file, so the loader re-stamps the
current file_order. Writes are atomic (temp + rename) and loads treat
any malformed/incompatible payload as a miss, so concurrent processes
can share one cache directory safely.

Port copy of ``cobrix_tpu.io.index_store``. Change from the JAX
package: `index_config_fingerprint` is salted with the port's name, so
the two packages sharing one cache directory never serve each other's
entries (their indexes of fixed-length records differ, ROADMAP C6), and
covers `is_index_generation_needed` and the reader's framing route
(RDW scan, fixed arithmetic or the generic per-record walk) beside the
JAX package's list; the copybook component is the port's
``plan.cache.parse_fingerprint``. `save_for_local_path`, which only the
continuous-ingest tailer calls, is left out with it (ROADMAP A8).

Integrity (io/integrity.py): payloads carry a CRC-32 over their
canonical serialization, verified on load. A bit-flipped entry — which
would otherwise deserialize into WRONG shard offsets and frame garbage
records — is quarantined, counted on
``cobrix_cache_corruption_total{plane="index"}``, and treated as a
miss, so the sequential index pass simply re-runs and re-persists.
Undecodable JSON (a torn write from a pre-atomic crash) counts as
corruption too; a clean format/fingerprint mismatch stays an ordinary
(uncounted) miss.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import List, Optional

from ..reader.index import SparseIndexEntry
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
# (2 = checksummed payloads, io/integrity.py)
_FORMAT = 2

# crash-consistency sweep once per root per process (the store itself
# is constructed per file per read)
_SWEPT_LOCK = threading.Lock()
_SWEPT_ROOTS: set = set()


def index_config_fingerprint(reader, params) -> str:
    """Digest of every input that shapes sparse-index generation for
    one reader configuration (anything missing here risks serving an
    index computed under different framing — enumerate generously)."""
    seg = params.multisegment
    token = repr((
        "cobrix_tpu_torch",
        _FORMAT,
        getattr(reader, "copybook_fingerprint", None),
        params.is_index_generation_needed,
        bool(getattr(reader, "generic_framing", False)),
        params.input_split_records,
        params.input_split_size_mb,
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


class SparseIndexStore:
    def __init__(self, cache_dir: str):
        self.root = os.path.join(cache_dir, "index")
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
        note_corruption("index", path, detail)

    def load(self, url: str, fingerprint: str, config_fp: str,
             file_id: int) -> Optional[List[SparseIndexEntry]]:
        """The persisted entries for this (url, file version, config),
        re-stamped with the caller's file_id — or None (miss: absent,
        stale fingerprint, corrupt — corrupt payloads are additionally
        quarantined and counted)."""
        path = self._path(url, config_fp)
        try:
            with open(path, encoding="utf-8") as f:
                raw = f.read()
        except OSError:
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
            # classic bit-flip that WOULD have framed garbage records
            # from wrong shard offsets
            self._corrupt(path, "payload checksum mismatch")
            return None
        if (payload.get("url") != url
                or payload.get("fingerprint") != fingerprint
                or payload.get("config") != config_fp):
            return None
        try:
            return [SparseIndexEntry(int(offset_from), int(offset_to),
                                     file_id, int(record_index))
                    for offset_from, offset_to, record_index
                    in payload["entries"]]
        except (KeyError, TypeError, ValueError):
            self._corrupt(path, "entry rows failed to deserialize")
            return None

    def save_for_local_path(self, path: str, config_fp: str,
                            entries: List[SparseIndexEntry]) -> bool:
        """Persist `entries` for the CURRENT on-disk version of a local
        file, under the same ``local:<size>:<mtime_ns>`` fingerprint a
        read probes for it — the continuous-ingest tailer calls this
        when a tailed generation finalizes, so the first read of a
        rotated-out file loads the incrementally-built index instead of
        re-indexing. False when the file cannot be stat'd (vanished
        between finalize and save)."""
        from ..reader.stream import normalize_local

        try:
            st = os.stat(normalize_local(path))
        except OSError:
            return False
        self.save(path, f"local:{st.st_size}:{st.st_mtime_ns}",
                  config_fp, entries)
        return True

    def save(self, url: str, fingerprint: str, config_fp: str,
             entries: List[SparseIndexEntry]) -> None:
        """Persist one file version's entries (atomic; best-effort — a
        full disk degrades to re-indexing, never to a failed read)."""
        payload = stamp_json_payload({
            "format": _FORMAT,
            "url": url,
            "fingerprint": fingerprint,
            "config": config_fp,
            "entries": [[e.offset_from, e.offset_to, e.record_index]
                        for e in entries],
        })
        path = self._path(url, config_fp)
        try:
            write_atomic(path, json.dumps(payload))
        except OSError as exc:
            _logger.warning("sparse-index save failed for %s: %s",
                            url, exc)
