"""The sink's commit log: CRC-stamped manifest records + dataset meta.

Port copy of ``cobrix_tpu.sink.manifest``, unchanged in layout: the
records, their CRC stamps and the schema fingerprint are the JAX
package's byte for byte, so a dataset written by either package reads,
appends and repairs (``tools/fsckcache.py --sink``) under the other.

A transactional dataset is a directory:

    <dataset_dir>/
        _sink_meta.json     # identity: schema fingerprint, format,
                            # partition spec, serialized Arrow schema
        manifest.log        # append-only commit log — THE source of
                            # truth for what is committed
        data/...            # committed columnar files (hive-style
                            # partition subdirs when partitioned)
        staging/            # in-flight files (invisible to readers)
        quarantine/         # orphans + corrupt entries, held for fsck

Readers trust ONLY files referenced by a valid committed manifest
record; everything else under ``data/``/``staging/`` is an orphan from
a crash window and is quarantined at recovery. Every manifest record is
one JSON line carrying its own CRC-32 (`io.integrity.stamp_json_payload`
— plane ``"sink"``), so a torn tail from a killed appender or a flipped
bit reads as a structurally-detected boundary, never as a silently
wrong file list.

The exactly-once contract with the ingest checkpoint
(the streaming tier's checkpoint): the manifest byte position AFTER each commit
append rides the ack's ``app_state``, committed atomically with the
source watermark. Recovery truncates the manifest back to that
position — a commit record past it belongs to a batch whose watermark
never committed and will be re-driven, so its files are quarantined and
its record discarded. A record BEFORE that position that fails its CRC
is real storage damage: loud structured `SinkCorruption`, never a
silent replay (`tools/fsckcache.py --sink` repairs offline).
"""
from __future__ import annotations

import base64
import hashlib
import json
from typing import List, Optional, Tuple

from ..io.integrity import stamp_json_payload, verify_json_payload

# bump when the record layout changes: a foreign-format dataset is
# refused (never misread), distinct from corruption
SINK_FORMAT = 1

META_NAME = "_sink_meta.json"
MANIFEST_NAME = "manifest.log"
DATA_DIR = "data"
STAGING_DIR = "staging"
QUARANTINE_DIR = "quarantine"

FILE_FORMATS = ("parquet", "arrow")
FILE_EXT = {"parquet": ".parquet", "arrow": ".arrow"}


class SinkError(Exception):
    """Base class for structured sink failures."""


class SinkSchemaError(SinkError):
    """The dataset was written under a different copybook/schema
    fingerprint (or format/partition spec) than the one reopening it —
    appending would silently mix incompatible rows, so the sink refuses
    up front."""


class SinkCorruption(SinkError):
    """Durable sink state failed verification INSIDE the committed
    region (a manifest record or meta file the checkpoint already
    acked). Self-healing would either drop committed rows or replay
    batches; neither is acceptable silently — run
    ``python tools/fsckcache.py --sink <dataset_dir> --repair`` to
    inspect and restore reader consistency offline."""


def schema_fingerprint(arrow_schema, plan_fingerprint: str = "") -> str:
    """Stable identity of what this dataset holds: the Arrow output
    schema (sans metadata — per-batch diagnostics must not drift it)
    plus the copybook plan fingerprint when the producer knows it.
    Reopening a dataset under a different fingerprint is refused."""
    schema_bytes = arrow_schema.remove_metadata().serialize().to_pybytes()
    h = hashlib.sha256()
    h.update(plan_fingerprint.encode("ascii", "replace"))
    h.update(b"\x00")
    h.update(schema_bytes)
    return h.hexdigest()


def build_meta(arrow_schema, schema_fp: str, file_format: str,
               partition_by: Tuple[str, ...],
               owner: str = "") -> dict:
    """The `_sink_meta.json` payload (CRC-stamped). ``owner`` is the
    stream identity (checkpoint dir + stream id) for stream-driven
    datasets, "" for one-shot exports and manual sinks — the gate that
    stops a WRONG stream's recovery from truncating another producer's
    committed history."""
    schema_b64 = base64.b64encode(
        arrow_schema.remove_metadata().serialize().to_pybytes()
    ).decode("ascii")
    return stamp_json_payload({
        "format": SINK_FORMAT,
        "schema_fp": schema_fp,
        "file_format": file_format,
        "partition_by": list(partition_by),
        "arrow_schema": schema_b64,
        "owner": owner,
    })


def parse_meta(raw: bytes) -> Optional[dict]:
    """Decode + CRC-verify a meta payload; None on ANY disagreement
    (the caller quarantines and decides whether the dataset is
    recoverable)."""
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(payload, dict) \
            or payload.get("format") != SINK_FORMAT:
        return None
    if not verify_json_payload(payload):
        return None
    return payload


def meta_arrow_schema(meta: dict):
    """The dataset's Arrow schema out of a verified meta payload."""
    import pyarrow as pa

    return pa.ipc.read_schema(
        pa.BufferReader(base64.b64decode(meta["arrow_schema"])))


def stamp_record(record: dict) -> bytes:
    """One manifest record as its on-disk line (CRC-stamped JSON +
    newline). The CRC covers the canonical serialization, so any
    in-line bit flip — even one that keeps the JSON valid — fails
    verification."""
    return (json.dumps(stamp_json_payload(record), sort_keys=True,
                       separators=(",", ":")) + "\n").encode("utf-8")


def parse_record(line: bytes) -> Optional[dict]:
    """Decode + verify one manifest line; None = torn/corrupt."""
    try:
        payload = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(payload, dict) or not verify_json_payload(payload):
        return None
    return payload


def scan_manifest(raw: bytes) -> Tuple[List[Tuple[int, dict]], int,
                                       Optional[str]]:
    """Walk a manifest image front to back.

    Returns ``(records, valid_bytes, defect)``: `records` is every
    verified record as ``(end_offset, payload)`` pairs in file order up
    to the first invalid line; `valid_bytes` is the byte length of that
    clean prefix (a safe truncation point); `defect` describes the
    first invalid region (torn tail, checksum mismatch), or None when
    the whole image verified."""
    records: List[Tuple[int, dict]] = []
    pos = 0
    while pos < len(raw):
        nl = raw.find(b"\n", pos)
        if nl < 0:
            return records, pos, (
                f"torn record at byte {pos} (no trailing newline)")
        record = parse_record(raw[pos:nl + 1].rstrip(b"\n"))
        if record is None:
            return records, pos, (
                f"unverifiable record at byte {pos}")
        pos = nl + 1
        records.append((pos, record))
    return records, pos, None


def defect_is_terminal(raw: bytes, valid_bytes: int) -> bool:
    """True when the invalid region of a manifest image is its FINAL
    line — the shape a crashed/in-flight append leaves (safe to treat
    as the crash window). False means valid-looking records exist
    AFTER the damage: that is mid-file corruption of history, which
    must be loud, never silently truncated."""
    nl = raw.find(b"\n", valid_bytes)
    return nl < 0 or nl == len(raw) - 1


def committed_files(records: List[Tuple[int, dict]]) -> List[dict]:
    """Every data-file entry referenced by commit records, in commit
    order (each entry: ``{"path", "rows", "bytes", "crc"}``)."""
    out: List[dict] = []
    for _end, record in records:
        if record.get("type") == "commit":
            out.extend(record.get("files") or [])
    return out
