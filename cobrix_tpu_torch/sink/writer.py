"""Transactional dataset writer: stage → finalize → manifest commit.

Port copy of ``cobrix_tpu.sink.writer``, whole: the one-shot export
(`CobolData.to_dataset`) drives it today; the stream recovery
(``committed_state``, ownership) waits for the port's streaming tier,
and is kept so that the two packages recover a dataset alike.

`DatasetSink` owns one dataset directory (local path or any
fsspec-known URL) and commits Arrow tables into it as Parquet or
Arrow-IPC files under a manifest-based commit protocol (see
`sink.manifest` for the on-disk layout and the exactly-once contract
with the ingest checkpoint). Every durable operation goes through a
`RetryPolicy` (`reader.stream.retrying_read`), and exhausted retries
re-raise the backend's OWN error type — the same semantics as the
read-side io planes.

Commit sequence for one table (the fault hooks name the kill windows
the crash matrix drives):

    pre_stage   -> serialize + write data files into staging/
    post_stage  -> move staged files to their final data/ paths
    pre_commit  -> append the CRC-stamped manifest record (fsync)
    post_commit -> (caller acks: the manifest position rides app_state)

A crash in ANY window recovers exactly-once: files without a committed
manifest record are quarantined orphans; a manifest record without a
committed checkpoint is truncated and its files quarantined; the batch
re-drives from the checkpointed watermark either way.
"""
from __future__ import annotations

import errno
import io as _io
import logging
import os
import posixpath
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..io.integrity import checksum, note_corruption
from ..reader.stream import RetryPolicy, path_scheme, retrying_read
from ..utils.atomic import write_atomic
from .manifest import (
    DATA_DIR,
    FILE_EXT,
    FILE_FORMATS,
    MANIFEST_NAME,
    META_NAME,
    QUARANTINE_DIR,
    STAGING_DIR,
    SinkCorruption,
    SinkError,
    SinkSchemaError,
    build_meta,
    committed_files,
    defect_is_terminal,
    meta_arrow_schema,
    parse_meta,
    scan_manifest,
    stamp_record,
)

_logger = logging.getLogger(__name__)

# adopt-the-valid-manifest sentinel: one-shot exports append onto
# whatever is durably committed; streams pass their checkpoint state
ADOPT = object()

# ------------------------------------------------------------------ faults

_FAULT_HOOK = None


def set_sink_fault_hook(hook) -> None:
    """Install (or clear, with None) the sink fault hook — called as
    ``hook(point, seq)`` at every commit kill-window boundary. Test
    infrastructure (`testing.faults.SinkFaultPlan`); never set in
    production."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def _fault(point: str, seq: int) -> None:
    hook = _FAULT_HOOK
    if hook is not None:
        hook(point, seq)


# ---------------------------------------------------------------- backends
#
# Durable primitives over the dataset volume. The module-level local
# write/append functions exist so `testing.faults.sink_write_faults`
# can patch exactly the durable-write call sites (ENOSPC/EROFS on the
# dataset volume must fail the COMMIT loudly, never half-commit).


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY entry: rename/create survives
    power loss only once the directory itself is durable (same
    discipline as obs.audit's flush). Filesystems that refuse
    directory fds degrade silently — the content fsyncs still hold."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _local_write(path: str, data: bytes) -> None:
    """Atomic durable whole-file write (temp + rename + fsync content
    AND the directory entry)."""
    write_atomic(path, data, fsync=True)
    _fsync_dir(os.path.dirname(path) or ".")


def _local_append(path: str, data: bytes) -> None:
    """Durable O_APPEND append of one manifest record (content + the
    directory entry, for the first append that creates the file). A
    short write (ENOSPC mid-record) surfaces as ENOSPC — the caller
    truncates the torn tail back before retrying or re-raising."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
    try:
        n = os.write(fd, data)
        if n != len(data):
            raise OSError(errno.ENOSPC,
                          f"short manifest append ({n}/{len(data)}B)",
                          path)
        os.fsync(fd)
    finally:
        os.close(fd)
    _fsync_dir(os.path.dirname(path) or ".")


class _LocalBackend:
    """Dataset volume primitives for plain filesystem paths."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def full(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def read_optional(self, rel: str) -> Optional[bytes]:
        try:
            with open(self.full(rel), "rb") as f:
                return f.read()
        except OSError:
            return None

    def write(self, rel: str, data: bytes) -> None:
        path = self.full(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _local_write(path, data)

    def append(self, rel: str, data: bytes,
               base_len: Optional[int] = None) -> None:
        _local_append(self.full(rel), data)

    def truncate(self, rel: str, length: int) -> None:
        try:
            with open(self.full(rel), "r+b") as f:
                f.truncate(length)
                f.flush()
                os.fsync(f.fileno())
        except FileNotFoundError:
            if length:
                raise

    def exists(self, rel: str) -> bool:
        return os.path.exists(self.full(rel))

    def move(self, rel_src: str, rel_dst: str) -> None:
        dst = self.full(rel_dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(self.full(rel_src), dst)
        # the manifest record referencing this file fsyncs next; the
        # rename must be durable FIRST or power loss can surface an
        # acked commit whose data file vanished
        _fsync_dir(os.path.dirname(dst))

    def list_files(self, rel_root: str) -> List[str]:
        root = self.full(rel_root)
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(root):
            for name in files:
                full = os.path.join(dirpath, name)
                out.append(posixpath.join(
                    rel_root,
                    os.path.relpath(full, root).replace(os.sep, "/")))
        return sorted(out)

    def quarantine(self, rel: str) -> bool:
        # UNBOUNDED, unlike the cache planes' 32-entry quarantine:
        # sink quarantine holds COMMITTED data (recovery truncations,
        # fsck repairs) — pruning OR deleting would turn a repair into
        # silent permanent loss. A failed move leaves the file where
        # it is (unreferenced files are invisible to readers; the next
        # recovery retries), never unlinks the only copy.
        src = self.full(rel)
        qroot = self.full(QUARANTINE_DIR)
        try:
            os.makedirs(qroot, exist_ok=True)
            dest = os.path.join(
                qroot, f"{int(time.time() * 1000):x}-{os.getpid()}-"
                       f"{os.path.basename(rel)}")
            os.replace(src, dest)
            return True
        except OSError as exc:
            _logger.warning(
                "sink quarantine of %s failed (%s); the file stays in "
                "place and the next recovery will retry", src, exc)
            return False

    def quarantine_count(self) -> int:
        try:
            return len(os.listdir(self.full(QUARANTINE_DIR)))
        except OSError:
            return 0


class _FsspecBackend:
    """Dataset volume primitives over any fsspec filesystem (object
    stores, memory://, ...). Appends use the filesystem's native append
    when it has one and fall back to read+rewrite — the manifest is
    small, and the commit point is the checkpoint's app_state, so the
    rewrite window is covered by the same recovery that covers torn
    local appends."""

    def __init__(self, url: str):
        try:
            import fsspec
        except ImportError as exc:  # pragma: no cover - env-dependent
            raise ImportError(
                "writing a sink dataset to a URL target requires "
                "fsspec (pip install fsspec and the scheme's backend); "
                f"target was {url!r}") from exc
        self.fs, self.root = fsspec.core.url_to_fs(url)
        self.fs.makedirs(self.root, exist_ok=True)

    def full(self, rel: str) -> str:
        return posixpath.join(self.root, rel)

    def read_optional(self, rel: str) -> Optional[bytes]:
        try:
            return self.fs.cat_file(self.full(rel))
        except (OSError, FileNotFoundError):
            return None

    def write(self, rel: str, data: bytes) -> None:
        path = self.full(rel)
        parent = posixpath.dirname(path)
        if parent:
            self.fs.makedirs(parent, exist_ok=True)
        self.fs.pipe_file(path, data)

    def append(self, rel: str, data: bytes,
               base_len: Optional[int] = None) -> None:
        path = self.full(rel)
        try:
            with self.fs.open(path, "ab") as f:
                f.write(data)
        except (NotImplementedError, ValueError, OSError):
            # a failed native append may have written a PARTIAL record;
            # rewrite from the caller's known-good length so torn bytes
            # never get wedged under the new record (base_len=None:
            # best effort from the current content)
            current = self.read_optional(rel) or b""
            if base_len is not None:
                current = current[:base_len]
            self.fs.pipe_file(path, current + data)

    def truncate(self, rel: str, length: int) -> None:
        current = self.read_optional(rel)
        if current is None:
            if length:
                raise FileNotFoundError(self.full(rel))
            return
        self.fs.pipe_file(self.full(rel), current[:length])

    def exists(self, rel: str) -> bool:
        return self.fs.exists(self.full(rel))

    def move(self, rel_src: str, rel_dst: str) -> None:
        dst = self.full(rel_dst)
        parent = posixpath.dirname(dst)
        if parent:
            self.fs.makedirs(parent, exist_ok=True)
        self.fs.mv(self.full(rel_src), dst)

    def list_files(self, rel_root: str) -> List[str]:
        root = self.full(rel_root)
        try:
            found = self.fs.find(root)
        except (OSError, FileNotFoundError):
            return []
        out = []
        for path in found:
            tail = path[len(root):].lstrip("/")
            if tail:
                out.append(posixpath.join(rel_root, tail))
        return sorted(out)

    def quarantine(self, rel: str) -> bool:
        # same no-deletion contract as the local backend: a failed
        # move leaves the (reader-invisible) file for the next retry
        base = posixpath.basename(rel)
        dest = posixpath.join(
            QUARANTINE_DIR,
            f"{int(time.time() * 1000):x}-{os.getpid()}-{base}")
        try:
            self.move(rel, dest)
            return True
        except (OSError, FileNotFoundError) as exc:
            _logger.warning(
                "sink quarantine of %s failed (%s); the file stays in "
                "place and the next recovery will retry",
                self.full(rel), exc)
            return False

    def quarantine_count(self) -> int:
        return len(self.list_files(QUARANTINE_DIR))


def _make_backend(dataset_dir: str):
    if path_scheme(dataset_dir) in (None, "file"):
        path = dataset_dir
        if path_scheme(path) == "file":
            path = path[len("file://"):]
        return _LocalBackend(path)
    return _FsspecBackend(dataset_dir)


# --------------------------------------------------------------- the sink


def _sanitize_partition_value(value) -> str:
    if value is None:
        return "__null__"
    s = str(value)[:64] or "__empty__"
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in s)


def _schema_has_column(schema, name: str) -> bool:
    """True when `name` resolves in `schema` — a top-level column or a
    dotted path through struct fields (root-group schemas keep the 01
    level as one struct column; ``RECORD.COMPANY-ID`` partitions on the
    nested field)."""
    import pyarrow as pa

    if name in schema.names:
        return True
    parts = name.split(".")
    if parts[0] not in schema.names:
        return False
    t = schema.field(parts[0]).type
    for p in parts[1:]:
        if not pa.types.is_struct(t):
            return False
        idx = t.get_field_index(p)
        if idx < 0:
            return False
        t = t.field(idx).type
    return True


def _column_array(table, name: str):
    """The (possibly nested) column `name` of `table` as an array."""
    if name in table.column_names:
        return table[name]
    import pyarrow.compute as pc

    parts = name.split(".")
    arr = table[parts[0]]
    for p in parts[1:]:
        arr = pc.struct_field(arr, p)
    return arr


class DatasetSink:
    """One transactional dataset target.

    ``committed_state`` selects the recovery mode on open: the `ADOPT`
    default trusts the whole valid manifest prefix (one-shot exports
    appending to their own dataset); a checkpoint ``app_state`` dict
    (or None, meaning "nothing ever committed") truncates the manifest
    to exactly the committed position — the streaming exactly-once
    path. `sink_cobol` wires the latter automatically.

    The open itself performs crash recovery: manifest tail truncation,
    staging sweep, and orphaned-data quarantine; the report lands on
    ``self.recovery``.
    """

    def __init__(self, dataset_dir: str, arrow_schema=None,
                 schema_fp: str = "", file_format: str = "parquet",
                 partition_by=(), target_file_mb: float = 64.0,
                 retry: Optional[RetryPolicy] = None,
                 committed_state=ADOPT, owner: str = ""):
        if file_format not in FILE_FORMATS:
            raise ValueError(
                f"file_format must be one of {FILE_FORMATS}, "
                f"got {file_format!r}")
        if file_format == "parquet":
            try:
                import pyarrow.parquet  # noqa: F401
            except ImportError as exc:
                raise ImportError(
                    "file_format='parquet' requires pyarrow.parquet; "
                    "use file_format='arrow' (Arrow IPC) if Parquet "
                    "support is not installed") from exc
        self.dataset_dir = str(dataset_dir)
        self.file_format = file_format
        self.partition_by = tuple(str(c) for c in (partition_by or ()))
        self.target_bytes = max(1, int(float(target_file_mb)
                                       * 1024 * 1024))
        self.retry = retry or RetryPolicy()
        self.backend = _make_backend(self.dataset_dir)
        from ..obs.metrics import sink_metrics

        self.metrics = sink_metrics()
        self._load_meta(arrow_schema, schema_fp, owner)
        self._guard_ownership(committed_state, owner)
        self._seq = 0
        self._records = 0
        self._manifest_bytes = 0
        self.last_commit: Optional[dict] = None
        self.recovery = self._recover(committed_state)

    def _guard_ownership(self, committed_state, owner: str) -> None:
        """Refuse recoveries that would silently destroy another
        producer's committed history. Stream mode (an explicit
        ``committed_state``) truncates the manifest to the checkpointed
        position — safe ONLY for the stream that wrote the dataset, so
        the dataset's recorded owner must match. ADOPT mode appends —
        safe only on datasets NOT owned by a live stream (a foreign
        commit would be chopped by that stream's next recovery)."""
        if committed_state is ADOPT:
            if self.owner:
                raise SinkError(
                    f"{self.dataset_dir} is owned by the ingest stream "
                    f"{self.owner!r}; a one-shot append here would be "
                    "truncated by that stream's next recovery. Export "
                    "to a separate dataset")
            return
        if self.owner != owner:
            want = self.owner or "<none — created by a one-shot export>"
            raise SinkError(
                f"{self.dataset_dir} belongs to stream {want!r} but "
                f"this drive recovers as {owner or '<no checkpoint>'!r}"
                "; truncating to this stream's checkpoint would discard "
                "the other producer's committed batches. Re-use the "
                "original checkpoint_dir/stream_id, or write to a "
                "fresh dataset_dir")
        if not owner and committed_state is None \
                and self._has_commits():
            raise SinkError(
                f"{self.dataset_dir} already holds committed batches "
                "but this ingestor has no checkpoint store (no "
                "committed state to recover to) — recovery would "
                "discard them. Give tail_cobol a checkpoint_dir, or "
                "sink into a fresh dataset_dir")

    def _has_commits(self) -> bool:
        raw = self.backend.read_optional(MANIFEST_NAME) or b""
        records, _valid, _defect = scan_manifest(raw)
        return any(rec.get("type") == "commit" for _e, rec in records)

    # -- identity ---------------------------------------------------------

    def _load_meta(self, arrow_schema, schema_fp: str,
                   owner: str = "") -> None:
        raw = self.backend.read_optional(META_NAME)
        meta = parse_meta(raw) if raw is not None else None
        if raw is not None and meta is None:
            note_corruption("sink", self.backend.full(META_NAME),
                            "sink meta failed verification")
            self.backend.quarantine(META_NAME)
        if meta is None:
            # a corrupt OR missing meta is only self-healable while the
            # dataset is still empty; afterwards the schema identity
            # and ownership are gone — re-creating them from the NEW
            # producer's config would bypass every drift/ownership
            # refusal and risk silently mixed rows
            if self.backend.read_optional(MANIFEST_NAME) \
                    or self.backend.list_files(DATA_DIR):
                raise SinkCorruption(
                    f"{self.dataset_dir}: {META_NAME} is "
                    f"{'corrupt' if raw is not None else 'missing'} "
                    "on a non-empty dataset — its schema/ownership "
                    "identity cannot be re-derived safely; run "
                    "tools/fsckcache.py --sink to inspect")
            if arrow_schema is None:
                raise ValueError(
                    f"{self.dataset_dir} is not an existing sink "
                    "dataset and no arrow_schema was given to create "
                    "one")
            self.arrow_schema = arrow_schema.remove_metadata()
            self.schema_fp = schema_fp
            self.owner = owner
            self._check_partition_columns()
            payload = build_meta(self.arrow_schema, schema_fp,
                                 self.file_format, self.partition_by,
                                 owner=owner)
            import json

            self._write_retry(META_NAME,
                              json.dumps(payload).encode("utf-8"),
                              describe="sink meta write")
            return
        if meta["file_format"] != self.file_format:
            raise SinkSchemaError(
                f"{self.dataset_dir} holds {meta['file_format']!r} "
                f"files; reopening with file_format="
                f"{self.file_format!r} is refused")
        if tuple(meta.get("partition_by") or ()) != self.partition_by:
            raise SinkSchemaError(
                f"{self.dataset_dir} is partitioned by "
                f"{tuple(meta.get('partition_by') or ())}; reopening "
                f"with partition_by={self.partition_by} is refused")
        if schema_fp and meta["schema_fp"] and \
                schema_fp != meta["schema_fp"]:
            raise SinkSchemaError(
                f"schema fingerprint drift: {self.dataset_dir} was "
                f"written under {meta['schema_fp'][:12]}… but this "
                f"producer fingerprints {schema_fp[:12]}… — the "
                "copybook or row-shaping options changed. Write to a "
                "fresh dataset (or migrate explicitly); appending "
                "mixed shapes is refused")
        stored = meta_arrow_schema(meta)
        if arrow_schema is not None and \
                not stored.equals(arrow_schema.remove_metadata()):
            raise SinkSchemaError(
                f"Arrow schema drift on {self.dataset_dir}: the "
                "dataset's stored schema does not match this "
                "producer's output schema; appending is refused")
        self.arrow_schema = stored
        self.schema_fp = meta["schema_fp"]
        self.owner = str(meta.get("owner") or "")
        self._check_partition_columns()

    def _check_partition_columns(self) -> None:
        for col in self.partition_by:
            if not _schema_has_column(self.arrow_schema, col):
                raise SinkSchemaError(
                    f"partition column {col!r} is not in the dataset "
                    "schema (top-level columns: "
                    f"{list(self.arrow_schema.names)}; nested struct "
                    "fields spell as 'ROOT.FIELD')")

    # -- recovery ---------------------------------------------------------

    @staticmethod
    def _normalize_committed(committed_state) -> Dict[str, int]:
        if committed_state is None:
            return {"manifest_bytes": 0, "seq": 0, "records": 0}
        if isinstance(committed_state, dict):
            inner = committed_state.get("sink", committed_state)
            if isinstance(inner, dict):
                return {
                    "manifest_bytes": int(
                        inner.get("manifest_bytes", 0) or 0),
                    "seq": int(inner.get("seq", 0) or 0),
                    "records": int(inner.get("records", 0) or 0),
                }
        # a foreign app_state (the consumer stored something else):
        # nothing of ours ever committed
        return {"manifest_bytes": 0, "seq": 0, "records": 0}

    def _recover(self, committed_state) -> dict:
        raw = self.backend.read_optional(MANIFEST_NAME) or b""
        records, valid_bytes, defect = scan_manifest(raw)
        manifest_path = self.backend.full(MANIFEST_NAME)
        report = {"truncated_commits": 0, "quarantined_files": 0,
                  "staged_quarantined": 0, "corrupt_tail": False,
                  "truncated_bytes": 0}
        if committed_state is ADOPT:
            if defect is not None \
                    and not defect_is_terminal(raw, valid_bytes):
                # valid records exist AFTER the damage: this is
                # mid-file corruption of committed history, not a
                # crashed append — truncating would silently discard
                # the later commits
                note_corruption("sink", manifest_path,
                                f"{defect} with later records present")
                raise SinkCorruption(
                    f"{self.dataset_dir}: a manifest record failed "
                    f"verification with committed records after it "
                    f"({defect}); refusing to silently drop them — "
                    "run tools/fsckcache.py --sink "
                    f"{self.dataset_dir} --repair to resolve offline")
            committed_bytes = valid_bytes
        else:
            committed = self._normalize_committed(committed_state)
            committed_bytes = committed["manifest_bytes"]
            if committed_bytes > len(raw):
                note_corruption(
                    "sink", manifest_path,
                    f"manifest is {len(raw)}B but the checkpoint "
                    f"committed {committed_bytes}B")
                raise SinkCorruption(
                    f"{self.dataset_dir}: manifest.log is shorter than "
                    "the checkpointed commit position — committed "
                    "records were lost; run tools/fsckcache.py --sink "
                    "to inspect, then restart the stream explicitly")
            if valid_bytes < committed_bytes:
                note_corruption(
                    "sink", manifest_path,
                    f"{defect} inside the committed region "
                    f"(committed={committed_bytes}B)")
                raise SinkCorruption(
                    f"{self.dataset_dir}: a manifest record inside the "
                    f"committed region failed verification ({defect}); "
                    "refusing to replay or drop committed batches "
                    "silently — run tools/fsckcache.py --sink "
                    f"{self.dataset_dir} --repair to restore reader "
                    "consistency offline")
        if defect is not None and len(raw) > committed_bytes:
            # torn/bit-flipped tail past the commit point: the crash
            # window itself — self-heals off the checkpointed position
            note_corruption("sink", manifest_path,
                            f"{defect} past the committed position "
                            "(truncated at recovery)")
            report["corrupt_tail"] = True
        kept = [(end, rec) for end, rec in records
                if end <= committed_bytes]
        dropped = [rec for end, rec in records if end > committed_bytes]
        if len(raw) > committed_bytes:
            report["truncated_bytes"] = len(raw) - committed_bytes
            self._truncate_retry(committed_bytes)
        report["truncated_commits"] = sum(
            1 for r in dropped if r.get("type") == "commit")
        # staging is in-flight by definition: everything there is an
        # orphan of a crashed commit
        for rel in self.backend.list_files(STAGING_DIR):
            if self.backend.quarantine(rel):
                report["staged_quarantined"] += 1
        # finalized files no KEPT record references: kills between
        # finalize and manifest append, and truncated (uncommitted)
        # commits' files alike
        referenced = {entry["path"] for entry in committed_files(kept)}
        for rel in self.backend.list_files(DATA_DIR):
            if rel not in referenced:
                if self.backend.quarantine(rel):
                    report["quarantined_files"] += 1
        commits = [rec for _end, rec in kept
                   if rec.get("type") == "commit"]
        if commits:
            self._seq = int(commits[-1]["seq"])
            self._records = int(commits[-1].get("records_total", 0))
        self._manifest_bytes = committed_bytes
        # audit + warn only on REAL recovery work: truncating a stale
        # recovery-audit record from a previous restart is routine (it
        # must not re-append one, or idle restarts would loop forever)
        if (report["truncated_commits"]
                or report["staged_quarantined"]
                or report["quarantined_files"]
                or report["corrupt_tail"]):
            self.metrics["recovered_commits"].inc(
                report["truncated_commits"])
            self.metrics["quarantined_files"].inc(
                report["quarantined_files"]
                + report["staged_quarantined"])
            _logger.warning(
                "sink recovery on %s: truncated %d uncommitted "
                "commit(s) (%dB), quarantined %d finalized + %d staged "
                "file(s)%s", self.dataset_dir,
                report["truncated_commits"], report["truncated_bytes"],
                report["quarantined_files"],
                report["staged_quarantined"],
                " after a corrupt manifest tail"
                if report["corrupt_tail"] else "")
            # durable audit trail: the recovery event rides the
            # manifest itself (it may be truncated by a LATER recovery
            # if no commit follows — the checkpoint stays authoritative)
            try:
                self._append_manifest(stamp_record({
                    "type": "recovery", "ts": time.time(), **report}))
            except OSError:
                pass  # auditing must not fail the open
        return report

    # -- commit -----------------------------------------------------------

    def app_state_token(self) -> dict:
        """The opaque consumer state the NEXT ack must commit: the
        manifest position that makes everything up to the last
        `commit_table` durable-and-visible exactly once."""
        return {"sink": {"manifest_bytes": self._manifest_bytes,
                         "seq": self._seq,
                         "records": self._records}}

    def commit_table(self, table, source: str = "",
                     offset_from: Optional[int] = None,
                     offset_to: Optional[int] = None) -> dict:
        """Stage, finalize, and manifest-commit one Arrow table as a
        single transaction; returns the new ``app_state`` token for
        the batch ack. Raises the backend's own OSError (ENOSPC,
        EROFS, ...) with NOTHING half-committed when the volume fails:
        the manifest is unchanged, and any finalized-but-unreferenced
        files are quarantined by the next recovery."""
        if not table.schema.remove_metadata().equals(self.arrow_schema):
            raise SinkSchemaError(
                "table schema does not match the dataset schema; "
                "refusing to append mixed shapes "
                f"(dataset: {self.arrow_schema.names}; "
                f"table: {table.schema.names})")
        seq = self._seq + 1
        _fault("pre_stage", seq)
        specs = self._plan_files(table, seq)
        for spec in specs:
            self._write_retry(spec["staged"], spec["data"],
                              describe="sink staging write")
        _fault("post_stage", seq)
        for spec in specs:
            self._move_retry(spec["staged"], spec["path"])
        _fault("pre_commit", seq)
        record = {
            "type": "commit",
            "seq": seq,
            "rows": table.num_rows,
            "records_total": self._records + table.num_rows,
            "files": [{"path": s["path"], "rows": s["rows"],
                       "bytes": len(s["data"]), "crc": s["crc"]}
                      for s in specs],
            "source": source,
            "offset_from": offset_from,
            "offset_to": offset_to,
            "ts": time.time(),
        }
        self._append_manifest(stamp_record(record))
        _fault("post_commit", seq)
        self._seq = seq
        self._records += table.num_rows
        total_bytes = sum(len(s["data"]) for s in specs)
        self.last_commit = {"seq": seq, "rows": table.num_rows,
                            "files": len(specs), "bytes": total_bytes,
                            "source": source}
        self.metrics["batches"].inc()
        self.metrics["records"].inc(table.num_rows)
        self.metrics["bytes"].inc(total_bytes)
        self.metrics["files"].inc(len(specs))
        return self.app_state_token()

    def to_table(self):
        """The committed dataset, read back in commit order (checksum-
        verified) — `read_dataset` on this sink's directory."""
        return read_dataset(self.dataset_dir)

    # -- internals --------------------------------------------------------

    def _write_retry(self, rel: str, data: bytes,
                     describe: str = "sink write") -> None:
        retrying_read(lambda: self.backend.write(rel, data) or b"",
                      self.retry, describe=f"{describe} ({rel})")

    def _move_retry(self, rel_src: str, rel_dst: str) -> None:
        retrying_read(
            lambda: self.backend.move(rel_src, rel_dst) or b"",
            self.retry, describe=f"sink finalize ({rel_dst})")

    def _truncate_retry(self, length: int) -> None:
        retrying_read(
            lambda: self.backend.truncate(MANIFEST_NAME, length) or b"",
            self.retry, describe="sink manifest truncate")

    def _append_manifest(self, line: bytes) -> None:
        base = self._manifest_bytes

        def op() -> bytes:
            try:
                self.backend.append(MANIFEST_NAME, line, base_len=base)
            except OSError:
                # clean this attempt's torn tail so a retry (or the
                # caller's own retry of commit_table) appends at the
                # committed position, never after garbage
                try:
                    self.backend.truncate(MANIFEST_NAME, base)
                except OSError:
                    pass
                raise
            return b""

        retrying_read(op, self.retry, describe="sink manifest append")
        self._manifest_bytes = base + len(line)

    def _serialize(self, table) -> bytes:
        import pyarrow as pa

        buf = _io.BytesIO()
        if self.file_format == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(table, buf)
        else:
            with pa.ipc.new_file(buf, table.schema) as w:
                w.write_table(table)
        return buf.getvalue()

    def _plan_files(self, table, seq: int) -> List[dict]:
        ext = FILE_EXT[self.file_format]
        specs: List[dict] = []
        idx = 0
        for part_dirs, part_table in self._split_partitions(table):
            for slice_table, data in self._roll(part_table):
                name = f"part-{seq:08d}-{idx:04d}{ext}"
                specs.append({
                    "path": posixpath.join(DATA_DIR, *part_dirs, name),
                    "staged": posixpath.join(STAGING_DIR, name),
                    "data": data,
                    "rows": slice_table.num_rows,
                    "crc": checksum(data),
                })
                idx += 1
        return specs

    def _split_partitions(self, table) -> Iterator[Tuple[tuple, object]]:
        if not self.partition_by:
            yield (), table
            return
        import pyarrow as pa
        import pyarrow.compute as pc

        cols = list(self.partition_by)
        arrays = {col: _column_array(table, col) for col in cols}
        keytab = pa.table(
            {f"k{i}": arrays[col] for i, col in enumerate(cols)})
        combos = keytab.group_by(list(keytab.column_names),
                                 use_threads=False) \
            .aggregate([]).to_pylist()
        combos.sort(key=lambda c: [str(v) for v in c.values()])
        for combo in combos:
            mask = None
            for i, col in enumerate(cols):
                value = combo[f"k{i}"]
                column = arrays[col]
                m = (pc.is_null(column) if value is None
                     else pc.equal(column, value))
                mask = m if mask is None else pc.and_(mask, m)
            part = table.filter(mask)
            dirs = tuple(
                f"{col.rsplit('.', 1)[-1]}="
                f"{_sanitize_partition_value(combo[f'k{i}'])}"
                for i, col in enumerate(cols))
            yield dirs, part

    def _roll(self, table) -> List[Tuple[object, bytes]]:
        """Split one partition's table into files of ~target size.
        The split count is estimated from the in-memory Arrow size so
        each slice serializes exactly once (compression may land files
        somewhat under target — rolling is approximate by design)."""
        if table.num_rows <= 1 \
                or table.nbytes <= self.target_bytes * 1.5:
            return [(table, self._serialize(table))]
        n_files = -(-table.nbytes // self.target_bytes)
        rows_per = max(1, -(-table.num_rows // n_files))
        out = []
        for start in range(0, table.num_rows, rows_per):
            sl = table.slice(start, rows_per)
            out.append((sl, self._serialize(sl)))
        return out


# ---------------------------------------------------------------- readers


def read_dataset(dataset_dir: str, verify: bool = True):
    """The committed dataset as ONE Arrow table, files concatenated in
    commit order (per-file schema metadata stripped — each file keeps
    its own batch diagnostics; the concatenation is positional). With
    ``verify`` (default) every data file is checked against the
    manifest's length + CRC — a mismatch is counted under plane
    ``"sink"`` and raised as `SinkCorruption`, never returned as
    silently wrong rows."""
    import pyarrow as pa

    backend = _make_backend(dataset_dir)
    raw_meta = backend.read_optional(META_NAME)
    if raw_meta is None:
        raise FileNotFoundError(
            f"{dataset_dir} is not a sink dataset (no {META_NAME})")
    meta = parse_meta(raw_meta)
    if meta is None:
        note_corruption("sink", backend.full(META_NAME),
                        "sink meta failed verification")
        raise SinkCorruption(
            f"{dataset_dir}: {META_NAME} failed verification")
    raw = backend.read_optional(MANIFEST_NAME) or b""
    records, valid, defect = scan_manifest(raw)
    if defect is not None and not defect_is_terminal(raw, valid):
        # a TERMINAL defect is an in-flight/crashed commit — readers
        # take the valid prefix by design. Damage with committed
        # records after it is mid-file corruption: serving the prefix
        # would silently drop rows
        note_corruption("sink", backend.full(MANIFEST_NAME),
                        f"{defect} with later records present")
        raise SinkCorruption(
            f"{dataset_dir}: manifest damage with committed records "
            f"after it ({defect}); run tools/fsckcache.py --sink")
    tables = []
    for entry in committed_files(records):
        data = backend.read_optional(entry["path"])
        if data is None:
            note_corruption("sink", backend.full(entry["path"]),
                            "committed data file missing")
            raise SinkCorruption(
                f"{dataset_dir}: committed file {entry['path']} is "
                "missing; run tools/fsckcache.py --sink")
        if verify and (len(data) != int(entry["bytes"])
                       or checksum(data) != int(entry["crc"])):
            note_corruption("sink", backend.full(entry["path"]),
                            "committed data file failed checksum")
            raise SinkCorruption(
                f"{dataset_dir}: committed file {entry['path']} failed "
                "its manifest checksum; run tools/fsckcache.py --sink")
        tables.append(_read_table(meta["file_format"], data)
                      .replace_schema_metadata(None))
    if not tables:
        return meta_arrow_schema(meta).empty_table()
    return (tables[0] if len(tables) == 1
            else pa.concat_tables(tables))


def _read_table(file_format: str, data: bytes):
    import pyarrow as pa

    if file_format == "parquet":
        import pyarrow.parquet as pq

        return pq.read_table(pa.BufferReader(data))
    with pa.ipc.open_file(pa.BufferReader(data)) as r:
        return r.read_all()


# ------------------------------------------------------------------- fsck


def fsck_sink(dataset_dir: str, repair: bool = False) -> dict:
    """Offline verify (and optionally repair) one sink dataset — the
    ``--sink`` mode of tools/fsckcache.py.

    Verifies: meta CRC, every manifest record's CRC, every committed
    data file against its manifest length+CRC, staging orphans, and
    finalized files no record references. ``repair`` truncates the
    manifest at the first unverifiable record (quarantining every file
    referenced at or beyond it) and quarantines all orphans — a
    destructive-but-honest repair restoring READER consistency; a
    stream whose checkpoint committed past the truncation point will
    refuse to resume (loudly) and must be restarted explicitly."""
    backend = _make_backend(dataset_dir)
    stats: Dict[str, object] = {
        "meta_ok": False, "commits": 0, "data_ok": 0,
        "data_corrupt": 0, "data_missing": 0, "manifest_defect": None,
        "staging_orphans": 0, "data_orphans": 0, "quarantined": 0,
        "truncated_bytes": 0,
    }
    raw_meta = backend.read_optional(META_NAME)
    meta = parse_meta(raw_meta) if raw_meta is not None else None
    stats["meta_ok"] = meta is not None
    raw = backend.read_optional(MANIFEST_NAME) or b""
    records, valid_bytes, defect = scan_manifest(raw)
    stats["manifest_defect"] = defect
    # (start, end, record) triples: start = previous record's end
    triples = [(([0] + [e for e, _r in records])[i], end, rec)
               for i, (end, rec) in enumerate(records)]
    stats["commits"] = sum(1 for _s, _e, r in triples
                           if r.get("type") == "commit")
    # verify data files; find the first commit whose files are damaged
    bad_paths: List[str] = []
    first_bad_end: Optional[int] = None
    referenced = set()
    for start, _end, rec in triples:
        if rec.get("type") != "commit":
            continue
        commit_ok = True
        for entry in (rec.get("files") or []):
            referenced.add(entry["path"])
            data = backend.read_optional(entry["path"])
            if data is None:
                stats["data_missing"] += 1
                commit_ok = False
            elif (len(data) != int(entry["bytes"])
                    or checksum(data) != int(entry["crc"])):
                stats["data_corrupt"] += 1
                bad_paths.append(entry["path"])
                commit_ok = False
            else:
                stats["data_ok"] += 1
        if not commit_ok and first_bad_end is None:
            # truncation point: the byte offset where this record began
            first_bad_end = start
    staging = backend.list_files(STAGING_DIR)
    stats["staging_orphans"] = len(staging)
    orphans = [rel for rel in backend.list_files(DATA_DIR)
               if rel not in referenced]
    stats["data_orphans"] = len(orphans)
    if repair:
        truncate_to = valid_bytes if defect is not None else len(raw)
        if first_bad_end is not None:
            truncate_to = min(truncate_to, first_bad_end)
        if truncate_to < len(raw):
            stats["truncated_bytes"] = len(raw) - truncate_to
            backend.truncate(MANIFEST_NAME, truncate_to)
            surviving, _v, _d = scan_manifest(raw[:truncate_to])
            still = {entry["path"]
                     for entry in committed_files(surviving)}
            for rel in referenced - still:
                if backend.exists(rel) and backend.quarantine(rel):
                    stats["quarantined"] += 1
        for rel in staging + orphans + bad_paths:
            if backend.exists(rel) and backend.quarantine(rel):
                stats["quarantined"] += 1
    stats["quarantine_held"] = backend.quarantine_count()
    stats["clean"] = bool(
        stats["meta_ok"] and defect is None
        and not stats["data_corrupt"] and not stats["data_missing"]
        and not stats["staging_orphans"] and not stats["data_orphans"])
    return stats
