"""Continuous exactly-once ingestion: tail live sources into batches.

`ContinuousIngestor` is the production replacement for the micro-batch
toy (`streaming.microbatch`): it tails growing local files and
object-store prefixes, decodes only the stable whole-record prefix of
each source, survives SIGKILL at any instant through the durable
checkpoint store, detects rotation and truncation structurally, and
delivers monotone-Record_Id Arrow batches whose concatenation is
byte-identical to a one-shot `read_cobol(...).to_arrow()` of the final
inputs.

Port copy of ``cobrix_tpu.streaming.ingest``. Every window the ingestor
delivers decodes on its device (``device``, the CUDA device unless
given ``"cpu"``, in place of the JAX package's ``backend``): the cut
window's bytes are staged in a pinned buffer of the ingestor's
`staging` pool and cross to the card in one copy; a fixed-length window
then takes ``FixedLenReader.read_result`` (the fused decode kernel on
the staged image), an RDW or record-header-parser window
``VarLenReader.read_shard`` (the scan, pack and fused kernels), with
file-absolute offsets and `WindowStream`'s ``file_size`` rule: the
window's end for a live window, the generation's final size for its
last one. The catch-up drain decodes its windows on the port's
`PipelineExecutor`, each worker on its own CUDA stream, and each
batch's `CobolData` carries the device, so its ``to_arrow`` builds the
Arrow buffers with the assembly kernels there. The host keeps what the
JAX package keeps on the host: the record-header walk of a live window
(`_cut`), the watermarks, the checkpoints and the source probes.

Delivery semantics — the ack window:

* every yielded `IngestBatch` carries the post-batch watermark;
* `batch.ack(app_state=...)` (or `ingestor.ack(...)`) durably commits
  that watermark — atomically with the consumer's opaque `app_state`;
* pulling the NEXT batch auto-acks the previous one (at-least-once for
  consumers that do nothing);
* after a crash, ingestion resumes from the last COMMITTED watermark.
  A consumer that records its output position in ``app_state`` and
  truncates its output back to `ingestor.app_state` on restart gets
  end-to-end exactly-once: re-driven batches land exactly where the
  truncated output ends. ``python -m cobrix_tpu_torch.testing.streamcheck``
  is the executable proof.

Supported configurations: everything framed by a record-header parser —
fixed-length records (with or without `generate_record_id`), RDW record
sequences (all endianness/adjustment variants), and custom
`record_header_parser` classes. Record extractors, text mode,
variable-size OCCURS, length-field framing, hierarchical copybooks, and
file header/footer offsets have no safe incremental framing on a LIVE
stream and are refused up front (the micro-batch API still covers the
whole-file flavors of those).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..api import CobolData, load_copybook_contents, parse_options
from ..device import resolve_device
from ..engine.staging import StagedBytes, StagingPool, worker_stream
from ..obs.metrics import stream_metrics
from ..reader.fixed_len_reader import FixedLenReader
from ..reader.index import IncrementalIndexer
from ..reader.parameters import ReaderParameters
from ..reader.schema import CobolOutputSchema
from ..reader.stream import RetryPolicy, open_stream, path_scheme
from ..reader.var_len_reader import (
    VarLenReader,
    default_segment_id_prefix,
    file_record_id_base,
)
from ..utils.file_utils import list_input_files
from .checkpoint import CheckpointStore, StreamCheckpoint
from .sources import (
    LIVE_FILE_SIZE,
    SourceProbe,
    SourceState,
    SourceTruncated,
    TailedFile,
    handle_head_matches,
    head_matches,
    probe_local,
    stat_local,
)

_logger = logging.getLogger(__name__)

_UNSET = object()

# finished-generation identity memory kept in the checkpoint (bounds the
# rename-rotation dedupe table)
_FINISHED_KEEP = 64

# the process-wide lag/age gauges aggregate over every LIVE ingestor
# (several follow sessions share one /metrics): each publishes its own
# (lag, age) here and the gauges get the sum / max — a caught-up
# session must not mask another session's backlog by overwriting
_GAUGE_LOCK = threading.Lock()
_LIVE_GAUGES: "Dict[int, Tuple[int, float]]" = {}


def _publish_gauges(key: int, metrics, lag: Optional[int],
                    age: Optional[float]) -> None:
    """Fold one ingestor's (lag, age) into the process gauges; None
    removes the entry (the ingestor closed)."""
    with _GAUGE_LOCK:
        if lag is None:
            _LIVE_GAUGES.pop(key, None)
        else:
            _LIVE_GAUGES[key] = (lag, age or 0.0)
        total = sum(entry[0] for entry in _LIVE_GAUGES.values())
        oldest = max((entry[1] for entry in _LIVE_GAUGES.values()),
                     default=0.0)
    metrics["lag_bytes"].set(total)
    metrics["watermark_age"].set(oldest)


class IngestBatch:
    """One delivered micro-batch: decoded data + its recovery watermark."""

    __slots__ = ("data", "source", "file_id", "generation",
                 "offset_from", "offset_to", "records", "diagnostics",
                 "_ingestor", "_seq")

    def __init__(self, data: CobolData, source: str, file_id: int,
                 generation: int, offset_from: int, offset_to: int,
                 ingestor: "ContinuousIngestor", seq: int):
        self.data = data
        self.source = source
        self.file_id = file_id
        self.generation = generation
        self.offset_from = offset_from
        self.offset_to = offset_to
        self.records = len(data)
        self.diagnostics = data.diagnostics
        self._ingestor = ingestor
        self._seq = seq

    def to_arrow(self):
        return self.data.to_arrow()

    def to_rows(self):
        return self.data.to_rows()

    def ack(self, app_state=_UNSET) -> None:
        """Durably commit this batch's watermark (and, atomically, the
        consumer's `app_state`)."""
        self._ingestor.ack(app_state, _seq=self._seq)

    def __len__(self) -> int:
        return self.records


class _LiveSource:
    """Runtime companion of one SourceState (non-checkpointed)."""

    __slots__ = ("state", "handle", "indexer", "alias_path",
                 "final_size", "finalizing", "rotating",
                 "stalled_since", "remote_stable_polls",
                 "last_seen_size")

    def __init__(self, state: SourceState):
        self.state = state
        self.handle: Optional[TailedFile] = None
        self.indexer: Optional[IncrementalIndexer] = None
        self.alias_path: Optional[str] = None
        self.final_size: Optional[int] = None  # set => generation final
        self.finalizing = False
        self.rotating = False  # finalizing because a successor exists
        self.stalled_since: Optional[float] = None
        self.remote_stable_polls = 0
        self.last_seen_size = -1


class ContinuousIngestor:
    """Tail `path` (file / directory / glob / remote prefix) forever,
    yielding exactly-once checkpointed `IngestBatch`es.

    Parameters beyond the standard `read_cobol` options:

    * ``device`` — where every window decodes (None: the CUDA device,
      raising without one; ``"cpu"``: the plain versions);
    * ``checkpoint_dir`` — durable watermark store (None = in-memory
      only: no crash recovery, acks are no-ops);
    * ``poll_interval_s`` / ``idle_timeout_s`` / ``max_batches`` — the
      loop bounds (idle_timeout_s=None polls forever);
    * ``batch_max_mb`` — upper bound on raw bytes per delivered batch
      (default: the pipeline chunk size);
    * ``tail_grace_s`` — how long a mid-record tail may sit unfinished
      before the ingestor logs a stall warning (the wait itself never
      blocks other sources);
    * ``truncation_policy`` — ``'error'`` raises `SourceTruncated` when
      a source shrinks below its watermark; ``'restart'`` re-ingests
      the new content as a fresh generation (counted either way);
    * ``finalize_on_idle`` — treat the idle timeout as end-of-stream:
      decode the remaining tails under the record-error policy and
      persist final sparse indexes before returning.

    A `batches()` generator abandoned MID-iteration (break/exception
    without exhausting it) leaves undelivered-but-cut windows behind:
    discard the ingestor and build a fresh one from the checkpoint —
    that is the crash-recovery path, and it is exact. Re-entering
    `batches()` is only supported after the previous generator returned
    normally (idle timeout / max_batches).
    """

    def __init__(self, path, copybook: Optional[str] = None,
                 copybook_contents=None,
                 checkpoint_dir: Optional[str] = None,
                 stream_id: str = "stream",
                 device=None,
                 poll_interval_s: float = 0.25,
                 idle_timeout_s: Optional[float] = None,
                 max_batches: Optional[int] = None,
                 batch_max_mb: Optional[float] = None,
                 tail_grace_s: float = 5.0,
                 truncation_policy: str = "error",
                 finalize_on_idle: bool = False,
                 auto_ack: bool = True,
                 **options):
        if truncation_policy not in ("error", "restart"):
            raise ValueError(
                f"truncation_policy must be 'error' or 'restart', "
                f"got {truncation_policy!r}")
        self.path = path
        self.device = resolve_device(device)
        self.poll_interval_s = max(0.01, float(poll_interval_s))
        self.idle_timeout_s = idle_timeout_s
        self.max_batches = max_batches
        self.tail_grace_s = max(0.0, float(tail_grace_s))
        self.truncation_policy = truncation_policy
        self.finalize_on_idle = finalize_on_idle
        self.auto_ack = auto_ack
        contents = load_copybook_contents(copybook, copybook_contents)
        self.copybook_contents = contents
        self.params = parse_options(options, streaming=True)
        _validate_tailable(self.params)
        self.is_var_len = self.params.needs_var_len_reader
        if self.is_var_len:
            self.reader = VarLenReader(contents, self.params,
                                       device=self.device)
            if self.reader.copybook.is_hierarchical:
                raise ValueError(
                    "continuous ingestion does not support hierarchical "
                    "copybooks (segment parent/child state cannot span "
                    "live micro-batches); use read_cobol on closed files")
            self._parser = self.reader.record_header_parser()
            seg = self.params.multisegment
            self._prefix = (seg.segment_id_prefix
                            if seg and seg.segment_id_prefix
                            else default_segment_id_prefix())
        else:
            self.reader = FixedLenReader(contents, self.params,
                                         device=self.device)
            self._parser = None
            self._prefix = ""
        seg_count = (len(self.params.multisegment.segment_level_ids)
                     if self.params.multisegment and self.is_var_len
                     else 0)
        self.schema = CobolOutputSchema(
            self.reader.copybook,
            policy=self.params.schema_policy,
            input_file_name_field=self.params.input_file_name_column,
            generate_record_id=self.params.generate_record_id,
            generate_seg_id_field_count=seg_count,
            segment_id_prefix="",
            corrupt_record_field=self.params.corrupt_record_column)
        self.batch_max_bytes = int(
            (batch_max_mb if batch_max_mb
             else self.params.pipeline_chunk_mb) * 1024 * 1024)
        if not self.is_var_len:
            rs = self.reader.record_size
            self.batch_max_bytes = max(rs, (self.batch_max_bytes
                                            // rs) * rs)
        self.retry = RetryPolicy(
            max_attempts=self.params.io_retry_attempts,
            base_delay=self.params.io_retry_base_delay,
            max_delay=self.params.io_retry_max_delay,
            deadline=self.params.io_retry_deadline)
        from ..io.config import IoConfig

        self.io = IoConfig.from_params(self.params)
        # the pinned buffers every window is staged in before its one
        # copy to the device (`report()` counts the copies); enough for
        # the catch-up drain's in-flight windows
        self.staging = StagingPool(
            (self.params.pipeline_max_inflight
             or self.params.resolved_pipeline_workers() + 2) + 1,
            self.device)
        self.metrics = stream_metrics()
        # ingest drift observability (collect_stats=true): per-source
        # {"prev": GenerationProfile, "live": GenerationProfile} — the
        # live profile folds every delivered batch; a drained
        # generation is compared against its predecessor on rotation /
        # finalize (stats/drift.py). Plain dict here: the stats package
        # itself is imported only when collect_stats is on
        self._drift: Dict[str, dict] = {}
        # -- durable + live state --------------------------------------
        self.store = (CheckpointStore(checkpoint_dir, stream_id)
                      if checkpoint_dir else None)
        self._sources: Dict[str, _LiveSource] = {}
        self._order: List[str] = []
        self._finished: Dict[str, dict] = {}  # ino -> identity
        self._delivered_records = 0
        self._delivered_batches = 0
        self._errors_total = 0
        self._app_state = None
        # per-batch watermark snapshots awaiting ack, keyed by batch
        # seq: acking batch N commits N's exact snapshot even when N+1
        # was already pulled (a later batch's watermark must never be
        # committed by an earlier batch's ack)
        self._staged: Dict[int, StreamCheckpoint] = {}
        self._acked_seq = 0
        self._batch_seq = 0
        self._last_advance = time.monotonic()
        self._closed = False
        self._restore()

    # -- durable state ---------------------------------------------------

    @property
    def plan_fingerprint(self) -> str:
        """Stable digest of (copybook text, parse-relevant options) —
        the sink's schema-drift sentinel: a dataset written under one
        fingerprint refuses batches produced under another."""
        from ..plan.cache import parse_fingerprint

        return parse_fingerprint(self.copybook_contents, self.params)

    @property
    def app_state(self):
        """The consumer state committed with the last durable ack (the
        restart-recovery token for exactly-once consumers)."""
        return self._app_state

    @property
    def delivered_records(self) -> int:
        """Rows delivered so far (committed + in the unacked window)."""
        return self._delivered_records

    def _restore(self) -> None:
        if self.store is None:
            return
        ckpt = self.store.load()
        if ckpt is None:
            return
        self._order = list(ckpt.order)
        self._delivered_records = ckpt.delivered_records
        self._delivered_batches = ckpt.delivered_batches
        self._errors_total = ckpt.errors_total
        self._app_state = ckpt.app_state
        self._finished = dict(ckpt.indexers.pop("__finished__", {}) or {})
        for path, payload in ckpt.sources.items():
            state = SourceState.from_dict(payload)
            live = _LiveSource(state)
            idx_state = (ckpt.indexers or {}).get(path)
            if idx_state:
                live.indexer = IncrementalIndexer.from_state(idx_state)
            self._sources[path] = live

    def watermark(self) -> dict:
        """The stream's live watermark as a JSON-safe dict — the serve
        follow mode ships this inside resume tokens so a client can
        re-subscribe on ANOTHER replica from the exact delivery point
        (`seed_watermark` is the receiving side)."""
        return {
            "sources": {path: live.state.to_dict()
                        for path, live in self._sources.items()},
            "order": list(self._order),
            "delivered_records": self._delivered_records,
        }

    def seed_watermark(self, watermark: dict) -> None:
        """Adopt a watermark produced by another ingestor's
        `watermark()` (replica failover): sources resume from the
        recorded offsets — identity (inode / head CRC / fingerprint)
        is re-verified by the normal probes on the first poll, so a
        source that rotated between attempts is handled structurally,
        never decoded against stale offsets. Must be called before the
        first batch is pulled."""
        if self._delivered_records or self._sources:
            raise RuntimeError("seed_watermark() must run on a fresh "
                               "ingestor, before any delivery")
        self._order = [str(t) for t in (watermark.get("order") or [])]
        self._delivered_records = int(
            watermark.get("delivered_records") or 0)
        for path, payload in (watermark.get("sources") or {}).items():
            state = SourceState.from_dict(payload)
            live = _LiveSource(state)
            if self.is_var_len and not self._is_remote(path):
                live.indexer = self._new_indexer() \
                    if state.offset == 0 else None
            self._sources[path] = live

    def _snapshot(self) -> StreamCheckpoint:
        sources = {}
        indexers = {}
        for path, live in self._sources.items():
            sources[path] = live.state.to_dict()
            if live.indexer is not None:
                indexers[path] = live.indexer.state_dict()
        if self._finished:
            indexers["__finished__"] = dict(self._finished)
        return StreamCheckpoint(
            delivered_records=self._delivered_records,
            delivered_batches=self._delivered_batches,
            sources=sources, order=list(self._order),
            app_state=self._app_state, indexers=indexers,
            errors_total=self._errors_total)

    # unacked snapshots retained; a consumer holding a batch older than
    # this many later pulls can no longer ack it individually
    _STAGE_WINDOW = 256

    def ack(self, app_state=_UNSET, _seq: Optional[int] = None) -> None:
        """Durably commit the watermark of the most recent batch (or of
        the specific batch that called `batch.ack()`). Raises OSError
        when the checkpoint cannot be made durable — an un-persistable
        ack must never claim success."""
        if not self._staged:
            return  # nothing delivered since the last commit
        seq = _seq if _seq else max(self._staged)
        if seq <= self._acked_seq:
            return  # already covered by a later ack
        commit = self._staged.get(seq)
        if commit is None:
            raise RuntimeError(
                f"batch #{seq} left the {self._STAGE_WINDOW}-batch "
                "staging window unacked; ack batches promptly (or use "
                "ingestor.ack() to commit the latest watermark)")
        if app_state is not _UNSET:
            self._app_state = app_state
        commit.app_state = self._app_state
        for old in [s for s in self._staged if s <= seq]:
            del self._staged[old]
        self._acked_seq = seq
        if self.store is not None:
            self.store.commit(commit)
            self.metrics["checkpoints"].inc()

    # -- source discovery ------------------------------------------------

    def _file_token(self, path: str, generation: int) -> str:
        return f"{path}::g{generation}" if generation else path

    def _assign_file_id(self, path: str, generation: int) -> int:
        token = self._file_token(path, generation)
        try:
            return self._order.index(token)
        except ValueError:
            self._order.append(token)
            return len(self._order) - 1

    def _discover(self) -> None:
        try:
            listed = list_input_files(self.path)
        except FileNotFoundError:
            listed = []  # directory/glob/prefix not created yet
        known_inos = {live.state.ino: path
                      for path, live in self._sources.items()
                      if live.state.ino}
        for f in listed:
            if f in self._sources:
                continue
            self._refuse_compressed(f)
            if path_scheme(f) in (None, "file"):
                stat = stat_local(f)
                if stat is None:
                    continue
                size, ino = stat
                if ino and ino in known_inos:
                    # the CURRENT generation of a tracked source,
                    # renamed (rotation in progress): remember where it
                    # went so a handle-less recovery can still drain it
                    self._sources[known_inos[ino]].alias_path = f
                    continue
                fin = self._finished.get(str(ino))
                if fin and fin.get("size") == size:
                    probe = SourceState(path=f, file_id=0,
                                        head_len=int(fin["head_len"]),
                                        head_crc=int(fin["head_crc"]))
                    if head_matches(f, probe):
                        continue  # a drained old generation, renamed
            state = SourceState(path=f,
                                file_id=self._assign_file_id(f, 0))
            self._sources[f] = _LiveSource(state)
            if self.is_var_len and not self._is_remote(f):
                self._sources[f].indexer = self._new_indexer()
        # sources that left the listing: remote done entries prune;
        # local ones keep draining through their handle
        for path in list(self._sources):
            live = self._sources[path]
            if live.state.done and path not in listed:
                self._forget(path)

    def _new_indexer(self) -> Optional[IncrementalIndexer]:
        p = self.params
        if p.input_split_records is None and p.input_split_size_mb is None:
            # match the one-shot default split so index equivalence holds
            return IncrementalIndexer()
        return IncrementalIndexer(records_per_entry=p.input_split_records,
                                  size_per_entry_mb=p.input_split_size_mb)

    def _is_remote(self, path: str) -> bool:
        return path_scheme(path) not in (None, "file")

    def _refuse_compressed(self, path: str) -> None:
        """A compressed feed cannot be tailed: the decompressed tail is
        not addressable until the member closes, and the compressed tail
        bytes are rewritten in place as the writer flushes — both break
        the offset/CRC watermark contract. Refuse loudly instead of
        framing garbage. Local files are magic-sniffed; remote files are
        judged by extension only (no extra round trips per poll)."""
        from ..io.compress import active_codec, codec_for_path

        codec = None
        if self._is_remote(path):
            codec = codec_for_path(path)
        else:
            try:
                codec = active_codec(path, self.io)
            except (OSError, ValueError):
                return  # unreadable now; the normal drain path reports
        if codec is not None:
            raise ValueError(
                f"continuous ingestion cannot tail compressed input "
                f"{path!r} (detected codec: {codec.name}); decompress "
                f"the feed before tailing, or use read_cobol on the "
                f"closed compressed file")

    def _forget(self, path: str) -> None:
        live = self._sources.pop(path, None)
        if live is not None and live.handle is not None:
            live.handle.close()

    # -- the delivery loop ------------------------------------------------

    def __iter__(self) -> Iterator[IngestBatch]:
        return self.batches()

    def batches(self) -> Iterator[IngestBatch]:
        """The delivery generator. Yields `IngestBatch`es as source
        bytes stabilize; honors `max_batches` / `idle_timeout_s`;
        auto-acks the previous batch on each pull when `auto_ack`."""
        idle_since = time.monotonic()
        produced = 0
        while not self._closed:
            self._discover()
            progressed = False
            for path in sorted(self._sources,
                               key=lambda p:
                               self._sources[p].state.file_id):
                live = self._sources[path]
                for batch in self._drain_source(live):
                    if self.auto_ack:
                        self.ack()  # commits the PREVIOUS batch
                    self._stage_commit(batch)
                    progressed = True
                    produced += 1
                    idle_since = time.monotonic()
                    yield batch
                    if self.max_batches is not None \
                            and produced >= self.max_batches:
                        return
                    if self._closed:
                        return
            self._update_gauges()
            if progressed:
                continue
            if self.idle_timeout_s is not None and \
                    time.monotonic() - idle_since >= self.idle_timeout_s:
                if self.finalize_on_idle:
                    for batch in self._finalize_all():
                        if self.auto_ack:
                            self.ack()
                        self._stage_commit(batch)
                        yield batch
                    if self.auto_ack:
                        self.ack()
                return
            time.sleep(self.poll_interval_s)

    def _stage_commit(self, batch: IngestBatch) -> None:
        """Snapshot the post-batch watermark as this batch's ack
        payload (bounded staging window)."""
        self._batch_seq += 1
        batch._seq = self._batch_seq
        self._staged[self._batch_seq] = self._snapshot()
        while len(self._staged) > self._STAGE_WINDOW:
            del self._staged[min(self._staged)]

    def close(self, finalize: bool = False) -> List[IngestBatch]:
        """Stop the stream. With `finalize=True`, decode every source's
        remaining tail under the record-error policy (returned as a
        final batch list) and persist final sparse indexes."""
        out: List[IngestBatch] = []
        if finalize and not self._closed:
            out = list(self._finalize_all())
            for batch in out:
                self._stage_commit(batch)
            if self.auto_ack:
                self.ack()
        self._closed = True
        for path in list(self._sources):
            live = self._sources[path]
            if live.handle is not None:
                live.handle.close()
                live.handle = None
        _publish_gauges(id(self), self.metrics, None, None)
        return out

    def _finalize_all(self) -> Iterator[IngestBatch]:
        for path in sorted(self._sources,
                           key=lambda p: self._sources[p].state.file_id):
            live = self._sources[path]
            if live.state.done:
                continue
            if live.final_size is None:
                size = self._live_size(live)
                if size is None:
                    continue
                live.final_size = size
            live.finalizing = True
            yield from self._drain_source(live)

    def _live_size(self, live: _LiveSource) -> Optional[int]:
        state = live.state
        if self._is_remote(state.path):
            try:
                from ..reader.stream import source_size

                return source_size(state.path, retry=self.retry)
            except Exception:
                return None
        if live.handle is not None:
            return live.handle.size()
        stat = stat_local(live.alias_path or state.path)
        return stat[0] if stat else None

    # -- per-source drain -------------------------------------------------

    def _drain_source(self, live: _LiveSource) -> Iterator[IngestBatch]:
        state = live.state
        if state.done:
            return
        if self._is_remote(state.path):
            yield from self._drain_remote(live)
            return
        # (re)acquire the generation handle
        if live.handle is None and live.final_size is None:
            probe = probe_local(state, None)
            if probe.verdict == "vanished" and live.alias_path:
                alias_stat = stat_local(live.alias_path)
                if alias_stat is not None:
                    probe = SourceProbe("grew", size=alias_stat[0])
            if probe.verdict == "vanished":
                if state.offset or state.pending_offset:
                    _logger.warning(
                        "tailed source %s vanished with %d bytes "
                        "committed; dropping the source",
                        state.path, state.offset)
                self._forget(state.path)
                return
            if probe.verdict == "truncated":
                yield from self._on_truncated(live, probe.size)
                return
            if probe.verdict == "rotated":
                # restart recovery: the generation the checkpoint
                # describes is no longer at the path — continue from an
                # inode/head-matched alias when one exists, else the
                # unread tail is gone
                alias = self._find_alias(state)
                alias_stat = stat_local(alias) if alias else None
                if alias_stat is None:
                    # vanished again between discovery and stat: treat
                    # like no alias at all
                    alias = None
                if alias is None:
                    _logger.warning(
                        "source %s rotated while the ingestor was "
                        "down and the old generation could not be "
                        "located; its unread tail (from offset %d) is "
                        "lost — starting the new generation",
                        state.path, state.offset)
                    self.metrics["rotations"].inc()
                    self._switch_generation(live, drained=False)
                    return
                live.alias_path = alias
                live.final_size = alias_stat[0]
                live.finalizing = True
                live.rotating = True
            try:
                live.handle = TailedFile(live.alias_path or state.path)
                if not state.ino:
                    state.ino = live.handle.ino
            except OSError:
                return
        if live.final_size is None:
            probe = probe_local(state, live.handle)
            if probe.verdict == "truncated":
                yield from self._on_truncated(live, probe.size)
                return
            if probe.verdict in ("grew", "unchanged") \
                    and probe.size != live.last_seen_size:
                # the file changed size: prove the held generation still
                # carries our consumed prefix. An in-place rewrite keeps
                # the inode and may even be LARGER than the watermark —
                # only the head CRC separates "grew" from "replaced",
                # and decoding a replacement against old offsets would
                # be silently wrong rows
                live.last_seen_size = probe.size
                if not handle_head_matches(live.handle, state):
                    _logger.warning(
                        "source %s was rewritten in place (head bytes "
                        "no longer match the committed watermark); the "
                        "old generation is unrecoverable", state.path)
                    yield from self._on_truncated(live, probe.size)
                    return
            if probe.verdict == "rotated":
                live.final_size = probe.size
                live.finalizing = True
                live.rotating = True
                stable = probe.size
            else:
                stable = probe.size
        else:
            stable = live.final_size
        yield from self._decode_stable(live, stable)
        if live.finalizing and state.pending_offset >= \
                (live.final_size or 0):
            self._finish_generation(live)

    def _find_alias(self, state: SourceState) -> Optional[str]:
        """Locate a rotated-away generation by inode + head CRC in the
        current listing (rename rotation keeps both)."""
        try:
            listed = list_input_files(self.path)
        except FileNotFoundError:
            return None
        for f in listed:
            if self._is_remote(f) or f == state.path:
                continue
            stat = stat_local(f)
            if stat is None:
                continue
            _size, ino = stat
            if state.ino and ino == state.ino and head_matches(f, state):
                return f
        return None

    def _on_truncated(self, live: _LiveSource, new_size: int
                      ) -> Iterator[IngestBatch]:
        state = live.state
        self.metrics["truncations"].inc()
        if self.truncation_policy == "error":
            raise SourceTruncated(state.path, new_size,
                                  state.pending_offset)
        _logger.warning(
            "source %s no longer carries its committed watermark "
            "(live size %d, watermark %d bytes); restarting the "
            "generation (truncation_policy='restart')", state.path,
            new_size, state.pending_offset)
        self._switch_generation(live, drained=False)
        return
        yield  # pragma: no cover — makes this a generator

    def _switch_generation(self, live: _LiveSource,
                           drained: bool) -> None:
        if not drained:
            # truncation/restart: the generation's profile is partial —
            # discard it rather than emit drift from incomplete data
            self._drift_generation_end(live, drained=False)
        state = live.state
        if drained and state.ino:
            self._finished[str(state.ino)] = {
                "head_len": state.head_len, "head_crc": state.head_crc,
                "size": state.offset if not live.finalizing
                else (live.final_size or state.offset)}
            while len(self._finished) > _FINISHED_KEEP:
                self._finished.pop(next(iter(self._finished)))
        if live.handle is not None:
            live.handle.close()
            live.handle = None
        generation = state.generation + 1
        fresh = SourceState(
            path=state.path,
            file_id=self._assign_file_id(state.path, generation),
            generation=generation)
        live.state = fresh
        live.alias_path = None
        live.final_size = None
        live.finalizing = False
        live.rotating = False
        live.stalled_since = None
        live.indexer = (self._new_indexer() if self.is_var_len
                        and not self._is_remote(state.path) else None)

    def _finish_generation(self, live: _LiveSource) -> None:
        """A generation is fully drained: persist its final sparse
        index, then either switch to the successor (rotation) or mark
        the source done (stream finalize)."""
        state = live.state
        self._drift_generation_end(live, drained=True)
        self._persist_final_index(live)
        state.offset = state.pending_offset
        state.records = state.pending_records
        if not live.rotating:
            state.done = True
            return
        self.metrics["rotations"].inc()
        _logger.info("source %s generation %d drained at %d bytes; "
                     "switching to the new generation", state.path,
                     state.generation, state.pending_offset)
        self._switch_generation(live, drained=True)

    def _persist_final_index(self, live: _LiveSource) -> None:
        if (live.indexer is None or self.io is None
                or not self.io.cache_enabled):
            return
        from ..io.index_store import (SparseIndexStore,
                                      index_config_fingerprint)
        from ..reader.parameters import MEGABYTE

        p = self.params
        split_mb = p.input_split_size_mb or 100
        explicit = (p.input_split_records is not None
                    or p.input_split_size_mb is not None)
        size = live.state.pending_offset
        if size == 0 or (not explicit and size <= split_mb * MEGABYTE):
            return  # one-shot indexing would skip this file too
        target = live.alias_path or live.state.path
        try:
            store = SparseIndexStore(self.io.cache_dir)
            config_fp = index_config_fingerprint(self.reader, self.params)
            entries = live.indexer.entries(live.state.file_id)
            store.save_for_local_path(target, config_fp, entries)
        except OSError:
            pass  # the cache must never fail the stream

    # -- decoding ---------------------------------------------------------

    def _decode_stable(self, live: _LiveSource, stable: int
                       ) -> Iterator[IngestBatch]:
        state = live.state
        final = live.final_size is not None
        if (self.params.resolved_pipeline_workers() > 0
                and stable - state.pending_offset
                >= 2 * self.batch_max_bytes):
            # a large backlog (catch-up after restart / a burst): run
            # the window decodes through the pipelined engine — a
            # bounded number of in-flight windows decoding concurrently
            # while this generator yields them in order. The remainder
            # (and every edge case: final tails, anomalies) stays on
            # the sequential path below
            yield from self._drain_backlog_pipelined(live, stable)
        while True:
            start = state.pending_offset
            avail = stable - start
            if avail <= 0:
                return
            take = min(avail, self.batch_max_bytes)
            raw = self._read_span(live, start, take)
            if len(raw) < take and not final:
                stable = start + len(raw)  # source shrank mid-poll;
                if len(raw) == 0:          # re-classified next poll
                    return
            window, records, anomaly, sizes = self._cut(
                live, raw, start, final and start + len(raw) >= stable)
            if not window:
                self._note_stall(live, anomaly)
                return
            live.stalled_since = None
            self._feed_indexer(live, sizes)
            batch = self._decode_window(live, window, start,
                                        final and start + len(window)
                                        >= stable)
            state.extend_head(window, start)
            state.pending_offset = start + len(window)
            # the post-batch watermark: durably committed only when the
            # consumer acks the snapshot staged after this yield
            state.offset = state.pending_offset
            state.records = state.pending_records
            self._advance_metrics(batch)
            if batch is not None:
                yield batch

    def _read_span(self, live: _LiveSource, offset: int,
                   n: int) -> bytes:
        state = live.state
        if live.handle is not None:
            return live.handle.read_at(offset, n)
        path = live.alias_path or state.path
        with open_stream(path, start_offset=offset, maximum_bytes=n,
                         retry=self.retry, io=self.io) as stream:
            return stream.next(n)

    def _cut(self, live: _LiveSource, raw: bytes, base_offset: int,
             final: bool):
        """(window, records_walked, anomaly, record_sizes) — the
        decodable prefix of `raw`. `window` ends at a record boundary
        (live) or spans the whole remainder (final, so tail policy
        matches a one-shot read); `records_walked` counts header-framed
        records; `record_sizes` is the indexer feed for the returned
        window (the CALLER feeds it when — and only when — the window's
        watermark advances); `anomaly` marks a header that failed to
        parse (the decode of the returned window surfaces it under the
        record-error policy)."""
        state = live.state
        if not self.is_var_len:
            rs = self.reader.record_size
            usable = (len(raw) // rs) * rs
            if final and usable < len(raw):
                # the generation ended mid-record: hand the tail to the
                # decoder so fail_fast raises / permissive ledgers,
                # exactly like a one-shot read of the final file
                return raw, len(raw) // rs, False, ()
            return raw[:usable], usable // rs, False, ()
        pos = 0
        walked = 0
        hl = self._parser.header_length
        sizes: List[tuple] = []
        anomaly = False
        while True:
            if pos + hl > len(raw):
                break
            header = raw[pos:pos + hl]
            try:
                meta = self._parser.get_record_metadata(
                    header, base_offset + pos + hl, LIVE_FILE_SIZE,
                    state.pending_records + walked)
            except Exception:
                anomaly = True
                break
            if meta.record_length < 0:
                anomaly = True
                break
            end = pos + hl + meta.record_length
            if end > len(raw):
                break  # incomplete tail record: wait for more bytes
            sizes.append((hl + meta.record_length, meta.is_valid))
            pos = end
            walked += 1
        if anomaly:
            resync = self.params.resync_window_bytes
            if pos > 0:
                # deliver the clean prefix first; the corrupt run is
                # next batch's problem (with full resync context)
                anomaly = False
            elif not final and len(raw) - pos < resync * 2 \
                    and len(raw) < self.batch_max_bytes \
                    and not self._stall_expired(live):
                # too little context for a faithful resync on a live
                # tail: wait (bounded by tail_grace_s) for more bytes
                return b"", 0, True, ()
            else:
                # decode everything we have: fail_fast raises the
                # framing error; permissive resyncs exactly like a
                # one-shot read over these bytes
                live.indexer = None  # counts diverge past corruption
                return raw, walked, True, ()
        if final and pos < len(raw) and base_offset + len(raw) \
                >= (live.final_size or 0):
            # final window with a partial tail: include it so the
            # decoder applies the end-of-file truncation policy
            return raw, walked, False, sizes
        return raw[:pos], walked, False, sizes

    def _feed_indexer(self, live: _LiveSource, sizes) -> None:
        if live.indexer is not None:
            for size, valid in sizes:
                live.indexer.add_record(size, valid)

    def _stall_expired(self, live: _LiveSource) -> bool:
        return (live.stalled_since is not None
                and time.monotonic() - live.stalled_since
                >= self.tail_grace_s)

    def _note_stall(self, live: _LiveSource, anomaly: bool) -> None:
        if live.stalled_since is None:
            live.stalled_since = time.monotonic()
        elif time.monotonic() - live.stalled_since >= self.tail_grace_s:
            _logger.warning(
                "source %s has held a mid-record%s tail beyond offset "
                "%d for %.1fs without growth",
                live.state.path, " (unparseable)" if anomaly else "",
                live.state.pending_offset, self.tail_grace_s)
            live.stalled_since = time.monotonic()  # warn once per grace

    def _decode_result(self, state: SourceState, window, start: int,
                       start_record_id: int,
                       final_size: Optional[int]):
        """Pure decode of one cut window -> FileResult (shared by the
        sequential loop and the pipelined backlog drain; safe to run
        concurrently — the readers are the same objects the engine
        already shares across its decode pool). `window`: its bytes, or
        `StagedBytes` the pipelined drain's read stage filled (closed
        here either way). It decodes on the calling thread's stream."""
        staged = (window if isinstance(window, StagedBytes)
                  else self.staging.stage(window))
        try:
            with worker_stream(self.device):
                if self.is_var_len:
                    # `WindowStream`'s size rule: the window's end for a
                    # live window, the final size for a final one
                    end = (start + staged.nbytes if final_size is None
                           else final_size)
                    return self.reader.read_shard(
                        staged, state.file_id, start, start_record_id,
                        end, self._prefix, path=state.path, before=b"")
                return self.reader.read_result(
                    staged, file_id=state.file_id,
                    first_record_id=start_record_id,
                    input_file_name=state.path)
        finally:
            staged.close()

    def _wrap_result(self, live: _LiveSource, result, start: int,
                     length: int) -> Optional[IngestBatch]:
        state = live.state
        data = CobolData([], self.schema, results=[result],
                         device=self.device)
        data.diagnostics = result.diagnostics
        if result.diagnostics is not None:
            self._errors_total += result.diagnostics.corrupt_records
        if result.n_rows == 0:
            return None  # fully-filtered window: watermark still moves
        return IngestBatch(data, state.path, state.file_id,
                           state.generation, start, start + length,
                           self, 0)

    def _decode_window(self, live: _LiveSource, window: bytes,
                       start: int, final: bool) -> Optional[IngestBatch]:
        state = live.state
        base = file_record_id_base(state.file_id)
        result = self._decode_result(
            state, window, start, base + state.pending_records,
            final_size=(live.final_size if final else None))
        if self.is_var_len:
            framed = result.records_framed
            state.pending_records += (framed if framed is not None
                                      else result.n_rows)
        else:
            state.pending_records += -(-len(window)
                                       // self.reader.record_size) \
                if final else len(window) // self.reader.record_size
        return self._wrap_result(live, result, start, len(window))

    def _drain_backlog_pipelined(self, live: _LiveSource, stable: int
                                 ) -> Iterator[IngestBatch]:
        """Cut up to one in-flight window's worth of the backlog and
        decode the windows CONCURRENTLY through the engine's
        `PipelineExecutor` (its backpressure bounds live memory; its
        watchdog bounds wedged decodes), yielding batches in record
        order. Record-id bases come from the framing walk, so only
        anomaly-free windows qualify — a window whose walk stops early
        falls back to the sequential loop, which derives ids from the
        decoder itself."""
        from ..engine.pipeline import PipelineExecutor

        state = live.state
        base = file_record_id_base(state.file_id)
        workers = self.params.resolved_pipeline_workers()
        max_windows = self.params.pipeline_max_inflight or workers + 2
        # (start, window, walked, start_record_id, sizes): the cut
        # cursor (pending_*) runs ahead over the whole super-window,
        # but the COMMITTED watermark (offset/records) and the indexer
        # advance per batch at yield time below — acking batch i must
        # commit exactly batch i's watermark, never a later window's
        windows = []
        while len(windows) < max_windows:
            start = state.pending_offset
            if stable - start < self.batch_max_bytes:
                break  # the tail stays sequential (final/partial logic)
            raw = self._read_span(live, start, self.batch_max_bytes)
            if len(raw) < self.batch_max_bytes:
                break
            rid = base + state.pending_records
            if not self.is_var_len:
                rs = self.reader.record_size
                window, walked, sizes = raw, len(raw) // rs, ()
            else:
                window, walked, anomaly, sizes = self._cut(
                    live, raw, start, False)
                if anomaly or not window:
                    break
            windows.append((start, window, walked, rid, sizes))
            state.extend_head(window, start)
            state.pending_offset = start + len(window)
            state.pending_records += walked
        if not windows:
            return

        def commit_window(start, window, walked, sizes) -> None:
            self._feed_indexer(live, sizes)
            state.offset = start + len(window)
            state.records = (state.offset // self.reader.record_size
                             if not self.is_var_len
                             else state.records + walked)

        if len(windows) == 1:
            start, window, walked, rid, sizes = windows[0]
            result = self._decode_result(state, window, start, rid, None)
            commit_window(start, window, walked, sizes)
            batch = self._wrap_result(live, result, start, len(window))
            self._advance_metrics(batch)
            if batch is not None:
                yield batch
            return
        ex = PipelineExecutor(workers, max_inflight=max_windows)

        def make_task(item):
            start, window, _walked, rid, _sizes = item

            def read() -> object:
                # the reader thread stages the window; a worker copies
                # it to the device on its own stream
                return self.staging.stage(window)

            def process(data) -> object:
                return self._decode_result(state, data, start, rid, None)
            return (read, process)

        results = ex.run([make_task(w) for w in windows])
        for (start, window, walked, _rid, sizes), result in zip(
                windows, results):
            if self.is_var_len and result.records_framed is not None \
                    and result.records_framed != walked:
                # the framing walk and the decoder disagreed on an
                # anomaly-free window: record ids past this point
                # would be wrong — refuse loudly rather than deliver
                # misnumbered rows (unreachable for the built-in
                # parsers; a custom parser with hidden state could)
                raise ValueError(
                    f"incremental framing walked {walked} record(s) at "
                    f"offset {start} of {state.path} but the decoder "
                    f"framed {result.records_framed}; the header "
                    "parser is not safe for pipelined tailing")
            commit_window(start, window, walked, sizes)
            batch = self._wrap_result(live, result, start, len(window))
            self._advance_metrics(batch)
            if batch is not None:
                yield batch

    # -- remote (immutable-object) sources -------------------------------

    def _drain_remote(self, live: _LiveSource) -> Iterator[IngestBatch]:
        state = live.state
        try:
            from ..reader.stream import source_size

            size = source_size(state.path, retry=self.retry)
        except Exception as exc:
            _logger.warning("size probe of %s failed: %s", state.path,
                            exc)
            return
        if size < state.pending_offset:
            yield from self._on_truncated(live, size)
            return
        if state.remote_fp and state.pending_offset:
            fp = self._remote_fingerprint(state.path)
            if fp and fp != state.remote_fp:
                # the object was REPLACED mid-consume: immutable stores
                # cannot serve the old generation — restart
                self.metrics["rotations"].inc()
                _logger.warning(
                    "remote source %s changed fingerprint mid-ingest "
                    "(%s -> %s); restarting as a new generation",
                    state.path, state.remote_fp, fp)
                self._switch_generation(live, drained=False)
                return
        if size != live.last_seen_size:
            # an in-progress upload may briefly show partial sizes on
            # some stores: require one stable poll before consuming
            live.last_seen_size = size
            live.remote_stable_polls = 0
            return
        live.remote_stable_polls += 1
        if not state.remote_fp:
            state.remote_fp = self._remote_fingerprint(state.path) or ""
        live.final_size = size
        live.finalizing = True
        yield from self._decode_stable(live, size)
        if state.pending_offset >= size:
            state.done = True
            state.offset = state.pending_offset
            state.records = state.pending_records

    def _remote_fingerprint(self, path: str) -> Optional[str]:
        from ..reader.stream import resolve_stream_backend

        scheme = path_scheme(path)
        try:
            factory = resolve_stream_backend(scheme)
            if factory is None:
                return None
            source = factory(path)
            try:
                return source.fingerprint()
            finally:
                source.close()
        except Exception:
            return None

    # -- observability ----------------------------------------------------

    def lag_bytes(self) -> int:
        """Stable-but-undelivered bytes across every tracked source."""
        lag = 0
        for live in self._sources.values():
            if live.state.done:
                continue
            size = (live.final_size if live.final_size is not None
                    else live.last_seen_size if self._is_remote(
                        live.state.path) else None)
            if size is None:
                size = self._live_size(live)
            if size is not None:
                lag += max(0, size - live.state.pending_offset)
        return lag

    def _advance_metrics(self, batch: Optional[IngestBatch]) -> None:
        self._last_advance = time.monotonic()
        if batch is None:
            return
        self._delivered_batches += 1
        self._delivered_records += batch.records
        self.metrics["batches"].inc()
        self.metrics["records"].inc(batch.records)
        if self.params.collect_stats:
            self._drift_fold(batch)

    # -- drift observability (collect_stats=true) -------------------------

    def _drift_fold(self, batch: IngestBatch) -> None:
        """Fold one delivered batch into its generation's live profile
        (every delivery path — sequential, pipelined backlog, directory
        — funnels through `_advance_metrics`, so no batch is missed)."""
        from ..stats import collect
        from ..stats.drift import GenerationProfile

        entry = self._drift.setdefault(batch.source,
                                       {"prev": None, "live": None})
        name = f"{batch.source}#gen{batch.generation}"
        prof = entry["live"]
        if prof is None or prof.name != name:
            prof = GenerationProfile(
                name, collect.segment_leaf_name(self.reader.copybook,
                                                self.params))
            entry["live"] = prof
        try:
            prof.fold(batch.to_arrow(),
                      nbytes=max(0, batch.offset_to - batch.offset_from))
        except Exception:
            # observability must never fail delivery; a fold error just
            # leaves this window out of the profile
            _logger.debug("drift profile fold failed for %s",
                          batch.source, exc_info=True)

    def _drift_generation_end(self, live: _LiveSource,
                              drained: bool) -> None:
        """A generation ended: compare its completed profile against
        the previous generation's and emit drift records (metrics +
        stats service ring + a JSONL trail under the cache root)."""
        if not self.params.collect_stats:
            return
        entry = self._drift.get(live.state.path)
        if entry is None:
            return
        cur, entry["live"] = entry["live"], None
        if cur is None or not drained:
            return
        prev, entry["prev"] = entry["prev"], cur
        if prev is None:
            return  # first completed generation: nothing to compare
        from ..stats import service
        from ..stats.drift import compare_generations

        events = compare_generations(prev, cur)
        self.metrics["stats_last_drift"].set(len(events))
        if not events:
            return
        for ev in events:
            self.metrics["stats_drift"].labels(kind=ev["kind"]).inc()
        service.note_drift(events)
        self._drift_append_jsonl(events)
        _logger.warning(
            "data drift detected on %s (%d record(s)): %s",
            live.state.path, len(events),
            ", ".join(sorted({ev["kind"] for ev in events})))

    def _drift_append_jsonl(self, events: List[dict]) -> None:
        """Durable drift trail: `<cache_dir>/stats/drift.jsonl`, one
        JSON record per event. Best-effort — the cache must never fail
        the stream."""
        if self.io is None or not self.io.cache_enabled:
            return
        import json as _json

        path = os.path.join(self.io.cache_dir, "stats", "drift.jsonl")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                for ev in events:
                    f.write(_json.dumps(dict(ev, ts=time.time()),
                                        sort_keys=True) + "\n")
        except OSError:
            pass

    def _update_gauges(self) -> None:
        lag = self.lag_bytes()
        age = (0.0 if lag == 0
               else time.monotonic() - self._last_advance)
        _publish_gauges(id(self), self.metrics, lag, age)


def tail_cobol(path, copybook: Optional[str] = None,
               copybook_contents=None, **kwargs) -> ContinuousIngestor:
    """Convenience constructor: ``for batch in tail_cobol(...)``."""
    return ContinuousIngestor(path, copybook=copybook,
                              copybook_contents=copybook_contents,
                              **kwargs)


def _validate_tailable(params: ReaderParameters) -> None:
    """Refuse configurations with no safe incremental framing on a live
    stream — loudly, up front, naming the alternative."""
    blockers = []
    if params.record_extractor:
        blockers.append("record_extractor")
    if params.is_text:
        blockers.append("is_text")
    if params.variable_size_occurs:
        blockers.append("variable_size_occurs")
    if params.length_field_name:
        blockers.append("record_length_field")
    if params.file_start_offset or params.file_end_offset:
        blockers.append("file_start_offset/file_end_offset")
    seg = params.multisegment
    if seg and (seg.segment_level_ids or seg.field_parent_map):
        blockers.append("segment_id_level*/segment-children")
    if getattr(params, "compression", "auto") not in (
            "auto", "none", "off", "raw"):
        # a growing compressed member has no stable byte identity: the
        # tail bytes a poll observed are rewritten when the writer
        # flushes more input into the same member, so offset/CRC
        # watermarks cannot survive a restart
        blockers.append("compression")
    if blockers:
        raise ValueError(
            "continuous ingestion supports record-header-parser framing "
            "only (fixed-length, RDW sequences, custom header parsers); "
            f"unsupported option(s): {', '.join(blockers)}. Use "
            "read_cobol / the micro-batch streaming API on closed files "
            "for these configurations.")
