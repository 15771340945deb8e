"""Drive modes: continuous `sink_cobol` and the one-shot export glue.

Port copy of ``cobrix_tpu.sink.drive`` over the port's `DatasetSink`:
each batch's table is built by the assembly kernels on the ingestor's
device before it commits.

`sink_cobol(tail_cobol(...), dataset_dir)` is the turnkey
mainframe→lakehouse pipeline: every `IngestBatch` the ingestor yields
is committed into the dataset INSIDE the batch's ack window — the
manifest position produced by `DatasetSink.commit_table` is exactly the
``app_state`` the checkpoint commit persists, so a SIGKILL at any
instant recovers to a dataset byte-identical to a one-shot read of the
final sources: never a duplicated, dropped, or torn batch. Source
rotation and truncation mid-sink are the ingestor's events and flow
through unchanged (a ``truncation_policy='error'`` stream raises
`SourceTruncated` with nothing half-committed).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .manifest import schema_fingerprint
from .writer import DatasetSink


@dataclass
class SinkResult:
    """What one `sink_cobol` drive committed (cumulative over the
    dataset, including batches recovered from earlier runs)."""

    dataset_dir: str
    batches: int = 0            # committed by THIS drive
    records: int = 0            # committed by THIS drive
    records_total: int = 0      # committed in the dataset overall
    files: int = 0
    bytes_written: int = 0
    recovery: dict = field(default_factory=dict)

    def to_table(self):
        from .writer import read_dataset

        return read_dataset(self.dataset_dir)


def stream_owner(ingestor) -> str:
    """The stream identity recorded as the dataset's owner: only THIS
    checkpoint store's recovery may truncate the dataset's manifest
    (a different stream — or no checkpoint at all — refuses instead of
    silently discarding committed history)."""
    store = getattr(ingestor, "store", None)
    if store is None:
        return ""
    import os

    return f"{os.path.realpath(store.root)}::{store.stream_id}"


def sink_for_ingestor(ingestor, dataset_dir: str,
                      file_format: str = "parquet",
                      partition_by=(), target_file_mb: float = 64.0
                      ) -> DatasetSink:
    """A `DatasetSink` bound to one ingest stream: schema + fingerprint
    from the ingestor's copybook plan, recovery from the ingestor's
    committed ``app_state`` (the exactly-once pairing `sink_cobol`
    drives; exposed for consumers that need manual batch control)."""
    from ..reader.arrow_out import arrow_schema as _arrow_schema

    schema = _arrow_schema(ingestor.schema.schema)
    return DatasetSink(
        dataset_dir, arrow_schema=schema,
        schema_fp=schema_fingerprint(schema, ingestor.plan_fingerprint),
        file_format=file_format, partition_by=partition_by,
        target_file_mb=target_file_mb, retry=ingestor.retry,
        committed_state=ingestor.app_state,
        owner=stream_owner(ingestor))


def sink_cobol(ingestor, dataset_dir: str,
               file_format: str = "parquet",
               partition_by=(), target_file_mb: float = 64.0,
               on_commit: Optional[Callable] = None) -> SinkResult:
    """Drain `ingestor` (a `streaming.tail_cobol` /
    `ContinuousIngestor`) into a transactional dataset until the
    ingestor's own loop bounds end it (``idle_timeout_s`` /
    ``max_batches``; without either this tails forever).

    Each batch commits before it acks; the ack persists the manifest
    position atomically with the source watermark. Crash recovery is
    automatic on the next `sink_cobol` over the same
    ``checkpoint_dir`` + ``dataset_dir`` pair. ``on_commit(info)``
    receives ``{"seq", "rows", "files", "bytes", "source", ...}``
    after the durable commit and BEFORE the ack — an exception aborts
    the drive with the batch committed but unacked, so the next
    recovery truncates that commit and the batch re-drives (the veto
    hook for external side effects like catalog registration).
    """
    sink = sink_for_ingestor(ingestor, dataset_dir,
                             file_format=file_format,
                             partition_by=partition_by,
                             target_file_mb=target_file_mb)
    result = SinkResult(dataset_dir=dataset_dir,
                        recovery=dict(sink.recovery))
    for batch in ingestor:
        table = batch.to_arrow()
        t0 = time.monotonic()
        token = sink.commit_table(
            table, source=batch.source,
            offset_from=batch.offset_from, offset_to=batch.offset_to)
        if on_commit is not None:
            # committed but NOT yet acked: an exception here vetoes
            # the ack and the batch re-drives after restart recovery
            info = dict(sink.last_commit or {})
            info["commit_s"] = time.monotonic() - t0
            info["app_state"] = token
            on_commit(info)
        batch.ack(app_state=token)
        result.batches += 1
        result.records += table.num_rows
        result.records_total = token["sink"]["records"]
        result.files += (sink.last_commit or {}).get("files", 0)
        result.bytes_written += (sink.last_commit or {}).get("bytes", 0)
        sink.metrics["lag_bytes"].set(ingestor.lag_bytes())
    result.records_total = sink.app_state_token()["sink"]["records"]
    return result
