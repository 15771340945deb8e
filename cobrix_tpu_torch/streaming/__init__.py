"""Streaming ingestion for cobrix_tpu_torch (port copy of
``cobrix_tpu.streaming``; every window decodes on the card unless a
surface is given ``device="cpu"``).

Two tiers:

* **micro-batch** (`CobolStreamer`, `stream_cobol` — the historical
  `cobrix_tpu.streaming` surface, kept import-compatible): decode byte
  chunks or whole new files appearing in a directory; in-memory state
  only.
* **continuous ingestion** (`ContinuousIngestor`, `tail_cobol`): the
  production feed — tail growing/rotating local files and object-store
  prefixes with durable CRC-framed checkpoints (`CheckpointStore`),
  an exactly-once ack window, structured rotation/truncation handling
  (`SourceTruncated`), incremental sparse indexing, and the
  `cobrix_stream_*` Prometheus metrics. Checkpoints are the JAX
  package's payloads: a checkpoint directory resumes in either package.
"""
from .checkpoint import CheckpointStore, StreamCheckpoint
from .ingest import ContinuousIngestor, IngestBatch, tail_cobol
from .microbatch import CobolStreamer, stream_cobol
from .sources import SourceState, SourceTruncated

__all__ = [
    "CheckpointStore",
    "StreamCheckpoint",
    "ContinuousIngestor",
    "IngestBatch",
    "tail_cobol",
    "CobolStreamer",
    "stream_cobol",
    "SourceState",
    "SourceTruncated",
]
