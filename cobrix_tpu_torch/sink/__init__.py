"""Transactional lakehouse sink: crash-consistent Parquet/Arrow-IPC
datasets driven by the exactly-once ingest ack window (port copy of
``cobrix_tpu.sink``).

* `sink_cobol(tail_cobol(...), dataset_dir)` — continuous
  mainframe→lakehouse pipeline: each micro-batch (decoded and built
  into Arrow on the card) is staged, finalized, and committed by a
  CRC-stamped manifest record whose position rides the checkpoint's
  ``app_state``; SIGKILL anywhere recovers to a dataset
  byte-identical to a one-shot read of the final sources.
* `read_cobol(...).to_dataset(dataset_dir)` — one-shot atomic batch
  export: the read's table (built by the assembly kernels on the card)
  is staged, finalized, and committed by ONE CRC-stamped manifest
  record; a crash leaves the dataset unchanged.
* `read_dataset(dataset_dir)` — checksum-verified read-back in commit
  order; the committed files are also plain Parquet/Arrow-IPC under
  ``data/``, consumable by any engine.
* `fsck_sink` — offline verify/repair.

The on-disk layout, the manifest records and the schema fingerprint
are the JAX package's, so either package reads, appends to and repairs
the other's datasets, and a stream's checkpoint directory resumes in
either package.

Corruption detections count under Prometheus plane ``"sink"``
(``cobrix_cache_corruption_total``); commit/recovery counters are the
``cobrix_sink_*`` series (`obs.metrics.sink_metrics`).
"""
from .drive import SinkResult, sink_cobol, sink_for_ingestor
from .manifest import (
    SinkCorruption,
    SinkError,
    SinkSchemaError,
    schema_fingerprint,
)
from .writer import (
    ADOPT,
    DatasetSink,
    fsck_sink,
    read_dataset,
    set_sink_fault_hook,
)

__all__ = [
    "ADOPT",
    "DatasetSink",
    "SinkCorruption",
    "SinkError",
    "SinkResult",
    "SinkSchemaError",
    "fsck_sink",
    "read_dataset",
    "schema_fingerprint",
    "set_sink_fault_hook",
    "sink_cobol",
    "sink_for_ingestor",
]
