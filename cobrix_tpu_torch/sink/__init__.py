"""Transactional lakehouse sink: crash-consistent Parquet/Arrow-IPC
datasets (port copy of ``cobrix_tpu.sink``, its one-shot half).

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
the other's datasets. `DatasetSink` keeps the stream recovery
(``committed_state``, ownership) whole; the streaming drive that uses
it (``sink_cobol``, ``sink_for_ingestor``, ``SinkResult``) comes with
the port's streaming tier.

Corruption detections count under Prometheus plane ``"sink"``
(``cobrix_cache_corruption_total``); commit/recovery counters are the
``cobrix_sink_*`` series (`obs.metrics.sink_metrics`).
"""
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
    "SinkSchemaError",
    "fsck_sink",
    "read_dataset",
    "schema_fingerprint",
    "set_sink_fault_hook",
]
