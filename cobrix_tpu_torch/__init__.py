"""cobrix_tpu_torch — the PyTorch/CUDA port of cobrix_tpu.

Parses COBOL copybooks and decodes fixed-length and RDW variable-length
(single- or multisegment, flat or hierarchical) EBCDIC files into
columnar data on an NVIDIA GPU: RDW files are framed and their records packed on the card by
hand-written CUDA kernels (``csrc/rdw_framing.cu``), every numeric field
of a record batch is decoded by one launch of a hand-written CUDA kernel
(``csrc/fused_decode.cu``), strings and floats by PyTorch ops on the same
device. With ``pipeline_workers`` a read runs through a chunk pipeline
(``engine``): pinned staging buffers, a CUDA stream per decode worker and
one copy back per decoded batch. Compressed feeds (gzip, bz2, xz, zlib,
zstd) are inflated on the host as they are read and storage backends
plug in by scheme (``register_stream_backend``, fsspec), with retries,
a persistent block cache, read-ahead and a persisted sparse index
(``io``). A ``filter`` (``query``: typed expressions, their grammar and
wire form, and a ``pyarrow.dataset``-shaped scan surface) is pushed into
the device read: the filter columns are decoded first and only the kept
records are decoded in full. Every read reports into the observability
plane (``obs``): trace spans with a Chrome-trace export (``trace_file``),
live progress (``progress_callback``), per-field decode and assemble
costs (``field_costs``), the metrics registry (``prometheus_text``) and
``explain``. The write half re-encodes a read's rows to mainframe bytes
(``CobolData.to_ebcdic``, ``encode``) and commits its table into a
transactional Parquet or Arrow-IPC dataset (``CobolData.to_dataset``,
``sink``, ``read_dataset``). Continuous ingestion tails growing and
rotating files with durable checkpoints (``tail_cobol``,
``ContinuousIngestor``, ``streaming``), decoding every window on the
card, and ``sink_cobol`` commits its batches into such a dataset
exactly once. The package imports torch and numpy and
nothing of ``cobrix_tpu``; it keeps its own copies of the copybook front
end, plan compiler, code pages, readers and pipeline. Entry points run on
the CUDA device unless given ``device="cpu"``.
"""
from .api import CobolData, read_cobol
from .copybook.copybook import Copybook, merge_copybooks, parse_copybook
from .copybook.datatypes import (
    CommentPolicy,
    DebugFieldsPolicy,
    Encoding,
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
    Usage,
)
from .device import resolve_device
from .explain import ScanReport, explain
from .io import IoConfig, register_fsspec_backend
from .io.compress import CompressedStreamError, register_codec
from .obs import ScanProgress, Tracer, prometheus_text
from .reader.columnar import ColumnarDecoder, DecodedBatch
from .profiling import ReadMetrics, profile_trace
from .reader.diagnostics import (FramingError, ReadDiagnostics,
                                 RecordErrorPolicy, ShardErrorPolicy,
                                 ShardFailureInfo)
from .reader.handlers import (DictHandler, JsonHandler, RecordHandler,
                              TupleHandler)
from .reader.stream import (ByteRangeSource, open_stream,
                            register_stream_backend, source_size)
from .sink import (DatasetSink, SinkCorruption, SinkSchemaError,
                   read_dataset, sink_cobol)
from .streaming import ContinuousIngestor, SourceTruncated, tail_cobol
from . import query

__all__ = [
    "ByteRangeSource",
    "CobolData",
    "CompressedStreamError",
    "ColumnarDecoder",
    "CommentPolicy",
    "ContinuousIngestor",
    "Copybook",
    "DatasetSink",
    "DebugFieldsPolicy",
    "DecodedBatch",
    "DictHandler",
    "Encoding",
    "FloatingPointFormat",
    "FramingError",
    "IoConfig",
    "JsonHandler",
    "ReadDiagnostics",
    "ReadMetrics",
    "RecordErrorPolicy",
    "RecordHandler",
    "ScanProgress",
    "ScanReport",
    "SchemaRetentionPolicy",
    "ShardErrorPolicy",
    "ShardFailureInfo",
    "SinkCorruption",
    "SinkSchemaError",
    "SourceTruncated",
    "Tracer",
    "TrimPolicy",
    "TupleHandler",
    "Usage",
    "explain",
    "merge_copybooks",
    "open_stream",
    "parse_copybook",
    "profile_trace",
    "prometheus_text",
    "query",
    "read_cobol",
    "read_dataset",
    "register_codec",
    "register_fsspec_backend",
    "register_stream_backend",
    "resolve_device",
    "sink_cobol",
    "source_size",
    "tail_cobol",
]
