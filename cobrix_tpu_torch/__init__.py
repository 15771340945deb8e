"""cobrix_tpu_torch — the PyTorch/CUDA port of cobrix_tpu.

Parses COBOL copybooks and decodes fixed-length and RDW variable-length
(single- or multisegment, flat or hierarchical) EBCDIC files into
columnar data on an NVIDIA GPU: RDW files are framed and their records packed on the card by
hand-written CUDA kernels (``csrc/rdw_framing.cu``), every numeric field
of a record batch is decoded by one launch of a hand-written CUDA kernel
(``csrc/fused_decode.cu``), strings and floats by PyTorch ops on the same
device. With ``pipeline_workers`` a read runs through a chunk pipeline
(``engine``): pinned staging buffers, a CUDA stream per decode worker and
one copy back per decoded batch. The package imports torch and numpy and
nothing of ``cobrix_tpu``; it keeps its own copies of the copybook front
end, plan compiler, code pages, readers and pipeline. Entry points run on
the CUDA device unless given ``device="cpu"``.
"""
from .api import CobolData, read_cobol
from .copybook.copybook import Copybook, merge_copybooks, parse_copybook
from .copybook.datatypes import (
    FloatingPointFormat,
    SchemaRetentionPolicy,
    TrimPolicy,
)
from .device import resolve_device
from .reader.columnar import ColumnarDecoder, DecodedBatch
from .reader.diagnostics import FramingError
from .reader.handlers import (DictHandler, JsonHandler, RecordHandler,
                              TupleHandler)

__all__ = [
    "CobolData",
    "ColumnarDecoder",
    "Copybook",
    "DecodedBatch",
    "DictHandler",
    "FloatingPointFormat",
    "FramingError",
    "JsonHandler",
    "RecordHandler",
    "SchemaRetentionPolicy",
    "TrimPolicy",
    "TupleHandler",
    "merge_copybooks",
    "parse_copybook",
    "read_cobol",
    "resolve_device",
]
