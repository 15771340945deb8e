"""Copybook-driven EBCDIC/ASCII encoding: the write half of the bridge.

Port copy of ``cobrix_tpu.encode``: the same modules, names and bytes,
on the port's copybook front end and code pages. It is host code (Python
and numpy) in both packages; nothing here runs on the card.

`encode_field` inverts the scalar decode oracle field-by-field;
`RecordEncoder`/`encode_file` invert the record extractors (fixed and
RDW/VRL framing, multisegment redefines, OCCURS incl. DEPENDING ON);
`BatchEncoder` is the vectorized column path for large synthetic
corpora (``chip_smoke.py`` phase 19 builds its TXN file with it).
`CobolData.to_ebcdic` re-encodes a read's rows through `RecordEncoder`.
"""
from .fields import EncodeError, encode_field
from .encoder import RecordEncoder, encode_file
from .kernels import BatchEncoder

__all__ = ["EncodeError", "encode_field", "RecordEncoder", "encode_file",
           "BatchEncoder"]
