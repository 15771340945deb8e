"""Segment ids of framed records.

Port copy of ``cobrix_tpu.reader.vrl_reader``, reduced to `SegmentIds`,
`decode_segment_id_bytes` and `resolve_segment_id_field`, unchanged: the
port frames RDW files on the device (``ops.device_framing``), so the
per-record `VRLRecordReader` is not carried over.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..copybook.ast import Primitive
from ..copybook.copybook import Copybook
from .parameters import ReaderParameters


class SegmentIds:
    """Per-record segment-id strings in dictionary-coded form: `codes`
    (int32 per record) indexing `uniq` (decoded strings, one per distinct
    byte pattern). Segment masks, redefine routing and level mapping
    work on the integer codes and never materialize per-record Python
    strings (the JAX package's sequence methods are not carried over)."""

    __slots__ = ("codes", "uniq")

    def __init__(self, codes, uniq):
        self.codes = codes
        self.uniq = list(uniq)

    def __len__(self) -> int:
        return len(self.codes)

    def map_uniq(self, mapping: dict, default: str = "") -> list:
        """Mapped value per DISTINCT id, aligned to `uniq` (one dict lookup
        per distinct id; broadcast over records via `codes`)."""
        return [mapping.get(u, default) for u in self.uniq]

    def _hits_mask(self, hits) -> "np.ndarray":
        """OR of code equalities — hit lists are tiny (distinct ids), so
        this beats np.isin's sort machinery on the hot per-record axis."""
        if not hits:
            return np.zeros(len(self.codes), dtype=bool)
        mask = self.codes == hits[0]
        for k in hits[1:]:
            mask |= self.codes == k
        return mask

    def mask_of(self, values) -> "np.ndarray":
        """Boolean per-record mask of ids contained in `values`."""
        return self._hits_mask(
            [k for k, u in enumerate(self.uniq) if u in values])

    def mask_of_mapped(self, mapping: dict, value: str,
                       default: str = "") -> "np.ndarray":
        """Boolean per-record mask of ids whose `mapping` image equals
        `value` (segment id -> active redefine routing)."""
        return self._hits_mask(
            [k for k, u in enumerate(self.uniq)
             if mapping.get(u, default) == value])

    def replace_at(self, i: int, value: str) -> None:
        """Point fixup (truncated trailing records decode individually)."""
        try:
            k = self.uniq.index(value)
        except ValueError:
            self.uniq.append(value)
            k = len(self.uniq) - 1
        self.codes[i] = k


def decode_segment_id_bytes(field_bytes, seg_field: Primitive,
                            options) -> SegmentIds:
    """Per-record segment ids from a [n, field_width] byte matrix as a
    dictionary-coded `SegmentIds`, decoding each unique byte pattern once
    (shared by the fixed-length and variable-length readers). Fields up to
    2 bytes code via one O(n) bincount; up to 8 bytes via an integer-key
    sort — both far cheaper than a row-wise lexicographic unique at exp2's
    600k narrow records."""
    fb = np.ascontiguousarray(field_bytes)
    n, w = fb.shape
    if n == 0:
        return SegmentIds(np.zeros(0, dtype=np.int32), [])
    if w <= 8:
        if w == 1:
            keys = fb[:, 0]
        elif w == 2:
            keys = fb.view("<u2").ravel()
        else:
            padded = np.zeros((n, 8), dtype=np.uint8)
            padded[:, :w] = fb
            keys = padded.view("<u8").ravel()
        if w <= 2:
            counts = np.bincount(keys, minlength=(1 << (8 * w)))
            uniq_keys = np.nonzero(counts)[0]
            code_of = np.zeros(counts.shape[0], dtype=np.int32)
            code_of[uniq_keys] = np.arange(len(uniq_keys), dtype=np.int32)
            codes = code_of[keys]
        else:
            uniq_keys, codes = np.unique(keys, return_inverse=True)
            codes = codes.astype(np.int32, copy=False)
        key_dt = {1: "<u1", 2: "<u2"}.get(w, "<u8")
        uniq_bytes = [uniq_keys.astype(key_dt)[k:k + 1].tobytes()[:w]
                      for k in range(len(uniq_keys))]
    else:
        flat = fb.view(np.dtype((np.void, w))).ravel()
        uniq_rows, codes = np.unique(flat, return_inverse=True)
        codes = codes.astype(np.int32, copy=False)
        uniq_bytes = [bytes(row) for row in uniq_rows]
    uniq = []
    for chunk in uniq_bytes:
        value = options.decode(seg_field.dtype, chunk)
        uniq.append("" if value is None else str(value).strip())
    return SegmentIds(codes, uniq)


def resolve_segment_id_field(params: ReaderParameters,
                             copybook: Copybook) -> Optional[Primitive]:
    """reference ReaderParametersValidator.getSegmentIdField."""
    if params.multisegment is None or not params.multisegment.segment_id_field:
        return None
    field = copybook.get_field_by_name(params.multisegment.segment_id_field)
    if not isinstance(field, Primitive):
        raise ValueError(
            f"The segment id field '{params.multisegment.segment_id_field}' "
            "must be a primitive.")
    return field
