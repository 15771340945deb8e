"""Fixed-length reader: record size, validity, record trimming and
multisegment records, decoding on the device.

Port copy of ``cobrix_tpu.reader.fixed_len_reader`` (the reference's
FixedLenNestedReader) for the reads that stay fixed-length in the JAX
package: no file header or footer, no record ids and no input-file-name
column, which route a read through the variable-length reader there as
here (``ReaderParameters.needs_var_len_reader``; the port's
``VarLenReader`` frames fixed-length records then). It carries
`record_size` with the ``record_length`` override,
`check_binary_data_validity` with ``debug_ignore_file_size``,
`_trimmed_matrix` (the record start and end offsets), and
`_read_multiseg_result` (``segment_field`` with a redefine map: each
record's segment value picks its redefine, and each active segment is
decoded with its own plan; as in the reference's fixed-length iterator,
there is no segment filter).

`read_chunk` takes a chunk of whole records on the host; the pipelined
read decodes a chunk of a plain layout (`plain_layout`) straight from
its staging buffer on the device instead (``engine.pipeline``).

Under a permissive record error policy a torn tail (a last record cut
short by the end of the file) is the JAX package's
(``_matrix_with_tail``, ``_ledger_tail``): ``permissive`` keeps it as a
zero-padded row with its available length, so the fields it cuts come
back null, and gives its reason; ``drop_malformed`` drops it; both
ledger it (`read_torn_chunk`). Every part of a permissive read is a
`FileResult` with its ledger (`permissive_part`). Under fail_fast a torn
tail raises the JAX package's error, word for word.

With a filter (``query.pushdown``, bound once per reader in
`pushdown` and shared with its counters by every chunk of the read) a
chunk is uploaded once and read in two stages on that one device image
(`read_image`): stage 1 packs each record up to its last filter field
and decodes the filter columns (the JAX package's ``mask_matrix``),
stage 2 packs the kept records at the selected plan's extent and
decodes them (``ColumnarDecoder.decode_raw``: the pack kernel, then the
fused kernel), per active segment for multisegment records. There is no
host gather and no second upload. The part is a `FileResult` whose
positions are the kept records' positions in the chunk, so a kept torn
tail keeps its reason on its row.

Changes from the JAX package: the host (oracle) walk is not carried
over (the port has no host backend). The JAX package reads a file with
a torn tail as one whole-file chunk; the sequential read here keeps its
64 MiB chunks, the last one carrying the tail, and the ledger and rows
are the same.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs.context import current as obs_current
from ..plan.cache import (copybook_for_params, decoder_cache_for,
                          parse_fingerprint)
from ..profiling import annotate
from ..query.pushdown import BoundFilter
from .columnar import ColumnarDecoder, DecodedBatch, decoder_for_segment
from .diagnostics import CorruptRecordInfo, RecordErrorPolicy, hex_snapshot
from .extractors import DecodeOptions
from .parameters import ReaderParameters
from .result import FileResult, SegmentBatch
from .vrl_reader import (SegmentIds, decode_segment_id_bytes,
                         resolve_segment_id_field)


class FixedLenReader:
    """Fixed-length reader bound to one copybook + parameters, decoding
    on `device` (None: the CUDA device; ``"cpu"``: the plain versions)."""

    def __init__(self, copybook_contents, params: ReaderParameters,
                 device=None):
        seg = params.multisegment
        self.device = resolve_device(device)
        self.copybook = copybook_for_params(copybook_contents, params)
        # stable copybook identity for the persisted profile key
        # (stats.store), as the JAX package's reader carries it
        self.copybook_fingerprint = parse_fingerprint(copybook_contents,
                                                      params)
        self.params = params
        self.segment_redefine_map = dict(
            seg.segment_id_redefine_map) if seg else {}
        # shared with every read of the same parse-cached copybook
        self._decoders: Dict[str, ColumnarDecoder] = \
            decoder_cache_for(self.copybook)
        # predicate pushdown (query/pushdown.py): bound once per reader,
        # shared (with its counters) by every chunk of the read
        self.pushdown = BoundFilter.build(params.filter, self.copybook,
                                          params)
        # zone-map chunk skipping (stats/skip.py), armed by read_cobol
        # under use_stats; None: every chunk is read
        self.chunk_skipper = None

    @property
    def record_size(self) -> int:
        return self.params.fixed_record_size(self.copybook)

    def check_binary_data_validity(self, data_size: int,
                                   ignore_file_size: bool = False,
                                   file_name: str = "") -> None:
        """reference FixedLenNestedReader.checkBinaryDataValidity."""
        rs = self.record_size
        if self.params.start_offset < 0:
            raise ValueError(
                f"Invalid record start offset = {self.params.start_offset}. "
                "A record start offset cannot be negative.")
        if self.params.end_offset < 0:
            raise ValueError(
                f"Invalid record end offset = {self.params.end_offset}. "
                "A record end offset cannot be negative.")
        if ignore_file_size or data_size % rs == 0:
            return
        where = f" of '{file_name}'" if file_name else ""
        raise ValueError(
            f"Binary record size {rs} does not divide data size "
            f"{data_size}{where}: the last {data_size % rs} byte(s) "
            f"(at file offset {data_size - data_size % rs}) do not form "
            "a whole record. Set record_error_policy='permissive' (or "
            "'drop_malformed') to tolerate a truncated tail, or "
            "'debug_ignore_file_size' to ignore it.")

    def decoder(self, active: str = "") -> ColumnarDecoder:
        return decoder_for_segment(self._decoders, self.copybook, active,
                                   self.device, select=self.params.select)

    @property
    def is_multisegment(self) -> bool:
        seg = self.params.multisegment
        return bool(seg and seg.segment_id_field and self.segment_redefine_map)

    @property
    def plain_layout(self) -> bool:
        """Records are exactly the copybook's layout, of one segment: a
        chunk decodes as it lies, with no trimming and no routing."""
        return (not self.is_multisegment and not self.params.start_offset
                and self.record_size == self.copybook.record_size)

    @property
    def needs_segment_ids(self) -> bool:
        """A chunk's records need their segment ids: multisegment
        records, or a filter with a segment-id conjunct."""
        return self.is_multisegment or (
            self.pushdown is not None
            and self.pushdown.segment_values is not None)

    def _trimmed_matrix(self, matrix: np.ndarray) -> Tuple[np.ndarray, int]:
        """Strip record start/end offsets to the copybook layout width.
        Returns (trimmed, width) — width < the copybook's record size
        means columns past a record's end are nulled via `lengths`."""
        start = self.params.start_offset
        rs_cb = self.copybook.record_size
        width = min(rs_cb, matrix.shape[1] - start)
        if start or self.params.end_offset or matrix.shape[1] != rs_cb:
            trimmed = np.zeros((matrix.shape[0], rs_cb), dtype=np.uint8)
            trimmed[:, :width] = matrix[:, start: start + width]
            return trimmed, width
        return matrix, width

    def _segment_values(self, matrix: np.ndarray) -> SegmentIds:
        """Per-record segment ids, dictionary-coded."""
        seg_field = resolve_segment_id_field(self.params, self.copybook)
        off = self.params.start_offset + seg_field.binary_properties.offset
        w = seg_field.binary_properties.actual_size
        return decode_segment_id_bytes(
            matrix[:, off:off + w], seg_field,
            DecodeOptions.from_copybook(self.copybook))

    def read_chunk(self, buf: np.ndarray, tail: Optional[np.ndarray] = None
                   ) -> Union[DecodedBatch, FileResult]:
        """Decode a chunk of whole records (`buf`: uint8 bytes on the
        host), and `tail`, the bytes of a torn last record kept as a
        zero-padded row of their length: one DecodedBatch, or a FileResult
        with a SegmentBatch per active segment for multisegment
        records. With a filter the chunk is uploaded once and read in
        two stages there (`read_image`): a FileResult."""
        rs = self.record_size
        matrix = buf.reshape(-1, rs)
        self.observe_records(matrix.shape[0])
        rec_lengths = None
        if tail is not None:
            n = matrix.shape[0]
            padded = np.zeros((n + 1, rs), dtype=np.uint8)
            padded[:n] = matrix
            padded[n, :len(tail)] = tail
            matrix = padded
            rec_lengths = np.full(n + 1, rs, dtype=np.int64)
            rec_lengths[n] = len(tail)
        if self.pushdown is not None:
            if rec_lengths is None:
                rec_lengths = np.full(matrix.shape[0], rs, dtype=np.int64)
            with annotate("cobrix.h2d", self.device):
                image = torch.from_numpy(matrix.reshape(-1)).to(self.device)
            return self.read_image(image, rec_lengths,
                                   self._segment_values(matrix)
                                   if self.needs_segment_ids else None)
        trimmed, width = self._trimmed_matrix(matrix)
        n = matrix.shape[0]
        if rec_lengths is not None:
            lengths = np.minimum(np.maximum(
                rec_lengths - self.params.start_offset, 0), width)
        else:
            lengths = (np.full(n, width, dtype=np.int64)
                       if width < self.copybook.record_size else None)
        if not self.is_multisegment:
            return self.decoder().decode(trimmed, lengths=lengths)
        return self._read_multiseg_result(matrix, trimmed, lengths)

    def observe_records(self, n: int) -> None:
        """`n` records of this reader's size into the read's
        record-length histogram (``obs.metrics``), when a read is
        active."""
        obs = obs_current()
        if obs is not None and obs.metrics is not None and n:
            obs.metrics["record_length"].observe_repeat(self.record_size, n)

    def permissive_part(self, part: Union[DecodedBatch, FileResult],
                        ledger=None, reasons: Optional[dict] = None
                        ) -> FileResult:
        """A decoded chunk as a part of a permissive read: a FileResult
        with `ledger` (a fresh one by default), the corrupt-record column
        and the `reasons` of its malformed rows, by row position."""
        p = self.params
        if isinstance(part, FileResult):
            result = part
        else:
            n = part.n_records
            positions = np.arange(n, dtype=np.int64)
            result = FileResult(
                n_rows=n, policy=p.schema_policy,
                segments=[SegmentBatch(part, None, positions, positions)])
        result.corrupt_record_field = p.corrupt_record_column
        result.diagnostics = (ledger if ledger is not None
                              else p.new_diagnostics())
        result.corrupt_row_reasons = reasons or None
        return result

    def read_torn_chunk(self, buf: np.ndarray, rem: int, file_name: str,
                        first_index: int, data_size: int) -> FileResult:
        """The last chunk of a file whose last `rem` bytes are a torn
        record, under a permissive policy: the whole records of `buf`
        (the first of them the file's record `first_index`), the tail
        kept (``permissive``) or dropped (``drop_malformed``), and the
        ledger entry of the JAX package's ``_ledger_tail`` (`data_size`:
        the file's size)."""
        rs = self.record_size
        whole, tail = buf[:len(buf) - rem], buf[len(buf) - rem:]
        keep = (self.params.record_error_policy
                is RecordErrorPolicy.PERMISSIVE)
        n = len(whole) // rs
        reason = (f"fixed-length record truncated at end of data: "
                  f"{rs} bytes declared, {rem} available")
        ledger = self.params.new_diagnostics()
        ledger.record(
            CorruptRecordInfo(file_name, data_size - rem, 0, reason,
                              hex_snapshot(tail[:16].tobytes()),
                              record_index=first_index + n if keep
                              else None),
            dropped=not keep)
        if not keep and n == 0:
            return FileResult(n_rows=0, policy=self.params.schema_policy,
                              corrupt_record_field=(
                                  self.params.corrupt_record_column),
                              diagnostics=ledger)
        part = self.read_chunk(whole, tail if keep else None)
        return self.permissive_part(part, ledger,
                                    {n: reason} if keep else None)

    def _read_multiseg_result(self, matrix: np.ndarray, trimmed: np.ndarray,
                              lengths: Optional[np.ndarray]) -> FileResult:
        p = self.params
        segment_ids = self._segment_values(matrix)
        result = FileResult(n_rows=matrix.shape[0], policy=p.schema_policy)
        for active in sorted(set(segment_ids.map_uniq(
                self.segment_redefine_map))):
            positions = np.nonzero(segment_ids.mask_of_mapped(
                self.segment_redefine_map, active))[0].astype(np.int64)
            decoded = self.decoder(active).decode(
                trimmed[positions],
                lengths=None if lengths is None else lengths[positions])
            result.segments.append(SegmentBatch(
                decoded, active or None, positions, positions))
        return result

    # -- filter pushdown: two stages on one device image ---------------------

    def read_image(self, image: torch.Tensor, rec_lengths: np.ndarray,
                   segment_ids: Optional[SegmentIds] = None) -> FileResult:
        """Read the records of a chunk image already on the device under
        the reader's filter (the JAX package's ``read_result`` and
        ``_read_multiseg_result`` pushdown branches): record i lies at
        byte i * record_size, `rec_lengths[i]` bytes long (a torn tail
        shorter); `segment_ids` are the records' segment ids (needed by
        multisegment records and a segment-id conjunct). Per active
        segment, stage 1 decodes the filter columns of the records the
        segment conjunct keeps and evaluates the predicate; stage 2
        decodes the kept records with the selected plan. Both stages
        pack their records from `image`; a segment that keeps nothing
        launches no stage 2."""
        p = self.params
        rs = self.record_size
        n = len(rec_lengths)
        width = min(self.copybook.record_size, rs - p.start_offset)
        offsets = np.arange(n, dtype=np.int64) * rs + p.start_offset
        lengths = np.minimum(np.maximum(rec_lengths - p.start_offset, 0),
                             width)
        result = FileResult(n_rows=0, policy=p.schema_policy,
                            records_framed=n)
        if self.is_multisegment:
            by_segment = {
                active: np.nonzero(segment_ids.mask_of_mapped(
                    self.segment_redefine_map, active))[0].astype(np.int64)
                for active in sorted(set(segment_ids.map_uniq(
                    self.segment_redefine_map)))}
        else:
            by_segment = {"": np.arange(n, dtype=np.int64)}
        for active, positions in by_segment.items():
            kept = self._pushdown_positions(image, offsets, lengths,
                                            positions, active, segment_ids)
            result.n_rows += len(kept)
            if not len(kept):
                continue
            decoded = self.decoder(active).decode_raw(
                image, offsets[kept], lengths[kept])
            result.segments.append(SegmentBatch(
                decoded, active or None, kept, kept))
        return result

    def _pushdown_positions(self, image: torch.Tensor, offsets: np.ndarray,
                            lengths: np.ndarray, positions: np.ndarray,
                            active: str,
                            segment_ids: Optional[SegmentIds]) -> np.ndarray:
        """The kept ones of the records at `positions` (the JAX
        package's ``_pushdown_positions``): segment-id conjuncts drop on
        the records' segment ids, then the stage-1 decode of ONLY the
        filter columns evaluates the value predicate."""
        pd = self.pushdown
        n = len(positions)
        kept = positions
        pruned_segment = 0
        if pd.segment_values is not None and segment_ids is not None:
            kept = kept[segment_ids.mask_of(set(pd.segment_values))[kept]]
            pruned_segment = n - len(kept)
        pruned_filter = 0
        if pd.value_expr is not None and len(kept):
            keep = pd.mask_raw(self._decoders, self.device, active, image,
                               offsets[kept], lengths[kept])
            pruned_filter = len(kept) - int(keep.sum())
            kept = kept[keep]
        pd.stats.note(scanned=n, pruned_segment=pruned_segment,
                      pruned_filter=pruned_filter,
                      bytes_skipped=(pruned_segment + pruned_filter)
                      * self.record_size)
        return kept
