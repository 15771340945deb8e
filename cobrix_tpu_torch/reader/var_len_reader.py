"""Variable-length reader: framing, segment ids and decode on the device.

Port of the fast path of ``cobrix_tpu.reader.var_len_reader`` (the
reference's VarLenNestedReader with VarLenNestedIterator): plain RDW
files, single- or multisegment, with Seg_Id levels, segment filters,
segment redefines and record ids. A file is read in windows of
`READ_WINDOW_BYTES`; each window crosses to the device once, and:

1. the scan kernel frames it from the position the previous window's
   last record left (``ops.device_framing.scan_window``; a record that
   continues past the window is read whole from the next one), and the
   offsets and lengths come to the host;
2. the pack kernel gathers each record's segment-id field (the
   counterpart of ``native.rdw_scan_segids``), which comes to the host
   and is decoded once per distinct byte pattern;
3. the host picks the kept records (Seg_Id levels, segment filter) and
   each record's active redefine;
4. per active segment, the pack kernel builds the kept records' matrix at
   that segment's plan extent, in batches of at most `PACK_BATCH_BYTES`,
   and the decoder decodes it on the device (``ColumnarDecoder
   .decode_raw``: the fused kernel and ``batch_torch``), giving one
   `SegmentBatch` of host planes each.

Fixed-length records that the JAX package reads with its variable-length
reader (a file header or footer, record ids or the input-file-name
column; ``ReaderParameters.needs_var_len_reader``) take the same steps,
framed by arithmetic in place of the scan (`frame_fixed_windows`: the
records its FixedLengthHeaderParser frames, `fixed_records`).

Seg_Id levels are computed once per file from the segment ids of all its
records (`_segment_level_ids_vectorized`), so they carry across windows.
`frame_windows` takes the place of the JAX reader's ``_frame_fast``,
`VarLenReader.read_result` of the fast branch of
``read_result_columnar`` with ``_read_result_fast``, and
`VarLenReader._decode_window` of the latter's per-segment decode.

Changes from the JAX package:
* It decodes every active segment with its own plan (the JAX package's
  per-active-segment branch), also when a redefine map is set, where the
  JAX package decodes every kept record once at the full plan's extent:
  exp3's 60-byte 'P' records are not widened to the 16,064-byte plan.
  Rows, dicts and their order are the same.
* The sequential read (`read_result`) frames a file whole, window by
  window. The JAX package splits a file over 100 MB (or as the
  ``input_split_*`` options say) at sparse-index entries; that changes
  nothing but the record ids, where a file header (`file_start_offset`
  > 0) counts as one record from the first split on (reference
  IndexGenerator.scala:117-120), and `read_result` shifts them from the
  index's first split to match.
* The pipelined read frames shards: `read_shard` reads the byte range of
  one sparse-index entry (`generate_index`, the JAX package's
  ``generate_index_fast``, here over the records the scan kernel frames)
  from a host staging buffer, numbering records from the entry's record
  index, as the JAX package's shard reads do; there the record-id shift
  comes from the plan itself.
* Fixed-length records in index shards: the JAX package's generic
  per-record reader does not end on such a shard (ROADMAP C6); the port
  frames each shard's whole records, with the record ids of its index.
* Not carried over: the hierarchical (segment-children) reads, the
  generic per-record reader's other framings (text, record-length
  fields, custom header parsers or extractors, variable OCCURS), the
  permissive error policies, filter pushdown and the persisted index.
  The column projection (`select`) reaches every segment decoder.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..copybook.ast import Primitive
from ..device import resolve_device
from ..engine.staging import StagedBytes
from ..ops.device_framing import TOO_BIG, ZERO, pack_records, scan_window
from ..plan.cache import copybook_for_params
from ..profiling import annotate
from .columnar import ColumnarDecoder, decoder_for_segment
from .diagnostics import framing_error
from .extractors import DecodeOptions
from .index import SparseIndexEntry, sparse_index_entries
from .parameters import (DEFAULT_FILE_RECORD_ID_INCREMENT,
                         DEFAULT_INDEX_ENTRY_SIZE_MB, MEGABYTE,
                         ReaderParameters)
from .result import FileResult, SegmentBatch
from .vrl_reader import (SegmentIds, decode_segment_id_bytes,
                         resolve_segment_id_field)

# bytes of the file on the device at a time (one scan window)
READ_WINDOW_BYTES = 64 * 1024 * 1024
# packed bytes of one decode batch: bounds the device memory a segment of
# wide records takes
PACK_BATCH_BYTES = 64 * 1024 * 1024


def default_segment_id_prefix() -> str:
    return time.strftime("%Y%m%d%H%M%S")


def _segment_level_ids_vectorized(segment_ids: Sequence[str],
                                  level_defs: Sequence[str], prefix: str,
                                  file_id: int, start_record_id: int):
    """Vectorized SegmentIdAccumulator (the JAX package's per-record
    reference) over a framed shard: Seg_Id0..N as per-level columns with
    the exact state semantics of the per-record accumulator (forward-filled current level/root, per-level counters
    reset at roots, empty root prefix before the first root). Returns
    (SegLevelColumns, no_match_yet_mask)."""
    from .result import SegLevelColumns

    n = len(segment_ids)
    level_lists = [s.split(",") for s in level_defs]
    level_count = len(level_lists)
    sid_level = {}
    for i, ids in enumerate(level_lists):
        for sid in ids:
            sid_level.setdefault(sid, i)
    if isinstance(segment_ids, SegmentIds):
        # one level lookup per DISTINCT id, broadcast by the codes
        lvl_uniq = np.asarray([sid_level.get(u, -1)
                               for u in segment_ids.uniq], dtype=np.int32)
        lvl = (lvl_uniq[segment_ids.codes] if len(lvl_uniq)
               else np.full(n, -1, dtype=np.int32))
    else:
        get_level = sid_level.get
        lvl = np.fromiter((get_level(s, -1) for s in segment_ids),
                          dtype=np.int32, count=n)

    # int32 state: the plane is memory-bandwidth bound; only root_rid
    # widens to int64 at the end. Explicit bound instead of silent wrap
    if n >= 2 ** 31:
        raise ValueError(
            f"shard of {n} records exceeds the 2^31 seg-id plane bound; "
            "split the input (hosts/input_split options)")
    idx = np.arange(n, dtype=np.int32)
    # forward-filled current level (last matched record's level; -1 = none)
    last_match = np.where(lvl >= 0, idx, np.int32(-1))
    np.maximum.accumulate(last_match, out=last_match)
    cur_level = np.where(last_match >= 0, lvl[np.maximum(last_match, 0)], -1)
    no_match_yet = last_match < 0
    # forward-filled root position (-1 before the first root: the
    # accumulator's empty pre-root prefix)
    root_pos = np.where(lvl == 0, idx, np.int32(-1))
    np.maximum.accumulate(root_pos, out=root_pos)
    root_rid = np.where(root_pos >= 0,
                        start_record_id + root_pos.astype(np.int64),
                        np.int64(-1))

    # per-level child counters (cumulative count since the current root)
    counters: List[Optional[np.ndarray]] = [None]
    for k in range(1, level_count):
        c = np.cumsum(lvl == k, dtype=np.int32)
        at_root = np.where(root_pos >= 0, c[np.maximum(root_pos, 0)],
                           np.int32(0))
        counters.append(c - at_root)
    valids = [cur_level >= k for k in range(level_count)]
    coded = dict(root_rid=root_rid, counters=counters, valids=valids,
                 prefix=f"{prefix}_{file_id}_", level_count=level_count)
    return SegLevelColumns(coded), no_match_yet


def file_record_id_base(file_order: int) -> int:
    """Deterministic Record_Id base per file (reference Constants.scala:28)."""
    return file_order * DEFAULT_FILE_RECORD_ID_INCREMENT


def _window_image(f, staged: bool, pos: int, length: int, device):
    """`length` bytes of `f` from `pos`: on the host (for error
    snapshots) and on `device`. A `StagedBytes` crosses from its staging
    buffer without a wait; a file is read into a fresh host buffer."""
    with annotate("cobrix.h2d", device):
        if staged:
            host = f.host()[pos:pos + length].numpy()
            image = f.to_device(device, pos, pos + length)
        else:
            host = np.empty(length, dtype=np.uint8)
            f.seek(pos)
            if f.readinto(memoryview(host)) != length:
                raise IOError(f"Short read at file offset {pos}")
            image = torch.from_numpy(host).to(device)
    return host, image


def frame_windows(f, size: int, device, big_endian: bool, adjustment: int,
                  file_header_bytes: int = 0, file_footer_bytes: int = 0,
                  window_bytes: Optional[int] = None):
    """Frame the RDW records of `size` bytes, a window of at most
    `window_bytes` (READ_WINDOW_BYTES by default) at a time, more when
    one record is longer. `f` is an open file, read into a fresh host
    buffer a window, or a `StagedBytes` holding the bytes (a shard of the
    pipelined read), whose windows cross to the device from the staging
    buffer without a wait. Yields (base, image, offsets, lengths) per
    window: its offset in the bytes framed, its bytes on `device` and its
    records' int64 payload offsets (relative to base) and lengths there.
    The records are exactly those of ``native.rdw_scan`` over the same
    bytes: each window's scan starts where the last one's chain stopped,
    and a malformed header raises the JAX package's FramingError at its
    offset. As in the host walk, the footer is cut only when it is
    shorter than the bytes framed, and a file header longer than 4 bytes
    is skipped whole at position 0."""
    window_bytes = window_bytes or READ_WINDOW_BYTES
    staged = isinstance(f, StagedBytes)
    end = size - file_footer_bytes if 0 < file_footer_bytes < size else size
    pos = file_header_bytes if file_header_bytes > 4 else 0
    need = 0
    while pos + 4 <= end:
        window_len = min(max(window_bytes, need), end - pos)
        last = pos + window_len == end
        host, image = _window_image(f, staged, pos, window_len, device)
        with annotate("cobrix.scan", device):
            offsets, lengths, status = scan_window(image, 0, last,
                                                   big_endian, adjustment)
        if status.code in (ZERO, TOO_BIG):
            p = status.position
            raise framing_error(host[p:p + 4].tobytes(), pos + p,
                                "zero" if status.code == ZERO else "big")
        if offsets.numel() == 0 and not last:
            # the first record is longer than the window: read a window
            # that holds it whole
            need = 4 + status.length
            continue
        need = 0
        yield pos, image, offsets, lengths
        if last:
            return
        pos += status.position


def fixed_records(size: int, record_size: int, file_header_bytes: int = 0,
                  file_footer_bytes: int = 0):
    """(offset of the first record, record count) of fixed-length records
    in `size` bytes, as the JAX package's FixedLengthHeaderParser frames
    them: a file header is skipped at position 0; a record starts
    wherever at least `record_size` bytes remain and more than the footer
    does; the bytes after the last record (a short tail, the footer) are
    no record."""
    pos = min(file_header_bytes, size) if file_header_bytes > 0 else 0
    need = (max(record_size, file_footer_bytes + 1) if file_footer_bytes > 0
            else record_size)
    n = (size - pos - need) // record_size + 1 if size - pos >= need else 0
    return pos, n


def frame_fixed_windows(f, size: int, device, record_size: int,
                        file_header_bytes: int = 0,
                        file_footer_bytes: int = 0,
                        window_bytes: Optional[int] = None):
    """`frame_windows` for fixed-length records (`fixed_records`): the
    same (base, image, offsets, lengths) per window of whole records,
    with no scan, since every record's offset is arithmetic."""
    window_bytes = window_bytes or READ_WINDOW_BYTES
    staged = isinstance(f, StagedBytes)
    pos, n = fixed_records(size, record_size, file_header_bytes,
                           file_footer_bytes)
    per = max(1, window_bytes // record_size)
    for first in range(0, n, per):
        k = min(per, n - first)
        base = pos + first * record_size
        _, image = _window_image(f, staged, base, k * record_size, device)
        offsets = torch.arange(k, dtype=torch.int64,
                               device=image.device) * record_size
        lengths = torch.full((k,), record_size, dtype=torch.int64,
                             device=image.device)
        yield base, image, offsets, lengths


class _FileSegmentIds:
    """The segment ids of a file's windows under one dictionary: each
    window's `SegmentIds` is recoded into the file's codes."""

    def __init__(self):
        self._index: Dict[str, int] = {}  # id -> file code, in code order
        self._codes: List[np.ndarray] = []

    def add(self, window: SegmentIds) -> None:
        to_file = np.asarray([self._index.setdefault(u, len(self._index))
                              for u in window.uniq], dtype=np.int32)
        self._codes.append(to_file[window.codes] if len(to_file)
                           else np.zeros(len(window), dtype=np.int32))

    def segment_ids(self) -> SegmentIds:
        codes = (np.concatenate(self._codes) if self._codes
                 else np.zeros(0, dtype=np.int32))
        return SegmentIds(codes, list(self._index))


class VarLenReader:
    """RDW reader bound to one copybook + parameters, decoding on
    `device` (None: the CUDA device; ``"cpu"``: the plain versions)."""

    def __init__(self, copybook_contents, params: ReaderParameters,
                 device=None):
        seg = params.multisegment
        self.device = resolve_device(device)
        self.copybook = copybook_for_params(copybook_contents, params)
        self.params = params
        self.segment_redefine_map = dict(
            seg.segment_id_redefine_map) if seg else {}
        self._decoders: Dict[str, ColumnarDecoder] = {}

    def _decoder_for_segment(self, active_segment: str) -> ColumnarDecoder:
        return decoder_for_segment(self._decoders, self.copybook,
                                   active_segment, self.device,
                                   select=self.params.select)

    def _segment_ids_vectorized(self, field_bytes: np.ndarray,
                                lengths: np.ndarray,
                                seg_field: Primitive) -> SegmentIds:
        """Per-record segment ids (dictionary-coded) from the [n, width]
        id-field byte matrix the pack kernel gathered (zero-padded past
        short records): each *unique* byte pattern decodes once (the
        scalar oracle); a record cut inside its id field decodes its
        actual bytes."""
        start = self.params.start_offset
        seg_off = seg_field.binary_properties.offset
        extent = start + seg_off + seg_field.binary_properties.actual_size
        short = lengths < extent  # id field truncated -> decode actual bytes
        options = DecodeOptions.from_copybook(self.copybook)
        out = decode_segment_id_bytes(field_bytes, seg_field, options)
        for i in np.nonzero(short)[0]:
            avail = max(0, int(lengths[i]) - (start + seg_off))
            value = options.decode(seg_field.dtype,
                                   bytes(field_bytes[i, :avail]))
            out.replace_at(int(i), "" if value is None else str(value).strip())
        return out

    def read_result(self, path: str, file_id: int = 0,
                    segment_id_prefix: Optional[str] = None,
                    start_record_id: int = 0) -> FileResult:
        """Frame and decode one file whole, window by window (see the
        module docstring). Record ids count every framed record from
        `start_record_id`, shifted by one from the sparse index's first
        split when a file header counts there."""
        p = self.params
        size = os.path.getsize(path)
        shifted = self._index_applies(size) and p.file_start_offset > 0
        with open(path, "rb") as f:
            result, file_ids, starts = self._read(
                f, size, file_id, segment_id_prefix, start_record_id,
                p.file_start_offset, p.file_end_offset,
                keep_starts=shifted, path=path)
        if shifted:
            roots = self._root_indices(file_ids.segment_ids())
            entries = sparse_index_entries(
                starts, file_id, p, roots, base=1,
                bytes_per_entry=self._bytes_per_entry(),
                trailing=self._trailing(size))
            if len(entries) > 1:
                shift_from = entries[1].record_index - 1
                for s in result.segments:
                    s.record_ids = s.record_ids + (s.positions >= shift_from)
                    if s.seg_level_ids is not None:
                        rid = s.seg_level_ids.coded["root_rid"]
                        rid += (rid >= start_record_id + shift_from)
        return result

    def read_shard(self, staged: StagedBytes, file_id: int,
                   offset_from: int, record_index: int, file_size: int,
                   segment_id_prefix: Optional[str] = None,
                   path: str = "") -> FileResult:
        """Frame and decode one shard of the pipelined read: the bytes
        [offset_from, offset_from + staged.nbytes) of the file `path` of
        `file_size` bytes, held in `staged`, with record ids from
        `record_index` (the JAX package's ``read_result_columnar`` over a
        shard stream). The file header applies to the shard that starts
        the file, the footer to the one that ends it; a shard up to twice
        READ_WINDOW_BYTES is framed as one window."""
        p = self.params
        n = staged.nbytes
        header = p.file_start_offset if offset_from == 0 else 0
        footer = p.file_end_offset if offset_from + n >= file_size else 0
        window = n if n <= 2 * READ_WINDOW_BYTES else None
        result, _, _ = self._read(staged, n, file_id, segment_id_prefix,
                                  record_index, header, footer,
                                  window_bytes=window, path=path)
        return result

    def _read(self, f, size: int, file_id: int, segment_id_prefix,
              start_record_id: int, header: int, footer: int,
              window_bytes: Optional[int] = None, keep_starts: bool = False,
              path: str = ""):
        """Frame and decode `size` bytes of `f` (`frame_windows`): the
        FileResult, the segment ids of every framed record, and the
        record header offsets when `keep_starts`."""
        p = self.params
        seg = p.multisegment
        prefix = segment_id_prefix or default_segment_id_prefix()
        seg_field = resolve_segment_id_field(p, self.copybook)
        levels = list(seg.segment_level_ids) if seg else []
        level_ids = {s for lvl in levels for s in lvl.split(",")}
        segment_filter = (set(seg.segment_id_filter)
                          if seg and seg.segment_id_filter else None)
        result = FileResult(n_rows=0, file_id=file_id,
                            input_file_name=path,
                            policy=p.schema_policy,
                            generate_record_id=p.generate_record_id,
                            generate_input_file_field=bool(
                                p.input_file_name_column))
        file_ids = _FileSegmentIds()
        starts: List[np.ndarray] = []
        matched = False       # a record of a Seg_Id level was seen
        n_total = 0           # records framed in earlier windows
        for base, image, offs_d, lengths, window_ids in self._frame(
                f, size, header, footer, window_bytes, file_ids):
            n = offs_d.numel()
            if keep_starts:
                starts.append(base + offs_d.cpu().numpy() - self._header_len)
            keep = np.ones(n, dtype=bool)
            if window_ids is not None:
                if levels and not matched:
                    hits = np.nonzero(window_ids.mask_of(level_ids))[0]
                    matched = bool(len(hits))
                    keep[:hits[0] if matched else n] = False
                if segment_filter is not None:
                    keep &= window_ids.mask_of(segment_filter)
            self._decode_window(result, image, offs_d, lengths, keep,
                                window_ids, n_total, start_record_id)
            n_total += n
        result.records_framed = n_total
        if levels and seg_field is not None:
            level_cols, _ = _segment_level_ids_vectorized(
                file_ids.segment_ids(), levels, prefix, file_id,
                start_record_id)
            for s in result.segments:
                s.seg_level_ids = level_cols.take(s.positions)
        starts = (np.concatenate(starts) if starts
                  else np.zeros(0, dtype=np.int64))
        return result, file_ids, starts

    def _frame(self, f, size: int, header: int, footer: int,
               window_bytes: Optional[int], file_ids: _FileSegmentIds):
        """`frame_windows` over `size` bytes of `f`, yielding (base,
        image, offsets on the device, host lengths, the window's segment
        ids or None) per window; the ids (their id field packed on the
        device, decoded on the host) are also added to `file_ids`."""
        p = self.params
        seg_field = resolve_segment_id_field(p, self.copybook)
        if p.is_record_sequence:
            windows = frame_windows(f, size, self.device, p.is_rdw_big_endian,
                                    p.rdw_length_adjustment, header, footer,
                                    window_bytes)
        else:
            windows = frame_fixed_windows(
                f, size, self.device, p.fixed_record_size(self.copybook),
                header, footer, window_bytes)
        for base, image, offs_d, lens_d in windows:
            lengths = lens_d.cpu().numpy()
            window_ids = None
            if seg_field is not None:
                with annotate("cobrix.segment_ids", self.device):
                    props = seg_field.binary_properties
                    field_bytes = pack_records(
                        image, offs_d, lens_d, props.actual_size,
                        p.start_offset + props.offset).cpu().numpy()
                    window_ids = self._segment_ids_vectorized(
                        field_bytes, lengths, seg_field)
                file_ids.add(window_ids)
            yield base, image, offs_d, lengths, window_ids

    # -- the sparse index ---------------------------------------------------

    def _index_split_config(self):
        """Validated split options and the root-boundary config
        (reference VarLenNestedReader.generateIndex :125-180: splits align
        to root-segment boundaries whenever Seg_Id generation is
        requested, so per-shard Seg_Id accumulators restart exactly at a
        root). The port takes no parent-child segment map."""
        params = self.params
        if params.input_split_records is not None and not (
                1 <= params.input_split_records <= 1_000_000_000):
            raise ValueError(
                "Invalid input split size. The requested number of records "
                f"is {params.input_split_records}.")
        if params.input_split_size_mb is not None and not (
                1 <= params.input_split_size_mb <= 2000):
            raise ValueError(
                f"Invalid input split size of {params.input_split_size_mb} MB.")
        seg = params.multisegment
        is_hierarchical = bool(seg and seg.segment_level_ids)
        root_segment_id = seg.segment_level_ids[0] if is_hierarchical else ""
        return is_hierarchical, root_segment_id

    @property
    def _header_len(self) -> int:
        """Bytes of a record's header before its payload (an RDW's 4)."""
        return 4 if self.params.is_record_sequence else 0

    def _trailing(self, size: int) -> Optional[bool]:
        """For fixed-length records, whether bytes follow the last record
        of a file of `size` bytes (a short tail or the footer): the JAX
        package's generic index pass then reaches the last record before
        the end of the stream, so a split may land on it. None for RDW
        files (`sparse_index_entries` keeps the vectorized index's
        footer rule)."""
        p = self.params
        if p.is_record_sequence:
            return None
        rs = p.fixed_record_size(self.copybook)
        pos, n = fixed_records(size, rs, p.file_start_offset,
                               p.file_end_offset)
        return size > pos + n * rs

    def _bytes_per_entry(self) -> float:
        return ((self.params.input_split_size_mb
                 or DEFAULT_INDEX_ENTRY_SIZE_MB) * MEGABYTE)

    def _index_applies(self, size: int) -> bool:
        """Whether the JAX package reads a file of `size` bytes in
        sparse-index shards (``index.file_index_entries`` returns
        entries)."""
        p = self.params
        explicit = (p.input_split_records is not None
                    or p.input_split_size_mb is not None)
        if not p.is_index_generation_needed or size == 0 \
                or not (explicit or size > self._bytes_per_entry()):
            return False
        self._index_split_config()  # validates the split options
        return True

    def _root_indices(self, segment_ids: SegmentIds) -> Optional[np.ndarray]:
        """Positions of the records a shard may start at (the roots),
        or None when any record may start one."""
        is_hierarchical, root_segment_id = self._index_split_config()
        if not is_hierarchical or resolve_segment_id_field(
                self.params, self.copybook) is None:
            return None
        return np.nonzero(segment_ids.mask_of(
            set(root_segment_id.split(","))))[0]

    def generate_index(self, path: str,
                       file_id: int) -> List[SparseIndexEntry]:
        """The sparse index of one file (the JAX package's
        ``generate_index_fast``): the scan kernel frames the file window
        by window, the record header offsets (and, for root-aligned
        splits, the segment ids) come to the host, and
        `index.sparse_index_entries` applies the reference's entry
        rule."""
        p = self.params
        self._index_split_config()
        starts: List[np.ndarray] = []
        file_ids = _FileSegmentIds()
        with open(path, "rb") as f:
            for base, _, offs_d, _, _ in self._frame(
                    f, os.path.getsize(path), p.file_start_offset,
                    p.file_end_offset, None, file_ids):
                starts.append(base + offs_d.cpu().numpy() - self._header_len)
        starts = (np.concatenate(starts) if starts
                  else np.zeros(0, dtype=np.int64))
        return sparse_index_entries(
            starts, file_id, p, self._root_indices(file_ids.segment_ids()),
            base=1 if p.file_start_offset > 0 else 0,
            bytes_per_entry=self._bytes_per_entry(),
            trailing=self._trailing(os.path.getsize(path)))

    def _decode_window(self, result: FileResult, image: torch.Tensor,
                       offs_d: torch.Tensor, lengths: np.ndarray,
                       keep: np.ndarray, window_ids: Optional[SegmentIds],
                       first: int, start_record_id: int) -> None:
        """Decode the kept records of one window, per active segment, in
        batches of at most PACK_BATCH_BYTES packed bytes."""
        kept = np.nonzero(keep)[0]
        result.n_rows += len(kept)
        by_segment: Dict[str, np.ndarray] = {}
        if window_ids is None:
            by_segment[""] = kept
        else:
            for active in set(window_ids.map_uniq(
                    self.segment_redefine_map)):
                mask = window_ids.mask_of_mapped(
                    self.segment_redefine_map, active)
                positions = np.nonzero(keep & mask)[0]
                if positions.size:
                    by_segment[active] = positions
        for active, positions in by_segment.items():
            decoder = self._decoder_for_segment(active)
            rows = max(1, PACK_BATCH_BYTES // max(decoder.plan.max_extent, 1))
            for b in range(0, len(positions), rows):
                part = positions[b:b + rows]
                decoded = decoder.decode_raw(
                    image, offs_d[torch.from_numpy(part).to(image.device)],
                    lengths[part], start_offset=self.params.start_offset)
                file_pos = first + part.astype(np.int64)
                result.segments.append(SegmentBatch(
                    decoded, active or None, file_pos,
                    start_record_id + file_pos))
