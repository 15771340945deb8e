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
* Under a permissive record error policy `frame_windows` resyncs past
  a malformed header on the host bytes after it (``reader.recovery``)
  and relaunches the scan on the same device image, with the JAX
  package's ``rdw_scan_permissive`` decisions; the ledger of each file
  or shard rides its FileResult. Where the JAX package reads a file in
  sparse-index shards, a permissive read that met a malformed record is
  read again in those shards (`read_result`), so that its decisions are
  the shards'.
* The generic framings (text, a record-length field, custom header
  parsers and record extractors, variable-size OCCURS: where
  ``supports_fast_framing`` is false) are framed on the host by the JAX
  package's per-record reader (`VRLRecordReader`, `make_record_reader`,
  `frame_records`), gathered into windows of about READ_WINDOW_BYTES
  of records that cross to the device once each (`_frame_generic`),
  and decoded there like the RDW windows; files are split at the
  generic generator's index (``index.sparse_index_generator``), which,
  for a record-length field, walks the records that field frames
  (`_LengthFieldRecords`; ROADMAP C7).
* A hierarchical (segment-children) read of RDW records decodes once
  (`decode_once`, the JAX package's ``_hierarchical_columnar_setup``):
  each window is framed on the device as above, and every framed record
  is decoded with the full plan's decoder (``decode_raw``: the pack
  kernel and one fused launch per batch of at most PACK_BATCH_BYTES);
  the batches' host planes join into one `DecodedBatch` over the file
  or shard (``DecodedBatch.concat``), since a root's children may lie
  in the next window. The table (``hierarchical_arrow
  .hierarchical_table``) and the rows (`_read_rows_hierarchical_columnar`,
  the nesting walk) are built from it on the host when asked for. A
  file the JAX package splits is read in its root-aligned index shards,
  as there.
* The host row walk (`row_walk`, `iter_rows` over ``extractors
  .extract_record`` and ``extract_hierarchical_record``) decodes, where
  the JAX package does, the variable-size OCCURS layouts whose
  DEPENDING ON arrays shift later fields and the hierarchical reads off
  the decode-once route (a column projection, which the walk ignores, a
  record start offset, no segment field, a generic framing, or
  fixed-length records): a row-backed FileResult per file or index
  shard, read through a stream of it.
* Where a file is read in its index shards (a hierarchy, a generic
  framing, a permissive re-read), `parallelism` threads read them, each
  on its own CUDA stream with a staging buffer of its own
  (`_map_shards`, the JAX package's indexed scan), results in shard
  order.
* A compressed or backend-served file is read through one seekable
  view of its source (``stream.open_input``: a `SourceFile` over the
  decompressing or backend source stack, the reader's `io`, `retry` and
  `on_retry`, set by ``api.read_cobol``), by the windows' uploads, the
  resync searches, the index pass, the index shards and a text shard's
  preceding bytes alike; sizes are its decompressed size
  (``stream.source_size``). A compressed file without a ``cache_dir``
  is not split (``io.compress.compressed_chunkable``). With a
  ``cache_dir`` a file's index entries are loaded from and saved in the
  sparse-index store (``io.index_store``) by `generate_index` and by the
  sequential read of a file it indexes, so a warm re-read makes no
  index pass on the card.
* Filter pushdown (``query.pushdown``, bound once per reader in
  `pushdown`): in `_read` the records a window keeps after the levels
  and the segment filter go through `_pushdown_kept` before
  `_decode_window`: a segment-id conjunct drops on the window's segment
  ids with no decode, then stage 1 decodes only the filter columns from
  the window image (the pack kernel and the fused kernel at the filter
  plan's extent, per active segment, so a field one redefine owns is
  null on the other segments' records and drops them) and the
  predicate is evaluated over their Arrow arrays; only the kept
  records' offsets go to `_decode_window`. RDW files, fixed-length
  records framed here, the generic framings, index shards and
  pipelined shards all take this route. The hierarchical decode-once
  read and the row walk filter the assembled result instead
  (``BoundFilter.filter_result_generic``), as the JAX package does; a
  segment conjunct raises there. The column projection (`select`)
  reaches every segment decoder of a flat read.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..copybook.ast import Group, Primitive
from ..device import resolve_device
from ..engine.chunks import plan_var_len_chunks, shard_progress_bytes
from ..engine.staging import StagedBytes, StagingPool, worker_stream
from ..io.compress import compressed_chunkable
from ..io.stats import current_io_stats
from ..obs.context import carry
from ..obs.context import current as obs_current
from ..obs.trace import maybe_span
from ..ops.device_framing import (CARRY, DONE, TOO_BIG, ZERO, pack_records,
                                  scan_window)
from ..plan.cache import (copybook_for_params, decoder_cache_for,
                          parse_fingerprint)
from ..profiling import annotate, timed_stage
from .columnar import (ColumnarDecoder, DecodedBatch, _resolve_occurs,
                       decoder_for_segment)
from .diagnostics import (DEFAULT_RESYNC_WINDOW, FramingError,
                          ReadDiagnostics, RecordErrorPolicy, framing_error,
                          hex_snapshot)
from .extractors import (DecodeOptions, _apply_post_processing,
                         extract_hierarchical_record, extract_record)
from .header_parsers import (FixedLengthHeaderParser, RdwHeaderParser,
                             RecordHeaderParser, create_record_header_parser)
from .index import (SparseIndexEntry, sparse_index_entries,
                    sparse_index_generator)
from ..query.pushdown import BoundFilter
from .parameters import (DEFAULT_FILE_RECORD_ID_INCREMENT,
                         DEFAULT_INDEX_ENTRY_SIZE_MB, MEGABYTE,
                         ReaderParameters)
from .recovery import RESYNC_CHAIN_DEPTH, find_next_rdw, truncated_tail
from .raw_extractors import (RawRecordContext, RawRecordExtractor,
                             TextRecordExtractor,
                             VarOccursRecordExtractor,
                             create_raw_record_extractor)
from .result import FileResult, SegmentBatch
from .schema import output_schema_for
from .stream import (ShardStream, SimpleStream, normalize_local, open_input,
                     open_stream, read_at, source_size)
from .vrl_reader import (SegmentIds, VRLRecordReader,
                         decode_segment_id_bytes, resolve_segment_id_field)

# bytes of the file on the device at a time (one scan window)
READ_WINDOW_BYTES = 64 * 1024 * 1024
# packed bytes of one decode batch: bounds the device memory a segment of
# wide records takes
PACK_BATCH_BYTES = 64 * 1024 * 1024


class SegmentIdAccumulator:
    """Generates Seg_Id0..N values record by record for the host row
    walk: root = `prefix_fileId_recordIndex`, children
    `<root>_L<level>_<counter>` (reference SegmentIdAccumulator)."""

    def __init__(self, segment_ids: Sequence[str], segment_id_prefix: str,
                 file_id: int):
        self._ids = [s.split(",") for s in segment_ids]
        self._count = len(segment_ids)
        self._acc = [0] * (self._count + 1)
        self._current_level = -1
        self._current_root = ""
        self.prefix = segment_id_prefix
        self.file_id = file_id

    def acquired_segment_id(self, segment_id: str, record_index: int) -> None:
        if self._count == 0:
            return
        level = None
        for i, ids in enumerate(self._ids):
            if segment_id in ids:
                level = i
                break
        if level is None:
            return
        self._current_level = level
        if level == 0:
            self._current_root = f"{self.prefix}_{self.file_id}_{record_index}"
            self._acc = [0] * len(self._acc)
        else:
            self._acc[level] += 1

    def get_segment_level_id(self, level: int) -> Optional[str]:
        if 0 <= level <= self._current_level:
            if level == 0:
                return self._current_root
            return f"{self._current_root}_L{level}_{self._acc[level]}"
        return None


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


def _has_dynamic_occurs_layout(root: Group) -> bool:
    """True when a variable-size OCCURS makes later field offsets
    record-dependent: a DEPENDING ON array followed by any other field, or
    nested inside another array. A single *trailing* depending array keeps
    static element offsets and stays on the columnar path."""
    state = {"after_var_array": False, "dynamic": False}

    def walk(group: Group, in_array: bool) -> None:
        for st in group.children:
            if state["dynamic"]:
                return
            if state["after_var_array"]:
                state["dynamic"] = True
                return
            is_dep_array = st.is_array and st.depending_on is not None
            if is_dep_array and in_array:
                state["dynamic"] = True
                return
            if isinstance(st, Group):
                walk(st, in_array or st.is_array)
                if state["dynamic"]:
                    return
            if is_dep_array:
                state["after_var_array"] = True

    walk(root, False)
    return state["dynamic"]


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


def _host_bytes(f, staged: bool, lo: int, hi: int) -> np.ndarray:
    """Bytes [lo, hi) of `f` on the host (a resync search's view)."""
    if staged:
        return f.host()[lo:hi].numpy()
    out = np.empty(hi - lo, dtype=np.uint8)
    f.seek(lo)
    if f.readinto(memoryview(out)) != hi - lo:
        raise IOError(f"Short read at file offset {lo}")
    return out


def _input_fingerprint(path: str, f) -> str:
    """The content-version key of an `open_input` reader's file: its
    source's (a compressed input's derives from the compressed bytes, a
    backend's from its etag/size) or, for a raw local file, the
    ``local:<size>:<mtime_ns>`` of the JAX package's local index key."""
    source = getattr(f, "source", None)
    if source is not None:
        return source.fingerprint()
    st = os.stat(normalize_local(path))
    return f"local:{st.st_size}:{st.st_mtime_ns}"


def resync_span(resync_window: int, adjustment: int) -> int:
    """Bytes after a bad header that a resync search can look at: the
    candidates in `resync_window`, each chained through up to
    ``RESYNC_CHAIN_DEPTH`` + 1 headers of at most 65,535 bytes plus the
    adjustment, and the last header's 4 bytes."""
    return (1 + resync_window
            + (RESYNC_CHAIN_DEPTH + 1) * (4 + 65535 + max(adjustment, 0))
            + 4)


def frame_windows(f, size: int, device, big_endian: bool, adjustment: int,
                  file_header_bytes: int = 0, file_footer_bytes: int = 0,
                  window_bytes: Optional[int] = None,
                  policy: RecordErrorPolicy = RecordErrorPolicy.FAIL_FAST,
                  ledger: Optional[ReadDiagnostics] = None,
                  file_name: str = "", base_offset: int = 0,
                  resync_window: int = DEFAULT_RESYNC_WINDOW,
                  corrupt_reasons: Optional[Dict[int, str]] = None):
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
    and, under the fail-fast `policy`, a malformed header raises the JAX
    package's FramingError at its offset. As in the host walk, the
    footer is cut only when it is shorter than the bytes framed, and a
    file header longer than 4 bytes is skipped whole at position 0.

    Under a permissive policy the records are those of the JAX
    package's ``rdw_scan_permissive`` over the same bytes: the records
    the scan framed before a malformed header are kept; `find_next_rdw`
    searches the host bytes after it (`resync_span` of them, with the
    end of the bytes framed in view only when they reach it) for the
    next plausible header; the skip goes into `ledger` at its offset
    plus `base_offset` (the bytes' offset in file `file_name`); and the
    scan is launched again from there on the same device image when the
    header lies in the window, or on the window that starts at it. A
    corrupt run longer than `resync_window` raises. A last record cut by
    the end of the data is ledgered (`recovery.truncated_tail`): kept,
    with its reason in `corrupt_reasons` (keyed by its position among
    the records framed), under ``permissive``, dropped under
    ``drop_malformed``. A clean file costs one scan per window under
    every policy."""
    window_bytes = window_bytes or READ_WINDOW_BYTES
    staged = isinstance(f, StagedBytes)
    permissive = policy is not RecordErrorPolicy.FAIL_FAST
    if permissive and ledger is None:
        ledger = ReadDiagnostics()
    end = size - file_footer_bytes if 0 < file_footer_bytes < size else size
    pos = file_header_bytes if file_header_bytes > 4 else 0
    need = 0
    framed = 0  # records yielded so far
    while pos + 4 <= end:
        window_len = min(max(window_bytes, need), end - pos)
        last = pos + window_len == end
        host, image = _window_image(f, staged, pos, window_len, device)
        start = 0
        parts = []
        next_pos = None   # where the next window starts (None: done)
        need = 0
        while True:
            with annotate("cobrix.scan", device):
                offsets, lengths, status = scan_window(
                    image, start, last, big_endian, adjustment)
            if offsets.numel():
                parts.append((offsets, lengths))
            if status.code not in (ZERO, TOO_BIG):
                if not last:
                    if status.code == CARRY and status.position == 0:
                        # the first record is longer than the window:
                        # read a window that holds it whole
                        need = 4 + status.length
                    next_pos = pos + status.position
                break
            p = status.position
            kind = "zero" if status.code == ZERO else "big"
            if not permissive:
                raise framing_error(host[p:p + 4].tobytes(), pos + p, kind)
            err = pos + p
            snapshot = host[p:p + 4].tobytes()
            reason = framing_error(snapshot, err, kind).reason
            hi = min(err + resync_span(resync_window, adjustment), end)
            blob = _host_bytes(f, staged, err, hi)
            nxt = find_next_rdw(blob, 1, 1 + resync_window, big_endian,
                                adjustment, len(blob) if hi == end else None)
            if nxt is None:
                remaining = end - err
                if remaining > resync_window:
                    raise FramingError(
                        f"Corrupt run at offset {base_offset + err} of "
                        f"'{file_name}' exceeds the resync window "
                        f"({resync_window} bytes) with no plausible record "
                        f"header found (headers = {hex_snapshot(snapshot)});"
                        " increase 'resync_window' or fix the input.",
                        offset=base_offset + err, header=snapshot,
                        file_name=file_name)
                ledger.record_skip(file_name, base_offset + err, remaining,
                                   reason, snapshot)
                break
            ledger.record_skip(file_name, base_offset + err, nxt, reason,
                               snapshot)
            if err + nxt - pos < window_len:
                start = err + nxt - pos  # on the same device image
                continue
            next_pos = err + nxt
            break
        if parts:
            offsets = (parts[0][0] if len(parts) == 1
                       else torch.cat([o for o, _ in parts]))
            lengths = (parts[0][1] if len(parts) == 1
                       else torch.cat([ln for _, ln in parts]))
            if permissive and last and status.code == DONE:
                offs_h, lens_h, reasons = truncated_tail(
                    host, offsets.cpu().numpy(), lengths.cpu().numpy(),
                    big_endian, adjustment, policy, ledger, file_name,
                    base_offset + pos, first=framed)
                if len(offs_h) < offsets.numel():
                    offsets, lengths = (offsets[:len(offs_h)],
                                        lengths[:len(offs_h)])
                if corrupt_reasons is not None:
                    corrupt_reasons.update(reasons)
            framed += offsets.numel()
            yield pos, image, offsets, lengths
        if next_pos is None:
            return
        pos = next_pos


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


class _LengthFieldRecords(RawRecordExtractor):
    """The records a record-length field frames (`VRLRecordReader`), as
    the record extractor `sparse_index_generator` walks: `offset` is the
    stream offset after the record returned last."""

    def __init__(self, reader: VRLRecordReader, start: int = 0):
        self._reader = reader
        self._offset = start
        self._next = self._fetch()

    def _fetch(self):
        if not self._reader.has_next():
            return None
        # the reader holds the record it returns next: the stream stands
        # at that record's end
        end = self._reader._reader.offset
        _, data = next(self._reader)
        return data, end

    @property
    def offset(self) -> int:
        return self._offset

    def has_next(self) -> bool:
        return self._next is not None

    def __next__(self) -> bytes:
        if self._next is None:
            raise StopIteration
        (record, self._offset), self._next = self._next, self._fetch()
        return record


class VarLenReader:
    """RDW reader bound to one copybook + parameters, decoding on
    `device` (None: the CUDA device; ``"cpu"``: the plain versions)."""

    def __init__(self, copybook_contents, params: ReaderParameters,
                 device=None):
        seg = params.multisegment
        self.device = resolve_device(device)
        self.copybook = copybook_for_params(copybook_contents, params)
        # stable copybook identity for the persisted sparse-index key
        # (io.index_store): survives process restarts, unlike id()
        self.copybook_fingerprint = parse_fingerprint(copybook_contents,
                                                      params)
        self.params = params
        # the read's io configuration, retry policy and retry hook
        # (``api.read_cobol`` sets them; None: a raw local read)
        self.io = None
        self.retry = None
        self.on_retry = None
        self.segment_redefine_map = dict(
            seg.segment_id_redefine_map) if seg else {}
        # shared with every read of the same parse-cached copybook
        self._decoders: Dict[str, ColumnarDecoder] = \
            decoder_cache_for(self.copybook)
        # predicate pushdown (query/pushdown.py): bound once per reader,
        # shared (with its counters) by every shard and window of the read
        self.pushdown = BoundFilter.build(params.filter, self.copybook,
                                          params)
        # zone-map chunk skipping (stats/skip.py), armed by read_cobol
        # under use_stats; None: every shard is read
        self.chunk_skipper = None
        # framing and decode seconds of the reads (`profiling.StageTimes`;
        # None: not timed)
        self.stage_times = None
        # threads that read a file's index shards (the `parallelism`
        # option; 1: one after another)
        self.parallelism = 1
        # variable-size OCCURS that shift later fields make the static
        # columnar plan inapplicable — those records decode on the host.
        # Walked over the whole record (all 01-level roots in one pass): a
        # variable array at the end of one root shifts every later root.
        self.dynamic_occurs_layout = bool(
            params.variable_size_occurs
            and _has_dynamic_occurs_layout(self.copybook.ast))

    @property
    def decode_once(self) -> bool:
        """True when a hierarchical read decodes every record once, on
        the device, at the full plan (the JAX package's
        ``_hierarchical_columnar_setup`` does not bail): a segment field,
        no column projection (the row walk ignores it), no record start
        offset (the walk reads child records without it), and RDW
        records the scan kernel frames."""
        p = self.params
        return bool(self.copybook.is_hierarchical
                    and not self.dynamic_occurs_layout
                    and not p.variable_size_occurs
                    and resolve_segment_id_field(p, self.copybook)
                    is not None
                    and not p.select and not p.start_offset
                    and p.supports_fast_framing)

    @property
    def row_walk(self) -> bool:
        """True when the records are decoded by the host row walk
        (`iter_rows`), exactly where the JAX package takes it: a
        hierarchical read off the decode-once route, or a variable-size
        OCCURS layout that shifts later fields."""
        return bool(self.copybook.is_hierarchical
                    or self.dynamic_occurs_layout) and not self.decode_once

    @property
    def generic_framing(self) -> bool:
        """True when the records are framed on the host by the generic
        per-record reader (`VRLRecordReader`): text, a record-length
        field, a custom header parser or record extractor, or
        variable-size OCCURS. Plain RDW files are framed by the scan
        kernel, plain fixed-length records by arithmetic."""
        p = self.params
        return not p.supports_fast_framing and bool(
            p.is_text or p.length_field_name or p.record_extractor
            or p.record_header_parser or p.variable_size_occurs)

    # -- the generic per-record framing ------------------------------------

    def record_extractor(self, starting_record_number: int,
                         stream: SimpleStream):
        """reference VarLenNestedReader.recordExtractor (:60-79)."""
        ctx = RawRecordContext(starting_record_number, stream, self.copybook,
                               self.params.re_additional_info)
        if self.params.record_extractor:
            return create_raw_record_extractor(self.params.record_extractor,
                                               ctx)
        if self.params.is_text:
            return TextRecordExtractor(ctx)
        if self.params.variable_size_occurs \
                and not self.params.is_record_sequence \
                and not self.params.length_field_name:
            return VarOccursRecordExtractor(ctx)
        return None

    def record_header_parser(self) -> RecordHeaderParser:
        """reference VarLenNestedReader.getDefaultRecordHeaderParser (:267)."""
        if self.params.record_header_parser:
            parser = create_record_header_parser(
                self.params.record_header_parser,
                record_size=self.copybook.record_size,
                file_header_bytes=self.params.file_start_offset,
                file_footer_bytes=self.params.file_end_offset,
                rdw_adjustment=self.params.rdw_adjustment)
        elif self.params.is_record_sequence:
            parser = RdwHeaderParser(self.params.is_rdw_big_endian,
                                     self.params.file_start_offset,
                                     self.params.file_end_offset,
                                     self.params.rdw_length_adjustment)
        else:
            # record_length override wins over the copybook size (same
            # semantics as FixedLenReader.record_size: the override is the
            # full on-disk record, offsets not re-added)
            parser = FixedLengthHeaderParser(
                self.params.fixed_record_size(self.copybook),
                self.params.file_start_offset, self.params.file_end_offset)
        if self.params.rhp_additional_info is not None:
            parser.on_receive_additional_info(self.params.rhp_additional_info)
        return parser

    def make_record_reader(self, stream: SimpleStream,
                           start_record_id: int = 0,
                           starting_file_offset: int = 0,
                           ledger=None) -> VRLRecordReader:
        """The per-record framing iterator (policy-aware; `ledger` carries
        the error ledger)."""
        return VRLRecordReader(
            self.copybook, stream, self.params, self.record_header_parser(),
            self.record_extractor(start_record_id, stream),
            start_record_id, starting_file_offset, ledger=ledger)

    def frame_records(self, stream: SimpleStream, start_record_id: int = 0,
                      starting_file_offset: int = 0, ledger=None
                      ) -> Iterator[Tuple[int, str, bytes]]:
        """Yield (record_index, segment_id, record_bytes)."""
        reader = self.make_record_reader(stream, start_record_id,
                                         starting_file_offset, ledger)
        while reader.has_next():
            index = reader.record_index + 1
            segment_id, data = next(reader)
            yield index, segment_id, data

    # -- the host row walk (`row_walk`) -----------------------------------

    def iter_rows(self, stream: SimpleStream, file_id: int = 0,
                  start_record_id: int = 0, starting_file_offset: int = 0,
                  segment_id_prefix: Optional[str] = None,
                  ledger=None) -> Iterator[List[object]]:
        """Each record of `stream` framed and decoded on the host (the
        JAX package's ``iter_rows``, without its per-row corrupt-reason
        output, which only its host backend reads): Seg_Id levels
        and the segment filter record by record, or the hierarchical
        rows."""
        if self.copybook.is_hierarchical:
            # hierarchical assemblies carry no per-row corruption
            # attribution (the ledger still records every incident)
            yield from self._iter_rows_hierarchical(
                stream, file_id, start_record_id, starting_file_offset,
                ledger=ledger)
            return
        params = self.params
        seg = params.multisegment
        prefix = segment_id_prefix or default_segment_id_prefix()
        accumulator = (SegmentIdAccumulator(seg.segment_level_ids, prefix, file_id)
                       if seg else None)
        level_count = len(seg.segment_level_ids) if seg else 0
        segment_filter = set(seg.segment_id_filter) if seg and seg.segment_id_filter else None
        options = DecodeOptions.from_copybook(self.copybook)
        generate_input_file = bool(params.input_file_name_column)

        record_reader = self.make_record_reader(
            stream, start_record_id, starting_file_offset, ledger)
        while record_reader.has_next():
            record_index = record_reader.record_index + 1
            segment_id, data = next(record_reader)
            level_ids: List[Optional[str]] = []
            if level_count and accumulator is not None:
                accumulator.acquired_segment_id(segment_id, record_index)
                level_ids = [accumulator.get_segment_level_id(i)
                             for i in range(level_count)]
            if level_ids and level_ids[0] is None:
                continue  # before the first root segment
            if segment_filter is not None and segment_id not in segment_filter:
                continue
            active_redefine = self.segment_redefine_map.get(segment_id, "")
            yield extract_record(
                self.copybook.ast,
                data,
                offset_bytes=params.start_offset,
                policy=params.schema_policy,
                variable_length_occurs=params.variable_size_occurs,
                generate_record_id=params.generate_record_id,
                segment_level_ids=level_ids,
                file_id=file_id,
                record_id=record_index,
                active_segment_redefine=active_redefine,
                generate_input_file_field=generate_input_file,
                input_file_name=stream.input_file_name,
                options=options)

    def _hierarchy_maps(self):
        """(segment id -> redefine group, parent -> child groups, root
        group names) — shared by the scalar and columnar hierarchical
        paths so they cannot disagree on the hierarchy."""
        segment_redefines = {g.name: g
                             for g in self.copybook.get_all_segment_redefines()}
        sid_map = {sid: segment_redefines[name]
                   for sid, name in self.segment_redefine_map.items()
                   if name in segment_redefines}
        parent_child_map = self.copybook.get_parent_children_segment_map()
        root_names = {g.name for g in segment_redefines.values()
                      if g.parent_segment is None}
        return sid_map, parent_child_map, root_names

    def _iter_rows_hierarchical(self, stream: SimpleStream, file_id: int,
                                start_record_id: int,
                                starting_file_offset: int,
                                ledger=None) -> Iterator[List[object]]:
        """Buffer one root record plus its children, then assemble
        (reference VarLenHierarchicalIterator.fetchNext :99)."""
        params = self.params
        segment_id_redefine_map, parent_child_map, root_names = \
            self._hierarchy_maps()
        options = DecodeOptions.from_copybook(self.copybook)
        generate_input_file = bool(params.input_file_name_column)

        buffer: List[Tuple[str, bytes]] = []
        root_record_index = 0

        def flush():
            return extract_hierarchical_record(
                self.copybook.ast,
                buffer,
                segment_id_redefine_map,
                parent_child_map,
                offset_bytes=params.start_offset,
                policy=params.schema_policy,
                variable_length_occurs=params.variable_size_occurs,
                generate_record_id=params.generate_record_id,
                file_id=file_id,
                record_id=root_record_index,
                generate_input_file_field=generate_input_file,
                input_file_name=stream.input_file_name,
                options=options)

        # Record_Id parity quirk: the reference's hierarchical iterator
        # stamps each assembled row with the raw record index of the record
        # that TRIGGERS the flush — the next root (or the total record
        # count at end of stream), VarLenHierarchicalIterator.scala:99-135
        last_index = start_record_id - 1
        for record_index, segment_id, data in self.frame_records(
                stream, start_record_id, starting_file_offset,
                ledger=ledger):
            redefine = segment_id_redefine_map.get(segment_id)
            is_root = redefine is not None and redefine.name in root_names
            if is_root:
                if buffer:
                    root_record_index = record_index
                    yield flush()
                buffer = [(segment_id, data)]
            elif buffer:
                buffer.append((segment_id, data))
            last_index = record_index
        if buffer:
            root_record_index = last_index + 1
            yield flush()

    def _read_rows(self, stream: SimpleStream, file_id: int,
                   segment_id_prefix: Optional[str], start_record_id: int,
                   path: str = "") -> FileResult:
        """The row-backed result of the host row walk over `stream` (the
        JAX package's ``read_result_columnar`` row branch): every record
        framed and decoded on the host, its incidents in the result's
        ledger; the walk attributes no reason to a row."""
        p = self.params
        ledger = p.new_diagnostics() if p.is_permissive else None
        result = FileResult(n_rows=0, file_id=file_id,
                            input_file_name=path or stream.input_file_name,
                            policy=p.schema_policy,
                            generate_record_id=p.generate_record_id,
                            generate_input_file_field=bool(
                                p.input_file_name_column),
                            corrupt_record_field=p.corrupt_record_column,
                            diagnostics=ledger)
        with timed_stage(self.stage_times, "walk"):
            result.rows = list(self.iter_rows(
                stream, file_id=file_id, start_record_id=start_record_id,
                starting_file_offset=stream.offset,
                segment_id_prefix=segment_id_prefix, ledger=ledger))
        result.n_rows = len(result.rows)
        if self.pushdown is not None:
            self.pushdown.filter_result_generic(result,
                                                self._output_schema())
        return result

    def _output_schema(self):
        """The read's CobolOutputSchema for the post-decode filter, from
        the constructor the API layer uses, so the filtered table types
        identically (``FileResult.to_arrow`` then serves it for the
        API's equal schema)."""
        return output_schema_for(self.copybook, self.params,
                                 is_var_len=True)

    # -- the decode-once hierarchical read (`decode_once`) ------------------

    def _read_hierarchical(self, f, size: int, file_id: int,
                           start_record_id: int, header: int, footer: int,
                           window_bytes: Optional[int], keep_starts: bool,
                           path: str, base_offset: int):
        """Frame `size` bytes of `f` window by window on the device
        (`_frame`: the scan kernel and the segment-id pack) and decode
        every framed record once with the full plan's decoder
        (``decode_raw``: the pack kernel, then one fused launch per batch
        of at most PACK_BATCH_BYTES packed bytes), so that no window image
        outlives its window. The batches' host planes are joined into one
        `DecodedBatch` over every record (``DecodedBatch.concat``): a
        root's children may lie in the next window. The result is lazy:
        its table comes from ``hierarchical_table`` and its rows from the
        nesting walk, both on the host (the JAX package's
        ``_hierarchical_columnar_setup`` and its two factories). Returns
        (result, the file's segment ids, record header offsets when
        `keep_starts`)."""
        from .hierarchical_arrow import hierarchical_table

        p = self.params
        result = FileResult(n_rows=0, file_id=file_id,
                            input_file_name=path,
                            policy=p.schema_policy,
                            generate_record_id=p.generate_record_id,
                            generate_input_file_field=bool(
                                p.input_file_name_column),
                            corrupt_record_field=p.corrupt_record_column,
                            diagnostics=(p.new_diagnostics()
                                         if p.is_permissive else None))
        decoder = self._decoder_for_segment("")
        rows = max(1, PACK_BATCH_BYTES // max(decoder.plan.max_extent, 1))
        file_ids = _FileSegmentIds()
        starts: List[np.ndarray] = []
        batches: List[DecodedBatch] = []
        n_total = 0
        windows = self._frame(
            f, size, header, footer, window_bytes, file_ids,
            ledger=result.diagnostics, file_name=path,
            base_offset=base_offset, corrupt_reasons={},
            start_record_id=start_record_id)
        while True:
            with timed_stage(self.stage_times, "frame"):
                window = next(windows, None)
            if window is None:
                break
            base, image, offs_d, lengths, _ = window
            n = offs_d.numel()
            if keep_starts:
                starts.append(base + offs_d.cpu().numpy() - self._header_len)
            with timed_stage(self.stage_times, "decode"):
                for b in range(0, n, rows):
                    batches.append(decoder.decode_raw(
                        image, offs_d[b:b + rows], lengths[b:b + rows]))
            n_total += n
        result.records_framed = n_total
        with timed_stage(self.stage_times, "join"):
            batch = DecodedBatch.concat(batches) if batches else None
        del batches
        ctx = self._hierarchical_context(batch, file_ids.segment_ids(),
                                         decoder, path)
        result.n_rows = ctx["n_roots"]
        result.rows_factory = (
            lambda: self._read_rows_hierarchical_columnar(
                ctx, file_id, start_record_id))
        result.arrow_factory = (
            lambda output_schema: hierarchical_table(
                ctx["batch"], ctx["segment_names"], self.copybook,
                output_schema, ctx["sid_map"], ctx["parent_child_map"],
                ctx["root_names"], file_id=file_id,
                start_record_id=start_record_id,
                input_file_name=ctx["input_file_name"])
            if ctx["n"] else None)
        if self.pushdown is not None:
            # no static columnar plan for the nesting: the whole filter
            # runs on the assembled table
            self.pushdown.filter_result_generic(result,
                                                self._output_schema())
        starts = (np.concatenate(starts) if starts
                  else np.zeros(0, dtype=np.int64))
        return result, file_ids, starts

    def _hierarchical_context(self, batch: Optional[DecodedBatch],
                              segment_ids: SegmentIds,
                              decoder: ColumnarDecoder,
                              input_file_name: str) -> dict:
        """What the nesting walk and the Arrow assembly share (the JAX
        package's ``_hierarchical_columnar_setup`` after its decode):
        the hierarchy maps, the per-redefine row masks, the
        dictionary-coded segment names and the number of roots."""
        sid_map, parent_child_map, root_names = self._hierarchy_maps()
        name_of_sid = {sid: g.name for sid, g in sid_map.items()}
        # per-redefine row masks: a redefine's columns are read only on
        # its own segment's records
        seg_masks = {name: segment_ids.mask_of_mapped(name_of_sid, name)
                     for name in {g.name for g in sid_map.values()}}
        # dictionary-coded segment names: one name per DISTINCT sid plus
        # the int32 code vector
        uniq_named = [name_of_sid.get(u) for u in segment_ids.uniq]
        root_uniq = np.asarray([nm in root_names for nm in uniq_named])
        n_roots = (int(root_uniq[segment_ids.codes].sum())
                   if len(uniq_named) else 0)
        return dict(batch=batch, segment_names=(uniq_named,
                                                segment_ids.codes),
                    segment_ids=segment_ids, sid_map=sid_map,
                    parent_child_map=parent_child_map,
                    root_names=root_names, seg_masks=seg_masks,
                    decoder=decoder, n=len(segment_ids), n_roots=n_roots,
                    input_file_name=input_file_name)

    def _read_rows_hierarchical_columnar(self, ctx: dict, file_id: int,
                                         start_record_id: int
                                         ) -> List[List[object]]:
        """Hierarchical rows with batched value decode: every record's
        fields come from ONE full-plan columnar batch (kernels, not the
        per-field scalar walk); only the parent/child nesting assembly
        runs per record, mirroring extract_hierarchical_record's scan
        semantics exactly (forward scan per child segment, stop when a
        parent id reappears, flush-trigger Record_Id)."""
        params = self.params
        n = ctx["n"]
        if n == 0:
            return []
        batch = ctx["batch"]
        segment_ids = ctx["segment_ids"].tolist()
        sid_map = ctx["sid_map"]
        parent_child_map = ctx["parent_child_map"]
        root_names = ctx["root_names"]
        seg_masks = ctx["seg_masks"]
        decoder = ctx["decoder"]
        stream_name = ctx["input_file_name"]
        slot_map = decoder.slot_map
        col_values: Dict[int, list] = {}

        def values_of(col):
            lst = col_values.get(col)
            if lst is None:
                spec = decoder.plan.columns[col]
                # dependee columns are READ at every row — the walk runs
                # non-emitted parts to register DEPENDING-ON counters from
                # whatever bytes overlay them (oracle parity) — so they
                # must never be masked
                is_dependee = (spec.statement is not None
                               and spec.statement.is_dependee)
                mask = (seg_masks.get(spec.segment)
                        if spec.segment is not None and not is_dependee
                        else None)
                lst = batch.column_values(col, relevant=mask)
                col_values[col] = lst
            return lst

        # the walk compiles once per (group, slot_path) into closures over
        # the column value lists — per-record work is list indexing, not
        # slot-map dict lookups per element (the hierarchical twin of
        # ColumnarDecoder._row_maker)
        maker_cache: Dict[tuple, object] = {}

        def build_group(group, slot_path):
            key = (id(group), slot_path)
            maker = maker_cache.get(key)
            if maker is not None:
                return maker
            parts = []  # (emit, fn) — fn(i, scan_i, span_end, pids, depend)
            for st in group.children:
                emit = not st.is_filler and not st.is_child_segment
                if st.is_array:
                    if isinstance(st, Group):
                        elems = [build_group(st, slot_path + (k,))
                                 for k in range(st.array_max_size)]
                        fn = (lambda i, s, e, pd, dep, st=st, el=elems:
                              [mk(i, s, e, pd, dep)
                               for mk in el[:_resolve_occurs(
                                   st, dep.get(st.depending_on))]])
                    else:
                        cols = [slot_map.get((id(st), slot_path + (k,)))
                                for k in range(st.array_max_size)]
                        lists = [None if c is None else values_of(c)
                                 for c in cols]
                        fn = (lambda i, s, e, pd, dep, st=st, ls=lists:
                              [None if l is None else l[i]
                               for l in ls[:_resolve_occurs(
                                   st, dep.get(st.depending_on))]])
                elif isinstance(st, Group):
                    fn = build_group(st, slot_path)
                else:
                    col = slot_map.get((id(st), slot_path))
                    if col is None:
                        fn = lambda i, s, e, pd, dep: None
                    elif st.is_dependee:
                        lst = values_of(col)
                        name = st.name
                        def fn(i, s, e, pd, dep, lst=lst, name=name):
                            value = lst[i]
                            if value is not None:
                                dep[name] = (value if isinstance(value, str)
                                             else int(value))
                            return value
                    else:
                        lst = values_of(col)
                        fn = lambda i, s, e, pd, dep, lst=lst: lst[i]
                parts.append((emit, fn))
            children_groups = (tuple(parent_child_map.get(group.name, ()))
                               if group.is_segment_redefine else ())

            def maker(i, scan_i, span_end, parent_ids, depend,
                      parts=tuple(parts), children_groups=children_groups):
                # declaration order throughout: dependees must register
                # before any later OCCURS resolves, emitted or not
                fields = []
                for emit, fn in parts:
                    value = fn(i, scan_i, span_end, parent_ids, depend)
                    if emit:
                        fields.append(value)
                for child in children_groups:
                    fields.append(extract_children(
                        child, scan_i + 1, span_end, parent_ids, depend))
                return tuple(fields)

            maker_cache[key] = maker
            return maker

        def extract_children(field, from_i, span_end, parent_ids, depend):
            child_maker = build_group(field, ())
            children = []
            j = from_i
            while j < span_end:
                sid_j = segment_ids[j]
                redefine = sid_map.get(sid_j)
                if redefine is not None and redefine.name == field.name:
                    children.append(child_maker(
                        j, j, span_end, [sid_j] + parent_ids, depend))
                elif sid_j in parent_ids:
                    break
                j += 1
            return children

        roots = [p for p in range(n)
                 if (g := sid_map.get(segment_ids[p])) is not None
                 and g.name in root_names]
        generate_input_file = bool(params.input_file_name_column)
        ast_roots = [r for r in self.copybook.ast.children
                     if isinstance(r, Group) and r.parent_segment is None]
        rows = []
        for ri, p in enumerate(roots):
            span_end = roots[ri + 1] if ri + 1 < len(roots) else n
            # Record_Id parity quirk: the id of the record that TRIGGERS
            # the flush — the next root, or one past the last record at
            # end of stream (VarLenHierarchicalIterator.scala:99-135)
            trigger_id = start_record_id + span_end
            depend: Dict[str, object] = {}
            records = [build_group(root, ())(p, p, span_end,
                                             [segment_ids[p]], depend)
                       for root in ast_roots]
            rows.append(_apply_post_processing(
                records, params.schema_policy, params.generate_record_id,
                [], file_id, trigger_id, generate_input_file,
                stream_name))
        return rows

    def _frame_generic(self, stream: SimpleStream, start_record_id: int,
                       window_bytes: Optional[int],
                       ledger: Optional[ReadDiagnostics],
                       corrupt_reasons: Optional[Dict[int, str]]):
        """The records `make_record_reader` frames on the host, gathered
        into windows of about `window_bytes` (READ_WINDOW_BYTES) record
        bytes: each window's records are laid end to end and cross to the
        device in one copy, with their offsets and lengths and their
        segment ids (or None). Yields (base, image, offsets on the device,
        host lengths, segment ids) as `frame_windows` does; the reasons
        of the malformed records the reader kept go into
        `corrupt_reasons`, by record position."""
        window_bytes = window_bytes or READ_WINDOW_BYTES
        seg_field = resolve_segment_id_field(self.params, self.copybook)
        reader = self.make_record_reader(stream, start_record_id,
                                         stream.offset, ledger)
        records: List[bytes] = []
        ids: List[str] = []
        held = 0

        def window():
            lengths = np.fromiter((len(r) for r in records), dtype=np.int64,
                                  count=len(records))
            offsets = np.zeros(len(records), dtype=np.int64)
            np.cumsum(lengths[:-1], out=offsets[1:])
            blob = np.frombuffer(bytearray(b"".join(records)) or
                                 bytearray(1), dtype=np.uint8)
            with annotate("cobrix.h2d", self.device):
                image = torch.from_numpy(blob).to(self.device)
            window_ids = None
            if seg_field is not None:
                index: Dict[str, int] = {}
                codes = np.fromiter(
                    (index.setdefault(i, len(index)) for i in ids),
                    dtype=np.int32, count=len(ids))
                window_ids = SegmentIds(codes, list(index))
            return (0, image, torch.from_numpy(offsets).to(self.device),
                    lengths, window_ids)

        with annotate("cobrix.frame", self.device):
            while reader.has_next():
                segment_id, data = next(reader)
                records.append(data)
                ids.append(segment_id)
                held += len(data)
                if held >= window_bytes:
                    yield window()
                    records, ids, held = [], [], 0
        if records:
            yield window()
        if corrupt_reasons is not None:
            corrupt_reasons.update(
                (index - start_record_id, reason)
                for index, reason in reader.corrupt_reasons.items())

    def _read_generic(self, path: str, size: int, file_id: int,
                      segment_id_prefix: Optional[str],
                      start_record_id: int,
                      entries: Optional[Sequence[SparseIndexEntry]] = None
                      ) -> List[FileResult]:
        """A file of a generic framing: whole, or, where the JAX package
        splits it (`_index_applies`), in the shards of its sparse index
        (`sparse_index_generator`), each a bounded stream of the file;
        `entries` (the shards a chunk skipper kept) in place of the
        index's."""
        if entries is None:
            entries = (self.generate_index(path, file_id)
                       if self._index_applies(size, path) else None)
            if not entries or len(entries) < 2:
                entries = [SparseIndexEntry(0, -1, file_id, 0)]

        def read(e: SparseIndexEntry) -> FileResult:
            n = 0 if e.offset_to < 0 else e.offset_to - e.offset_from
            with self.open_stream(path, e.offset_from, n) as stream:
                result, _, _ = self._read(
                    stream, stream.size() - e.offset_from, file_id,
                    segment_id_prefix, start_record_id + e.record_index,
                    0, 0, path=path, base_offset=e.offset_from)
            return result
        return self._map_shards(read, entries, path)

    def open_input(self, path: str, start_offset: int = 0,
                   maximum_bytes: int = 0):
        """`path` as a seekable reader under the read's io stack
        (``stream.open_input``)."""
        return open_input(path, start_offset, maximum_bytes,
                          retry=self.retry, on_retry=self.on_retry,
                          io=self.io)

    def open_stream(self, path: str, start_offset: int = 0,
                    maximum_bytes: int = 0) -> SimpleStream:
        """`path` as a SimpleStream under the read's io stack
        (``stream.open_stream``)."""
        return open_stream(path, start_offset, maximum_bytes,
                           retry=self.retry, on_retry=self.on_retry,
                           io=self.io)

    def input_size(self, path: str) -> int:
        """The logical (decompressed) size of `path`."""
        return source_size(path, retry=self.retry, on_retry=self.on_retry,
                           io=self.io)

    def _bytes_before(self, path: str, offset: int, n: int = 2) -> bytes:
        """The (up to) `n` bytes of the file `path` before `offset`, read
        through its own view (decompressed bytes for a compressed file)."""
        if offset <= 0 or not path:
            return b""
        with self.open_input(path) as f:
            return read_at(f, max(0, offset - n), min(n, offset))

    def _shard_width(self, entries: Sequence) -> int:
        return max(1, min(self.parallelism, len(entries)))

    def _map_shards(self, read, entries: Sequence,
                    path: str) -> List[FileResult]:
        """`read(entry)` of every index shard of the file `path`, in shard
        order: one after
        another, or on `parallelism` threads (the JAX package's indexed
        scan, ``cobrix_tpu/api.py:909-913``), each on its own CUDA
        stream, as the pipeline's workers are, and each in the read's
        observability context (``obs.context.carry``) as one shard of
        the read (`_as_shard`)."""
        obs = obs_current()
        progress = obs.progress if obs is not None else None
        if progress is not None and len(entries) > 1:
            # the file was planned as one unit of progress
            progress.set_plan(
                chunks_total=progress.chunks_total + len(entries) - 1)

        def shard(e):
            return self._as_shard(lambda: read(e), path, e)
        width = self._shard_width(entries)
        if width == 1:
            return [shard(e) for e in entries]

        def run(e):
            with worker_stream(self.device):
                return shard(e)
        with ThreadPoolExecutor(max_workers=width) as ex:
            return list(ex.map(carry(run), entries))

    def _as_shard(self, run, path: str,
                  entry: SparseIndexEntry) -> FileResult:
        """`run()`, the read of the index shard `entry` of the file
        `path`, as one shard of the read: a "shard" span under the scan's
        root when the read traces (the reader's stage spans nest under
        it), and one unit of progress with its bytes and rows (the JAX
        package's indexed scan, ``cobrix_tpu/api.py:843-905``)."""
        obs = obs_current()
        if obs is None or (obs.tracer is None and obs.progress is None):
            return run()
        tracer, progress = obs.tracer, obs.progress
        if progress is not None:
            progress.chunk_started()
        if tracer is None:
            result = run()
        else:
            with tracer.span("shard", "shard", parent=tracer.root_id,
                             args={"file": path,
                                   "offset_from": entry.offset_from,
                                   "offset_to": entry.offset_to}):
                result = run()
        if progress is not None:
            progress.chunk_done(
                bytes_done=shard_progress_bytes(entry,
                                                self.input_size(path)),
                records=result.n_rows)
        return result

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
                    start_record_id: int = 0) -> List[FileResult]:
        """Frame and decode one file whole, window by window (see the
        module docstring): the file's one FileResult, in a list. Record
        ids count every framed record from `start_record_id`, shifted by
        one from the sparse index's first split when a file header counts
        there.

        Where the JAX package reads the file in sparse-index shards
        (`_index_applies`), a permissive read that met a malformed record
        is read again in those shards (`read_shard`, one FileResult
        each): a shard's resync search sees no further than the shard's
        end, so its decisions, and the positions its ledger gives, are
        the shard's. A clean file frames the same records either way and
        is read once.

        With a chunk skipper armed (``use_stats``) the file is planned
        as the JAX package's indexed scan plans it (`_read_kept_shards`):
        its kept shards are read, and those its profile proves match
        nothing never are."""
        p = self.params
        size = self.input_size(path)
        if self.chunk_skipper is not None:
            kept = self._read_kept_shards(path, size, file_id,
                                          segment_id_prefix,
                                          start_record_id)
            if kept is not None:
                return kept
        if self.generic_framing or self.row_walk:
            return self._read_generic(path, size, file_id,
                                      segment_id_prefix, start_record_id)
        indexed = self._index_applies(size, path)
        if indexed and self.decode_once:
            # a hierarchical file is read in the index's root-aligned
            # shards, where the JAX package reads it so: each shard's
            # records decode once, as one batch
            with timed_stage(self.stage_times, "index"):
                entries = self.generate_index(path, file_id)
            if len(entries) > 1:
                return self._read_file_shards(path, size, entries, file_id,
                                              start_record_id,
                                              segment_id_prefix)
        shifted = indexed and p.file_start_offset > 0
        key = cached = None
        obs = obs_current()
        tracer = obs.tracer if obs is not None else None
        try:
            with self.open_input(path) as f:
                if indexed:
                    # the file's stored index, as the JAX package's
                    # indexed scan looks it up (the read frames the file
                    # whole either way; a miss keeps its starts)
                    key, cached = self._stored_index(path, f, file_id)
                # the whole file is one shard of the read (`_as_shard`),
                # unless a permissive read re-reads it in its index's
                with maybe_span(tracer, "shard", "shard",
                                args={"file": path, "offset_from": 0,
                                      "offset_to": -1}):
                    result, file_ids, starts = self._read(
                        f, size, file_id, segment_id_prefix,
                        start_record_id, p.file_start_offset,
                        p.file_end_offset,
                        keep_starts=indexed and cached is None, path=path)
        except FramingError as exc:
            if not indexed or exc.file_name != path:
                raise
            # the JAX package's index pass frames the file first and
            # raises there, with no file name (its throwaway ledger's)
            raise FramingError(
                str(exc).replace(f" of '{path}' ", " of '' ", 1),
                offset=exc.offset, reason=exc.reason,
                header=exc.header) from None
        if not indexed:
            return [self._progress_whole(result, size)]
        entries = cached
        if entries is None:
            entries = sparse_index_entries(
                starts, file_id, p,
                self._root_indices(file_ids.segment_ids()),
                base=1 if p.file_start_offset > 0 else 0,
                bytes_per_entry=self._bytes_per_entry(),
                trailing=self._trailing(size))
            self._save_index(key, path, entries)
        ledger = result.diagnostics
        if ledger is not None and ledger.corrupt_records \
                and len(entries) > 1:
            del result
            return self._read_file_shards(path, size, entries, file_id,
                                          start_record_id, segment_id_prefix)
        if shifted and len(entries) > 1:
            shift_from = entries[1].record_index - 1
            for s in result.segments:
                s.record_ids = s.record_ids + (s.positions >= shift_from)
                if s.seg_level_ids is not None:
                    rid = s.seg_level_ids.coded["root_rid"]
                    rid += (rid >= start_record_id + shift_from)
        return [self._progress_whole(result, size)]

    def _read_kept_shards(self, path: str, size: int, file_id: int,
                          segment_id_prefix: Optional[str],
                          start_record_id: int
                          ) -> Optional[List[FileResult]]:
        """The file `path` under the read's chunk skipper, planned as the
        pipelined read plans it (``engine.chunks.plan_var_len_chunks``:
        its sparse-index shards, those the profile proves match nothing
        left out), and the kept shards read with `_read_file_shards` (a
        generic framing's through `_read_generic`), however many the
        skipper kept. None when the plan keeps the file as one whole
        shard: it is then read as a stats-off read reads it. A file
        whose every shard is skipped gives no result (no read, no
        launch)."""
        shards = plan_var_len_chunks(self, [path], self.params, self.retry,
                                     self.on_retry, io=self.io)
        if len(shards) == 1 and shards[0].offset_from == 0 \
                and shards[0].offset_to < 0:
            return None
        if not shards:
            obs = obs_current()
            if obs is not None and obs.progress is not None:
                # the file was planned as one unit of progress: it is
                # done, with none of its bytes read
                obs.progress.chunk_started()
                obs.progress.chunk_done(bytes_done=0, records=0)
            return []
        kept = [SparseIndexEntry(s.offset_from, s.offset_to, file_id,
                                 s.record_index) for s in shards]
        if self.generic_framing or self.row_walk:
            return self._read_generic(path, size, file_id,
                                      segment_id_prefix, start_record_id,
                                      entries=kept)
        return self._read_file_shards(path, size, kept, file_id,
                                      start_record_id, segment_id_prefix)

    @staticmethod
    def _progress_whole(result: FileResult, size: int) -> FileResult:
        """A file read whole: one unit of the read's progress."""
        obs = obs_current()
        if obs is not None and obs.progress is not None:
            obs.progress.chunk_started()
            obs.progress.chunk_done(bytes_done=size, records=result.n_rows)
        return result

    def _read_file_shards(self, path: str, size: int,
                          entries: Sequence[SparseIndexEntry], file_id: int,
                          start_record_id: int,
                          segment_id_prefix: Optional[str]
                          ) -> List[FileResult]:
        """`read_shard` of each sparse-index entry of the file `path`,
        read into a buffer of the staging pool, one a thread
        (`_map_shards`)."""
        pool = StagingPool(self._shard_width(entries), self.device)

        def read(entry: SparseIndexEntry) -> FileResult:
            end = size if entry.offset_to < 0 else min(entry.offset_to, size)
            n = max(0, end - entry.offset_from)
            staged = pool.acquire(n)
            try:
                with self.open_input(path, entry.offset_from, n) as f, \
                        timed_stage(self.stage_times, "read"):
                    f.seek(entry.offset_from)
                    if f.readinto(memoryview(staged.host().numpy())) != n:
                        raise IOError(f"Short read from {path} at "
                                      f"{entry.offset_from}")
                return self.read_shard(
                    staged, file_id, entry.offset_from,
                    start_record_id + entry.record_index, size,
                    segment_id_prefix, path=path)
            finally:
                staged.close()
        return self._map_shards(read, entries, path)

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
        if self.generic_framing or self.row_walk:
            stream = ShardStream(staged.host().numpy(), offset_from,
                                 file_size, path,
                                 before=self._bytes_before(path,
                                                           offset_from))
            result, _, _ = self._read(stream, n, file_id, segment_id_prefix,
                                      record_index, 0, 0, path=path,
                                      base_offset=offset_from)
            return result
        header = p.file_start_offset if offset_from == 0 else 0
        footer = p.file_end_offset if offset_from + n >= file_size else 0
        window = n if n <= 2 * READ_WINDOW_BYTES else None
        result, _, _ = self._read(staged, n, file_id, segment_id_prefix,
                                  record_index, header, footer,
                                  window_bytes=window, path=path,
                                  base_offset=offset_from)
        return result

    def _read(self, f, size: int, file_id: int, segment_id_prefix,
              start_record_id: int, header: int, footer: int,
              window_bytes: Optional[int] = None, keep_starts: bool = False,
              path: str = "", base_offset: int = 0):
        """Frame and decode `size` bytes of `f` (`frame_windows`), at
        `base_offset` of the file `path`: the FileResult (with its ledger
        and the reasons of its malformed rows under a permissive policy),
        the segment ids of every framed record, and the record header
        offsets when `keep_starts`. A hierarchical read decodes once
        (`_read_hierarchical`); the row walk reads `f`, a SimpleStream,
        on the host (`_read_rows`) and gives no ids nor offsets."""
        if self.row_walk:
            return (self._read_rows(f, file_id, segment_id_prefix,
                                    start_record_id, path), None, None)
        if self.decode_once:
            return self._read_hierarchical(
                f, size, file_id, start_record_id, header, footer,
                window_bytes, keep_starts, path, base_offset)
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
                                p.input_file_name_column),
                            corrupt_record_field=p.corrupt_record_column,
                            diagnostics=(p.new_diagnostics()
                                         if p.is_permissive else None))
        reasons: Dict[int, str] = {}
        file_ids = _FileSegmentIds()
        starts: List[np.ndarray] = []
        matched = False       # a record of a Seg_Id level was seen
        n_total = 0           # records framed in earlier windows
        windows = self._frame(
            f, size, header, footer, window_bytes, file_ids,
            ledger=result.diagnostics, file_name=path,
            base_offset=base_offset, corrupt_reasons=reasons,
            start_record_id=start_record_id)
        while True:
            with timed_stage(self.stage_times, "frame"):
                window = next(windows, None)
            if window is None:
                break
            base, image, offs_d, lengths, window_ids = window
            n = offs_d.numel()
            obs = obs_current()
            if obs is not None and obs.metrics is not None and n:
                # record-length distribution (one vectorized bucket count
                # a window, never a per-record loop)
                obs.metrics["record_length"].observe_many(lengths)
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
            with timed_stage(self.stage_times, "decode"):
                if self.pushdown is not None:
                    keep = self._pushdown_kept(image, offs_d, lengths,
                                               keep, window_ids)
                self._decode_window(result, image, offs_d, lengths, keep,
                                    window_ids, n_total, start_record_id)
            n_total += n
        result.records_framed = n_total
        result.corrupt_row_reasons = reasons or None
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
               window_bytes: Optional[int], file_ids: _FileSegmentIds,
               ledger: Optional[ReadDiagnostics] = None,
               file_name: str = "", base_offset: int = 0,
               corrupt_reasons: Optional[Dict[int, str]] = None,
               start_record_id: int = 0):
        """`frame_windows` over `size` bytes of `f` (at `base_offset` of
        the file `file_name`, under the read's record error policy, its
        incidents into `ledger`), yielding (base, image, offsets on the
        device, host lengths, the window's segment ids or None) per
        window; the ids (their id field packed on the device, decoded on
        the host) are also added to `file_ids`."""
        p = self.params
        seg_field = resolve_segment_id_field(p, self.copybook)
        if self.generic_framing:
            # `f` is a SimpleStream; the header parser sees the file's
            # header and footer itself
            for window in self._frame_generic(f, start_record_id,
                                              window_bytes, ledger,
                                              corrupt_reasons):
                if window[4] is not None:
                    file_ids.add(window[4])
                yield window
            return
        if p.is_record_sequence:
            windows = frame_windows(
                f, size, self.device, p.is_rdw_big_endian,
                p.rdw_length_adjustment, header, footer, window_bytes,
                policy=p.record_error_policy,
                ledger=(ledger if ledger is not None
                        else p.new_diagnostics()),
                file_name=file_name, base_offset=base_offset,
                resync_window=p.resync_window_bytes,
                corrupt_reasons=corrupt_reasons)
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
        to root-segment boundaries whenever Seg_Id generation or a
        parent-child segment map is requested, so per-shard Seg_Id
        accumulators and hierarchical rows restart exactly at a root)."""
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
        is_hierarchical = bool(seg and (seg.segment_level_ids
                                        or seg.field_parent_map))
        root_segment_id = ""
        if seg:
            if seg.field_parent_map and self.segment_redefine_map:
                # every root id is a valid split boundary (multi-root files,
                # reference Test12MultiRootSparseIndex)
                root_segment_id = ",".join(self.copybook.get_root_segment_ids(
                    self.segment_redefine_map, seg.field_parent_map))
            elif seg.segment_level_ids:
                root_segment_id = seg.segment_level_ids[0]
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

    def _index_applies(self, size: int, path: str) -> bool:
        """Whether the JAX package reads the file `path` of `size`
        (decompressed) bytes in sparse-index shards
        (``index.file_index_entries`` returns entries): never a
        compressed file without a cache_dir."""
        p = self.params
        explicit = (p.input_split_records is not None
                    or p.input_split_size_mb is not None)
        if not p.is_index_generation_needed or size == 0 \
                or not (explicit or size > self._bytes_per_entry()) \
                or not compressed_chunkable(path, self.io):
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

    def _index_store(self):
        """(SparseIndexStore, config fingerprint) of the read's
        cache_dir, or None (no cache_dir, or an unusable cache volume:
        the cache must never fail the read)."""
        if self.io is None or not self.io.cache_enabled:
            return None
        from ..io.index_store import (SparseIndexStore,
                                      index_config_fingerprint)
        try:
            return (SparseIndexStore(self.io.cache_dir),
                    index_config_fingerprint(self, self.params))
        except OSError:
            return None

    def generate_index(self, path: str,
                       file_id: int) -> List[SparseIndexEntry]:
        """The sparse index of one file (the JAX package's
        ``generate_index_fast``): the scan kernel frames the file window
        by window, the record header offsets (and, for root-aligned
        splits, the segment ids) come to the host, and
        `index.sparse_index_entries` applies the reference's entry
        rule. With a cache_dir the entries of this file version and
        configuration are loaded from the sparse-index store when it
        has them (no pass at all: ``index_hits``) and saved when
        computed (``index_misses``, ``index_saves``), as the JAX
        package's ``file_index_entries`` does."""
        with (self.open_stream(path) if self.generic_framing
              else self.open_input(path)) as f:
            store, cached = self._stored_index(path, f, file_id)
            if cached is not None:
                return cached
            entries = (self._generate_index_generic(f, file_id)
                       if self.generic_framing
                       else self._generate_index_fast(f, path, file_id))
        self._save_index(store, path, entries)
        return entries

    def _stored_index(self, path: str, f, file_id: int):
        """((store, config fingerprint, file fingerprint) or None, the
        stored entries of this file version or None), counting the
        lookup as a hit or a miss; `f` is the file's open reader."""
        store = self._index_store()
        if store is None:
            return None, None
        key = store + (_input_fingerprint(path, f),)
        cached = store[0].load(path, key[2], store[1], file_id)
        stats = current_io_stats()
        if stats is not None:
            stats.bump("index_hits" if cached is not None
                       else "index_misses")
        return key, cached

    @staticmethod
    def _save_index(key, path: str, entries) -> None:
        """Persist freshly computed entries under `key` (from
        `_stored_index`; None: no store)."""
        if key is None:
            return
        key[0].save(path, key[2], key[1], entries)
        stats = current_io_stats()
        if stats is not None:
            stats.bump("index_saves")

    def _generate_index_fast(self, f, path: str,
                             file_id: int) -> List[SparseIndexEntry]:
        """The scan kernel's index pass over the open reader `f`."""
        p = self.params
        self._index_split_config()
        size = self.input_size(path)
        starts: List[np.ndarray] = []
        file_ids = _FileSegmentIds()
        # the read's skip decisions (a throwaway ledger: the shards
        # record the incidents), so that splits land on the records the
        # shards frame
        for base, _, offs_d, _, _ in self._frame(
                f, size, p.file_start_offset, p.file_end_offset, None,
                file_ids):
            starts.append(base + offs_d.cpu().numpy() - self._header_len)
        starts = (np.concatenate(starts) if starts
                  else np.zeros(0, dtype=np.int64))
        return sparse_index_entries(
            starts, file_id, p, self._root_indices(file_ids.segment_ids()),
            base=1 if p.file_start_offset > 0 else 0,
            bytes_per_entry=self._bytes_per_entry(),
            trailing=self._trailing(size))

    def _generate_index_generic(self, stream: SimpleStream, file_id: int
                                ) -> List[SparseIndexEntry]:
        """reference VarLenNestedReader.generateIndex (:125-180): the
        generic per-record generator over the file's `stream`, with the
        read's resync decisions. For records framed by a record-length
        field the generator takes the records the length field frames
        (`_LengthFieldRecords`); the JAX package gives it the
        fixed-length header parser there, so its splits land every
        copybook-size bytes, inside records (ROADMAP C7)."""
        p = self.params
        is_hierarchical, root_segment_id = self._index_split_config()
        extractor = (_LengthFieldRecords(self.make_record_reader(stream))
                     if p.length_field_name and not p.record_extractor
                     else self.record_extractor(0, stream))
        return sparse_index_generator(
            file_id,
            stream,
            record_header_parser=self.record_header_parser(),
            record_extractor=extractor,
            records_per_index_entry=p.input_split_records,
            size_per_index_entry_mb=p.input_split_size_mb,
            copybook=self.copybook,
            segment_field=resolve_segment_id_field(p, self.copybook),
            is_hierarchical=is_hierarchical,
            root_segment_id=root_segment_id,
            record_error_policy=p.record_error_policy,
            resync_window_bytes=p.resync_window_bytes)

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
                    image, offs_d, lengths,
                    start_offset=self.params.start_offset, rows=part)
                file_pos = first + part.astype(np.int64)
                result.segments.append(SegmentBatch(
                    decoded, active or None, file_pos,
                    start_record_id + file_pos))

    def _pushdown_kept(self, image: torch.Tensor, offs_d: torch.Tensor,
                       lengths: np.ndarray, keep: np.ndarray,
                       window_ids: Optional[SegmentIds]) -> np.ndarray:
        """The filter over the records a window keeps (the JAX package's
        ``_pushdown_kept``): segment-id conjuncts drop on the raw ids
        (no decode at all), then stage 1 decodes ONLY the filter columns
        from the window image and evaluates the value predicate — per
        active segment, so a field owned by one redefine evaluates null
        (and drops) on the other segments' records, as a post-hoc filter
        on the assembled table does. `scanned` counts the records the
        pushdown examined: the levels and the segment filter dropped
        theirs before. Returns the new keep mask."""
        pd = self.pushdown
        kept = np.nonzero(keep)[0]
        n_scanned = len(kept)
        pruned_segment = 0
        bytes_skipped = 0
        if pd.segment_values is not None and window_ids is not None \
                and len(kept):
            mask = window_ids.mask_of(set(pd.segment_values))[kept]
            pruned_segment = len(kept) - int(mask.sum())
            bytes_skipped += int(lengths[kept][~mask].sum())
            kept = kept[mask]
        pruned_filter = 0
        if pd.value_expr is not None and len(kept):
            if window_ids is None or not self.segment_redefine_map:
                groups = {"": np.arange(len(kept))}
            else:
                groups = {}
                for active in sorted(set(window_ids.map_uniq(
                        self.segment_redefine_map))):
                    idx = np.nonzero(window_ids.mask_of_mapped(
                        self.segment_redefine_map, active)[kept])[0]
                    if len(idx):
                        groups[active] = idx
            mask = np.zeros(len(kept), dtype=bool)
            for active, idx in groups.items():
                sub = kept[idx]
                mask[idx] = pd.mask_raw(
                    self._decoders, self.device, active, image,
                    offs_d[torch.from_numpy(sub).to(image.device)],
                    lengths[sub], start_offset=self.params.start_offset)
            pruned_filter = len(kept) - int(mask.sum())
            bytes_skipped += int(lengths[kept][~mask].sum())
            kept = kept[mask]
        pd.stats.note(scanned=n_scanned, pruned_segment=pruned_segment,
                      pruned_filter=pruned_filter,
                      bytes_skipped=bytes_skipped)
        out = np.zeros(len(keep), dtype=bool)
        out[kept] = True
        return out
