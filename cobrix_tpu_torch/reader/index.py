"""Sparse index: the byte ranges a variable-length file is read in.

Port copy of ``cobrix_tpu.reader.index``: `SparseIndexEntry` as it is,
and `file_index_entries` for local files, which returns None when one
shard suffices and otherwise the reader's index
(``VarLenReader.generate_index``). `sparse_index_entries` is the entry
rule of the JAX package's vectorized index
(``VarLenReader.generate_index_fast``), applied to the record header
offsets that the port's scan kernel frames: split every
`input_split_records` records or every `input_split_size_mb` MB (100 MB
by default) with the size drift carried, only at roots when Seg_Id
levels are set, and never at the last record unless bytes follow it; a
file header counts as one record (reference
IndexGenerator.scala:117-120). For fixed-length records it gives the
entries of the JAX package's generic generator
(``sparse_index_generator`` with a fixed-length header parser) over
their arithmetic offsets.

The generic per-record generator, `sparse_index_generator` (reference
IndexGenerator.sparseIndexGenerator, IndexGenerator.scala:33-127), with
its permissive resync, indexes the generic framings (text, record-length
fields, custom header parsers and extractors, variable-size OCCURS: where
``ReaderParameters.supports_fast_framing`` is false); `IncrementalIndexer`
is its record-at-a-time twin, copied unchanged.

Left out: the on-disk index store (``io.cache_dir``) and compressed
inputs, which ``api.read_cobol`` refuses before planning (ROADMAP A4f).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np

from ..copybook.ast import Primitive
from ..copybook.copybook import Copybook
from .diagnostics import (
    DEFAULT_RESYNC_WINDOW,
    ReadDiagnostics,
    RecordErrorPolicy,
)
from .header_parsers import RdwHeaderParser, RecordHeaderParser
from .parameters import DEFAULT_INDEX_ENTRY_SIZE_MB, MEGABYTE
from .raw_extractors import RawRecordExtractor
from .recovery import (
    PendingReader,
    generic_blob_validator,
    rdw_blob_validator,
    resync_stream,
)
from .stream import SimpleStream


@dataclass(frozen=True)
class SparseIndexEntry:
    offset_from: int
    offset_to: int      # -1 = to end of file
    file_id: int
    record_index: int


def file_index_entries(reader, file_path: str, file_order: int,
                       params) -> Optional[List[SparseIndexEntry]]:
    """Sparse index for one local file, or None when a single shard
    suffices (empty, or not over the split size without an explicit
    split option)."""
    explicit = (params.input_split_records is not None
                or params.input_split_size_mb is not None)
    split_mb = params.input_split_size_mb or DEFAULT_INDEX_ENTRY_SIZE_MB
    size = os.path.getsize(file_path)
    if size == 0 or (not explicit and size <= split_mb * MEGABYTE):
        return None
    return reader.generate_index(file_path, file_order)


def sparse_index_entries(starts: np.ndarray, file_id: int, params,
                         root_indices: Optional[np.ndarray], base: int,
                         bytes_per_entry: float,
                         trailing: Optional[bool] = None
                         ) -> List[SparseIndexEntry]:
    """The entries over records whose headers start at `starts` (file
    offsets, in order). `root_indices`: the positions a split may land
    on (None: any); `base`: 1 when a file header counts as a record;
    `bytes_per_entry`: the size split in bytes; `trailing`: for
    fixed-length records (the JAX package's generic index pass), whether
    bytes follow the last record, which lets a split land on it; None
    for the vectorized RDW index, where a footer does."""
    n = len(starts)

    def next_root(i: int) -> Optional[int]:
        if root_indices is None:
            return i
        k = np.searchsorted(root_indices, i, side="left")
        if k >= len(root_indices):
            return None
        return int(root_indices[k])

    entries = [SparseIndexEntry(0, -1, file_id, 0)]
    per = params.input_split_records
    mb = bytes_per_entry
    # processing the last record ends the stream before the split check
    # (IndexGenerator loop order) — unless a footer region follows it,
    # which is consumed as one more counted iteration
    if trailing is None:
        trailing = params.file_end_offset > 0
    last_candidate = n - 1 if trailing else n - 2
    subtracted = 0
    chunk_start_counted = 0
    i = -1  # a first-chunk split at record 0 is possible (header counted)
    while True:
        if per is not None:
            cand = chunk_start_counted + per - base
        else:
            target = subtracted + mb
            cand = int(np.searchsorted(starts, target, side="left"))
        cand = max(cand, i + 1)
        split_at = next_root(cand)
        if split_at is None or split_at > last_candidate:
            break
        entries[-1] = replace(entries[-1], offset_to=int(starts[split_at]))
        entries.append(SparseIndexEntry(
            int(starts[split_at]), -1, file_id, split_at + base))
        if per is not None:
            chunk_start_counted = split_at + base
        else:
            subtracted += mb
        i = split_at
    return entries


class IncrementalIndexer:
    """Sparse-index construction one record at a time — the streaming
    twin of `sparse_index_generator` for the continuous-ingest tailer.

    A growing file cannot be indexed by a one-shot sequential pass (the
    pass would never end), but the tailer already frames every record as
    it stabilizes; feeding those framings here keeps the sparse index
    CURRENT at every watermark, so when the generation finalizes
    (rotation, stream shutdown) the complete entries persist to the
    index store and the very first batch `read_cobol` of the rotated
    file goes straight to shard planning — no re-index pass.

    Split arithmetic mirrors `sparse_index_generator` exactly for the
    non-hierarchical case (records-per-entry, or size-per-entry with
    drift carry); `state_dict()`/`from_state` round-trip through the
    ingest checkpoint so a crashed tailer resumes indexing from its
    watermark instead of record zero. Hierarchical root-boundary
    alignment needs segment inspection the live tailer refuses anyway
    (see streaming.ingest), so it is unsupported here."""

    def __init__(self, records_per_entry: Optional[int] = None,
                 size_per_entry_mb: Optional[int] = None):
        self.records_per_entry = records_per_entry
        self.size_per_entry_mb = size_per_entry_mb
        self._bytes_per_entry = (size_per_entry_mb
                                 or DEFAULT_INDEX_ENTRY_SIZE_MB) * MEGABYTE
        self.byte_index = 0
        self.record_index = 0
        self.records_in_chunk = 0
        self.bytes_in_chunk = 0
        # (offset_from, record_index) split points; entry 0 is implicit
        self._splits: List[List[int]] = [[0, 0]]
        # one-record lookahead: the one-shot generator detects EOF
        # BEFORE its split branch, so the stream's LAST record can
        # never open a new entry — mirrored here by applying each
        # record only once a successor proves it was not last
        self._held: Optional[List] = None

    def _need_split(self) -> bool:
        if self.records_per_entry is not None:
            return self.records_in_chunk >= self.records_per_entry
        return self.bytes_in_chunk >= self._bytes_per_entry

    def add_record(self, record_size: int, is_valid: bool = True) -> None:
        """One framed record, in stream order (`record_size` includes
        its header bytes — the full stream distance it consumed)."""
        if self._held is not None:
            self._apply(*self._held)
        self._held = [int(record_size), bool(is_valid)]

    def _apply(self, record_size: int, is_valid: bool) -> None:
        if is_valid and self._need_split():
            self._splits.append([self.byte_index, self.record_index])
            self.records_in_chunk = 0
            if self.records_per_entry is None:
                # carry the size-split drift (sparse_index_generator's
                # block-alignment rule)
                self.bytes_in_chunk -= self._bytes_per_entry
            else:
                self.bytes_in_chunk = 0
        self.record_index += 1
        self.records_in_chunk += 1
        self.byte_index += record_size
        self.bytes_in_chunk += record_size

    def entries(self, file_id: int) -> List[SparseIndexEntry]:
        """The sparse index as of the records fed so far (the last entry
        is open-ended, matching the one-shot generator's output; the
        held lookahead record never contributes a split, exactly like
        the generator's last record)."""
        out: List[SparseIndexEntry] = []
        for i, (offset_from, record_index) in enumerate(self._splits):
            offset_to = (self._splits[i + 1][0]
                         if i + 1 < len(self._splits) else -1)
            out.append(SparseIndexEntry(offset_from, offset_to, file_id,
                                        record_index))
        return out

    def state_dict(self) -> dict:
        return {
            "records_per_entry": self.records_per_entry,
            "size_per_entry_mb": self.size_per_entry_mb,
            "byte_index": self.byte_index,
            "record_index": self.record_index,
            "records_in_chunk": self.records_in_chunk,
            "bytes_in_chunk": self.bytes_in_chunk,
            "splits": [list(s) for s in self._splits],
            "held": list(self._held) if self._held else None,
        }

    @classmethod
    def from_state(cls, state: dict) -> "IncrementalIndexer":
        indexer = cls(records_per_entry=state.get("records_per_entry"),
                      size_per_entry_mb=state.get("size_per_entry_mb"))
        indexer.byte_index = int(state.get("byte_index", 0))
        indexer.record_index = int(state.get("record_index", 0))
        indexer.records_in_chunk = int(state.get("records_in_chunk", 0))
        indexer.bytes_in_chunk = int(state.get("bytes_in_chunk", 0))
        splits = state.get("splits") or [[0, 0]]
        indexer._splits = [[int(a), int(b)] for a, b in splits]
        held = state.get("held")
        indexer._held = ([int(held[0]), bool(held[1])] if held
                         else None)
        return indexer


def sparse_index_generator(file_id: int,
                           data_stream: SimpleStream,
                           record_header_parser: Optional[RecordHeaderParser] = None,
                           record_extractor: Optional[RawRecordExtractor] = None,
                           records_per_index_entry: Optional[int] = None,
                           size_per_index_entry_mb: Optional[int] = None,
                           copybook: Optional[Copybook] = None,
                           segment_field: Optional[Primitive] = None,
                           is_hierarchical: bool = False,
                           root_segment_id: str = "",
                           record_error_policy: RecordErrorPolicy =
                           RecordErrorPolicy.FAIL_FAST,
                           resync_window_bytes: int = DEFAULT_RESYNC_WINDOW,
                           ledger: Optional[ReadDiagnostics] = None
                           ) -> List[SparseIndexEntry]:
    root_segment_ids = root_segment_id.split(",")
    byte_index = 0
    index: List[SparseIndexEntry] = [SparseIndexEntry(0, -1, file_id, 0)]
    root_record_id = ""
    records_in_chunk = 0
    bytes_in_chunk = 0
    record_index = 0
    is_really_hierarchical = (copybook is not None and segment_field is not None
                              and is_hierarchical)
    is_split_by_size = records_per_index_entry is None
    if records_per_index_entry is not None:
        def need_split(records: int, size: int) -> bool:
            return records >= records_per_index_entry
    else:
        bytes_per_entry = (size_per_index_entry_mb
                           or DEFAULT_INDEX_ENTRY_SIZE_MB) * MEGABYTE

        def need_split(records: int, size: int) -> bool:
            return size >= bytes_per_entry

    def get_segment_id(record: bytes) -> str:
        value = copybook.extract_primitive_field(segment_field, record)
        return "" if value is None else str(value).strip()

    permissive = record_error_policy is not RecordErrorPolicy.FAIL_FAST
    if permissive and ledger is None:
        ledger = ReadDiagnostics()
    reader = PendingReader(data_stream)

    def header_validator():
        if type(record_header_parser) is RdwHeaderParser:
            return rdw_blob_validator(record_header_parser)
        return generic_blob_validator(record_header_parser,
                                      data_stream.size(), reader.offset)

    end_of_file = False
    while not end_of_file:
        record = None
        if record_extractor is not None:
            offset0 = record_extractor.offset
            if record_extractor.has_next():
                record = next(record_extractor)
                is_valid = True
            else:
                is_valid = False
            record_size = record_extractor.offset - offset0
            has_more = record_extractor.has_next()
        else:
            header = reader.read(record_header_parser.header_length)
            while True:
                try:
                    meta = record_header_parser.get_record_metadata(
                        header, reader.offset, data_stream.size(),
                        record_index)
                    break
                except ValueError as exc:
                    # corruption tolerance mirrors VRLRecordReader so the
                    # index pass and the shard framers skip identically
                    if not permissive:
                        raise
                    header = resync_stream(
                        reader, header, header_validator(),
                        record_header_parser.header_length,
                        resync_window_bytes, ledger,
                        data_stream.input_file_name,
                        getattr(exc, "reason", str(exc)))
                    if header is None:
                        meta = None
                        break
            if meta is None:
                record_size = reader.offset - byte_index
                has_more = False
                is_valid = False
            else:
                if meta.record_length > 0:
                    record = reader.read(meta.record_length)
                record_size = reader.offset - byte_index
                has_more = record_size > 0
                is_valid = meta.is_valid

        if (record_extractor is None and reader.at_end) \
                or (record_extractor is not None
                    and data_stream.is_end_of_stream) or not has_more:
            end_of_file = True
        elif is_valid:
            if is_really_hierarchical and not root_record_id:
                cur = get_segment_id(record)
                if (cur and not root_segment_ids) or cur in root_segment_ids:
                    root_record_id = cur
            if need_split(records_in_chunk, bytes_in_chunk):
                if (not is_really_hierarchical
                        or get_segment_id(record) in root_segment_ids):
                    entry = SparseIndexEntry(byte_index, -1, file_id, record_index)
                    index[-1] = replace(index[-1], offset_to=entry.offset_from)
                    index.append(entry)
                    records_in_chunk = 0
                    if is_split_by_size:
                        # carry the size-split drift so shard boundaries stay
                        # aligned with storage blocks
                        bytes_in_chunk -= (size_per_index_entry_mb
                                           or DEFAULT_INDEX_ENTRY_SIZE_MB) * MEGABYTE
                    else:
                        bytes_in_chunk = 0
        # NOTE: invalid records (file headers/footers) ARE counted, mirroring
        # the reference exactly (IndexGenerator.scala:117-120 increments
        # unconditionally) — even though VRLRecordReader skips invalid
        # records without numbering them. The resulting Record_Id shift
        # after a file header on indexed reads is reference behavior.
        record_index += 1
        records_in_chunk += 1
        byte_index += record_size
        bytes_in_chunk += record_size
    if is_really_hierarchical and root_segment_id and not root_record_id:
        logging.getLogger(__name__).error(
            "Root segment %s=='%s' not found in the data file.",
            segment_field.name, root_segment_id)
    elif is_really_hierarchical and not root_record_id:
        logging.getLogger(__name__).error(
            "Root segment %s is empty for every record in the data file.",
            segment_field.name)
    return index
