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

Left out: the on-disk index store (``io.cache_dir``) and compressed
inputs, which ``api.read_cobol`` refuses before planning (ROADMAP A4f);
the generic generator itself and `IncrementalIndexer`, whose other
framings the port does not take.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np


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
    from .parameters import DEFAULT_INDEX_ENTRY_SIZE_MB, MEGABYTE

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
