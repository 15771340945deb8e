"""Chunk planning: split a scan into independently-executable byte ranges.

Port copy of ``cobrix_tpu.engine.chunks``. Two planners, one chunk
contract:

* fixed-length files split on record-size-aligned byte strides — chunk
  boundaries are pure arithmetic, no scan needed;
* variable-length streams split on sparse-index entries
  (reader/index.py) — the index pass turns the inherently-sequential
  record stream into restartable byte ranges, exactly the mechanism the
  reference uses to parallelize VRL files across Spark partitions
  (IndexBuilder.scala:49-66).

Chunk plans are EXECUTION plans only: a pipelined read with the same
split options decodes the same records with the same Record_Ids as the
sequential path, so turning the pipeline on can never change results.

Changes from the JAX package: the stats chunk skipper (``use_stats``,
ROADMAP A6/A8) is not carried over; the port reads local, uncompressed
files only, so sizes come from ``os.path.getsize`` and there is no
retry policy or compressed-chunk check; `plan_fixed_chunks` takes the
record size in place of the fixed-length reader; `WorkShard`
(``parallel.planner.WorkShard`` in the JAX package) lives here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

from ..reader.index import file_index_entries
from ..reader.parameters import DEFAULT_FILE_RECORD_ID_INCREMENT


def shard_progress_bytes(shard) -> int:
    """Best-effort byte size of a var-len shard for progress/telemetry
    accounting: closed ranges are exact; an open tail range
    (offset_to < 0 = 'to end of file') falls back to the file size."""
    if shard.offset_to >= 0:
        return max(0, shard.offset_to - shard.offset_from)
    try:
        return max(0, os.path.getsize(shard.file_path) - shard.offset_from)
    except OSError:
        return 0


@dataclass(frozen=True)
class FixedChunk:
    """One fixed-length unit of pipelined work: a record-aligned byte
    range of one input file (the whole file when the file is too small or
    not cleanly divisible)."""

    file_path: str
    file_order: int
    offset: int            # byte offset of the chunk in the file
    nbytes: int            # bytes to read (0 = to end of file)
    first_record_id: int   # Record_Id of the chunk's first record
    whole_file: bool       # single-chunk file (odd tails)


@dataclass(frozen=True)
class WorkShard:
    """A byte range of one variable-length file."""
    file_path: str
    file_order: int
    offset_from: int
    offset_to: int          # -1 = to end of file
    record_index: int       # Record_Id seed for the shard (reference
                            # SparseIndexEntry.recordIndex semantics)


def fixed_file_chunkable(size: int, record_size: int, params,
                         chunk_bytes: int, ignore_file_size: bool) -> bool:
    """THE fixed-length split predicate: no file-level header/footer
    trims and a record-divisible payload (or debug_ignore_file_size)."""
    payload = size - params.file_start_offset - params.file_end_offset
    return (size > chunk_bytes
            and not params.file_start_offset
            and not params.file_end_offset
            and (payload % record_size == 0 or ignore_file_size))


def plan_fixed_chunks(record_size: int, files, params, chunk_bytes: int,
                      ignore_file_size: bool = False) -> List[FixedChunk]:
    """Byte-stride chunk plan over fixed-length input files.

    A file splits only when the conditions of `fixed_file_chunkable`
    hold; anything else — including a truncated tail — stays a single
    whole-file chunk, so tail handling matches the sequential read.
    """
    rs = record_size
    chunk_bytes = max(rs, (chunk_bytes // rs) * rs)  # record-aligned
    chunks: List[FixedChunk] = []
    for file_order, file_path in enumerate(files):
        base = file_order * DEFAULT_FILE_RECORD_ID_INCREMENT
        size = os.path.getsize(file_path)
        if not fixed_file_chunkable(size, rs, params, chunk_bytes,
                                    ignore_file_size):
            chunks.append(FixedChunk(file_path, file_order, 0, 0, base,
                                     whole_file=True))
            continue
        done = 0
        while done < size:
            n = min(chunk_bytes, size - done)
            chunks.append(FixedChunk(file_path, file_order, done, n,
                                     base + done // rs, whole_file=False))
            done += n
    return chunks


def plan_var_len_chunks(reader, files, params) -> List[WorkShard]:
    """Byte-range shard plan for a variable-length read: the sparse index
    per file turns the sequential record stream into shards; files
    without a useful index become one whole-file shard."""
    shards: List[WorkShard] = []
    for file_order, file_path in enumerate(files):
        base = file_order * DEFAULT_FILE_RECORD_ID_INCREMENT
        entries = None
        if params.is_index_generation_needed:
            entries = file_index_entries(reader, file_path, file_order,
                                         params)
        if entries is not None and len(entries) > 1:
            for e in entries:
                shards.append(WorkShard(file_path, file_order,
                                        e.offset_from, e.offset_to,
                                        base + e.record_index))
        else:
            shards.append(WorkShard(file_path, file_order, 0, -1, base))
    return shards


def auto_split_mb(params) -> Optional[float]:
    """The sparse-index split size (MB) a pipelined variable-length read
    should default to, or None to leave the plan untouched.

    Only configurations where split granularity provably cannot change
    results get the default: plain RDW streams with no file header/footer
    regions (whose counted-invalid-record quirk shifts Record_Ids between
    indexed and unindexed reads — reference IndexGenerator.scala:117-120).
    Explicit input_split options always win.
    """
    if (params.input_split_records is not None
            or params.input_split_size_mb is not None):
        return None
    if not params.is_index_generation_needed:
        return None
    if params.file_start_offset or params.file_end_offset:
        return None
    if not params.supports_fast_framing:
        return None
    # fractional chunk sizes pass through (the index multiplies by
    # MEGABYTE); below 1 MB the split-option validation floor applies,
    # so tiny-chunk runs use explicit input_split options instead
    mb = float(params.pipeline_chunk_mb)
    return mb if mb >= 1 else None
