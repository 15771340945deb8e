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

Sizes come from ``reader.stream.source_size`` (a compressed input's
decompressed size, a backend object's size under the read's retry
policy), and a compressed input splits only with a ``cache_dir``
(``io.compress.compressed_chunkable``): without its decompressed block
plane every chunk would re-inflate the prefix, so it is one whole-file
chunk or shard.

When a read armed a chunk skipper (``use_stats=true`` + a filter + a
warm profile, stats/skip.py), both planners drop ranges the profile
PROVES cannot frame a matching record — before any byte is read.
Offsets and Record_Id bases of surviving chunks are absolute, so
skipping never renumbers or reorders what remains. The sequential reads
plan a file under a skipper with these planners too
(``api._read_fixed_kept``, ``VarLenReader._read_kept_shards``): one
skip rule for every read, and a file is read in its plan's units however
many the skipper keeps; only a file planned as one whole chunk is read
as a stats-off read reads it.

Changes from the JAX package: `plan_fixed_chunks` takes the record size
and the skipper in place of the fixed-length reader; `WorkShard`
(``parallel.planner.WorkShard`` in the JAX package) lives here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..io.compress import compressed_chunkable
from ..reader.index import file_index_entries
from ..reader.parameters import DEFAULT_FILE_RECORD_ID_INCREMENT, MEGABYTE
from ..reader.stream import RetryPolicy, source_size


def shard_progress_bytes(shard, file_size: int) -> int:
    """Byte size of a var-len shard (a WorkShard or a sparse-index entry)
    for progress and read accounting: a closed range is exact, clamped to
    the file; an open tail range (offset_to < 0 = 'to end of file') runs
    to `file_size`, so bytes_done reaches bytes_total. The caller passes
    the file's logical size (decompressed for a compressed feed), as the
    read sized it: the JAX package's version sizes a local file with
    ``os.path.getsize`` itself."""
    end = (file_size if shard.offset_to < 0
           else min(shard.offset_to, file_size))
    return max(0, end - shard.offset_from)


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
                      ignore_file_size: bool = False,
                      retry: Optional[RetryPolicy] = None, on_retry=None,
                      io=None, skipper=None) -> List[FixedChunk]:
    """Byte-stride chunk plan over fixed-length input files.

    A file splits only when the conditions of `fixed_file_chunkable`
    hold and it is `compressed_chunkable`; anything else — including a
    truncated tail — stays a single whole-file chunk, so tail handling
    matches the sequential read. With a `skipper` (the read's
    ``stats.skip.ChunkSkipper``) the plan strides on the profile grid
    and leaves out every chunk the profile proves matches nothing.
    """
    rs = record_size
    if skipper is not None:
        # chunking is output-invariant: with skipping armed, plan on
        # the profile grid so skip granularity matches the proofs
        chunk_bytes = min(chunk_bytes, max(
            rs, int(params.stats_chunk_mb * MEGABYTE)))
    chunk_bytes = max(rs, (chunk_bytes // rs) * rs)  # record-aligned
    chunks: List[FixedChunk] = []
    for file_order, file_path in enumerate(files):
        base = file_order * DEFAULT_FILE_RECORD_ID_INCREMENT
        size = source_size(file_path, retry=retry, on_retry=on_retry,
                           io=io)
        if not fixed_file_chunkable(size, rs, params, chunk_bytes,
                                    ignore_file_size) \
                or not compressed_chunkable(file_path, io):
            if skipper is not None \
                    and skipper.should_skip(file_path, 0, -1):
                continue
            chunks.append(FixedChunk(file_path, file_order, 0, 0, base,
                                     whole_file=True))
            continue
        done = 0
        while done < size:
            n = min(chunk_bytes, size - done)
            if skipper is None \
                    or not skipper.should_skip(file_path, done, done + n):
                chunks.append(FixedChunk(file_path, file_order, done, n,
                                         base + done // rs,
                                         whole_file=False))
            done += n
    return chunks


def plan_var_len_chunks(reader, files, params,
                        retry: Optional[RetryPolicy] = None, on_retry=None,
                        io=None) -> List[WorkShard]:
    """Byte-range shard plan for a variable-length read: the sparse index
    per file turns the sequential record stream into shards; files
    without a useful index (or a compressed file without a cache_dir)
    become one whole-file shard. A chunk skipper armed on the reader
    (``reader.chunk_skipper``) drops each shard its profile proves
    matches nothing."""
    skipper = getattr(reader, "chunk_skipper", None)
    shards: List[WorkShard] = []
    for file_order, file_path in enumerate(files):
        base = file_order * DEFAULT_FILE_RECORD_ID_INCREMENT
        entries = None
        if params.is_index_generation_needed:
            entries = file_index_entries(reader, file_path, file_order,
                                         params, retry, on_retry, io=io)
        if entries is not None and len(entries) > 1:
            for e in entries:
                if skipper is not None and skipper.should_skip(
                        file_path, e.offset_from, e.offset_to):
                    continue
                shards.append(WorkShard(file_path, file_order,
                                        e.offset_from, e.offset_to,
                                        base + e.record_index))
        elif skipper is None \
                or not skipper.should_skip(file_path, 0, -1):
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
