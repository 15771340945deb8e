"""Micro-batch streaming reads (the original `streaming.py` surface).

The equivalent of the reference's experimental DStream integration
(`CobolStreamer.cobolStream`, spark-cobol
source/streaming/CobolStreamer.scala:42-82): fixed-length records arrive
as a stream — either an iterable of byte chunks (sockets, queues) or new
files appearing in a directory (the `binaryRecordsStream` semantic) — and
each micro-batch is decoded with the standard fixed-length reader into a
`CobolData` batch. Record_Id numbering continues monotonically across
batches so re-assembled streams stay reproducible.

Port copy of ``cobrix_tpu.streaming.microbatch``: every batch decodes
on the streamer's device (``device``, the CUDA device unless given
``"cpu"``, in place of the JAX package's ``backend``) through
``FixedLenReader.read_result`` — one copy of the batch's records to the
card from a pinned staging buffer, then the fused decode kernel.

For live, growing, rotating sources with crash recovery, use the
production ingestion layer (`streaming.ingest.ContinuousIngestor`) —
this module consumes whole files exactly once per process lifetime and
keeps its only state in memory.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Iterator, Optional

from ..api import CobolData, parse_options
from ..device import resolve_device
from ..reader.fixed_len_reader import FixedLenReader
from ..reader.schema import CobolOutputSchema
from ..utils.file_utils import list_input_files

_logger = logging.getLogger(__name__)

# per-file read granularity for stream_directory: files above this
# stream as several record-aligned batches instead of one whole-file
# read, bounding peak memory at ~one chunk + its decoded columns
DIRECTORY_CHUNK_BYTES = 64 * 1024 * 1024

# how long a size-stable file whose length is NOT a whole number of
# records may sit before it is consumed under the record-error policy
# anyway (a slow writer paused mid-record gets this long to finish; a
# junk file can starve at most this long before it surfaces)
NONDIVISIBLE_GRACE_S = 1.0


class CobolStreamer:
    """Decode a stream of fixed-length COBOL records in micro-batches.

    Options are the standard `read_cobol` option keys (record layout,
    schema policy, generate_record_id, ...). Variable-length streams are
    not supported, matching the reference (CobolStreamer.scala uses the
    fixed-length reader only). Batches decode on `device` (None: the
    CUDA device, raising without one; ``"cpu"``: the plain versions).
    """

    def __init__(self, copybook_contents, device=None, **options):
        params = parse_options(options, streaming=True)
        if params.is_record_sequence:
            raise ValueError(
                "Streaming supports fixed-length records only "
                "(like the reference's CobolStreamer)")
        self.device = resolve_device(device)
        self.reader = FixedLenReader(copybook_contents, params,
                                     device=self.device)
        self.params = params
        self._schema = CobolOutputSchema(
            self.reader.copybook,
            policy=params.schema_policy,
            input_file_name_field=params.input_file_name_column,
            generate_record_id=params.generate_record_id,
            corrupt_record_field=params.corrupt_record_column)
        self._next_record_id = 0

    @property
    def record_size(self) -> int:
        return self.reader.record_size

    def _batch(self, data, file_id: int = 0,
               input_file_name: str = "",
               whole_file: bool = True) -> CobolData:
        result = self.reader.read_result(
            data, file_id=file_id,
            first_record_id=self._next_record_id,
            input_file_name=input_file_name)
        # advance by records CONSUMED (file header/footer regions are not
        # records), independent of rows emitted
        body = len(data) - (
            (self.params.file_start_offset + self.params.file_end_offset)
            if whole_file else 0)
        self._next_record_id += max(body, 0) // self.record_size
        data_out = CobolData([], self._schema, results=[result],
                             device=self.device)
        data_out.diagnostics = result.diagnostics
        return data_out

    # -- chunked byte stream ------------------------------------------------

    def stream_chunks(self, chunks: Iterable[bytes]) -> Iterator[CobolData]:
        """One decoded batch per incoming chunk (chunks need not align to
        record boundaries; partial records carry over)."""
        if self.params.file_start_offset or self.params.file_end_offset:
            # a chunk stream has no file boundaries: there is no "file
            # header/footer" to trim, and _batch would subtract the offsets
            # from every micro-batch (mis-sizing the divisibility check and
            # the record-id advance). Offsets stay valid for
            # stream_directory, where each file genuinely has them.
            raise ValueError(
                "Options 'file_start_offset'/'file_end_offset' cannot be "
                "used with stream_chunks; use stream_directory for files "
                "with headers/footers")
        rs = self.record_size
        # carried partial-record bytes accumulate in a LIST joined once
        # per emitted batch: the old `pending += chunk` rebuilt the whole
        # buffer per incoming chunk — O(n^2) over a chunky stream
        parts = []
        pending_len = 0
        for chunk in chunks:
            if not chunk:
                continue
            parts.append(bytes(chunk))
            pending_len += len(parts[-1])
            usable = pending_len - (pending_len % rs)
            if usable == 0:
                continue
            buf = b"".join(parts)
            data, remainder = buf[:usable], buf[usable:]
            parts = [remainder] if remainder else []
            pending_len = len(remainder)
            yield self._batch(data)
        if pending_len:
            raise ValueError(
                f"Stream ended mid-record: {pending_len} trailing bytes "
                f"(record size {rs})")

    # -- directory watching -------------------------------------------------

    def stream_directory(self, path, poll_interval: float = 1.0,
                         max_batches: Optional[int] = None,
                         idle_timeout: Optional[float] = None
                         ) -> Iterator[CobolData]:
        """Yield batches as new files appear under `path` (the
        `binaryRecordsStream` micro-batch semantic; files larger than
        ~64 MB stream as several record-aligned batches). Stops after
        `max_batches` files, or after `idle_timeout` seconds without new
        files (None = poll forever).

        A file is consumed only once its size is stable across two
        polls (an in-progress write is left for the next poll) and is
        marked consumed only after a successful decode. A stable file
        whose size is NOT a whole number of records gets
        `NONDIVISIBLE_GRACE_S` seconds for its writer to finish, then
        is consumed anyway and handled by the ``record_error_policy``
        — fail_fast raises the reader's divisibility error, permissive
        policies ledger the partial tail — instead of being silently
        skipped forever."""
        consumed = set()
        pending_sizes = {}
        nondivisible_since = {}
        produced = 0
        batches = 0
        idle_since = time.monotonic()
        while True:
            listing_ok = True
            try:
                files = list_input_files(path)
            except FileNotFoundError:
                # directory/glob not there (not created yet, or a
                # transiently unmounted volume) — keep polling, and do
                # NOT shrink bookkeeping off an empty failed listing:
                # wiping `consumed` here would re-deliver every file
                # when the mount comes back
                files = []
                listing_ok = False
            listed = set(files)
            if listing_ok:
                # files that left the listing can never be consumed
                # again: drop their bookkeeping so a long-lived watcher
                # over a rotating directory holds O(current files)
                # state, not O(everything ever seen)
                consumed &= listed
                for stale in [f for f in pending_sizes
                              if f not in listed]:
                    pending_sizes.pop(stale, None)
                    nondivisible_since.pop(stale, None)
            progressed = False
            for f in files:
                if f in consumed:
                    continue
                try:
                    size = os.path.getsize(f)
                except OSError:
                    continue  # vanished between listing and stat
                if pending_sizes.get(f) != size:
                    pending_sizes[f] = size  # new or still growing
                    nondivisible_since.pop(f, None)
                    continue
                body = (size - self.params.file_start_offset
                        - self.params.file_end_offset)
                if body % self.record_size != 0:
                    # stable but mid-record: give the writer a bounded
                    # grace to finish, then consume it under the record
                    # error policy — a junk file must surface through
                    # the ledger (or raise), never starve silently
                    first = nondivisible_since.setdefault(
                        f, time.monotonic())
                    if time.monotonic() - first < NONDIVISIBLE_GRACE_S:
                        continue
                    _logger.warning(
                        "streamed file %s is size-stable at %d bytes, "
                        "which is not a whole number of %d-byte "
                        "records; consuming it under "
                        "record_error_policy=%s", f, size,
                        self.record_size,
                        self.params.record_error_policy.name.lower())
                emitted = yield from self._stream_file(f, produced, size)
                consumed.add(f)
                pending_sizes.pop(f, None)
                nondivisible_since.pop(f, None)
                produced += 1
                batches += emitted
                progressed = True
                idle_since = time.monotonic()
                if max_batches is not None and produced >= max_batches:
                    return
            if not progressed:
                if (idle_timeout is not None
                        and time.monotonic() - idle_since >= idle_timeout):
                    return
            time.sleep(poll_interval)

    def _stream_file(self, f: str, file_id: int, size: int):
        """One file -> one or more batches; whole-file reads go through
        a zero-copy mmap view, oversized files stream in record-aligned
        chunks (both bound peak memory, replacing the old unbounded
        `fh.read()`). Returns the number of batches emitted."""
        from ..reader.stream import open_stream

        rs = self.record_size
        chunkable = (size > DIRECTORY_CHUNK_BYTES
                     and not self.params.file_start_offset
                     and not self.params.file_end_offset
                     and size % rs == 0)
        if not chunkable:
            with open_stream(f) as stream:
                data = stream.next_view(size)
            yield self._batch(data, file_id=file_id, input_file_name=f)
            return 1
        chunk_bytes = max(rs, (DIRECTORY_CHUNK_BYTES // rs) * rs)
        emitted = 0
        with open_stream(f) as stream:
            done = 0
            while done < size:
                data = stream.next_view(min(chunk_bytes, size - done))
                if not data:
                    break
                yield self._batch(data, file_id=file_id,
                                  input_file_name=f, whole_file=False)
                done += len(data)
                emitted += 1
        return emitted


def stream_cobol(copybook_contents, chunks: Iterable[bytes],
                 device=None, **options) -> Iterator[CobolData]:
    """Functional shorthand: decode an iterable of byte chunks."""
    return CobolStreamer(copybook_contents, device=device,
                         **options).stream_chunks(chunks)
