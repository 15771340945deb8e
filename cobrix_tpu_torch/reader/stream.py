"""Byte streams, byte-range sources and input paths.

Port copy of ``cobrix_tpu.reader.stream``: the SimpleStream contract
(reference stream/SimpleStream.scala:21: size/offset/next(n)/close +
inputFileName) with local-file and in-memory implementations, and the
source half: `ByteRangeSource`, `RetryPolicy` with `retrying_read`,
`BufferedSourceStream`, `_LocalFileSource`, the scheme registry
(`register_stream_backend`, `resolve_stream_backend`, `stream_lister`),
`source_size` and `open_stream`. A compressed input (io/compress.py)
reads through a `DecompressingSource`, so every offset below addresses
decompressed bytes; a `scheme://` path resolves through the registry
(the fsspec adapter, io/fsspec_source.py, registers any scheme fsspec
knows) with the read's io layers (io/config.py) stacked on.

Changes from the JAX package:

* `SimpleStream.preceding` gives the bytes just before a stream's
  offset, so that a text shard starts from the previous line end as the
  whole-file read does (ROADMAP C8); every stream kind has it, the
  buffered one (and so the decompressing one) included.
* `ByteRangeSource.readinto` reads a range straight into a caller's
  buffer (a pinned staging buffer of the pipeline; a decompressing
  source copies from its inflate window once).
* `open_source` is the part of `open_stream` that builds the source
  stack; `open_stream` frames it as a buffered stream, and `open_input`
  as a `SourceFile`, the one seekable reader over a source that the
  device reads' window uploads, resync searches, shard reads and the
  pipeline's reader thread use. A raw local file is opened as itself.
* `ShardStream` reads a byte range already held on the host.
* The per-read memo and counters come from `io.stats.current_io_stats`,
  which reads the read's observability context (``obs.context``), as
  the JAX package's does.
"""
from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

_logger = logging.getLogger(__name__)


class SimpleStream:
    def size(self) -> int:
        raise NotImplementedError

    @property
    def true_size(self) -> int:
        """Size of the UNDERLYING file, independent of byte-range bounding.
        File-footer rules must measure against this, not `size()` — a
        byte-range shard of an indexed scan ends mid-file, and its tail is
        ordinary data, not a footer."""
        return self.size()

    @property
    def offset(self) -> int:
        raise NotImplementedError

    @property
    def input_file_name(self) -> str:
        return ""

    @property
    def is_end_of_stream(self) -> bool:
        return self.offset >= self.size()

    def next(self, n: int) -> bytes:
        raise NotImplementedError

    def preceding(self, n: int) -> bytes:
        """Up to `n` bytes of the underlying file just before the current
        offset: fewer at the file's start, none where the stream cannot
        see them. A text shard's record extractor reads the previous
        line end here (`raw_extractors.TextRecordExtractor`)."""
        return b""

    def next_view(self, n: int):
        """Like `next`, but may return a zero-copy bytes-like view of the
        underlying storage (FSStream: an mmap window — whole-file framing
        then reads straight from the page cache instead of paying a full
        copy). Callers must treat the result as read-only."""
        return self.next(n)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryStream(SimpleStream):
    """In-memory stream (test tier-2 equivalent of TestStringStream)."""

    def __init__(self, data: bytes, file_name: str = "", start_offset: int = 0,
                 maximum_bytes: int = 0):
        end = len(data)
        if maximum_bytes > 0:
            end = min(end, start_offset + maximum_bytes)
        self._whole = data
        self._data = data[start_offset:end]
        self._base = start_offset
        self._pos = 0
        self._file_name = file_name

    def size(self) -> int:
        return self._base + len(self._data)

    def preceding(self, n: int) -> bytes:
        off = self.offset
        return bytes(self._whole[max(0, off - n):off])

    @property
    def offset(self) -> int:
        return self._base + self._pos

    @property
    def input_file_name(self) -> str:
        return self._file_name

    def next(self, n: int) -> bytes:
        chunk = self._data[self._pos: self._pos + n]
        self._pos += len(chunk)
        return chunk


class FSStream(SimpleStream):
    """Local-file stream with optional byte-range bounding
    (reference FSStream + FileStreamer maximumBytes semantics: `size()`
    reports the logical end of the allowed range)."""

    def __init__(self, path: str, start_offset: int = 0, maximum_bytes: int = 0,
                 buffer_size: int = 8 * 1024 * 1024):
        self._path = path
        self._file_size = os.path.getsize(path)
        self._f = open(path, "rb", buffering=buffer_size)
        if start_offset:
            self._f.seek(start_offset)
        self._pos = start_offset
        if maximum_bytes > 0:
            self._limit = min(self._file_size, start_offset + maximum_bytes)
        else:
            self._limit = self._file_size

    def size(self) -> int:
        return self._limit

    @property
    def true_size(self) -> int:
        return self._file_size

    @property
    def offset(self) -> int:
        return self._pos

    @property
    def input_file_name(self) -> str:
        return self._path

    def preceding(self, n: int) -> bytes:
        lo = max(0, self._pos - n)
        return os.pread(self._f.fileno(), self._pos - lo, lo)

    def next(self, n: int) -> bytes:
        n = min(n, self._limit - self._pos)
        if n <= 0:
            return b""
        chunk = self._f.read(n)
        self._pos += len(chunk)
        return chunk

    def next_view(self, n: int):
        """Zero-copy mmap window for bulk reads (small reads keep the
        buffered path). The memoryview pins the mapping; it is released
        when the last decode result referencing it is dropped."""
        n = min(n, self._limit - self._pos)
        if n <= 0:
            return b""
        if n < 4 * 1024 * 1024:
            return self.next(n)
        import mmap

        mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        view = memoryview(mm)[self._pos:self._pos + n]
        self._pos += n
        self._f.seek(self._pos)
        return view

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# pluggable storage backends
# ---------------------------------------------------------------------------

class ByteRangeSource:
    """Random-access byte source a storage backend provides: the minimal
    surface a remote filesystem needs (the Hadoop FSDataInputStream role
    in FileStreamer.scala:37)."""

    def size(self) -> int:
        raise NotImplementedError

    def read(self, offset: int, n: int) -> bytes:
        """Up to `n` bytes at `offset` (short reads allowed; b'' at EOF)."""
        raise NotImplementedError

    def readinto(self, offset: int, view: memoryview) -> int:
        """Up to ``len(view)`` bytes at `offset` into `view` (a writable
        byte buffer); the count read, 0 at EOF. Sources that hold the
        bytes already (a decompressing source's window, a local file)
        override this to copy once."""
        data = self.read(offset, len(view))
        view[:len(data)] = data
        return len(data)

    def fingerprint(self) -> str:
        """Content-version key for the persistent cache planes
        (cobrix_tpu_torch.io): two opens of an unchanged object must
        agree, and a changed object must differ. Backends with real
        version metadata (etag/ukey/mtime) override; the size-only
        default misses same-size rewrites, which cache-sensitive
        backends should not rely on."""
        return f"size:{self.size()}"

    @property
    def name(self) -> str:
        return ""

    def close(self) -> None:
        pass


DEFAULT_CHUNK_SIZE = 30 * 1024 * 1024  # reference 30MB buffer
# (reader/common/Constants.scala defaultStreamBufferInMB)


@dataclass(frozen=True)
class RetryPolicy:
    """IO retry with exponential backoff + jitter for storage backends.

    A transient backend failure (exception or an empty read short of the
    logical limit) is retried up to `max_attempts` total attempts with
    sleeps of `base_delay * 2**k` seconds (capped at `max_delay`, each
    multiplied by a uniform [0.5, 1.0) jitter so a fleet of shard readers
    doesn't hammer storage in lockstep). `deadline` bounds the whole
    retry sequence per read so a dead backend still fails promptly.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: float = 30.0

    def delay(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (1-based), jittered."""
        backoff = min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)
        return backoff * (0.5 + 0.5 * random.random())


NO_RETRY = RetryPolicy(max_attempts=1)


def retrying_read(fn: Callable[[], bytes], policy: RetryPolicy,
                  describe: str = "storage read",
                  on_retry: Optional[Callable[[], None]] = None) -> bytes:
    """Run `fn` under `policy`. Empty results are returned as-is (EOF is
    the caller's concern); only exceptions are retried here."""
    start = time.monotonic()
    attempt = 1
    while True:
        try:
            return fn()
        except Exception as exc:  # backend exceptions are retryable
            if getattr(exc, "permanent", False):
                raise  # deterministic damage (e.g. CompressedStreamError):
                # retrying cannot help, and wrapping would strip the
                # structured attributes callers dispatch on
            if policy.max_attempts <= 1:
                raise  # no retry configured: keep the backend's own type
            elapsed = time.monotonic() - start
            if (attempt >= policy.max_attempts
                    or elapsed >= policy.deadline):
                msg = (f"{describe} failed after {attempt} attempt(s) "
                       f"over {elapsed:.2f}s: {exc}")
                # a dead backend should fail with its OWN error type
                # (S3 auth errors, fsspec FileNotFound, ...) so callers
                # can dispatch on it; fall back to IOError only when the
                # type cannot carry a plain message
                try:
                    raised = type(exc)(msg)
                except Exception:
                    raised = IOError(msg)
                raise raised from exc
            delay = min(policy.delay(attempt),
                        max(policy.deadline - elapsed, 0.0))
            _logger.warning("%s failed (attempt %d/%d): %s — retrying in "
                            "%.3fs", describe, attempt, policy.max_attempts,
                            exc, delay)
            time.sleep(delay)
            attempt += 1
            if on_retry is not None:
                on_retry()


def read_fully(source: ByteRangeSource, offset: int, view: memoryview,
               retry: RetryPolicy, on_retry=None) -> int:
    """Fill `view` with the source's bytes from `offset`, re-issuing
    short reads (the readFully loop of BufferedFSDataInputStream.scala:51)
    under `retry`: an exception is retried by `retrying_read`; an empty
    read short of the range is anomalous (the size probe said these bytes
    exist) and is re-issued a bounded number of times before the short
    count is returned, for the framing layer to handle as a truncation."""
    want = len(view)
    got = 0
    empty_reads = 0
    while got < want:
        n = retrying_read(
            lambda: source.readinto(offset + got, view[got:]), retry,
            describe=(f"read of {want - got} bytes at {offset + got} "
                      f"from '{source.name}'"),
            on_retry=on_retry)
        if not n:
            empty_reads += 1
            if empty_reads >= retry.max_attempts:
                break
            if on_retry is not None:
                on_retry()
            time.sleep(retry.delay(empty_reads))
            continue
        empty_reads = 0
        got += n
    return got


class BufferedSourceStream(SimpleStream):
    """SimpleStream over a ByteRangeSource with chunked buffering: storage
    is hit once per DEFAULT_CHUNK_SIZE, not once per record, and short
    reads are re-issued until the chunk is full (the readFully loop of
    BufferedFSDataInputStream.scala:51)."""

    def __init__(self, source: ByteRangeSource, start_offset: int = 0,
                 maximum_bytes: int = 0,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 retry: Optional[RetryPolicy] = None,
                 on_retry: Optional[Callable[[], None]] = None):
        self._source = source
        self._retry = retry or NO_RETRY
        self._on_retry = on_retry
        self._file_size = retrying_read(
            lambda: source.size(), self._retry,
            describe=f"size probe of '{source.name}'", on_retry=on_retry)
        self._pos = start_offset
        if maximum_bytes > 0:
            self._limit = min(self._file_size, start_offset + maximum_bytes)
        else:
            self._limit = self._file_size
        self._chunk_size = max(chunk_size, 1)
        self._buf = b""
        self._buf_start = start_offset

    def size(self) -> int:
        return self._limit

    @property
    def true_size(self) -> int:
        return self._file_size

    @property
    def offset(self) -> int:
        return self._pos

    @property
    def input_file_name(self) -> str:
        return self._source.name

    @property
    def source(self) -> ByteRangeSource:
        """The underlying byte source (fingerprint probes for the
        persistent cache planes read it without a second backend open)."""
        return self._source

    def _fill(self, offset: int) -> None:
        want = min(self._chunk_size, self._limit - offset)
        buf = bytearray(max(want, 0))
        got = read_fully(self._source, offset, memoryview(buf), self._retry,
                         self._on_retry)
        self._buf = bytes(buf) if got == len(buf) else bytes(buf[:got])
        self._buf_start = offset

    def preceding(self, n: int) -> bytes:
        lo = max(0, self._pos - n)
        rel = lo - self._buf_start
        if 0 <= rel and self._pos - self._buf_start <= len(self._buf):
            return self._buf[rel:self._pos - self._buf_start]
        buf = bytearray(self._pos - lo)
        got = read_fully(self._source, lo, memoryview(buf), self._retry,
                         self._on_retry)
        return bytes(buf[:got])

    def next(self, n: int) -> bytes:
        n = min(n, self._limit - self._pos)
        if n <= 0:
            return b""
        out = []
        remaining = n
        while remaining > 0:
            rel = self._pos - self._buf_start
            if not (0 <= rel < len(self._buf)):
                self._fill(self._pos)
                rel = 0
                if not self._buf:
                    break
            piece = self._buf[rel:rel + remaining]
            out.append(piece)
            self._pos += len(piece)
            remaining -= len(piece)
        return b"".join(out)

    def close(self) -> None:
        self._source.close()


class SourceFile:
    """A seekable binary reader over a ByteRangeSource (`seek`, `tell`,
    `readinto`, `pread`), with a local file object's read surface: the
    one view through which the device reads' window uploads, resync
    searches, index-shard reads and the pipeline's reader thread read a
    compressed or backend-served input. Reads go straight into the
    caller's buffer (`read_fully`, under the read's retry policy), in
    pieces of at most `chunk_size` bytes, as a buffered stream fills its
    chunks (so read-ahead stays ahead of a consumer that asks for a
    whole window at once)."""

    def __init__(self, source: ByteRangeSource,
                 retry: Optional[RetryPolicy] = None,
                 on_retry: Optional[Callable[[], None]] = None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE):
        self._source = source
        self._chunk = max(1, chunk_size)
        self._retry = retry or NO_RETRY
        self._on_retry = on_retry
        self._size = retrying_read(
            lambda: source.size(), self._retry,
            describe=f"size probe of '{source.name}'", on_retry=on_retry)
        self._pos = 0

    @property
    def source(self) -> ByteRangeSource:
        return self._source

    def size(self) -> int:
        return self._size

    def seek(self, pos: int, whence: int = 0) -> int:
        base = {0: 0, 1: self._pos, 2: self._size}[whence]
        self._pos = max(0, base + pos)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, buf) -> int:
        view = memoryview(buf).cast("B")
        n = min(len(view), max(0, self._size - self._pos))
        got = 0
        while got < n:
            want = min(self._chunk, n - got)
            k = read_fully(self._source, self._pos + got,
                           view[got:got + want], self._retry,
                           self._on_retry)
            got += k
            if k < want:
                break
        self._pos += got
        return got

    def pread(self, n: int, offset: int) -> bytes:
        """Up to `n` bytes at `offset`; the position does not move."""
        buf = bytearray(max(0, min(n, self._size - offset)))
        got = read_fully(self._source, offset, memoryview(buf), self._retry,
                         self._on_retry) if buf else 0
        return bytes(buf[:got])

    def close(self) -> None:
        self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_at(f, offset: int, n: int) -> bytes:
    """Up to `n` bytes at `offset` of an `open_input` reader (a local
    file object or a SourceFile), leaving its position alone."""
    if isinstance(f, SourceFile):
        return f.pread(n, offset)
    return os.pread(f.fileno(), n, offset)


class _LocalFileSource(ByteRangeSource):
    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "rb")
        self._size = os.path.getsize(path)

    def size(self) -> int:
        return self._size

    def read(self, offset: int, n: int) -> bytes:
        return os.pread(self._f.fileno(), n, offset)

    def readinto(self, offset: int, view: memoryview) -> int:
        return os.preadv(self._f.fileno(), [view], offset)

    def fingerprint(self) -> str:
        # size+mtime version key (the idiom reader/index.py uses for
        # local files): the decompressed cache plane keys generations
        # off this, and the size-only default would miss a same-size
        # rewrite of a compressed feed
        st = os.fstat(self._f.fileno())
        return f"local:{st.st_size}:{st.st_mtime_ns}"

    @property
    def name(self) -> str:
        return self._path

    def close(self) -> None:
        self._f.close()


# scheme -> factory(full_url) -> ByteRangeSource
_STREAM_BACKENDS: Dict[str, Callable[[str], ByteRangeSource]] = {}
# optional per-scheme listing (url -> [urls]) and sizing (url -> bytes):
# remote directory scans and shard planning route through these instead
# of os.path, so a remote *directory* read works end to end
_STREAM_LISTERS: Dict[str, Callable[[str], list]] = {}
_STREAM_SIZERS: Dict[str, Callable[[str], int]] = {}


def register_stream_backend(scheme: str,
                            factory: Callable[[str], ByteRangeSource],
                            lister: Optional[Callable[[str], list]] = None,
                            sizer: Optional[Callable[[str], int]] = None
                            ) -> None:
    """Register a storage backend for `scheme://...` paths (the pluggable
    role of the reference's Hadoop FileSystem resolution,
    FileNameUtils/FileStreamer). The factory receives the full path and
    returns a ByteRangeSource. `lister` (recursive glob/directory
    listing returning full URLs) and `sizer` (byte size without opening
    a stream) are optional capabilities; without them a scheme path is
    treated as one verbatim input of unknown size."""
    scheme = scheme.lower()
    _STREAM_BACKENDS[scheme] = factory
    if lister is not None:
        _STREAM_LISTERS[scheme] = lister
    elif scheme in _STREAM_LISTERS:
        del _STREAM_LISTERS[scheme]
    if sizer is not None:
        _STREAM_SIZERS[scheme] = sizer
    elif scheme in _STREAM_SIZERS:
        del _STREAM_SIZERS[scheme]


def resolve_stream_backend(scheme: str
                           ) -> Optional[Callable[[str], ByteRangeSource]]:
    """The factory for `scheme`, auto-registering the fsspec adapter
    (cobrix_tpu_torch.io) for any scheme fsspec implements that nothing
    claimed explicitly. Returns None for a truly unknown scheme."""
    factory = _STREAM_BACKENDS.get(scheme)
    if factory is not None:
        return factory
    from ..io.fsspec_source import known_protocol, register_fsspec_backend

    if known_protocol(scheme):
        register_fsspec_backend(scheme)
        return _STREAM_BACKENDS.get(scheme)
    return None


def stream_lister(scheme: str) -> Optional[Callable[[str], list]]:
    """The scheme's listing capability (after backend resolution)."""
    resolve_stream_backend(scheme)
    return _STREAM_LISTERS.get(scheme)


def source_size(path: str, retry: Optional[RetryPolicy] = None,
                on_retry: Optional[Callable[[], None]] = None,
                io=None) -> int:
    """LOGICAL byte size of one input (local or backend-resolved)
    without building a buffered stream; the planning/validation sizer.
    For a compressed input this is the DECOMPRESSED size — every
    downstream consumer (chunk planners, shard planning, divisibility
    validation, metrics totals) addresses decompressed offsets, so the
    sizer answers in the same space (warm: the persisted inflate index;
    cold: one memoized streaming-discovery pass). A remote size is one
    backend metadata round trip, so it memoizes on the active read."""
    from ..io import compress as _compress
    from ..io.stats import current_io_stats

    scheme = path_scheme(path)
    if scheme in (None, "file"):
        local = normalize_local(path)
        codec = _compress.active_codec(local, io)
        if codec is None:
            return os.path.getsize(local)
        return _compress.decompressed_size(local, codec, io=io,
                                           retry=retry,
                                           on_retry=on_retry)
    stats = current_io_stats()
    memo = stats.memo if stats is not None else None
    if memo is not None:
        size = memo.get(("size", path))
        if size is not None:
            return size
    # remote codec detection: the pin, the per-read memo, and the
    # extension map are free; the magic sniff (one tiny backend read)
    # only runs inside an active read, so a bare planning probe of an
    # extensionless raw file costs exactly what it used to
    codec = None
    mode = _compress.compression_mode(io)
    if mode not in ("auto",):
        codec = _compress.active_codec(path, io)
    elif memo is not None or _compress.codec_for_path(path) is not None:
        codec = _compress.active_codec(path, io, retry=retry,
                                       on_retry=on_retry)
    if codec is not None:
        size = _compress.decompressed_size(path, codec, io=io,
                                           retry=retry, on_retry=on_retry)
        if memo is not None:
            memo[("size", path)] = size
        return size
    sizer = None
    if resolve_stream_backend(scheme) is not None:
        sizer = _STREAM_SIZERS.get(scheme)
    if sizer is not None:
        if retry is not None:
            size = retrying_read(lambda: sizer(path), retry,
                                 describe=f"size probe of '{path}'",
                                 on_retry=on_retry)
        else:
            size = sizer(path)
    else:
        with open_stream(path, retry=retry, on_retry=on_retry,
                         io=io) as stream:
            size = stream.size()
    if memo is not None:
        memo[("size", path)] = size
    return size


def open_source(path: str, start_offset: int = 0, maximum_bytes: int = 0,
                chunk_size: int = DEFAULT_CHUNK_SIZE,
                retry: Optional[RetryPolicy] = None,
                on_retry: Optional[Callable[[], None]] = None,
                io=None):
    """The source stack `open_stream` frames, as (source, chunk size), or
    (None, chunk size) for a raw local file, which is read as itself.

    Compressed inputs (codec pinned, magic-sniffed, or extension-
    detected — io/compress.py) wrap the backend source in a
    DecompressingSource, so `start_offset`/`maximum_bytes` and everything
    downstream address DECOMPRESSED offsets; the decompressed plane owns
    its own block caching, so the raw-bytes cache/prefetch stack is
    skipped for them, and the chunk shrinks to its block. `scheme://`
    paths resolve through the backend registry (falling back to the
    fsspec adapter for any scheme fsspec knows); `io`
    (cobrix_tpu_torch.io.IoConfig) stacks the persistent block cache and
    the read-ahead prefetcher onto them (`wrap_source`). `retry` applies
    to registry-backed storage only."""
    from ..io import compress as _compress

    scheme = path_scheme(path)
    if scheme in (None, "file"):
        local = normalize_local(path)
        codec = _compress.active_codec(local, io)
        if codec is None:
            return None, chunk_size
        source = _compress.DecompressingSource(_LocalFileSource(local),
                                               local, codec, io=io)
        return source, min(max(chunk_size, 1), source.block)
    factory = resolve_stream_backend(scheme)
    if factory is None:
        raise ValueError(
            f"No stream backend registered for scheme {scheme!r} "
            f"(register one with cobrix_tpu_torch.register_stream_backend;"
            f" fsspec-known schemes register automatically when fsspec "
            f"is installed)")
    source = (retrying_read(lambda: factory(path), retry,
                            describe=f"open of '{path}'", on_retry=on_retry)
              if retry is not None else factory(path))
    codec = _compress.active_codec_from_source(path, io, source,
                                               retry=retry,
                                               on_retry=on_retry)
    if codec is not None:
        source = _compress.DecompressingSource(source, path, codec, io=io)
        return source, min(max(chunk_size, 1), source.block)
    if io is not None:
        from ..io.config import wrap_source

        source, chunk_size = wrap_source(source, path, io, chunk_size,
                                         start_offset=start_offset,
                                         maximum_bytes=maximum_bytes)
    return source, chunk_size


def open_stream(path: str, start_offset: int = 0, maximum_bytes: int = 0,
                chunk_size: int = DEFAULT_CHUNK_SIZE,
                retry: Optional[RetryPolicy] = None,
                on_retry: Optional[Callable[[], None]] = None,
                io=None) -> SimpleStream:
    """Open `path` as a SimpleStream: raw local files use the
    OS-buffered FSStream; compressed and `scheme://` inputs read their
    `open_source` stack through the chunked buffer. `file://` is local.
    `on_retry` is called once per retried read (diagnostics hook)."""
    source, chunk_size = open_source(path, start_offset, maximum_bytes,
                                     chunk_size, retry, on_retry, io)
    if source is None:
        return FSStream(normalize_local(path), start_offset=start_offset,
                        maximum_bytes=maximum_bytes)
    return BufferedSourceStream(source, start_offset=start_offset,
                                maximum_bytes=maximum_bytes,
                                chunk_size=chunk_size,
                                retry=retry, on_retry=on_retry)


def open_input(path: str, start_offset: int = 0, maximum_bytes: int = 0,
               retry: Optional[RetryPolicy] = None,
               on_retry: Optional[Callable[[], None]] = None, io=None):
    """Open `path` as a seekable binary reader: a raw local file as
    itself (``open(path, "rb")``), anything else as a `SourceFile` over
    its `open_source` stack (`start_offset`/`maximum_bytes` bound the
    read-ahead window of a backend source). `read_at` reads either
    without moving it."""
    source, chunk_size = open_source(path, start_offset, maximum_bytes,
                                     retry=retry, on_retry=on_retry, io=io)
    if source is None:
        return open(normalize_local(path), "rb")
    return SourceFile(source, retry=retry, on_retry=on_retry,
                      chunk_size=chunk_size)


def path_scheme(path: str) -> Optional[str]:
    """'s3://bucket/key' -> 's3'; None for plain local paths (a Windows
    drive letter is not a scheme)."""
    head, sep, _ = path.partition("://")
    if not sep or len(head) <= 1:
        return None
    return head.lower()


def normalize_local(path: str) -> str:
    """Strip the `file://` prefix so every os.path consumer downstream
    sees a plain local path; other paths pass through unchanged."""
    if path_scheme(path) == "file":
        return path[len("file://"):]
    return path


class ShardStream(SimpleStream):
    """A byte range of a file already held on the host (a pipelined
    shard's staging buffer), read as the JAX package's bounded `FSStream`
    over the same range reads it: offsets are file offsets from `base`,
    `size()` is the range's end and `true_size` the file's size.
    `before`: the file's bytes just before `base` (`preceding`)."""

    def __init__(self, data, base: int, true_size: int,
                 file_name: str = "", before: bytes = b""):
        self._data = data
        self._base = base
        self._pos = 0
        self._true_size = true_size
        self._file_name = file_name
        self._before = before

    def preceding(self, n: int) -> bytes:
        head = bytes(self._data[max(0, self._pos - n):self._pos])
        more = n - len(head)
        return self._before[max(0, len(self._before) - more):] + head \
            if more > 0 else head

    def size(self) -> int:
        return self._base + len(self._data)

    @property
    def true_size(self) -> int:
        return self._true_size

    @property
    def offset(self) -> int:
        return self._base + self._pos

    @property
    def input_file_name(self) -> str:
        return self._file_name

    def next(self, n: int) -> bytes:
        chunk = bytes(self._data[self._pos:self._pos + max(n, 0)])
        self._pos += len(chunk)
        return chunk
