"""Byte streams and input paths.

Port copy of ``cobrix_tpu.reader.stream``, reduced to the stream
contract the generic per-record reader, its custom header parsers and
record extractors read through (`SimpleStream`, with `MemoryStream` and
the local-file `FSStream`) and the path helpers `path_scheme` and
`normalize_local`. One addition: `SimpleStream.preceding` gives the
bytes just before a stream's offset, so that a text shard starts from
the previous line end as the whole-file read does (ROADMAP C8). The
port reads local files only, so the retry
policy, the buffered byte-range sources and the registry of storage
backends (``scheme://`` paths) are not carried over (ROADMAP A4f);
``api.list_input_files`` refuses any scheme but ``file://`` by name.
"""
from __future__ import annotations

import os
from typing import Optional


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
