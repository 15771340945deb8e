"""Live-source tracking: growth, rotation, truncation, fingerprints.

Port copy of ``cobrix_tpu.streaming.sources`` over the port's
``reader.stream`` (`SimpleStream`, `normalize_local`, `path_scheme`):
the head CRCs cover the same bytes and give the same values, so a
checkpoint written by either package re-verifies in the other.

A tailed source is a path whose bytes keep arriving. This module owns
the part of continuous ingestion that is about FILES, not records:

* **SourceState** — one source's durable watermark: committed byte
  offset, committed record count, generation number, and the content
  fingerprint that distinguishes "the same file grew" from "a different
  file wearing the same name".
* **fingerprinting** — local files are identified by inode plus a
  CRC-32 of the consumed head (frozen at `HEAD_PROBE_BYTES`): after a
  crash the head CRC proves the file at the path is still the
  generation the checkpoint describes. Registry-backed (object-store)
  sources use the backend's own `fingerprint()` — objects there are
  immutable, so a changed fingerprint IS a replacement.
* **TailedFile** — a held file descriptor per live local source, the
  `tail -F` discipline: a rotation by rename moves the PATH, not the
  open file, so the old generation's remaining bytes stay readable and
  are drained exactly once before the switch to the new file.
* **rotation / truncation classification** — `probe()` compares the
  live stat against the watermark and returns a structured verdict
  (grew / unchanged / rotated / truncated / vanished); truncation below
  the watermark NEVER decodes silently wrong bytes — the ingestor turns
  it into a `SourceTruncated` error or a policy-driven restart.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field
from typing import Optional

from ..reader.stream import SimpleStream, normalize_local, path_scheme

# how many leading bytes participate in a local generation fingerprint:
# enough that two different log generations virtually never collide,
# small enough that re-verification on restart is one cheap read
HEAD_PROBE_BYTES = 64 * 1024

# live-window sentinel passed to record-header parsers as "file size":
# a growing file has no meaningful total size, and no parser tail/footer
# rule may fire off it
LIVE_FILE_SIZE = 1 << 62


class SourceTruncated(RuntimeError):
    """A tailed source shrank below its committed watermark: the bytes
    the checkpoint accounts for no longer exist. Structured — the
    ingestor either surfaces this (truncation_policy='error') or
    restarts the generation (truncation_policy='restart'); it never
    silently decodes the new shorter content against old offsets."""

    def __init__(self, path: str, size: int, watermark: int):
        super().__init__(
            f"source '{path}' truncated to {size} bytes below its "
            f"committed watermark of {watermark} bytes; refusing to "
            "decode (set truncation_policy='restart' to re-ingest the "
            "new content as a fresh generation)")
        self.path = path
        self.size = size
        self.watermark = watermark


@dataclass
class SourceState:
    """One source's watermark + identity (serialized into checkpoints)."""

    path: str
    file_id: int
    offset: int = 0           # committed byte offset (file-absolute)
    records: int = 0          # committed records consumed (id domain)
    generation: int = 0       # rotations survived
    ino: int = 0              # st_ino of the current generation (local)
    head_len: int = 0         # bytes covered by head_crc
    head_crc: int = 0         # CRC-32 over the first head_len bytes
    remote_fp: str = ""       # backend fingerprint (registry schemes)
    done: bool = False        # fully consumed (immutable remote object,
    #                           or a finalized local generation)
    # -- live (non-checkpointed) fields ---------------------------------
    pending_offset: int = field(default=0, compare=False)
    pending_records: int = field(default=0, compare=False)

    CHECKPOINT_FIELDS = ("path", "file_id", "offset", "records",
                         "generation", "ino", "head_len", "head_crc",
                         "remote_fp", "done")

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.CHECKPOINT_FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "SourceState":
        state = cls(path=str(d.get("path", "")),
                    file_id=int(d.get("file_id", 0)))
        for k in cls.CHECKPOINT_FIELDS[2:]:
            if k in d:
                setattr(state, k, type(getattr(state, k))(d[k]))
        state.pending_offset = state.offset
        state.pending_records = state.records
        return state

    @property
    def is_remote(self) -> bool:
        return path_scheme(self.path) not in (None, "file")

    def extend_head(self, data: bytes, at_offset: int) -> None:
        """Fold newly-consumed bytes into the head fingerprint while it
        is still open (< HEAD_PROBE_BYTES). Bytes must be consumed in
        order — the CRC is a running digest of the file's prefix."""
        if self.head_len >= HEAD_PROBE_BYTES or at_offset != self.head_len:
            return
        take = data[:HEAD_PROBE_BYTES - self.head_len]
        self.head_crc = zlib.crc32(take, self.head_crc) & 0xFFFFFFFF
        self.head_len += len(take)


def head_matches(path: str, state: SourceState) -> bool:
    """Re-verify a local source's identity after restart: the first
    `state.head_len` bytes of the file at `path` must reproduce the
    recorded CRC. True for an empty head (nothing was consumed — any
    content is acceptable)."""
    if state.head_len == 0:
        return True
    try:
        with open(normalize_local(path), "rb") as f:
            crc = 0
            remaining = state.head_len
            while remaining > 0:
                chunk = f.read(min(remaining, 1 << 20))
                if not chunk:
                    return False
                crc = zlib.crc32(chunk, crc) & 0xFFFFFFFF
                remaining -= len(chunk)
    except OSError:
        return False
    return crc == state.head_crc


def handle_head_matches(handle: "TailedFile", state: SourceState) -> bool:
    """Verify the HELD generation still carries the consumed prefix the
    watermark describes (an in-place rewrite keeps the inode and may
    even grow the file — only the content proves identity). True for an
    empty head: nothing was consumed, so nothing can be contradicted."""
    if state.head_len == 0:
        return True
    crc = 0
    read = 0
    while read < state.head_len:
        chunk = handle.read_at(read, min(state.head_len - read, 1 << 20))
        if not chunk:
            return False
        crc = zlib.crc32(chunk, crc) & 0xFFFFFFFF
        read += len(chunk)
    return crc == state.head_crc


class TailedFile:
    """Held descriptor over one LOCAL source generation (`tail -F`
    semantics: renames move the path, not this handle)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(normalize_local(path), "rb")
        st = os.fstat(self._f.fileno())
        self.ino = int(getattr(st, "st_ino", 0) or 0)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def read_at(self, offset: int, n: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(n)

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class WindowStream(SimpleStream):
    """A byte window of a larger file presented with FILE-ABSOLUTE
    offsets: the VRL reader's ledger entries and truncation messages
    then carry real file offsets, identical to a one-shot read's."""

    def __init__(self, data, base_offset: int, file_name: str = "",
                 file_size: Optional[int] = None):
        self._data = data
        self._base = base_offset
        self._pos = 0
        self._file_name = file_name
        # what the framing layer believes the whole file's size is: the
        # window end for a self-consistent live window (cut at a record
        # boundary), the real final size for a finalized generation (so
        # tail/footer policy rules behave exactly like a one-shot read)
        self._file_size = (base_offset + len(data) if file_size is None
                           else file_size)

    def size(self) -> int:
        return self._base + len(self._data)

    @property
    def true_size(self) -> int:
        return self._file_size

    @property
    def offset(self) -> int:
        return self._base + self._pos

    @property
    def input_file_name(self) -> str:
        return self._file_name

    def next(self, n: int) -> bytes:
        chunk = bytes(self._data[self._pos:self._pos + n])
        self._pos += len(chunk)
        return chunk


def stat_local(path: str):
    """(size, ino) of a local path, or None when it vanished."""
    try:
        st = os.stat(normalize_local(path))
    except OSError:
        return None
    return int(st.st_size), int(getattr(st, "st_ino", 0) or 0)


@dataclass(frozen=True)
class SourceProbe:
    """One poll's verdict about one local source."""

    verdict: str          # 'grew' | 'unchanged' | 'rotated' |
    #                       'truncated' | 'vanished'
    size: int = 0         # live size of the CURRENT generation handle
    path_size: int = 0    # size of whatever now sits at the path
    path_ino: int = 0


def probe_local(state: SourceState, handle: Optional[TailedFile]
                ) -> SourceProbe:
    """Classify what happened to a local source since the last poll.

    The held handle (when present) is the source of truth for the
    CURRENT generation: rotation-by-rename leaves it readable. The
    path's stat tells whether the path still points at this generation
    (same inode) or at a successor."""
    stat = stat_local(state.path)
    if handle is not None:
        gen_size = handle.size()
        if gen_size < state.pending_offset:
            # the generation we hold shrank under us: copy-truncate
            # rotation or an operator truncation — either way the
            # watermarked bytes are gone from this handle
            return SourceProbe("truncated", size=gen_size,
                               path_size=stat[0] if stat else 0,
                               path_ino=stat[1] if stat else 0)
        if stat is None or (state.ino and stat[1] != state.ino):
            # the path vanished or points at a new inode: the held
            # generation is final at gen_size — drain it, then switch
            return SourceProbe("rotated", size=gen_size,
                               path_size=stat[0] if stat else 0,
                               path_ino=stat[1] if stat else 0)
        return SourceProbe(
            "grew" if gen_size > state.pending_offset else "unchanged",
            size=gen_size, path_size=stat[0], path_ino=stat[1])
    # no handle (restart recovery): classify from path stat + head CRC
    if stat is None:
        return SourceProbe("vanished")
    size, ino = stat
    if size < state.offset:
        return SourceProbe("truncated", size=size, path_size=size,
                           path_ino=ino)
    if (state.ino and ino and ino != state.ino) \
            or not head_matches(state.path, state):
        return SourceProbe("rotated", size=0, path_size=size,
                           path_ino=ino)
    return SourceProbe("grew" if size > state.offset else "unchanged",
                       size=size, path_size=size, path_ino=ino)
