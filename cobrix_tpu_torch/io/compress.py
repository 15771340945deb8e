"""Compressed-feed ingestion: the streaming decompression plane.

Real mainframe feeds arrive gzip/zstd/bzip2-compressed. This module
makes a compressed input look like any other byte source *ahead of
framing*: `open_stream` detects the codec (magic bytes, extension
fallback, or the `compression=` read option to pin/disable) and wraps
the backend source in a **DecompressingSource** — a ByteRangeSource
over the *decompressed* byte space — so the framing layer, both chunk
planners, the sparse-index VRL splitter, multihost shard planning, the
serve tier, pushdown, stats/zone-maps, and the sink all address
decompressed offsets without knowing the wire bytes were smaller. One
wrapping plane lights up every existing surface (CODAG's
fuse-decompression-into-the-scan design, PAPERS.md — never stage an
inflated copy to disk).

Bounded-memory streaming inflate with a **seekable inflate index**:

* the inflater keeps a sliding window of recent decompressed bytes
  (about two `compress_block_mb` blocks), never the whole file;
* every member/frame boundary crossed becomes a *restartable
  checkpoint* ``(compressed_offset, decompressed_offset)`` — corpora
  written by `testing.corpus` emit one member per block, so their
  checkpoints land every `compress_block_mb` of decompressed output
  (foreign single-member files degrade to one checkpoint at 0);
* checkpoints + the decompressed total persist in the `cache_dir`
  under ``<cache_dir>/compress/`` (compress_index.py), CRC-stamped and
  keyed by the *compressed* file fingerprint, so a warm re-scan or a
  mid-stream failover seeks without re-inflating the prefix;
* with a `cache_dir`, decompressed blocks write through to the block
  cache under a generation keyed ``inflate:<codec>:<compressed
  fingerprint>`` — a warm scan serves every block from disk and
  performs ZERO inflate work (`IoStats.inflate_skipped` counts the
  blocks that skipped the inflater).

Codec registry: gzip/zlib and bz2 from the stdlib, xz/lzma as a
registry bonus, zstd through the optional ``zstandard`` module behind
one actionable ImportError. Magic detection is strict (gzip's method +
reserved-flag bytes are validated) because an EBCDIC binary record can
begin with any bytes; ``compression='none'`` is the escape hatch for a
pathological raw file, ``compression='<codec>'`` pins a misnamed one.

Port copy of ``cobrix_tpu.io.compress``. Changes from the JAX package:

* `DecompressingSource.readinto` copies the served range from the
  inflate window (or the cached block) straight into the caller's
  buffer — the pipeline's pinned staging buffer takes one host copy of
  the inflater's output; `read` is built on it. `block` names the
  decompressed-plane block size (`open_source` shrinks the stream chunk
  to it).
* The per-read memo and counters come from the read's IoStats on its
  observability context (io/stats.py). The inflater runs on whichever thread
  reads the source — the pipeline's reader thread — and zlib, bz2 and
  lzma release the GIL on large buffers.
* zstd needs the optional ``zstandard`` module; without it a zstd input
  raises the JAX package's actionable ImportError, never a raw read.

Error surface: damaged compressed input raises a structured
`CompressedStreamError` carrying the codec plus compressed AND
decompressed offsets. Under a permissive `record_error_policy` the
stream truncates at the last cleanly-inflated byte (the framing layer
then ledgers the torn tail exactly like a truncated raw file) and the
damage is counted under the ``compress`` integrity plane; `fail_fast`
raises it.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..reader.stream import (
    DEFAULT_CHUNK_SIZE,
    BufferedSourceStream,
    ByteRangeSource,
    RetryPolicy,
    SimpleStream,
    normalize_local,
    path_scheme,
    resolve_stream_backend,
    retrying_read,
)

_logger = logging.getLogger(__name__)

MEGABYTE = 1024 * 1024

# decompressed-plane block granularity (checkpoint stride + post-
# decompression cache block size) when no IoConfig carries the
# `compress_block_mb` option
DEFAULT_COMPRESS_BLOCK = 4 * MEGABYTE

# bytes of compressed input per backend read while inflating
_COMP_READ = 1 * MEGABYTE

# magic probe length: enough for every registered codec's signature
MAGIC_PROBE = 6


class CompressedStreamError(IOError):
    """Structured damage report for a compressed input: the codec plus
    BOTH offsets (where in the wire bytes the decoder gave up, and how
    far the decompressed stream had cleanly reached), so an operator
    can locate the damage in the file they actually have on disk."""

    # damage in the wire bytes is deterministic, not a transient backend
    # fault: retrying_read must re-raise the ORIGINAL exception (with its
    # codec/offset attributes intact) instead of retrying and rebuilding
    permanent = True

    def __init__(self, message: str, *, codec: str = "",
                 compressed_offset: int = -1,
                 decompressed_offset: int = -1):
        super().__init__(message)
        self.codec = codec
        self.compressed_offset = compressed_offset
        self.decompressed_offset = decompressed_offset


# ---------------------------------------------------------------------------
# codec registry
# ---------------------------------------------------------------------------


class Codec:
    """One registered compression codec: detection + a streaming
    decoder factory. Decoders follow the stdlib decompressor protocol
    (``decompress(data)`` / ``eof`` / ``unused_data``), which is what
    lets one inflater handle concatenated members for every codec."""

    def __init__(self, name: str, extensions: Tuple[str, ...],
                 magic: Optional[Callable[[bytes], bool]],
                 decoder_factory: Callable[[], object]):
        self.name = name
        self.extensions = extensions
        self._magic = magic
        self._factory = decoder_factory

    def matches_magic(self, head: bytes) -> bool:
        return bool(self._magic and head and self._magic(head))

    def new_decoder(self):
        return self._factory()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Codec({self.name!r})"


def _gzip_magic(head: bytes) -> bool:
    # strict: id bytes + deflate method + reserved FLG bits zero. A raw
    # EBCDIC COMP field could start 0x1f 0x8b; four constrained bytes
    # make an accidental match astronomically unlikely.
    return (len(head) >= 4 and head[0] == 0x1F and head[1] == 0x8B
            and head[2] == 0x08 and (head[3] & 0xE0) == 0)


def _bz2_magic(head: bytes) -> bool:
    return (len(head) >= 4 and head[:3] == b"BZh"
            and 0x31 <= head[3] <= 0x39)


def _zstd_magic(head: bytes) -> bool:
    return head[:4] == b"\x28\xb5\x2f\xfd"


def _xz_magic(head: bytes) -> bool:
    return head[:6] == b"\xfd7zXZ\x00"


def _zstd_decoder():
    try:
        import zstandard
    except ImportError as exc:
        raise ImportError(
            "this input is zstd-compressed, but the optional "
            "'zstandard' module is not installed. Install it "
            "(pip install zstandard) to read zstd feeds, re-compress "
            "the feed as gzip/bz2, or pass compression='none' to read "
            "the raw bytes") from exc
    return zstandard.ZstdDecompressor().decompressobj()


def _make_codecs():
    import bz2
    import lzma
    import zlib

    return {
        "gzip": Codec("gzip", (".gz", ".gzip"), _gzip_magic,
                      lambda: zlib.decompressobj(16 + zlib.MAX_WBITS)),
        # bare zlib has no reliable magic (0x78 is a printable byte and
        # a valid EBCDIC value): extension/pin detection only
        "zlib": Codec("zlib", (".zz", ".zlib"), None,
                      lambda: zlib.decompressobj(zlib.MAX_WBITS)),
        "bz2": Codec("bz2", (".bz2",), _bz2_magic,
                     lambda: bz2.BZ2Decompressor()),
        "xz": Codec("xz", (".xz", ".lzma"), _xz_magic,
                    lambda: lzma.LZMADecompressor()),
        "zstd": Codec("zstd", (".zst", ".zstd"), _zstd_magic,
                      _zstd_decoder),
    }


_CODECS = _make_codecs()

# user spellings accepted by the `compression=` option
_ALIASES = {"gz": "gzip", "bzip2": "bz2", "lzma": "xz",
            "zstandard": "zstd", "deflate": "zlib"}


def register_codec(codec: Codec) -> None:
    """Register a custom codec (name + extensions + magic + stdlib-
    protocol decoder factory) for detection and `compression=` pinning."""
    _CODECS[codec.name] = codec


def known_codecs() -> List[str]:
    return sorted(_CODECS)


def codec_by_name(name: str) -> Codec:
    key = _ALIASES.get(name.lower(), name.lower())
    codec = _CODECS.get(key)
    if codec is None:
        raise ValueError(
            f"unknown compression codec {name!r}; one of "
            f"{known_codecs()} (or 'auto'/'none')")
    return codec


def sniff_magic(head: bytes) -> Optional[Codec]:
    """The codec whose magic signature `head` carries, or None."""
    for codec in _CODECS.values():
        if codec.matches_magic(head):
            return codec
    return None


def codec_for_path(path: str) -> Optional[Codec]:
    """Extension-based detection fallback (the only detection bare
    zlib gets — its two-byte header is too weak to sniff safely)."""
    lowered = path.lower().rstrip("/")
    for codec in _CODECS.values():
        for ext in codec.extensions:
            if lowered.endswith(ext):
                return codec
    return None


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def _memo():
    from .stats import current_io_stats

    stats = current_io_stats()
    return stats.memo if stats is not None else None


def _detect(head: bytes, path: str) -> Optional[Codec]:
    """Auto-mode detection: magic sniff first, extension fallback —
    but when a real head WAS read and the extension's codec carries a
    sniffable magic the head does not have, the bytes veto the name
    (a raw file merely *named* `.gz` stays raw). The extension alone
    decides only for magic-less codecs (zlib) and unreadable heads."""
    codec = sniff_magic(head)
    if codec is not None:
        return codec
    by_ext = codec_for_path(path)
    if by_ext is not None and by_ext._magic is not None and head:
        return None
    return by_ext


def compression_mode(io) -> str:
    """The effective `compression=` option riding the IoConfig
    ('auto' when no io config reached this call site)."""
    return (getattr(io, "compression", "auto") or "auto").lower()


def _local_head(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read(MAGIC_PROBE)
    except OSError:
        return None  # probe failed: the real open surfaces the real error


def _remote_head(path: str, retry: Optional[RetryPolicy],
                 on_retry, io=None) -> Optional[bytes]:
    scheme = path_scheme(path)
    factory = resolve_stream_backend(scheme) if scheme else None
    if factory is None:
        return None
    try:
        source = (retrying_read(lambda: factory(path), retry,
                                describe=f"codec probe open of '{path}'",
                                on_retry=on_retry)
                  if retry is not None else factory(path))
    except Exception:
        return None  # probe failed: the real open surfaces the real error
    if io is not None and getattr(io, "cache_enabled", False):
        # probe through the persistent block-cache plane (read-ahead
        # off): a warm re-scan's magic sniff never touches the backend,
        # and a cold sniff's block-0 fetch is one the scan needs anyway
        try:
            from dataclasses import replace as _dc_replace

            from .config import wrap_source

            source, _ = wrap_source(source, path,
                                    _dc_replace(io, prefetch_depth=0),
                                    MAGIC_PROBE)
        except Exception:
            pass  # the raw source still answers the probe
    try:
        read = lambda: source.read(0, MAGIC_PROBE)  # noqa: E731
        return (retrying_read(read, retry,
                              describe=f"codec probe of '{path}'",
                              on_retry=on_retry)
                if retry is not None else read())
    except Exception:
        return None
    finally:
        try:
            source.close()
        except Exception:
            pass


def active_codec(path: str, io=None, head: Optional[bytes] = None,
                 retry: Optional[RetryPolicy] = None,
                 on_retry=None) -> Optional[Codec]:
    """The codec this input decompresses through, or None (raw).

    `compression=` pin wins outright ('none' disables detection); auto
    mode sniffs magic bytes first and falls back to the extension map.
    The sniff result memoizes on the active read (one probe per file
    per read, shared by open_stream / source_size / planners), so a
    pipelined read's per-chunk opens never re-probe."""
    mode = compression_mode(io)
    if mode in ("none", "off", "raw"):
        return None
    if mode != "auto":
        return codec_by_name(mode)
    memo = _memo()
    if memo is not None:
        cached = memo.get(("codec", path))
        if cached is not None:
            return _CODECS.get(cached) if cached else None
    if head is None:
        scheme = path_scheme(path)
        if scheme in (None, "file"):
            head = _local_head(normalize_local(path))
        else:
            head = _remote_head(path, retry, on_retry, io=io)
    if head is None:
        # Probe failed (unreadable file / backend error): fall back to
        # the extension alone, unmemoized, so a later caller holding the
        # read's retry policy re-probes instead of inheriting a guess.
        return codec_for_path(path)
    codec = _detect(head, path)
    if memo is not None:
        memo[("codec", path)] = codec.name if codec else ""
    return codec


def active_codec_from_source(path: str, io, source: ByteRangeSource,
                             retry: Optional[RetryPolicy] = None,
                             on_retry=None) -> Optional[Codec]:
    """`active_codec` for an already-open backend source (open_stream's
    registry branch): the magic probe reads the head off THAT source
    instead of paying a second backend open. Pin and per-read memo
    short-circuit without touching the source at all."""
    mode = compression_mode(io)
    if mode in ("none", "off", "raw"):
        return None
    if mode != "auto":
        return codec_by_name(mode)
    memo = _memo()
    if memo is not None:
        cached = memo.get(("codec", path))
        if cached is not None:
            return _CODECS.get(cached) if cached else None
    read = lambda: source.read(0, MAGIC_PROBE)  # noqa: E731
    try:
        head = (retrying_read(read, retry,
                              describe=f"codec probe of '{path}'",
                              on_retry=on_retry)
                if retry is not None else read())
    except Exception:
        # Probe failed: extension fallback, unmemoized — the first real
        # read off this source surfaces the real error.
        return codec_for_path(path)
    codec = _detect(head, path)
    if memo is not None:
        memo[("codec", path)] = codec.name if codec else ""
    return codec


def is_compressed(path: str, io=None,
                  retry: Optional[RetryPolicy] = None,
                  on_retry=None) -> bool:
    return active_codec(path, io, retry=retry, on_retry=on_retry) \
        is not None


def compressed_chunkable(path: str, io=None) -> bool:
    """Whether a compressed input may be split into byte-range chunks/
    shards at all. Without a cache_dir there is no decompressed block
    plane and no persisted inflate index: every chunk stream would
    re-inflate the prefix up to its offset (O(n^2) over the scan), so
    both planners fall back to one whole-file shard — the streaming-
    discovery single-shard fallback. Raw inputs are always chunkable
    here (the ordinary predicates still apply downstream)."""
    if not is_compressed(path, io):
        return True
    return bool(io is not None and getattr(io, "cache_enabled", False))


# ---------------------------------------------------------------------------
# streaming member-aware inflater
# ---------------------------------------------------------------------------


class _Inflater:
    """Bounded-memory streaming decoder over concatenated members/
    frames (multi-member gzip, multi-stream bz2/xz, multi-frame zstd).
    Tracks absolute compressed/decompressed positions and records every
    member boundary crossed — the restartable checkpoints of the
    seekable inflate index. Tolerates all-NUL tail padding (tape-block
    style) after a clean member end."""

    def __init__(self, codec: Codec, comp_base: int = 0,
                 decomp_base: int = 0):
        self.codec = codec
        self.comp_pos = comp_base      # compressed bytes consumed
        self.decomp_pos = decomp_base  # decompressed bytes produced
        self.boundaries: List[Tuple[int, int]] = []
        self.mid_member = False
        self._padding = False
        self._d = codec.new_decoder()

    def _error(self, detail: str, cause=None) -> CompressedStreamError:
        err = CompressedStreamError(
            f"{self.codec.name} stream damaged near compressed offset "
            f"{self.comp_pos} (decompressed offset {self.decomp_pos}): "
            f"{detail}",
            codec=self.codec.name, compressed_offset=self.comp_pos,
            decompressed_offset=self.decomp_pos)
        err.__cause__ = cause
        return err

    def feed(self, data: bytes) -> bytes:
        out = []
        while data:
            if self._padding:
                if data.strip(b"\x00"):
                    raise self._error("garbage after stream padding")
                self.comp_pos += len(data)
                break
            if self._d is None:
                self._d = self.codec.new_decoder()
            try:
                piece = self._d.decompress(data)
            except Exception as exc:
                raise self._error(str(exc) or type(exc).__name__, exc)
            if piece:
                out.append(piece)
                self.decomp_pos += len(piece)
            if getattr(self._d, "eof", False):
                rest = getattr(self._d, "unused_data", b"") or b""
                self.comp_pos += len(data) - len(rest)
                self.boundaries.append((self.comp_pos, self.decomp_pos))
                self.mid_member = False
                self._d = None
                if rest and not rest.strip(b"\x00"):
                    self._padding = True
                    self.comp_pos += len(rest)
                    break
                data = rest
            else:
                self.comp_pos += len(data)
                self.mid_member = True
                data = b""
        return b"".join(out)

    def finish(self) -> None:
        """Storage EOF reached: a decoder still inside a member means
        the final member was torn (truncated download, crashed
        writer)."""
        if self.mid_member:
            raise self._error("stream ends inside a compressed member "
                              "(truncated input)")


# ---------------------------------------------------------------------------
# DecompressingSource
# ---------------------------------------------------------------------------


class DecompressingSource(ByteRangeSource):
    """A ByteRangeSource over the DECOMPRESSED byte space of a
    compressed backend source. Thread-safe; owns the decompressed-plane
    caching:

    * warm block-cache hits serve without touching the inflater
      (`inflate_skipped`);
    * misses inflate forward from the nearest restartable checkpoint,
      writing completed blocks through to the cache;
    * `size()` answers from the persisted inflate index when warm, and
      runs ONE streaming discovery pass (checkpoint + cache + index
      building as it goes) when cold.
    """

    def __init__(self, inner: ByteRangeSource, url: str, codec: Codec,
                 io=None, io_stats=None):
        from .stats import current_io_stats

        self._inner = inner
        self._url = url
        self._codec = codec
        self._io_stats = io_stats if io_stats is not None \
            else current_io_stats()
        self._block = int(getattr(io, "compress_block_bytes", 0)
                          or DEFAULT_COMPRESS_BLOCK)
        self._permissive = bool(getattr(io, "permissive_errors", False))
        self._lock = threading.RLock()
        memo = self._io_stats.memo if self._io_stats is not None else None
        fp = memo.get(("fingerprint", url)) if memo is not None else None
        if fp is None:
            fp = inner.fingerprint()
            if memo is not None:
                memo[("fingerprint", url)] = fp
        self._inner_fp = fp
        self._cache = None
        self._gen_dir = None
        self._store = None
        if io is not None and getattr(io, "cache_enabled", False):
            try:
                from .blockcache import shared_block_cache
                from .compress_index import InflateIndexStore

                self._cache = shared_block_cache(io.cache_dir,
                                                 io.cache_max_bytes)
                self._gen_dir = self._cache.generation_dir(
                    url, self.fingerprint())
                self._store = InflateIndexStore(io.cache_dir)
            except OSError as exc:
                _logger.warning(
                    "decompressed-plane cache unavailable under %s "
                    "(%s); inflating without it", io.cache_dir, exc)
                self._cache = self._gen_dir = self._store = None
        # seekable inflate index state (absolute offsets)
        self._total: Optional[int] = None
        self._comp_size: Optional[int] = None
        self._checkpoints: List[Tuple[int, int]] = [(0, 0)]
        # live inflate state
        self._inf: Optional[_Inflater] = None
        self._comp_read = 0            # next compressed offset to read
        self._win = bytearray()        # window of recent decompressed bytes
        self._win_start = 0
        # the most recently materialized cache block: consecutive reads
        # inside one block cost ONE cache fetch (and one inflate_skipped
        # bump — the counter means distinct blocks served, per source)
        self._last_block: Optional[Tuple[int, bytes]] = None
        # damage state
        self._truncated_at: Optional[int] = None
        self._error: Optional[CompressedStreamError] = None
        self._load_index()

    # -- identity --------------------------------------------------------

    @property
    def name(self) -> str:
        return self._inner.name or self._url

    @property
    def codec_name(self) -> str:
        return self._codec.name

    @property
    def block(self) -> int:
        """The decompressed-plane block size (checkpoint stride and
        cache entry size)."""
        return self._block

    def fingerprint(self) -> str:
        # the decompressed plane's version key: derived from the
        # COMPRESSED file's fingerprint so a changed wire file
        # invalidates sparse indexes, block generations, and resume
        # plans keyed off this source — and so the plane can never
        # collide with a raw-bytes generation of the same url
        return f"inflate:{self._codec.name}:{self._inner_fp}"

    def close(self) -> None:
        self._inner.close()

    # -- counters --------------------------------------------------------

    def _bump(self, key: str, n=1) -> None:
        if self._io_stats is not None and n:
            self._io_stats.bump(key, n)

    # -- inflate index ---------------------------------------------------

    def _load_index(self) -> None:
        memo = self._io_stats.memo if self._io_stats is not None else None
        entry = None
        if self._store is not None:
            entry = self._store.load(self._url, self._codec.name,
                                     self._inner_fp)
        if entry is not None:
            self._total = entry.total
            self._comp_size = entry.comp_size
            self._merge_checkpoints(entry.checkpoints)
        elif memo is not None:
            total = memo.get(("dsize", self._url))
            if total is not None:
                self._total = int(total)

    def _merge_checkpoints(self, points) -> None:
        merged = {(0, 0)}
        merged.update((int(c), int(d)) for c, d in self._checkpoints)
        merged.update((int(c), int(d)) for c, d in points)
        self._checkpoints = sorted(merged, key=lambda p: p[1])

    def _thinned_checkpoints(self) -> List[Tuple[int, int]]:
        """Checkpoints spaced >= one block of decompressed output (a
        foreign file with thousands of tiny members must not bloat the
        persisted index); the first and final boundaries always stay."""
        out: List[Tuple[int, int]] = []
        for c, d in self._checkpoints:
            if (not out or d - out[-1][1] >= self._block
                    or (self._total is not None and d == self._total)):
                out.append((c, d))
        return out

    def _persist_index(self) -> None:
        if (self._store is None or self._total is None
                or self._truncated_at is not None
                or self._error is not None):
            return
        self._store.save(self._url, self._codec.name, self._inner_fp,
                         self._total, self._comp_size or 0,
                         self._thinned_checkpoints())

    # -- size ------------------------------------------------------------

    def size(self) -> int:
        with self._lock:
            if self._total is None:
                self._discover()
            return int(self._total)

    def _discover(self) -> None:
        """Cold streaming discovery: one bounded-memory pass from the
        furthest known checkpoint to EOF, recording checkpoints, write-
        through caching completed blocks, then persisting the inflate
        index. The single pass that makes every later consumer
        (planners, footer rules, metrics totals) see the decompressed
        size."""
        last = self._checkpoints[-1]
        self._restart(last)
        while self._inf is not None:
            if not self._step():
                break
            self._flush_blocks(trim_to=self._current_block_start())
        if self._total is None:
            # damaged stream under a permissive policy: serve the clean
            # prefix as the stream's extent
            self._total = (self._truncated_at
                           if self._truncated_at is not None else 0)
        memo = self._io_stats.memo if self._io_stats is not None else None
        if memo is not None:
            memo[("dsize", self._url)] = self._total

    # -- live inflate machinery -----------------------------------------

    def _restart(self, checkpoint: Tuple[int, int]) -> None:
        comp, decomp = checkpoint
        self._inf = _Inflater(self._codec, comp_base=comp,
                              decomp_base=decomp)
        self._comp_read = comp
        self._win = bytearray()
        self._win_start = decomp

    def _current_block_start(self) -> int:
        pos = self._inf.decomp_pos if self._inf is not None \
            else self._win_start + len(self._win)
        return (pos // self._block) * self._block

    def _step(self) -> bool:
        """Feed one compressed read through the inflater; False once
        the stream ended (cleanly or by damage)."""
        inf = self._inf
        raw = self._inner.read(self._comp_read, _COMP_READ)
        t0 = time.perf_counter()
        if not raw:
            try:
                inf.finish()
            except CompressedStreamError as exc:
                self._damage(exc)
                return False
            self._note_eof()
            return False
        self._comp_read += len(raw)
        try:
            piece = inf.feed(raw)
        except CompressedStreamError as exc:
            self._bump("inflate_s", time.perf_counter() - t0)
            self._damage(exc)
            return False
        self._bump("inflate_s", time.perf_counter() - t0)
        self._bump("compressed_bytes_in", len(raw))
        if piece:
            self._bump("decompressed_bytes_out", len(piece))
            self._win.extend(piece)
        if inf.boundaries:
            self._merge_checkpoints(inf.boundaries)
            inf.boundaries.clear()
        return True

    def _note_eof(self) -> None:
        inf = self._inf
        total = inf.decomp_pos
        comp_size = inf.comp_pos
        fresh = self._total is None
        self._total = total
        self._comp_size = comp_size
        self._merge_checkpoints([(comp_size, total)])
        # the final (usually partial) block can only be cached once the
        # total is known — flush everything still in the window
        self._flush_blocks(trim_to=None, final=True)
        self._inf = None
        if fresh:
            self._persist_index()

    def _damage(self, exc: CompressedStreamError) -> None:
        from .integrity import note_corruption

        note_corruption("compress", self._url, str(exc),
                        io_stats=self._io_stats)
        self._inf = None
        if self._permissive:
            self._truncated_at = exc.decompressed_offset
            if self._total is None:
                self._total = self._truncated_at
            _logger.warning(
                "permissive policy: %s — serving the %d cleanly "
                "decompressed byte(s) and truncating", exc,
                self._truncated_at)
        else:
            self._error = exc
            raise exc

    def _flush_blocks(self, trim_to: Optional[int],
                      final: bool = False) -> None:
        """Write completed aligned blocks out of the window into the
        decompressed block cache, then trim the window to `trim_to`
        (None = drop everything cacheable; serving reads pass the
        request start so the bytes being served survive the trim)."""
        if self._cache is not None and self._gen_dir is not None:
            end = self._win_start + len(self._win)
            bs = ((self._win_start + self._block - 1)
                  // self._block) * self._block
            if self._win_start % self._block == 0:
                bs = self._win_start
            while bs + self._block <= end:
                be = bs + self._block
                self._cache.put(
                    self._gen_dir, bs, be,
                    bytes(self._win[bs - self._win_start:
                                    be - self._win_start]),
                    io_stats=self._io_stats)
                bs = be
            if final and self._total is not None and bs < self._total \
                    and self._total <= end:
                self._cache.put(
                    self._gen_dir, bs, self._total,
                    bytes(self._win[bs - self._win_start:
                                    self._total - self._win_start]),
                    io_stats=self._io_stats)
        if trim_to is None:
            cut = self._current_block_start()
        else:
            cut = min(trim_to, self._current_block_start())
        if cut > self._win_start:
            del self._win[:cut - self._win_start]
            self._win_start = cut

    # -- reads -----------------------------------------------------------

    def _block_range(self, idx: int) -> Tuple[int, int]:
        start = idx * self._block
        end = start + self._block
        if self._total is not None:
            end = min(end, self._total)
        return start, end

    def _cached_block(self, pos: int) -> Optional[bytes]:
        if self._cache is None or self._gen_dir is None \
                or self._total is None:
            return None
        bs, be = self._block_range(pos // self._block)
        if be <= bs:
            return None
        if self._last_block is not None and self._last_block[0] == bs:
            return self._last_block[1]
        data = self._cache.get(self._gen_dir, bs, be,
                               io_stats=self._io_stats)
        if data is None:
            return None
        self._last_block = (bs, data)
        self._bump("inflate_skipped")
        self._bump("block_hits")
        self._bump("bytes_from_cache", len(data))
        return data

    def _end(self, offset: int, n: int) -> int:
        """The end of the servable range [offset, offset + n): the stored
        damage re-raised, the size discovered, the range clamped to the
        total and a permissive truncation."""
        if self._error is not None:
            raise self._error
        if self._total is None:
            self._discover()
        end = min(offset + n, self._total)
        if self._truncated_at is not None:
            end = min(end, self._truncated_at)
        return end

    def read(self, offset: int, n: int) -> bytes:
        with self._lock:
            end = self._end(offset, n)
            if offset >= end:
                return b""
            out = bytearray(end - offset)
            got = self._copy_into(offset, end, memoryview(out))
        return bytes(out) if got == len(out) else bytes(out[:got])

    def readinto(self, offset: int, view: memoryview) -> int:
        with self._lock:
            end = self._end(offset, len(view))
            if offset >= end:
                return 0
            return self._copy_into(offset, end, view)

    def _copy_into(self, offset: int, end: int, view: memoryview) -> int:
        """Copy [offset, end) into `view` piece by piece (the window, a
        cached block, or freshly inflated bytes); the count copied."""
        pos = offset
        while pos < end:
            found = self._locate(pos, end)
            if found is None:
                break
            buf, lo, hi = found
            k = pos - offset
            with memoryview(buf) as src:
                view[k:k + hi - lo] = src[lo:hi]
            pos += hi - lo
        return pos - offset

    def _locate(self, pos: int, end: int):
        """(buffer, lo, hi): the bytes buffer[lo:hi] are the next piece
        of [pos, end), or None past the servable data."""
        # 1. the live window
        wend = self._win_start + len(self._win)
        if self._win_start <= pos < wend:
            return (self._win, pos - self._win_start,
                    min(end, wend) - self._win_start)
        # 2. the decompressed block cache (warm scans: zero inflate)
        cached = self._cached_block(pos)
        if cached is not None:
            bs = (pos // self._block) * self._block
            stop = min(end, bs + len(cached))
            return cached, pos - bs, stop - bs
        # 3. inflate forward from the best restartable checkpoint
        if self._inf is None or pos < self._win_start:
            best = (0, 0)
            for c, d in self._checkpoints:
                if d <= pos and d >= best[1]:
                    best = (c, d)
            self._restart(best)
        while (self._win_start + len(self._win)) <= pos:
            if self._inf is None or not self._step():
                break
            # cache completed blocks, keep the bytes still to serve
            self._flush_blocks(trim_to=pos)
        wend = self._win_start + len(self._win)
        if self._win_start <= pos < wend:
            return (self._win, pos - self._win_start,
                    min(end, wend) - self._win_start)
        return None


# ---------------------------------------------------------------------------
# stream composition + planner plumbing
# ---------------------------------------------------------------------------


def open_compressed_stream(source: ByteRangeSource, url: str,
                           codec: Codec, io=None, start_offset: int = 0,
                           maximum_bytes: int = 0,
                           chunk_size: int = DEFAULT_CHUNK_SIZE,
                           retry: Optional[RetryPolicy] = None,
                           on_retry=None) -> SimpleStream:
    """The compressed flavor of `open_stream`'s tail: DecompressingSource
    over the backend source, framed through the ordinary buffered
    stream so every downstream consumer sees decompressed offsets. The
    stream chunk shrinks to the decompressed block size so each fill
    lines up with the cache/window granularity."""
    dsrc = DecompressingSource(source, url, codec, io=io)
    return BufferedSourceStream(dsrc, start_offset=start_offset,
                                maximum_bytes=maximum_bytes,
                                chunk_size=min(max(chunk_size, 1),
                                               dsrc.block),
                                retry=retry, on_retry=on_retry)


def decompressed_size(path: str, codec: Codec, io=None,
                      retry: Optional[RetryPolicy] = None,
                      on_retry=None) -> int:
    """Logical (decompressed) size of one compressed input: the warm
    inflate index answers instantly; cold falls back to the streaming
    discovery pass (memoized on the active read, so planning +
    validation + metrics probe it once)."""
    memo = _memo()
    if memo is not None:
        size = memo.get(("dsize", path))
        if size is not None:
            return int(size)
    from ..reader.stream import open_stream

    with open_stream(path, retry=retry, on_retry=on_retry,
                     io=io) as stream:
        return stream.size()
