"""Compressed-input detection.

Port copy of the detection half of ``cobrix_tpu.io.compress``: the codec
registry entries with a strict magic test (gzip, bz2 and xz), the
magic sniff (`sniff_magic`), the extension fallback (`codec_for_path`,
vetoed by a head that lacks the extension codec's magic), `codec_by_name`
for the ``compression=`` option and the local-file part of
`active_codec`. ``compression="none"`` (or ``off`` / ``raw``) reads the
raw bytes; ``auto``, the default, sniffs every input.

The port does not inflate yet (ROADMAP A4f): ``api.read_cobol`` raises a
ValueError naming an input whose codec is detected or named, where the
JAX package would frame the decompressed bytes. So the decoders, the
inflate index, the block cache and the remote probes are not carried
over, nor are bare zlib (no magic to sniff) and zstd (its decoder needs
the ``zstandard`` module, which the card machine lacks).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..reader.stream import normalize_local, path_scheme

# magic probe length: enough for every registered codec's signature
MAGIC_PROBE = 6


class Codec:
    """One registered compression codec: its name, file extensions and
    magic test (the JAX package's `Codec` without its decoder
    factory)."""

    def __init__(self, name: str, extensions: Tuple[str, ...],
                 magic: Optional[Callable[[bytes], bool]]):
        self.name = name
        self.extensions = extensions
        self._magic = magic

    def matches_magic(self, head: bytes) -> bool:
        return bool(self._magic and head and self._magic(head))

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


def _xz_magic(head: bytes) -> bool:
    return head[:6] == b"\xfd7zXZ\x00"


_CODECS: Dict[str, Codec] = {
    "gzip": Codec("gzip", (".gz", ".gzip"), _gzip_magic),
    "bz2": Codec("bz2", (".bz2",), _bz2_magic),
    "xz": Codec("xz", (".xz", ".lzma"), _xz_magic),
}

# user spellings accepted by the `compression=` option
_ALIASES = {"gz": "gzip", "bzip2": "bz2", "lzma": "xz"}


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
    """Extension-based detection fallback."""
    lowered = path.lower().rstrip("/")
    for codec in _CODECS.values():
        for ext in codec.extensions:
            if lowered.endswith(ext):
                return codec
    return None


def _detect(head: bytes, path: str) -> Optional[Codec]:
    """Auto-mode detection: magic sniff first, extension fallback —
    but when a real head WAS read and the extension's codec carries a
    sniffable magic the head does not have, the bytes veto the name
    (a raw file merely *named* `.gz` stays raw)."""
    codec = sniff_magic(head)
    if codec is not None:
        return codec
    by_ext = codec_for_path(path)
    if by_ext is not None and by_ext._magic is not None and head:
        return None
    return by_ext


def _local_head(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read(MAGIC_PROBE)
    except OSError:
        return None  # probe failed: the real open surfaces the real error


def active_codec(path: str, compression: str = "auto") -> Optional[Codec]:
    """The codec a local input is compressed with, or None (raw).

    A `compression` pin wins outright ('none', 'off' and 'raw' disable
    detection); auto mode sniffs the magic bytes first and falls back to
    the extension map."""
    mode = (compression or "auto").lower()
    if mode in ("none", "off", "raw"):
        return None
    if mode != "auto":
        return codec_by_name(mode)
    head = _local_head(normalize_local(path)) \
        if path_scheme(path) in (None, "file") else None
    if head is None:
        return codec_for_path(path)
    return _detect(head, path)
