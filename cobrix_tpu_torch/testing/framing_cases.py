"""The grid of RDW scan and record-pack cases, shared by the tests and
``chip_smoke.py``.

`scan_cases()` maps a name to (image bytes, big_endian, rdw_adjustment,
file_header_bytes, file_footer_bytes): both endiannesses, an adjustment
of -4 (``is_rdw_part_of_record_length``) and a positive one, the file
header (longer than 4 bytes, exactly 4, past the end) and footer (cutting
a record, not shorter than the image), a truncated last record, a lone
header at the end, trailing bytes, a zero header (raw and after the
adjustment), an oversized header (at 0 and after the file header), a zero
header inside the footer, and images of 0-3 bytes. `pack_case()` is an
image with record offsets and lengths that start unaligned, run past the
image's last byte, start before it or past it, and are not positive.
`WINDOWS` are window sizes that cut records at every phase, header
included.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# the host walk's cap on one record (native MAX_RDW_RECORD_SIZE)
MAX_RDW_RECORD_SIZE = 100 * 1024 * 1024

WINDOWS = (5, 16, 37, 100, 1 << 20)


def rdw_header(length: int, big_endian: bool) -> bytes:
    if big_endian:
        return bytes([(length >> 8) & 0xFF, length & 0xFF, 0, 0])
    return bytes([0, 0, length & 0xFF, (length >> 8) & 0xFF])


def rdw_stream(lengths, big_endian=False, stored_delta=0, seed=0) -> bytes:
    """RDW records with random payloads; each header stores the length
    plus `stored_delta` (what a reader's adjustment takes off again)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for ln in lengths:
        out += rdw_header(ln + stored_delta, big_endian)
        out += rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes()
    return bytes(out)


def _lengths(n, seed, lo=1, hi=300) -> List[int]:
    return np.random.default_rng(seed).integers(lo, hi, size=n).tolist()


def scan_cases() -> Dict[str, Tuple[bytes, bool, int, int, int]]:
    base = rdw_stream(_lengths(40, 1), seed=1)
    be = rdw_stream(_lengths(40, 2), big_endian=True, seed=2)
    part = rdw_stream(_lengths(30, 3), stored_delta=4, seed=3)
    plus = rdw_stream(_lengths(30, 4, lo=4), stored_delta=-3, seed=4)
    zero = bytearray(rdw_stream(_lengths(12, 5), seed=5))
    first = 4 + _lengths(12, 5)[0]
    zero[first:first + 4] = rdw_header(0, False)
    # a header that stores 4 under an adjustment of -4, before the third
    # record
    zero_adj = rdw_stream([7, 3, 9], stored_delta=4, seed=6)
    zero_adj = zero_adj[:18] + rdw_header(4, False) + zero_adj[18:]
    cut = rdw_stream(_lengths(10, 7), seed=7)
    big = MAX_RDW_RECORD_SIZE
    return {
        "le": (base, False, 0, 0, 0),
        "be": (be, True, 0, 0, 0),
        "part_of_length": (part, False, -4, 0, 0),
        "positive_adjustment": (plus, False, 3, 0, 0),
        "file_header": (b"\x01" * 10 + base, False, 0, 10, 0),
        "file_header_4_is_ignored": (base, False, 0, 4, 0),
        "file_header_past_end": (base[:20], False, 0, 30, 0),
        "file_footer": (base + b"\x00" * 7, False, 0, 0, 7),
        "footer_cuts_a_record": (base, False, 0, 0, 50),
        "footer_not_shorter_than_image": (base[:9], False, 0, 0, 9),
        "header_and_footer": (b"\x05" * 9 + be + b"\x00" * 8, True, 0, 9, 8),
        "truncated_last": (cut[:-5], False, 0, 0, 0),
        "header_only_at_end": (rdw_stream([5], seed=8)[:4], False, 0, 0, 0),
        "trailing_garbage": (base + b"\x00\x00\x07", False, 0, 0, 0),
        "zero_header": (bytes(zero), False, 0, 0, 0),
        "zero_after_adjustment": (zero_adj, False, -4, 0, 0),
        "oversized_header": (base, False, big, 0, 0),
        "oversized_after_file_header": (b"\x01" * 10 + base, False, big,
                                        10, 0),
        "zero_in_footer_is_no_error": (base + b"\x00" * 6, False, 0, 0, 6),
        "empty": (b"", False, 0, 0, 0),
        "one_byte": (b"\x00", False, 0, 0, 0),
        "two_bytes": (b"\x00\x00", False, 0, 0, 0),
        "three_bytes": (b"\x00\x00\x05", False, 0, 0, 0),
    }


def pack_case() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image, int64 offsets, int64 lengths)."""
    rng = np.random.default_rng(11)
    image = rng.integers(0, 256, size=1000, dtype=np.uint8)
    offsets = np.array([0, 1, 3, 17, 250, 999, 990, -5, 1000, 1500, 7, 33],
                       dtype=np.int64)
    lengths = np.array([20, 64, 5, 0, 300, 1, 40, 30, 10, 10, -3, 200],
                       dtype=np.int64)
    return image, offsets, lengths
