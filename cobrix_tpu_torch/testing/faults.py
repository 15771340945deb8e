"""Fault injection — the corruption side of the test-data generators.

Port copy of ``cobrix_tpu.testing.faults``, reduced to the byte-level
injectors that the port's tests and ``chip_smoke.py`` use:
`rdw_record_starts` (over ``reader.recovery.rdw_scan_host``, the host
walk, in place of the native scan), `flip_bit`, `truncate`,
`splice_garbage`, `overwrite`, `zero_rdw`, `oversize_rdw` and
`garbage_run`. The storage, cache, sink and worker faults are not
carried over, since the port has none of those planes yet.

All injectors are pure: they take `bytes` and return corrupted `bytes`,
so assertions can check that the ledger points at the right offset.
"""
from __future__ import annotations

from typing import List

import numpy as np


def rdw_record_starts(data: bytes, big_endian: bool = False,
                      rdw_adjustment: int = 0) -> List[int]:
    """Byte offset of every RDW header in a clean file — the structural
    boundaries truncation/corruption fixtures enumerate."""
    from ..reader.recovery import rdw_scan_host

    offsets, _ = rdw_scan_host(data, big_endian, rdw_adjustment, 0, 0)
    return [int(o) - 4 for o in offsets]


def flip_bit(data: bytes, offset: int, bit: int = 0) -> bytes:
    """Flip one bit at `offset` (bit 0 = LSB)."""
    out = bytearray(data)
    out[offset] ^= (1 << bit)
    return bytes(out)


def truncate(data: bytes, keep: int) -> bytes:
    """Torn tail: keep only the first `keep` bytes."""
    return data[:keep]


def splice_garbage(data: bytes, offset: int, garbage: bytes) -> bytes:
    """Insert foreign bytes at `offset` (a torn-and-respliced dump)."""
    return data[:offset] + garbage + data[offset:]


def overwrite(data: bytes, offset: int, patch: bytes) -> bytes:
    """Overwrite bytes in place at `offset`."""
    return data[:offset] + patch + data[offset + len(patch):]


def zero_rdw(data: bytes, record_start: int) -> bytes:
    """Zero out the 4-byte RDW header at a record start — the classic
    'RDW headers should never be zero' failure."""
    return overwrite(data, record_start, b"\x00\x00\x00\x00")


def oversize_rdw(data: bytes, record_start: int,
                 big_endian: bool = False) -> bytes:
    """Make the RDW at a record start declare an absurd length (driven
    through the 100 MB cap by the rdw_adjustment=0 default decoders the
    suite uses via huge 16-bit lengths only when adjusted; here it simply
    declares far more bytes than the file holds)."""
    header = b"\xff\xff\x00\x00" if big_endian else b"\x00\x00\xff\xff"
    return overwrite(data, record_start, header)


def garbage_run(length: int, seed: int = 0) -> bytes:
    """Deterministic non-header-looking garbage: 0x00/0x40 heavy like a
    real torn EBCDIC region (zero RDWs, so framing must resync)."""
    rng = np.random.default_rng(seed)
    pool = np.asarray([0x00, 0x40, 0x00, 0xFF], dtype=np.uint8)
    return bytes(pool[rng.integers(0, len(pool), size=length)])
