"""Fault injection — the corruption side of the test-data generators.

Port copy of ``cobrix_tpu.testing.faults``, reduced to the byte-level
injectors that the port's tests and ``chip_smoke.py`` use:
`rdw_record_starts` (over ``reader.recovery.rdw_scan_host``, the host
walk, in place of the native scan), `flip_bit`, `truncate`,
`splice_garbage`, `overwrite`, `zero_rdw`, `oversize_rdw` and
`garbage_run`; the network-shaped source wrapper `ChaosSource` with
`register_chaos_backend`; the compressed-feed injectors
(`compressed_member_spans`, `truncate_compressed_member`,
`corrupt_compressed_trailer`, `garbage_between_members`); and the
durable-state injector `corrupt_cache_entry` (with `cache_entry_paths`)
for the block, index, stats and compress planes. The sink, checkpoint
and worker faults are not carried over, since the port has none of
those planes yet.

All injectors are pure: they take `bytes` and return corrupted `bytes`,
so assertions can check that the ledger points at the right offset.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..reader.stream import ByteRangeSource


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


class ChaosSource(ByteRangeSource):
    """Network-shaped fault wrapper over ANY ByteRangeSource (including
    the fsspec adapter) — the composable injector the remote-io test
    matrix drives the retry + cache + prefetch stack through:

    * `fail_reads` / `fail_every` — transient IOErrors: the first N
      reads fail, or every k-th read fails (exercises retries landing
      on prefetch-pool threads, not just the consumer);
    * `error_type` — what a failure raises (proves 'dead backend fails
      with the backend's OWN error type' end to end);
    * `latency_s` — per-read sleep: a slow filesystem (read-ahead must
      hide it; supervision deadlines must survive it);
    * `truncate_at` — storage EOF short of the advertised size: reads
      at/after the cut return b'' while size() keeps promising more —
      the short-read anomaly BufferedSourceStream re-probes and the
      framing layer then ledgers as truncation.

    Counters (`read_calls`, `failures_served`, `slept_s`) stay on the
    wrapper for assertions."""

    def __init__(self, inner: ByteRangeSource, fail_reads: int = 0,
                 fail_every: int = 0, fail_forever: bool = False,
                 error_type=IOError, latency_s: float = 0.0,
                 truncate_at: Optional[int] = None):
        self._inner = inner
        self.fail_reads = fail_reads
        self.fail_every = fail_every
        self.fail_forever = fail_forever
        self.error_type = error_type
        self.latency_s = latency_s
        self.truncate_at = truncate_at
        self.read_calls = 0
        self.failures_served = 0
        self.slept_s = 0.0

    def size(self) -> int:
        return self._inner.size()

    def fingerprint(self) -> str:
        return self._inner.fingerprint()

    @property
    def name(self) -> str:
        return self._inner.name

    def close(self) -> None:
        self._inner.close()

    def read(self, offset: int, n: int) -> bytes:
        import time

        self.read_calls += 1
        if self.latency_s:
            time.sleep(self.latency_s)
            self.slept_s += self.latency_s
        should_fail = (self.fail_forever
                       or self.failures_served < self.fail_reads
                       or (self.fail_every
                           and self.read_calls % self.fail_every == 0))
        if should_fail:
            self.failures_served += 1
            raise self.error_type(
                f"injected fault #{self.failures_served} "
                f"(offset={offset}, n={n})")
        if self.truncate_at is not None:
            if offset >= self.truncate_at:
                return b""  # storage EOF short of the logical limit
            n = min(n, self.truncate_at - offset)
        return self._inner.read(offset, n)


def register_chaos_backend(scheme: str, data: bytes,
                           **kwargs) -> "ChaosSource":
    """Register `scheme://` serving `data` through one ChaosSource over
    an in-memory source (returned for counter assertions)."""
    from ..reader.stream import register_stream_backend

    class _MemSource(ByteRangeSource):
        def __init__(self, payload: bytes, name: str):
            self._payload = payload
            self._name = name

        def size(self) -> int:
            return len(self._payload)

        def read(self, offset: int, n: int) -> bytes:
            return self._payload[offset:offset + n]

        def fingerprint(self) -> str:
            import hashlib

            return hashlib.sha256(self._payload).hexdigest()

        @property
        def name(self) -> str:
            return self._name

    source = ChaosSource(_MemSource(data, f"{scheme}://chaos"), **kwargs)
    register_stream_backend(scheme, lambda path: source)
    return source


# -- compressed-feed fault injection --------------------------------------
#
# The injectors below damage COMPRESSED WIRE BYTES, not the decompressed
# payload: a feed torn mid-member (an aborted upload), a member whose
# trailer CRC no longer matches (a bit rotted in transit), and foreign
# bytes spliced between members (a concatenation gone wrong). The
# streaming decompression plane (io/compress.py) must turn each into a
# structured `CompressedStreamError` carrying BOTH offsets (where in the
# wire bytes and where in the decompressed stream), honor
# `record_error_policy`, and count the damage under the `compress`
# integrity plane.


def compressed_member_spans(data: bytes, codec: str = "gzip"
                            ) -> List[Tuple[int, int]]:
    """[(start, end)) wire-byte span of every member/frame in a
    concatenated compressed stream — the structural boundaries the
    compressed injectors aim at. Found by actually decoding (magic
    bytes can occur inside compressed payloads, so scanning is not
    safe)."""
    from ..io.compress import codec_by_name

    c = codec_by_name(codec)
    spans: List[Tuple[int, int]] = []
    pos = 0
    while pos < len(data):
        d = c.new_decoder()
        chunk = data[pos:]
        d.decompress(chunk)
        if not d.eof:
            raise ValueError(
                f"stream ends mid-member at wire offset {pos} "
                f"(already damaged?)")
        consumed = len(chunk) - len(d.unused_data)
        spans.append((pos, pos + consumed))
        pos += consumed
    return spans


def truncate_compressed_member(data: bytes, codec: str = "gzip",
                               which: int = -1,
                               keep_fraction: float = 0.5
                               ) -> Tuple[bytes, int]:
    """Tear the stream mid-member: keep everything before member
    `which` plus `keep_fraction` of that member's wire bytes. Returns
    (torn_stream, cut_wire_offset). The inflate must fail (or, under a
    permissive policy, stop) AT the cut — never frame garbage past it.
    """
    spans = compressed_member_spans(data, codec)
    start, end = spans[which % len(spans)]
    cut = start + max(1, int((end - start) * keep_fraction))
    return data[:cut], cut


def corrupt_compressed_trailer(data: bytes, codec: str = "gzip",
                               which: int = -1) -> Tuple[bytes, int]:
    """Flip one bit inside member `which`'s trailer region (the final
    bytes of the member's wire span — for gzip the CRC32/ISIZE words).
    Returns (corrupted_stream, flip_offset). The decoder's own
    integrity check must surface as `CompressedStreamError`, not as
    silently wrong decompressed bytes."""
    spans = compressed_member_spans(data, codec)
    start, end = spans[which % len(spans)]
    pos = max(start, end - 5)  # inside gzip CRC32; tail bytes otherwise
    return flip_bit(data, pos), pos


def garbage_between_members(data: bytes, codec: str = "gzip",
                            which: int = 0, length: int = 64,
                            seed: int = 0) -> Tuple[bytes, int]:
    """Splice non-codec garbage at the boundary AFTER member `which` —
    the mis-concatenated feed. Returns (spliced_stream, splice_offset).
    The inflater tolerates NUL padding there (tape-style blocking) but
    must refuse anything else with a structured error at the splice."""
    spans = compressed_member_spans(data, codec)
    _start, end = spans[which % len(spans)]
    rng = np.random.default_rng(seed)
    junk = bytes(rng.integers(1, 255, size=length, dtype=np.uint8))
    return splice_garbage(data, end, junk), end


# -- durable-state fault injection ---------------------------------------


def cache_entry_paths(cache_dir: str, plane: str = "block"):
    """Every durable entry file of one cache plane under `cache_dir`,
    sorted for determinism. Planes: 'block' (aligned .blk entries),
    'index' (sparse-index .json payloads), 'stats' (scan-profile .json
    payloads), 'compress' (seekable inflate-index .json payloads)."""
    sub = {"block": "blocks", "index": "index", "stats": "stats",
           "compress": "compress"}[plane]
    suffix = {"block": ".blk", "index": ".json", "stats": ".json",
              "compress": ".json"}[plane]
    root = os.path.join(cache_dir, sub)
    out = []
    for dirpath, dirs, files in os.walk(root):
        if os.path.basename(dirpath) == "quarantine":
            dirs[:] = []
            continue
        for name in files:
            if name.endswith(suffix):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def corrupt_cache_entry(cache_dir: str, plane: str = "block",
                        mode: str = "bitflip", which: int = 0,
                        offset: int = -9) -> str:
    """Corrupt one persistent-cache entry in place and return its path.

    * ``mode='bitflip'`` — flip one bit at `offset` (negative = from
      the tail, default lands inside the payload, past any header);
    * ``mode='truncate'`` — tear the file to half its size (a crashed
      copy, a filesystem that lost the tail);
    * ``mode='garbage'`` — replace the whole file with non-format bytes.

    `which` picks the entry (sorted order). The integrity layer must
    turn every one of these into a counted, quarantined MISS."""
    paths = cache_entry_paths(cache_dir, plane)
    if not paths:
        raise FileNotFoundError(
            f"no '{plane}' cache entries under {cache_dir}")
    path = paths[which % len(paths)]
    data = open(path, "rb").read()
    if mode == "bitflip":
        pos = offset if offset >= 0 else len(data) + offset
        pos = max(0, min(len(data) - 1, pos))
        data = flip_bit(data, pos)
    elif mode == "truncate":
        data = data[:max(1, len(data) // 2)]
    elif mode == "garbage":
        data = b"\x00\xff" * max(8, len(data) // 4)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(data)
    return path
