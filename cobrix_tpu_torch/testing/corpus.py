"""Synthetic load factory: chunked corpora, optionally compressed.

Port copy of ``cobrix_tpu.testing.corpus``, reduced to what the port's
I/O tests and ``chip_smoke.py`` use: the TXN and COMPANY/CONTACT
copybooks and their read options, `member_compressor` and the two
chunked writers, both of which can emit one compressed member per
flushed chunk (so every chunk boundary is a restartable checkpoint of
the streaming inflate index):

* `write_fixed_corpus` — flat fixed-length transaction records with
  controlled *selectivity* knobs (`distinct_accounts` bounds the
  account-predicate cardinality, `status_weights` skews the status
  column);
* `write_multiseg_corpus` — RDW-framed COMPANY/CONTACT hierarchy with a
  controlled *segment mix* (`contacts_per_company` drives the
  record-length distribution: 34-byte parent vs 60-byte child frames).

Change from the JAX package: its writers build records through its
encoder (``cobrix_tpu.encode.BatchEncoder``); these pack the same
layouts with numpy (big-endian COMP, sign-nibble COMP-3,
trailing-overpunch zoned decimals, EBCDIC text through ``generators``'
table). The port has its own `encode.BatchEncoder` now, and these
writers stay numpy all the same: they are the load factory of
``chip_smoke.py``'s large corpora, and the Python per-record paths
around an encoder cost too much there (phase 18's 8,000,000-record TXN
corpus took 139.2 s through Python writers on the card's host; see
PERF.md). ``chip_smoke.py`` phase 19 builds a TXN file through
`BatchEncoder` when the encoder itself is what it measures. The values
are drawn from the same distributions, not the same bytes; tests read
one file with both packages. Of the damage helpers only
`corrupt_fixed_corpus` is carried over (the round-trip tests damage a
TXN corpus with it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .generators import encode_comp_be, encode_strings_column

TXN_COPYBOOK = """
       01  TXN.
           05  TXN-ID        PIC 9(9)  COMP.
           05  ACCOUNT       PIC X(10).
           05  CURRENCY      PIC X(3).
           05  AMOUNT        PIC S9(9)V99 COMP-3.
           05  BALANCE       PIC S9(7)V99.
           05  STATUS        PIC X(1).
           05  BRANCH        PIC 9(4) COMP.
"""
TXN_RECORD_SIZE = 35

MULTISEG_COPYBOOK = """
       01  COMPANY-DETAILS.
           05  SEGMENT-ID      PIC X(1).
           05  COMPANY-ID      PIC X(10).
           05  STATIC-DETAILS.
              10  COMPANY-NAME PIC X(15).
              10  REG-NUM      PIC 9(8)  COMP.
           05  CONTACTS REDEFINES STATIC-DETAILS.
              10  PHONE        PIC X(17).
              10  CONTACT      PIC X(28).
"""

_CURRENCIES = ("USD", "EUR", "GBP", "ZAR", "CHF", "JPY")
_STATUSES = "ACDPR"


def fixed_read_options() -> Dict[str, str]:
    return {"copybook_contents": TXN_COPYBOOK}


def multiseg_read_options() -> Dict[str, str]:
    return {
        "copybook_contents": MULTISEG_COPYBOOK,
        "is_record_sequence": "true",
        "segment_field": "SEGMENT-ID",
        "redefine_segment_id_map": "STATIC-DETAILS => C",
        "redefine_segment_id_map_1": "CONTACTS => P",
    }


def member_compressor(compression: str):
    """One-shot `bytes -> compressed member` for a canonical codec name
    (io.compress registry names/aliases). Corpus writers emit ONE member
    per flushed chunk, so generated compressed corpora are seekable:
    every chunk boundary is a restartable checkpoint for the streaming
    inflate index."""
    from ..io.compress import codec_by_name

    name = codec_by_name(compression).name
    if name == "gzip":
        import gzip as _gzip

        return name, lambda b: _gzip.compress(b, compresslevel=1,
                                              mtime=0)
    if name == "zlib":
        import zlib as _zlib

        return name, lambda b: _zlib.compress(b, 1)
    if name == "bz2":
        import bz2 as _bz2

        return name, lambda b: _bz2.compress(b, 1)
    if name == "xz":
        import lzma as _lzma

        return name, lambda b: _lzma.compress(b, preset=0)
    if name == "zstd":
        try:
            import zstandard
        except ImportError as exc:
            raise ImportError(
                "writing a zstd corpus needs the optional 'zstandard' "
                "package (pip install zstandard)") from exc
        cctx = zstandard.ZstdCompressor()
        return name, cctx.compress
    raise ValueError(f"no corpus compressor for codec {name!r}")


class _CorpusSink:
    """File sink for the chunked corpus writers: plain pass-through, or
    one compressed member per write() when `compression` is given."""

    def __init__(self, path: str, compression: Optional[str] = None):
        self._f = open(path, "wb")
        self._compress = None
        self.wire_bytes = 0
        if compression:
            _name, self._compress = member_compressor(compression)

    def write(self, data: bytes) -> None:
        if self._compress is not None:
            data = self._compress(bytes(data))
        self._f.write(data)
        self.wire_bytes += len(data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


def _digit_matrix(values: np.ndarray, digits: int) -> np.ndarray:
    """|values| as [n, digits] decimal digits, most significant first."""
    v = np.abs(values.astype(np.int64))
    return (v[:, None] // 10 ** np.arange(digits - 1, -1, -1,
                                          dtype=np.int64)) % 10


def _comp3_signed(values: np.ndarray, digits: int) -> np.ndarray:
    """[n] ints -> [n, digits//2+1] packed decimal, sign nibble C/D."""
    n = len(values)
    width = digits // 2 + 1
    stream = np.zeros((n, width * 2), dtype=np.uint8)
    pad = 1 if digits % 2 == 0 else 0
    stream[:, pad:pad + digits] = _digit_matrix(values, digits)
    stream[:, -1] = np.where(values < 0, 0x0D, 0x0C)
    return (stream[:, 0::2] << 4) | stream[:, 1::2]


def _zoned_signed(values: np.ndarray, digits: int) -> np.ndarray:
    """[n] ints -> [n, digits] EBCDIC zoned decimal, the sign overpunched
    on the last digit (zone C positive, D negative)."""
    out = (0xF0 + _digit_matrix(values, digits)).astype(np.uint8)
    out[:, -1] = np.where(values < 0, 0xD0, 0xC0) + (out[:, -1] - 0xF0)
    return out


def _text(values, width: int) -> np.ndarray:
    return encode_strings_column(list(values), width, pad=0x40)


def _text_of(vocab: Sequence[str], idx: np.ndarray,
             width: int) -> np.ndarray:
    """`_text(vocab[i] for i in idx)`'s bytes, each distinct value
    encoded once."""
    return _text(vocab, width)[idx]


def _numbered_text(prefix: str, values: np.ndarray, digits: int,
                   width: int) -> np.ndarray:
    """`_text(f"{prefix}{v:0{digits}d}" for v in values)`'s bytes for
    0 <= v < 10 ** digits, built with numpy."""
    out = np.full((len(values), width), 0x40, dtype=np.uint8)
    out[:, :len(prefix)] = _text([prefix], len(prefix))[0]
    digit_bytes = _text("0123456789", 1)[:, 0]
    out[:, len(prefix):len(prefix) + digits] = digit_bytes[
        _digit_matrix(values, digits)]
    return out


def write_fixed_corpus(path: str, num_records: int, *, seed: int = 7,
                       chunk_records: int = 262144,
                       distinct_accounts: int = 1000,
                       status_weights: Optional[Sequence[float]] = None,
                       compression: Optional[str] = None,
                       ) -> Dict[str, int]:
    """Stream `num_records` fixed-length TXN records to `path`. With
    `compression` (a codec name the io.compress registry knows) each
    flushed chunk becomes one compressed member. Returns {records,
    bytes, record_size} — `bytes` is the DECOMPRESSED payload size;
    `wire_bytes` joins it when compressed."""
    rng = np.random.default_rng(seed)
    accounts = [f"ACC{i:07d}" for i in range(distinct_accounts)]
    weights = None
    if status_weights is not None:
        weights = np.asarray(status_weights, dtype=np.float64)
        weights = weights / weights.sum()
    written = 0
    total = 0
    with _CorpusSink(path, compression) as f:
        while written < num_records:
            n = min(chunk_records, num_records - written)
            rec = np.concatenate([
                encode_comp_be(np.arange(written, written + n), 4),
                _text_of(accounts,
                         rng.integers(0, distinct_accounts, size=n), 10),
                _text_of(_CURRENCIES,
                         rng.integers(0, len(_CURRENCIES), size=n), 3),
                _comp3_signed(rng.integers(-10 ** 11 + 1, 10 ** 11,
                                           size=n), 11),
                _zoned_signed(rng.integers(-10 ** 9 + 1, 10 ** 9,
                                           size=n), 9),
                _text_of(_STATUSES,
                         rng.choice(len(_STATUSES), size=n, p=weights), 1),
                encode_comp_be(rng.integers(0, 10 ** 4, size=n), 2),
            ], axis=1)
            data = rec.tobytes()
            f.write(data)
            written += n
            total += len(data)
    out = {"records": written, "bytes": total,
           "record_size": TXN_RECORD_SIZE}
    if compression:
        out["wire_bytes"] = f.wire_bytes
    return out


def _interleave_positions(contacts: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Final-sequence row positions for c parent rows followed by their
    `contacts[i]` child rows each."""
    c = len(contacts)
    before = np.concatenate(([0], np.cumsum(contacts)[:-1]))
    pos_c = np.arange(c, dtype=np.int64) + before
    k_total = int(contacts.sum())
    within = np.arange(k_total, dtype=np.int64) - np.repeat(before,
                                                            contacts)
    pos_p = np.repeat(pos_c + 1, contacts) + within
    return pos_c, pos_p


def _rdw_headers(length: int, n: int, big_endian: bool) -> np.ndarray:
    hdr = (bytes([length >> 8, length & 0xFF, 0, 0]) if big_endian
           else bytes([0, 0, length & 0xFF, length >> 8]))
    return np.tile(np.frombuffer(hdr, dtype=np.uint8), (n, 1))


def write_multiseg_corpus(path: str, num_companies: int, *,
                          seed: int = 7, chunk_companies: int = 131072,
                          contacts_per_company: Tuple[int, int] = (0, 4),
                          big_endian_rdw: bool = False,
                          compression: Optional[str] = None
                          ) -> Dict[str, int]:
    """Stream an RDW-framed COMPANY/CONTACT corpus to `path`. The
    contact range drives both the segment mix and the record-length
    distribution. With `compression` each flushed chunk becomes one
    compressed member. Returns {records, companies, contacts, bytes}
    (plus `wire_bytes` when compressed)."""
    len_c, len_p = 30 + 4, 56 + 4
    rng = np.random.default_rng(seed)
    lo, hi = contacts_per_company
    names = [f"Company {i:05d} Ltd."[:15] for i in range(500)]
    people = [f"Contact Person {i:04d}" for i in range(500)]
    done = 0
    records = 0
    contacts_total = 0
    total = 0
    with _CorpusSink(path, compression) as f:
        while done < num_companies:
            c = min(chunk_companies, num_companies - done)
            k = rng.integers(lo, hi + 1, size=c)
            kt = int(k.sum())
            ids = _numbered_text("C", np.arange(done, done + c), 9, 10)
            mat_c = np.concatenate([
                _rdw_headers(len_c - 4, c, big_endian_rdw),
                _text_of("C", np.zeros(c, dtype=np.int64), 1), ids,
                _text_of(names, rng.integers(0, len(names), size=c), 15),
                encode_comp_be(rng.integers(0, 10 ** 8, size=c), 4),
            ], axis=1)
            pos_c, pos_p = _interleave_positions(k)
            lens = np.empty(c + kt, dtype=np.int64)
            lens[pos_c] = len_c
            lens[pos_p] = len_p
            offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
            buf = np.empty(int(lens.sum()), dtype=np.uint8)
            buf[(offs[pos_c][:, None]
                 + np.arange(len_c)).ravel()] = mat_c.ravel()
            if kt:
                phones = _numbered_text(
                    "+", rng.integers(0, 10 ** 12, size=kt), 14, 17)
                mat_p = np.concatenate([
                    _rdw_headers(len_p - 4, kt, big_endian_rdw),
                    _text_of("P", np.zeros(kt, dtype=np.int64), 1),
                    np.repeat(ids, k, axis=0), phones,
                    _text_of(people,
                             rng.integers(0, len(people), size=kt), 28),
                ], axis=1)
                buf[(offs[pos_p][:, None]
                     + np.arange(len_p)).ravel()] = mat_p.ravel()
            f.write(buf.tobytes())
            done += c
            records += c + kt
            contacts_total += kt
            total += buf.nbytes
    out = {"records": records, "companies": done,
           "contacts": contacts_total, "bytes": total}
    if compression:
        out["wire_bytes"] = f.wire_bytes
    return out


def corrupt_fixed_corpus(data: bytes, *, count: int = 3, seed: int = 0,
                         kinds: Sequence[str] = ("sign-nibble",
                                                 "packed-digit",
                                                 "torn-write")
                         ) -> Tuple[bytes, List[Dict[str, object]]]:
    """Damage `count` records of a TXN corpus per kind (torn-write
    always tears the file tail). Returns (corrupted, sites)."""
    from ..copybook.copybook import parse_copybook
    from .faults import corrupt_record, field_site

    cb = parse_copybook(TXN_COPYBOOK)
    rec = cb.record_size
    amount = field_site(cb, "AMOUNT")
    n = len(data) // rec
    rng = np.random.default_rng(seed)
    out = bytearray(data)
    sites: List[Dict[str, object]] = []
    body_kinds = [k for k in kinds if k != "torn-write"]
    picks = rng.choice(n - 1, size=min(count * len(body_kinds), n - 1),
                       replace=False) if body_kinds else []
    for i, idx in enumerate(picks):
        kind = body_kinds[i % len(body_kinds)]
        start = int(idx) * rec
        out[start:start + rec] = corrupt_record(
            bytes(out[start:start + rec]), kind, site=amount)
        sites.append({"record": int(idx), "kind": kind,
                      "offset": start + amount[0]})
    if "torn-write" in kinds:
        keep = (n - 1) * rec + rec * 2 // 3
        out = out[:keep]
        sites.append({"record": n - 1, "kind": "torn-write",
                      "offset": keep})
    return bytes(out), sites
