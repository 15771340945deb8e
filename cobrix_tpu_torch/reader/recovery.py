"""Header resynchronization: recover record framing after corruption.

Port copy of ``cobrix_tpu.reader.recovery``. Changes: the JAX package's
`rdw_scan_permissive` re-drives its native host scan; here it re-drives
`rdw_scan_host`, a copy of that scan's numpy walk
(``cobrix_tpu.native.rdw_scan``), and it is the *plain version* of the
port's permissive RDW framing, which runs the scan kernel on the device
window by window (``reader.var_len_reader.frame_windows``) and calls
`find_next_rdw` and `truncated_tail` below for the same decisions.
`truncated_tail` is the JAX function's truncated-last-record rule, taken
out so both framings share it.

Real mainframe dumps contain bit rot, torn tails and garbage splices; a
fail-fast frame chain turns one bad RDW into a dead file. In the
permissive policies the framers recover instead: on an invalid header
they scan forward within a bounded window (``resync_window_bytes``,
default 64 KB) for the next *plausible* header — one whose length parses
and whose implied next header also parses (or lands exactly on EOF) —
record the skipped byte range in the read's ledger, and resume. A corrupt
run longer than the window is a hard error even in permissive modes, so a
completely garbage file still fails promptly with a clear message.

Two framing planes share the same resync rules:

  * :func:`rdw_scan_permissive` — the whole-shard vectorized plane: wraps
    the native ``rdw_scan`` and re-drives it across corrupt regions using
    a vectorized candidate search (clean files cost one native call, same
    as fail-fast).
  * :class:`PendingReader` + :func:`resync_stream` — the per-record
    stream plane (custom header parsers, length fields, the host oracle
    path): a small pushback wrapper so bytes read ahead during a resync
    are re-served to the normal framing loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..copybook.datatypes import MAX_RDW_RECORD_SIZE
from .diagnostics import (
    CorruptRecordInfo,
    FramingError,
    ReadDiagnostics,
    RecordErrorPolicy,
    framing_error,
    hex_snapshot,
)
from .stream import SimpleStream


def rdw_scan_host(data, big_endian: bool, rdw_adjustment: int = 0,
                  file_header_bytes: int = 0, file_footer_bytes: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """All RDW record (payload offset, length) pairs of a file image, one
    header at a time on the host (``cobrix_tpu.native.rdw_scan``'s numpy
    walk). Raises the JAX package's FramingError on a zero or oversized
    header."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    raw = buf.tobytes()
    size = len(raw)
    pos = 0
    body_end = (size - file_footer_bytes
                if 0 < file_footer_bytes < size else size)
    out_o, out_l = [], []
    hi, lo = (0, 1) if big_endian else (3, 2)
    while pos + 4 <= body_end:
        if file_header_bytes > 4 and pos == 0:
            pos = file_header_bytes
            continue
        ln = raw[pos + lo] + 256 * raw[pos + hi] + rdw_adjustment
        if ln <= 0:
            raise framing_error(raw[pos:pos + 4], pos, "zero")
        if ln > MAX_RDW_RECORD_SIZE:
            raise framing_error(raw[pos:pos + 4], pos, "big")
        out_o.append(pos + 4)
        out_l.append(min(ln, body_end - (pos + 4)))
        pos += 4 + ln
    return (np.asarray(out_o, dtype=np.int64),
            np.asarray(out_l, dtype=np.int64))


def _rdw_lengths_at(buf: np.ndarray, positions: np.ndarray,
                    big_endian: bool, adjustment: int) -> np.ndarray:
    """Parsed RDW length at each candidate position (vectorized)."""
    if big_endian:
        lens = buf[positions + 1].astype(np.int64) \
            + 256 * buf[positions].astype(np.int64)
    else:
        lens = buf[positions + 2].astype(np.int64) \
            + 256 * buf[positions + 3].astype(np.int64)
    return lens + adjustment


def _rdw_reserved_zero(buf: np.ndarray, positions: np.ndarray,
                       big_endian: bool) -> np.ndarray:
    """True where the RDW's reserved byte pair is zero (bytes 2-3 for
    big-endian, 0-1 for little-endian). The record parser itself stays
    lax (mirroring the reference), but for RESYNC plausibility this is
    the discriminator that keeps EBCDIC payload bytes — which routinely
    parse as large-but-valid lengths — from hijacking the scan: a
    payload-aligned candidate chain dies at its first successor, whose
    reserved pair is payload too."""
    if big_endian:
        reserved = buf[positions + 2] | buf[positions + 3]
    else:
        reserved = buf[positions] | buf[positions + 1]
    return reserved == 0


# How many successor headers a resync candidate must chain through before
# it is believed. Payload/garbage bytes regularly parse as ONE valid
# header, so a single-successor check mis-resyncs; requiring the chain to
# survive 3 successors (or land exactly on EOF) rejects those while still
# accepting a real record start even when ANOTHER corrupt site lies a few
# records ahead (deeper checks would reject everything between two nearby
# corruption sites, swallowing good records).
RESYNC_CHAIN_DEPTH = 3
GENERIC_CHAIN_DEPTH = 3


def find_next_rdw(buf: np.ndarray, start: int, end: int, big_endian: bool,
                  adjustment: int,
                  body_end: Optional[int] = None,
                  depth: int = RESYNC_CHAIN_DEPTH) -> Optional[int]:
    """First plausible RDW header position in ``buf[start:end)``.

    Plausible: the length parses into (0, MAX_RDW_RECORD_SIZE] and the
    implied header chain stays parseable for ``depth`` successors - or
    lands exactly on ``body_end`` first. With ``body_end`` of None the
    buffer is a window into a longer stream: a chain running past the
    window is unverifiable and accepted (the caller's framing loop
    re-validates it live). Deep chaining keeps payload bytes that happen
    to parse as one valid header from hijacking the resync.
    """
    limit = len(buf) if body_end is None else body_end
    end = min(end, limit - 3)
    if end <= start:
        return None
    cand = np.arange(start, end, dtype=np.int64)
    lens = _rdw_lengths_at(buf, cand, big_endian, adjustment)
    alive = (lens > 0) & (lens <= MAX_RDW_RECORD_SIZE) \
        & _rdw_reserved_zero(buf, cand, big_endian)
    confirmed = np.zeros(len(cand), dtype=bool)
    escaped = np.zeros(len(cand), dtype=bool)
    overshoot = np.full(len(cand), np.inf)
    pos = cand + 4 + lens  # each candidate's next-header position
    for _ in range(depth):
        if body_end is not None:
            confirmed |= alive & (pos == limit)
        # chain leaves the buffer before `depth` successors. Mid-stream
        # (no body_end) that is unverifiable; at/with a true end it is a
        # candidate whose final record overruns the data — a truncated
        # tail. Both are kept only as a fallback below, so a
        # payload-parsed giant length cannot outrank a candidate whose
        # chain verifies inside the buffer, yet a lone truncated final
        # record after a corrupt run is still recovered (and then
        # clamped + ledgered by the framing layer) rather than silently
        # swallowed into the skip.
        escaping = alive & ~confirmed & (pos + 4 > limit)
        overshoot[escaping] = pos[escaping] - limit
        escaped |= escaping
        alive &= ~confirmed & ~escaped
        if not alive.any():
            break
        safe = np.minimum(np.where(alive, pos, 0), limit - 4)
        nxt_lens = _rdw_lengths_at(buf, safe, big_endian, adjustment)
        alive &= (nxt_lens > 0) & (nxt_lens <= MAX_RDW_RECORD_SIZE) \
            & _rdw_reserved_zero(buf, safe, big_endian)
        pos = pos + 4 + nxt_lens
    hits = np.nonzero(confirmed | alive)[0]
    if len(hits):
        return int(cand[hits[0]])
    hits = np.nonzero(escaped)[0]
    if not len(hits):
        return None
    if body_end is None:
        return int(cand[hits[0]])
    # with the true end in view, the least-overshooting chain is the
    # plausible truncated tail; a payload-parsed giant length overshoots
    # by ~its whole bogus record
    return int(cand[hits[np.argmin(overshoot[hits])]])


def rdw_scan_permissive(data, big_endian: bool, adjustment: int,
                        file_header_bytes: int, file_footer_bytes: int,
                        policy: RecordErrorPolicy,
                        window: int,
                        ledger: ReadDiagnostics,
                        file_name: str = "",
                        base_offset: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Whole-shard RDW framing that survives corrupt headers.

    Drives the native ``rdw_scan`` across corrupt regions: on a framing
    error the clean prefix is kept, the corrupt run is skipped via
    :func:`find_next_rdw` (bounded by ``window``), and every incident is
    recorded in ``ledger``. Returns ``(offsets, lengths, corrupt_reasons)``
    where ``corrupt_reasons`` maps kept record positions to the reason a
    record is malformed (truncated tail); under ``drop_malformed`` those
    records are already removed from the output arrays.

    Byte offsets in ledger entries are absolute file offsets
    (``base_offset`` + buffer position).
    """
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    size = buf.size
    body_end = size - file_footer_bytes \
        if 0 < file_footer_bytes < size else size
    resume = 0
    parts_off, parts_len = [], []

    def scan_clean(lo: int, hi: int, header_bytes: int):
        if hi <= lo:
            return
        o, l = rdw_scan_host(buf[lo:hi], big_endian, adjustment,
                             header_bytes, 0)
        if len(o):
            parts_off.append(o + lo)
            parts_len.append(l)

    while resume < body_end:
        header_bytes = file_header_bytes if resume == 0 else 0
        try:
            scan_clean(resume, body_end, header_bytes)
            break
        except FramingError as exc:
            err = resume + max(exc.offset, 0)
            # the prefix up to the bad header is clean by construction
            scan_clean(resume, err, header_bytes)
            snapshot = bytes(buf[err:err + 4])
            nxt = find_next_rdw(buf, err + 1, err + 1 + window, big_endian,
                                adjustment, body_end)
            if nxt is None:
                remaining = body_end - err
                if remaining > window:
                    raise FramingError(
                        f"Corrupt run at offset {base_offset + err} of "
                        f"'{file_name}' exceeds the resync window "
                        f"({window} bytes) with no plausible record header "
                        f"found (headers = {hex_snapshot(snapshot)}); "
                        "increase 'resync_window' or fix the input.",
                        offset=base_offset + err, header=snapshot,
                        file_name=file_name) from exc
                ledger.record_skip(file_name, base_offset + err, remaining,
                                   exc.reason, snapshot)
                break
            ledger.record_skip(file_name, base_offset + err, nxt - err,
                               exc.reason, snapshot)
            resume = nxt

    if parts_off:
        offsets = np.concatenate(parts_off)
        lengths = np.concatenate(parts_len)
    else:
        offsets = np.zeros(0, dtype=np.int64)
        lengths = np.zeros(0, dtype=np.int64)

    offsets, lengths, corrupt_reasons = truncated_tail(
        buf, offsets, lengths, big_endian, adjustment, policy, ledger,
        file_name, base_offset)
    return offsets, lengths, corrupt_reasons


def truncated_tail(buf: np.ndarray, offsets: np.ndarray,
                   lengths: np.ndarray, big_endian: bool, adjustment: int,
                   policy: RecordErrorPolicy, ledger: ReadDiagnostics,
                   file_name: str = "", base_offset: int = 0,
                   first: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                            Dict[int, str]]:
    """The truncated-last-record rule of the permissive framings: a last
    record (at `offsets[-1]`, buffer-relative; record position `first` +
    its index) clamped against the end of the data was truncated (its
    header declared more bytes than the data holds). It is ledgered;
    `drop_malformed` drops it from the arrays, `permissive` keeps it and
    gives its reason. Returns (offsets, lengths, {position: reason})."""
    corrupt_reasons: Dict[int, str] = {}
    if len(offsets):
        # a record clamped against end-of-data was truncated: its header
        # declared more bytes than the file holds
        last = len(offsets) - 1
        declared = int(_rdw_lengths_at(
            buf, np.asarray(offsets[last:last + 1]) - 4, big_endian,
            adjustment)[0])
        actual = int(lengths[last])
        if declared > actual:
            pos = int(offsets[last])
            reason = (f"record truncated at end of data: header declares "
                      f"{declared} bytes, {actual} available")
            ledger.record(
                _truncation_entry(file_name, base_offset + pos - 4,
                                  reason, bytes(buf[pos - 4:pos]),
                                  None if policy is RecordErrorPolicy.
                                  DROP_MALFORMED else first + last),
                dropped=policy is RecordErrorPolicy.DROP_MALFORMED)
            if policy is RecordErrorPolicy.DROP_MALFORMED:
                offsets = offsets[:last]
                lengths = lengths[:last]
            else:
                corrupt_reasons[first + last] = reason
    return offsets, lengths, corrupt_reasons


def _truncation_entry(file_name: str, offset: int, reason: str,
                      header: bytes, record_index: Optional[int]):
    return CorruptRecordInfo(file_name, offset, 0, reason,
                             hex_snapshot(header), record_index)


class PendingReader:
    """Forward reads over a SimpleStream with pushback: bytes read ahead
    during a resync are re-served before the stream is touched again."""

    __slots__ = ("stream", "_pending")

    def __init__(self, stream: SimpleStream):
        self.stream = stream
        self._pending = b""

    @property
    def offset(self) -> int:
        return self.stream.offset - len(self._pending)

    @property
    def at_end(self) -> bool:
        return not self._pending and self.stream.is_end_of_stream

    def push_back(self, data: bytes) -> None:
        self._pending = bytes(data) + self._pending

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if self._pending:
            head = self._pending[:n]
            self._pending = self._pending[n:]
            if len(head) == n:
                return head
            return head + self.stream.next(n - len(head))
        return self.stream.next(n)


def rdw_blob_validator(parser) -> Callable[[bytes, int, bool], Optional[int]]:
    """Candidate validator over a resync blob for RDW headers: vectorized
    search delegated to :func:`find_next_rdw`. When the blob reaches the
    end of the stream (`at_eof`) the chain rules match the whole-file
    scan exactly, so the stream and vectorized planes resync identically."""

    def first_plausible(blob: bytes, start: int,
                        at_eof: bool) -> Optional[int]:
        buf = np.frombuffer(blob, dtype=np.uint8)
        return find_next_rdw(buf, start, len(blob), parser.is_big_endian,
                             parser.rdw_adjustment,
                             body_end=len(blob) if at_eof else None)

    return first_plausible


def generic_blob_validator(parser, file_size: int, base_offset: int
                           ) -> Callable[[bytes, int, bool], Optional[int]]:
    """Candidate validator for arbitrary header parsers: a position is
    plausible when the parser yields a positive record length there and
    the implied header chain stays parseable for GENERIC_CHAIN_DEPTH
    successors (or exits the blob — exactly at its end when `at_eof`)."""
    hlen = parser.header_length

    def meta_len(blob: bytes, k: int) -> Optional[int]:
        try:
            meta = parser.get_record_metadata(
                blob[k:k + hlen], base_offset + k + hlen, file_size, 0)
        except ValueError:
            return None
        return meta.record_length if meta.record_length > 0 else None

    def chains(blob: bytes, k: int, at_eof: bool) -> bool:
        q = k
        for _ in range(GENERIC_CHAIN_DEPTH + 1):
            if q == len(blob) and at_eof:
                return True
            if q + hlen > len(blob):
                return not at_eof  # unverifiable: accept mid-stream only
            ln = meta_len(blob, q)
            if ln is None:
                return False
            q = q + hlen + ln
        return True

    def first_plausible(blob: bytes, start: int,
                        at_eof: bool) -> Optional[int]:
        for k in range(start, len(blob) - hlen + 1):
            if chains(blob, k, at_eof):
                return k
        return None

    return first_plausible


def resync_stream(reader: PendingReader, bad_header: bytes,
                  first_plausible: Callable[[bytes, int, bool],
                                            Optional[int]],
                  header_length: int, window: int,
                  ledger: ReadDiagnostics, file_name: str,
                  reason: str) -> Optional[bytes]:
    """Skip a corrupt run on the stream plane and return the next
    plausible header's bytes (the remainder of the read-ahead blob is
    pushed back). None means the corrupt run reaches end-of-stream (the
    remaining bytes were skipped and ledgered). Raises FramingError when
    the run exceeds the window mid-stream.
    """
    bad_offset = reader.offset - len(bad_header)
    blob = bytes(bad_header) + reader.read(window)
    at_eof = len(blob) < window + len(bad_header)
    found = (first_plausible(blob, 1, at_eof)
             if len(blob) > header_length else None)
    if found is None:
        if at_eof:
            if len(blob):
                ledger.record_skip(file_name, bad_offset, len(blob), reason,
                                   blob[:4])
            return None
        raise FramingError(
            f"Corrupt run at offset {bad_offset} of '{file_name}' exceeds "
            f"the resync window ({window} bytes) with no plausible record "
            f"header found (headers = {hex_snapshot(blob[:4])}); increase "
            "'resync_window' or fix the input.",
            offset=bad_offset, header=blob[:4], file_name=file_name)
    ledger.record_skip(file_name, bad_offset, found, reason, blob[:4])
    header = blob[found:found + header_length]
    reader.push_back(blob[found + header_length:])
    return header
