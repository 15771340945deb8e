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
for the block, index, stats and compress planes; the encoder-aware
record damage (`field_site`, `corrupt_record`); and the one-shot sink's
faults (`SinkKilled`, `SinkFaultPlan`, `SINK_KILL_POINTS`,
`corrupt_sink_manifest`, `sink_write_faults`); the live-source faults
of continuous ingestion (`LiveAppender`, `rotate_source`,
`truncate_source`, `replace_source`, `crash_consumer_after`) and the
checkpoint plane of `corrupt_cache_entry`. The worker faults are not
carried over, since the port has no such plane yet.

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
    payloads), 'compress' (seekable inflate-index .json payloads),
    'checkpoint' (continuous-ingest watermark slots — pass the
    CHECKPOINT directory)."""
    if plane == "checkpoint":
        from ..streaming.checkpoint import checkpoint_files

        return checkpoint_files(cache_dir)
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


# -- encoder-aware record corruption --------------------------------------
#
# The injectors above damage FRAMING (headers, tails, splices). The
# helpers below damage the *content* of one record in ways only a
# decoder notices — an invalid packed sign nibble, a non-digit BCD
# nibble, a segment id no redefine maps — plus the two framing flavors
# a per-record corruptor needs (RDW length damage, mid-record torn
# write). Each damage class has a SPECIFIC observable diagnostic, which
# the damage tests assert per kind:
#
#   sign-nibble   the damaged COMP-3 field decodes to None (0x0A is not
#                 a sign), neighbors intact;
#   packed-digit  same field-level None (a nibble >= 0x0A is not a
#                 digit);
#   rdw-length    zeroed header => "zero-length RDW header" resync
#                 ledger entry; oversized => clamped-tail truncation;
#   segment-id    no redefine branch matches => every segment column
#                 of the row is None;
#   torn-write    the record's tail is lost mid-field => permissive
#                 nulls the tail and ledgers a truncation.

CORRUPT_RECORD_KINDS = ("sign-nibble", "packed-digit", "rdw-length",
                        "segment-id", "torn-write")


def field_site(copybook, field_name: str):
    """(byte_offset, byte_size) of a named primitive inside one record
    — the encoder-aware aim point for `corrupt_record`. Accepts
    copybook text or a parsed `Copybook`."""
    from ..copybook.ast import transform_identifier
    from ..copybook.copybook import parse_copybook

    if isinstance(copybook, str):
        copybook = parse_copybook(copybook)
    want = transform_identifier(field_name)
    for st in copybook.ast.walk_primitives():
        if st.name == want:
            return (st.binary_properties.offset,
                    st.binary_properties.data_size)
    raise KeyError(f"no primitive named {field_name!r} in copybook")


def corrupt_record(record: bytes, kind: str, *, site=None,
                   header: bool = False, big_endian: bool = False,
                   seed: int = 0) -> bytes:
    """Damage ONE record's bytes in an encoder-aware way and return the
    corrupted record. `site` is the (offset, size) of the targeted field
    *within the record body* (from `field_site`); `header=True` means
    `record` starts with its own 4-byte RDW (sites shift by 4, and
    'rdw-length' is applicable). `kind` is one of CORRUPT_RECORD_KINDS.
    """
    out = bytearray(record)
    base = 4 if header else 0
    if kind == "sign-nibble":
        off, size = site
        pos = base + off + size - 1  # sign lives in the final nibble
        out[pos] = (out[pos] & 0xF0) | 0x0A  # 0xA: not C/D/F
    elif kind == "packed-digit":
        off, size = site
        pos = base + off  # first digit byte
        out[pos] = 0xBB   # nibbles 0xB: not decimal digits
    elif kind == "rdw-length":
        if not header:
            raise ValueError("rdw-length damage needs header=True "
                             "(the record must carry its own RDW)")
        out[0:4] = b"\x00\x00\x00\x00" if seed % 2 == 0 else (
            b"\xff\xff\x00\x00" if big_endian else b"\x00\x00\xff\xff")
    elif kind == "segment-id":
        off, size = site
        # 0x5A..: EBCDIC punctuation — never a mapped segment id value
        for i in range(size):
            out[base + off + i] = 0x5A
    elif kind == "torn-write":
        keep = base + max(1, (len(record) - base) * 2 // 3)
        return bytes(out[:keep])
    else:
        raise ValueError(f"unknown corruption kind {kind!r}; one of "
                         f"{CORRUPT_RECORD_KINDS}")
    return bytes(out)


# -- live-source fault injection -----------------------------------------
#
# The injectors below break LIVE sources, not static bytes: the
# continuous-ingest tailer (cobrix_tpu_torch.streaming) must survive files
# that grow in torn non-record-aligned increments, rotate under it,
# shrink below its watermark, and consumers that die mid-stream. Driven
# by the port's streaming tests and ``testing.streamcheck``.


class LiveAppender:
    """Background thread growing a file in TORN increments: appends are
    deliberately cut at non-record boundaries (and optionally fsync'd
    mid-record with a pause), so the tailer's stable-prefix framing is
    exercised against every partial-record shape a live writer
    produces.

        app = LiveAppender(path, payload, slice_sizes=(7, 3, 12))
        app.start(); ...; app.join()

    `slice_sizes` cycles; when exhausted the remainder goes out in one
    write. `pause_s` sleeps between appends (0 = as fast as possible).
    """

    def __init__(self, path: str, payload: bytes,
                 slice_sizes=(5, 1, 9, 2), pause_s: float = 0.02,
                 fsync: bool = False):
        import threading

        self.path = str(path)
        self.payload = payload
        self.slice_sizes = tuple(slice_sizes)
        self.pause_s = pause_s
        self.fsync = fsync
        self.appended = 0
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import itertools
        import time

        sizes = itertools.cycle(self.slice_sizes)
        pos = 0
        with open(self.path, "ab") as f:
            while pos < len(self.payload):
                n = min(next(sizes), len(self.payload) - pos)
                f.write(self.payload[pos:pos + n])
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
                pos += n
                self.appended = pos
                if self.pause_s:
                    time.sleep(self.pause_s)

    def start(self) -> "LiveAppender":
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()


def rotate_source(path: str, new_content: bytes,
                  rotated_suffix: str = ".1") -> str:
    """Classic rename rotation: the current file moves to
    ``path + rotated_suffix`` (same inode, same content) and a NEW file
    with `new_content` appears at `path`. Returns the rotated-away
    path. The tailer must drain the old generation exactly once (via
    its held descriptor or the inode-matched alias) before switching."""
    rotated = path + rotated_suffix
    os.replace(path, rotated)
    with open(path, "wb") as f:
        f.write(new_content)
    return rotated


def truncate_source(path: str, keep_bytes: int) -> None:
    """Shrink a live file in place below (presumably) the consumer's
    watermark — the copy-truncate / operator-mistake shape that must
    surface as a structured ``source_truncated`` outcome, never as
    silently wrong rows."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def replace_source(path: str, new_content: bytes) -> None:
    """In-place content replacement keeping the path (and usually the
    inode): the rotation flavor only the head-CRC check can detect
    when the new content is not shorter than the watermark."""
    with open(path, "wb") as f:
        f.write(new_content)


def crash_consumer_after(batches: int):
    """A consumer-side crash hook: returns a callable to invoke once
    per delivered batch; on the N-th call the PROCESS dies via
    ``os._exit`` — no exception, no cleanup, no atexit — exactly how
    SIGKILL/OOM ends an ingesting worker. For in-process tests prefer
    simply abandoning the ingestor (same recovery path, no subprocess);
    subprocess harnesses (``testing.streamcheck``) use this."""
    state = {"n": 0}

    def hook() -> None:
        state["n"] += 1
        if state["n"] >= batches:
            os._exit(137)
    return hook


# -- lakehouse-sink fault injection --------------------------------------
#
# The injectors below break the TRANSACTIONAL SINK (`sink`):
# consumers killed between staging a data file and committing its
# manifest record, manifest records torn or bit-flipped on disk, and
# dataset volumes that fail writes — a crash matrix drives the commit
# protocol's recovery through every window with them. Once-markers use
# an O_EXCL cross-process claim: a RESTARTED consumer re-
# installs the plan, but the marker guarantees each fault fires exactly
# once across the whole kill/restart sequence.

SINK_KILL_POINTS = ("pre_stage", "post_stage", "pre_commit",
                    "post_commit")


class SinkKilled(Exception):
    """Raised by a SinkFaultPlan in ``action='raise'`` mode — the
    in-process stand-in for SIGKILL (the commit is abandoned exactly
    where the kill landed; recovery runs on the next sink open)."""


class SinkFaultPlan:
    """Kill plan keyed by commit kill-window (and optionally commit
    seq). ``action='exit'`` dies via ``os._exit(137)`` (subprocess
    harnesses); ``action='raise'`` raises
    `SinkKilled` (in-process tests: abandon the sink, reopen it, and
    check what recovery left).

        plan = SinkFaultPlan(state_dir, action="raise")
        plan.kill("pre_commit")          # first commit reaching the
                                         # stage-write→manifest window
        plan.kill("post_commit", seq=3)  # commit #3, after the append,
                                         # before the ack
        with plan.installed():
            DatasetSink(dataset_dir, ...).commit_table(table)
    """

    def __init__(self, state_dir: str, action: str = "exit"):
        if action not in ("exit", "raise"):
            raise ValueError(f"action must be 'exit' or 'raise', "
                             f"got {action!r}")
        self.state_dir = str(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.action = action
        self._kills: dict = {}

    def kill(self, point: str, seq: Optional[int] = None,
             once: bool = True) -> "SinkFaultPlan":
        if point not in SINK_KILL_POINTS:
            raise ValueError(f"unknown sink kill point {point!r}; "
                             f"one of {SINK_KILL_POINTS}")
        self._kills[(point, seq)] = once
        return self

    def _marker(self, point: str, seq: Optional[int]) -> str:
        return os.path.join(self.state_dir,
                            f"sink_fault_{point}_{seq or 'any'}")

    def fired(self, point: str, seq: Optional[int] = None) -> bool:
        return os.path.exists(self._marker(point, seq))

    def _claim(self, point: str, seq: Optional[int]) -> bool:
        try:
            fd = os.open(self._marker(point, seq),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def __call__(self, point: str, seq: int) -> None:
        for key in ((point, seq), (point, None)):
            if key not in self._kills:
                continue
            once = self._kills[key]
            if once and not self._claim(*key):
                continue
            if not once:
                self._claim(*key)  # fired() breadcrumb
            if self.action == "exit":
                os._exit(137)
            raise SinkKilled(
                f"injected sink kill at {point} (commit seq {seq})")

    def installed(self):
        """Context manager installing this plan as the sink fault hook
        (uninstalled on exit, even on test failure)."""
        import contextlib

        from ..sink.writer import set_sink_fault_hook

        @contextlib.contextmanager
        def _ctx():
            set_sink_fault_hook(self)
            try:
                yield self
            finally:
                set_sink_fault_hook(None)
        return _ctx()


def corrupt_sink_manifest(dataset_dir: str, mode: str = "bitflip",
                          which: int = -1) -> str:
    """Corrupt one record of a LOCAL sink dataset's manifest in place;
    returns the manifest path.

    * ``mode='bitflip'`` — flip one bit inside record `which` (default
      the last record; the CRC stamp must catch it even when the JSON
      stays parseable);
    * ``mode='torn'`` — tear the manifest mid-way through record
      `which` (a crashed appender / lost tail page).

    Recovery must treat damage past the checkpointed position as a
    self-healing truncation and damage inside it as loud
    `SinkCorruption` — never silence, never replay."""
    from ..sink.manifest import MANIFEST_NAME

    path = os.path.join(dataset_dir, MANIFEST_NAME)
    data = open(path, "rb").read()
    lines = data.split(b"\n")[:-1]  # trailing "" after final newline
    if not lines:
        raise FileNotFoundError(f"no manifest records under {path}")
    idx = which % len(lines)
    start = sum(len(ln) + 1 for ln in lines[:idx])
    if mode == "bitflip":
        # flip a LOW bit inside the record's payload region (past the
        # opening brace, ahead of the newline) so the line often stays
        # valid JSON — only the CRC can catch it
        pos = start + min(len(lines[idx]) - 2, 20)
        data = flip_bit(data, pos, bit=0)
    elif mode == "torn":
        data = data[:start + max(1, len(lines[idx]) // 2)]
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(data)
    return path


class sink_write_faults:
    """Context manager making every DATASET-VOLUME write fail the way
    a full or read-only volume does (``mode='enospc'`` => OSError
    ENOSPC, ``mode='readonly'`` => OSError EROFS) while reads keep
    working. Patches the sink writer's durable-write call sites
    (`_local_write` staging/meta writes, `_local_append` manifest
    appends)::

        with sink_write_faults("enospc"):
            sink.commit_table(table)   # raises ENOSPC, NOTHING
                                       # half-committed

    The contract under test: unlike cache planes, the sink must fail
    LOUDLY (an un-persistable commit must never be acked) and
    atomically (the manifest is unchanged; recovery quarantines any
    finalized-but-unreferenced files)."""

    def __init__(self, mode: str = "enospc",
                 fail_writes: bool = True, fail_appends: bool = True):
        import errno

        self.errno = {"enospc": errno.ENOSPC,
                      "readonly": errno.EROFS}[mode]
        self.mode = mode
        self.write_attempts = 0
        self.append_attempts = 0
        self.fail_writes = fail_writes
        self.fail_appends = fail_appends
        self._saved = None

    def __enter__(self):
        from ..sink import writer

        fault = self
        self._saved = (writer._local_write, writer._local_append)

        def failing_write(path, data):
            fault.write_attempts += 1
            if fault.fail_writes:
                raise OSError(fault.errno,
                              f"injected {fault.mode} on sink write",
                              path)
            return fault._saved[0](path, data)

        def failing_append(path, data):
            fault.append_attempts += 1
            if fault.fail_appends:
                raise OSError(fault.errno,
                              f"injected {fault.mode} on sink append",
                              path)
            return fault._saved[1](path, data)

        writer._local_write = failing_write
        writer._local_append = failing_append
        return self

    def __exit__(self, *exc):
        from ..sink import writer

        writer._local_write, writer._local_append = self._saved
        return False
