"""The tile plans of the port's RDW scan and record pack, on the CPU.

The kernels (``cobrix_tpu_torch/csrc/rdw_framing.cu``) run only on the
card; what they compute from their plans is modelled here in numpy, step
for step, and held exactly against the plain versions and the JAX
package:

* the scan's three passes at tiny tiles (T in 8, 16, 64, 1024): per-tile
  exits by pointer doubling to the last position of each chain inside
  its tile, the chain across tiles from the start (tiles a long record
  skips get no entry), and the walk of each entered tile; against
  ``scan_window_plain`` on every ``scan_cases()`` case, whole and cut at
  every window of ``WINDOWS`` (last window or not), against
  ``cobrix_tpu.native.rdw_scan`` through the reader's windowed framing,
  and on hypothesis-drawn streams;
* ``plan_pack_tiles``: every output byte in exactly one tile, each tile
  starting on a 16-byte word, chunks that a block's threads divide
  evenly, and staging that fits the plan's slots, words and shared
  memory, at extents 1, 5, 16, 17, 60, 333 and 16,064;
* the pack's flat-word assembly over a simulated address space (the
  image at each alignment 0-15, garbage around it), staging only aligned
  words that hold a byte of the record, against ``pack_records_plain``
  at start offsets 0, 3 and 7.

Tolerance: exact.
"""
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cobrix_tpu import native
from cobrix_tpu.reader.diagnostics import FramingError as JaxFramingError
from cobrix_tpu_torch.ops import device_framing as df
from cobrix_tpu_torch.reader import var_len_reader as vlr
from cobrix_tpu_torch.reader.diagnostics import FramingError
from cobrix_tpu_torch.testing.framing_cases import (WINDOWS, pack_case,
                                                    rdw_header, rdw_stream,
                                                    scan_cases)

CASES = scan_cases()
TILES = (8, 16, 64, 1024)
PACK_EXTENTS = (1, 5, 16, 17, 60, 333, 16064)
SMEM_LIMIT = 232448  # shared memory a block may take on the H100


# ---------------------------------------------------------------------------
# the scan's three passes
# ---------------------------------------------------------------------------

def _links(image, last_window, big_endian, adjustment):
    """next(p) for every position, -1 where p is a stop (link_at), and
    the header length at every position (bytes past the end read 0)."""
    L = len(image)
    b = np.zeros(L + 4, dtype=np.int64)
    b[:L] = image
    ln = ((b[1:L + 1] + 256 * b[:L]) if big_endian
          else (b[2:L + 2] + 256 * b[3:L + 3])) + adjustment
    pos = np.arange(L, dtype=np.int64)
    nxt = pos + 4 + ln
    ok = (pos + 4 <= L) & (ln > 0) & (ln <= df.MAX_RDW_RECORD_SIZE)
    nxt = np.where(nxt > L, L if last_window else -1, nxt)
    return np.where(ok, nxt, -1), ln


def model_scan(image, start, last_window, big_endian, adjustment, tile):
    """The kernel's passes: (offsets, lengths, WindowStatus, tiles
    entered)."""
    image = np.frombuffer(bytes(image), dtype=np.uint8)
    L = len(image)
    link, ln = _links(image, last_window, big_endian, adjustment)
    pos = np.arange(L, dtype=np.int64)
    tile_end = np.minimum((pos // tile + 1) * tile, L)
    # pass 1: each position's last chain position inside its tile
    ex = np.where((link < 0) | (link >= tile_end), pos, link)
    assert np.all(ex - (pos // tile) * tile < 65536)  # 16-bit local links
    while True:
        nx = ex[ex]
        if np.array_equal(nx, ex):
            break
        ex = nx
    exits = np.where(link[ex] < 0, ex, link[ex])
    # pass 2: the chain across tiles
    entry = np.full(-(-L // tile), -1, dtype=np.int64)
    e, hops = start, 0
    code, at, length = df.DONE, L, 0
    while e < L:
        k = e // tile
        end = min((k + 1) * tile, L)
        entry[k] = e
        hops += 1
        x = int(exits[e])
        if x < end:
            assert link[x] < 0
            at = x
            if x + 4 <= L:
                length = int(ln[x])
                code = (df.ZERO if length <= 0 else df.TOO_BIG
                        if length > df.MAX_RDW_RECORD_SIZE else df.CARRY)
            else:
                code = df.DONE if last_window else df.CARRY
            break
        assert x >= end
        e = x
    # pass 3: walk each entered tile, count, scan, write
    starts = []
    for k in np.nonzero(entry >= 0)[0]:
        p, end = int(entry[k]), min((int(k) + 1) * tile, L)
        while p < end and link[p] >= 0:
            starts.append(p)
            p = int(link[p])
    starts = np.asarray(starts, dtype=np.int64)
    return (starts + 4, link[starts] - (starts + 4),
            df.WindowStatus(code, at, length), hops)


def _plain(image, start, last_window, big_endian, adjustment):
    t = torch.from_numpy(np.frombuffer(bytes(image), np.uint8).copy())
    o, ln, status = df.scan_window_plain(t, start, last_window, big_endian,
                                         adjustment)
    return o.tolist(), ln.tolist(), status


def _cuts(image, header, footer):
    """The record area as the reader takes it, then windows cut from its
    start at every size of WINDOWS, each as (lo, hi, last)."""
    end = len(image) - footer if 0 < footer < len(image) else len(image)
    start = header if header > 4 else 0
    for lo, hi in [(start, end)] + [(start, start + w) for w in WINDOWS]:
        if hi > end or lo > hi:
            continue
        for last in ((True,) if hi == end else (False, True)):
            yield lo, hi, last


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_scan_matches_plain(name, tile):
    image, big_endian, adj, header, footer = CASES[name]
    for lo, hi, last in _cuts(image, header, footer):
        window = image[lo:hi]
        for start in sorted({0, min(5, len(window)), len(window)}):
            o, ln, status, hops = model_scan(window, start, last,
                                             big_endian, adj, tile)
            assert (o.tolist(), ln.tolist(), status) == _plain(
                window, start, last, big_endian, adj), (lo, hi, last, start)
            assert hops <= -(-len(window) // tile)


def _outcome(fn):
    try:
        offsets, lengths = fn()
    except (FramingError, JaxFramingError) as e:
        return ("error", type(e).__name__, str(e), e.offset, e.reason,
                e.header)
    return ("ok", np.asarray(offsets, dtype=np.int64).tolist(),
            np.asarray(lengths, dtype=np.int64).tolist())


def _native(image, big_endian, adj, header, footer):
    return _outcome(lambda: native.rdw_scan(
        np.frombuffer(image, np.uint8), big_endian, adj, header, footer))


def _model_windowed(image, big_endian, adj, header, footer, tile,
                    monkeypatch):
    """The reader's windowed framing with the model as its scan."""
    def scan(window, start, last, be, adjustment):
        o, ln, status, _ = model_scan(window.numpy().tobytes(), start, last,
                                      be, adjustment, tile)
        return torch.from_numpy(o), torch.from_numpy(ln), status

    monkeypatch.setattr(vlr, "scan_window", scan)

    def run():
        offs, lens = [], []
        for base, _, o, ln in vlr.frame_windows(
                io.BytesIO(image), len(image), "cpu", big_endian, adj,
                header, footer):
            offs.extend((base + o.numpy()).tolist())
            lens.extend(ln.numpy().tolist())
        return offs, lens
    return _outcome(run)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_windowed_scan_matches_native(name, tile, monkeypatch):
    image, big_endian, adj, header, footer = CASES[name]
    want = _native(image, big_endian, adj, header, footer)
    for window in WINDOWS:
        monkeypatch.setattr(vlr, "READ_WINDOW_BYTES", window)
        assert _model_windowed(image, big_endian, adj, header, footer, tile,
                               monkeypatch) == want, window


def test_model_scan_leaves_tiles_a_long_record_skips_without_entry():
    image = rdw_stream([3, 200, 7, 300, 2], seed=9)
    o, ln, status, hops = model_scan(image, 0, True, False, 0, 16)
    assert ln.tolist() == [3, 200, 7, 300, 2] and status.code == df.DONE
    assert hops < -(-len(image) // 16) // 4
    assert (o.tolist(), ln.tolist(), status) == _plain(image, 0, True,
                                                      False, 0)


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       tile=st.sampled_from(TILES),
       big_endian=st.booleans(),
       delta=st.sampled_from([0, 4, -2]),
       long_records=st.booleans(),
       cut=st.integers(0, 64),
       corrupt=st.booleans())
def test_model_scan_random_streams(seed, tile, big_endian, delta,
                                   long_records, cut, corrupt):
    """Records shorter and longer than the tile, both endiannesses,
    adjustments, zero headers, and windows cut anywhere (with a carry
    when the window is not the last)."""
    rng = np.random.default_rng(seed)
    hi = 3000 if long_records else 40
    lengths = rng.integers(1, hi, size=int(rng.integers(0, 30))).tolist()
    body = bytearray(rdw_stream(lengths, big_endian, delta, seed))
    if corrupt and lengths:
        k = int(rng.integers(0, len(lengths)))
        at = sum(4 + ln for ln in lengths[:k])
        body[at:at + 4] = rdw_header(-delta, big_endian)  # length 0
    image = bytes(body)
    window = image[:max(0, len(image) - cut)]
    for last in (False, True):
        for start in (0, min(len(window), 4 + (lengths[0] if lengths
                                                else 0))):
            got = model_scan(window, start, last, big_endian, -delta, tile)
            assert (got[0].tolist(), got[1].tolist(), got[2]) == _plain(
                window, start, last, big_endian, -delta)


# ---------------------------------------------------------------------------
# the pack's plan
# ---------------------------------------------------------------------------

def _chunk_rows(plan, extent, rows):
    """For each chunk of a tile of `rows` rows: (first row, first column,
    rows touched, the row-local columns of its last row's end)."""
    tile_bytes = rows * extent
    tile_words = -(-tile_bytes // 16)
    out = []
    for c in range(-(-tile_words // plan.chunk_words)):
        b0 = 16 * plan.chunk_words * c
        b1 = min(16 * plan.chunk_words * (c + 1), tile_bytes)
        out.append((b0 // extent, b0 % extent,
                    (b1 - 1) // extent - b0 // extent + 1,
                    (b1 - 1) % extent + 1))
    return out


@pytest.mark.parametrize("n", [1, 7, 16, 1000, 684995])
@pytest.mark.parametrize("extent", PACK_EXTENTS)
def test_pack_plan_covers_every_byte_once_in_word_aligned_tiles(extent, n):
    plan = df.plan_pack_tiles(n, extent)
    assert plan.rows >= 1 and plan.tiles == -(-n // plan.rows)
    assert (plan.rows * extent) % 16 == 0  # every tile starts on a word
    assert plan.chunk_words % plan.threads == 0
    assert plan.threads <= df.PACK_THREADS and plan.threads % 32 == 0
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes >= min(32, plan.slot_words)
    assert plan.smem_bytes <= 2 * df.PACK_STAGE_BYTES < SMEM_LIMIT
    covered = np.zeros(n * extent if n * extent < 1 << 24 else 0,
                       dtype=np.int8)
    for k in range(plan.tiles):
        r0 = k * plan.rows
        rows = min(plan.rows, n - r0)
        assert (r0 * extent) % 16 == 0
        if covered.size:
            covered[r0 * extent:(r0 + rows) * extent] += 1
        if k in (0, plan.tiles - 1):
            for row, col, touched, last_end in _chunk_rows(plan, extent,
                                                           rows):
                assert touched <= plan.slots
                # a row's bytes in one chunk fit a slot at any phase
                for s in range(touched):
                    lo = col if s == 0 else 0
                    hi = last_end if s == touched - 1 else extent
                    assert (15 + hi - lo + 15) // 16 <= plan.slot_words
    if covered.size:
        assert np.all(covered == 1)


# ---------------------------------------------------------------------------
# the pack's flat-word assembly
# ---------------------------------------------------------------------------

def model_pack(image, offsets, lengths, extent, start_offset, align):
    """The kernel's pack by its plan, over a simulated address space in
    which image[0] lies at an address of phase `align`; every word staged
    is read from that space (garbage outside the image) and must hold a
    byte of the record it was staged for. Returns the [n, extent]
    output."""
    n, E = len(offsets), extent
    plan = df.plan_pack_tiles(n, E)
    size = len(image)
    base = 64 + align
    mem = np.full(base + size + 64, 0xEE, dtype=np.uint8)
    mem[base:base + size] = image
    out = np.full(n * E, 0xAB, dtype=np.uint8)
    writes = np.zeros(n * E, dtype=np.int32)
    K, B, W = plan.chunk_words, plan.threads, plan.slot_words
    chunk_rows, chunk_cols = divmod(16 * K, E)
    step_rows, step_cols = divmod(16 * B, E)

    def advance(cur, rows, cols):
        row, col = cur[0] + rows, cur[1] + cols
        return (row + 1, col - E) if col >= E else (row, col)

    for tile in range(plan.tiles):
        r0 = tile * plan.rows
        rows = min(plan.rows, n - r0)
        tile_bytes = rows * E
        tile_words = -(-tile_bytes // 16)
        n_chunks = -(-tile_words // K)
        assert (r0 * E) % 16 == 0
        # each thread's word cursor, from one division at its start
        cursors = [divmod(16 * t, E) for t in range(B)]
        chunk = (0, 0)
        for c in range(n_chunks):
            if c + 1 == n_chunks:
                nslots, hi_last = rows - chunk[0], E
            else:
                b = advance(chunk, chunk_rows, chunk_cols)
                nslots = b[0] - chunk[0] + (b[1] > 0)
                hi_last = b[1] if b[1] > 0 else E
            assert nslots <= plan.slots
            # stage
            buf = np.full(plan.slots * W * 16 + 16, 0xCD, dtype=np.uint8)
            meta = []
            for s in range(nslots):
                i = r0 + chunk[0] + s
                lo = chunk[1] if s == 0 else 0
                hi = hi_last if s == nslots - 1 else E
                off = int(offsets[i]) + start_offset
                ln = min(int(lengths[i]) - start_offset, E)
                if off < 0 or ln <= 0 or off >= size:
                    ln = 0
                elif off + ln > size:
                    ln = size - off
                end = min(ln, hi)
                if end <= lo:
                    meta.append((0, 0))
                    continue
                src = base + off + lo
                a0, phase = src & ~15, src & 15
                words = (phase + (end - lo) + 15) >> 4
                assert words <= W
                for w in range(words):
                    a = a0 + 16 * w
                    # the word holds a byte of the record's span
                    assert a < base + off + end and a + 16 > base + off + lo
                    buf[(s * W + w) * 16:(s * W + w + 1) * 16] = mem[a:a + 16]
                meta.append((s * W * 16 + phase - lo, end))
            s32 = buf.view("<u4")
            # assemble: thread t takes words t, t + B, ... of the chunk
            last = min((c + 1) * K, tile_words)
            for t in range(B):
                for word in range(c * K + t, last, B):
                    row, col = cursors[t]
                    slot = row - chunk[0]
                    bias, end = meta[slot]
                    left = tile_bytes - 16 * word
                    if col + 16 <= E and (col + 16 <= end or col >= end):
                        if col < end:
                            b = bias + col
                            a, sh = b >> 2, (b & 3) * 8
                            x = [int(s32[a + k]) for k in range(4)]
                            if sh:
                                assert (b + 15) // (W * 16) == slot \
                                    and (a + 4) * 4 < (slot + 1) * W * 16
                            x.append(int(s32[a + 4]) if sh else 0)
                            v = [((x[k + 1] << 32 | x[k]) >> sh) & 0xFFFFFFFF
                                 for k in range(4)]
                            word_bytes = np.array(v, "<u4").view(np.uint8)
                        else:
                            word_bytes = np.zeros(16, np.uint8)
                    else:
                        word_bytes = np.zeros(16, np.uint8)
                        cc, sl, mm = col, slot, meta[slot]
                        for k in range(min(16, left)):
                            if cc < mm[1]:
                                word_bytes[k] = buf[mm[0] + cc]
                            cc += 1
                            if cc == E:
                                cc, sl = 0, sl + 1
                                if k + 1 < min(16, left):
                                    mm = meta[sl]
                    at = r0 * E + 16 * word
                    k = 16 if left >= 16 else left
                    out[at:at + k] = word_bytes[:k]
                    writes[at:at + k] += 1
                    cursors[t] = advance(cursors[t], step_rows, step_cols)
            if c + 1 < n_chunks:
                chunk = advance(chunk, chunk_rows, chunk_cols)
    assert np.all(writes == 1)
    return out.reshape(n, E)


def _pack_inputs(extent):
    """pack_case() and, for narrow extents, a larger random case whose
    tiles hold many rows."""
    cases = [pack_case()]
    if extent <= 64:
        rng = np.random.default_rng(extent)
        image = rng.integers(0, 256, size=3000, dtype=np.uint8)
        n = 600
        cases.append((image, rng.integers(-8, 3008, size=n).astype(np.int64),
                      rng.integers(-2, 90, size=n).astype(np.int64)))
    return cases


@pytest.mark.parametrize("align", range(16))
@pytest.mark.parametrize("start_offset", [0, 3, 7])
@pytest.mark.parametrize("extent", PACK_EXTENTS)
def test_model_pack_matches_plain(extent, start_offset, align):
    for image, offsets, lengths in _pack_inputs(extent):
        want = df.pack_records_plain(torch.from_numpy(image),
                                     torch.from_numpy(offsets),
                                     torch.from_numpy(lengths), extent,
                                     start_offset).numpy()
        got = model_pack(image, offsets, lengths, extent, start_offset,
                         align)
        assert np.array_equal(got, want)


def test_scan_window_refuses_a_tile_the_kernel_does_not_take():
    image = torch.from_numpy(np.frombuffer(rdw_stream([3, 9]),
                                           np.uint8).copy())
    for tile in (0, 4, 12, 3 * 1024, 1 << 17):
        with pytest.raises(ValueError, match="power of two"):
            df.scan_window(image, 0, True, tile=tile)
    for tile in TILES + (df.MAX_SCAN_TILE,):
        offsets, lengths, status = df.scan_window(image, 0, True, tile=tile)
        assert offsets.tolist() == [4, 11] and lengths.tolist() == [3, 9]
        assert status == df.WindowStatus(df.DONE, 20, 0)
