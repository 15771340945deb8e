"""A numpy model of how ``csrc/arrow_assemble.cu`` cuts the Arrow
assembly's work, on the CPU (the kernels themselves run only on a card;
``chip_smoke.py`` phase 14 holds them to the plain version there).

`arrow_scalars`: the plan's work table names a (request, tile) a block;
a tile is RT rows x SC slots (``arrow_assemble.scalar_tile``), staged
column-major in shared memory with a column stride of RT + 1 and written
record-major, 16 bytes of output a thread where they are contiguous and
aligned; the validity bits are packed in tile order as the value pass
goes (the lanes of a word's positions OR them together), and each word
of the output's bitmap over a run of the tile is one thread's: stored
where the tile fills the word, OR-ed in where it shares it. The model
replays that index arithmetic and shows every element written exactly
once, every staged slot inside the shared buffer, every packed word
written by one lane, and the bitmap built in any order of the tiles
equal to the packed validity, with no tile storing a word another tile
touches.

`arrow_str_copy`: a tile of 256 strings writes the byte range [its base,
+ its sum) of its array's data; a tile whose code points or UTF-8 bytes
overflow the shared buffers writes directly. The model replays the
staged path's items (16 code points of an all-ASCII string, or a whole
other string) and its aligned 16-byte stores, and shows every output
byte written exactly once, whichever path each tile takes.
"""
import numpy as np
import pytest
import torch

from cobrix_tpu_torch.ops import arrow_assemble as asm
from cobrix_tpu_torch.testing import arrow_cases

ROWS = [1, 31, 32, 33, 257, 4097]


# -- arrow_scalars ------------------------------------------------------------

def _tile(desc_row, t):
    """(k0, s0, rt, sc) of tile t of a request, as the kernel derives it."""
    S, L = int(desc_row[asm.D_SLOTS]), int(desc_row[asm.D_LEN])
    RT, SC = int(desc_row[asm.D_RT]), int(desc_row[asm.D_SC])
    rtiles = int(desc_row[asm.D_RTILES])
    k0, s0 = (t % rtiles) * RT, (t // rtiles) * SC
    return k0, s0, min(RT, L // S - k0), min(SC, S - s0)


def _stores(desc_row, k0, s0, rt, sc, oitem):
    """The output elements of one tile's value pass in tile order, and
    for each thread's group of 16 / oitem consecutive positions its first
    element and whether it is one 16-byte store."""
    S, RT = int(desc_row[asm.D_SLOTS]), int(desc_row[asm.D_RT])
    V, cnt = 16 // oitem, rt * sc
    q = np.arange(cnt)
    k, c = q // sc, q % sc
    # the transposed tile: slot (c, k) of a column-major buffer
    assert (c * (RT + 1) + k).max() < asm.SCALAR_CAP
    e = (k0 + k) * S + s0 + c
    q0 = np.arange(0, cnt, V)
    # the packed validity words: word m is written by the lane whose
    # group starts at position 32 m, once
    leaders = q0[q0 % 32 == 0] // 32
    assert leaders.tolist() == list(range(-(-cnt // 32)))
    last = np.minimum(q0 + V - 1, cnt - 1)
    vector = (q0 + V <= cnt) & (e[q0] % V == 0) & (e[last] == e[q0] + V - 1)
    return e, e[q0], vector


def _words(desc_row, k0, s0, rt, sc):
    """The tile's validity words: [(word, bit positions of the tile's
    elements in it, stored whole?)], by the warp loop of the kernel."""
    S, L = int(desc_row[asm.D_SLOTS]), int(desc_row[asm.D_LEN])
    whole = sc == S
    run = rt * S if whole else sc
    nruns = 1 if whole else rt
    wpr = (run + 31) // 32 + 1
    words = []
    for it in range(nruns * wpr):
        g = it // wpr
        start = (k0 + g) * S + s0
        W = start // 32 + it % wpr
        if W * 32 >= start + run:
            continue
        e = W * 32 + np.arange(32)
        mine = (e >= start) & (e < start + run)
        past = e >= L
        words.append((W, np.nonzero(mine)[0], bool((mine | past).all())))
    return words


def _scalar_plan(n, slots):
    requests, buf = arrow_cases.grid(n, seed=n, slots=slots)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    return requests, plan


# the 2,000-slot grid at up to 257 rows (chip_smoke.py's shape)
@pytest.mark.parametrize("n,slots", [(n, s) for n in ROWS
                                     for s in (1, 3, 40, 2000)
                                     if s < 2000 or n <= 257])
def test_scalar_tiles_write_every_element_once(n, slots):
    requests, plan = _scalar_plan(n, slots)
    work = plan.num_work
    assert work.dtype == np.int32 and work.shape[1] == 2
    seen_requests = set()
    for i in plan.num_ids.tolist():
        d, r = plan.desc[i], requests[i]
        S = len(r.planes)
        RT, SC = asm.scalar_tile(S)
        assert (d[asm.D_RT], d[asm.D_SC]) == (RT, SC)
        assert RT <= asm.SCALAR_ROWS and RT * SC <= asm.SCALAR_ELEMS
        assert SC * (RT + 1) <= asm.SCALAR_CAP
        tiles = work[work[:, 0] == i, 1]
        # one entry a tile, in order: no search, no gap
        assert tiles.tolist() == list(range(len(tiles)))
        written = np.zeros(r.length, dtype=np.int64)
        bits = np.zeros(r.length, dtype=np.int64)
        words = {}
        oitem = asm.OUT_ITEMSIZE[r.out_kind]
        for t in tiles.tolist():
            k0, s0, rt, sc = _tile(d, t)
            assert rt > 0 and sc > 0
            e, first, vector = _stores(d, k0, s0, rt, sc, oitem)
            np.add.at(written, e, 1)
            # a 16-byte store: aligned, inside the array
            assert ((first[vector] * oitem) % 16 == 0).all()
            assert (first[vector] + 16 // oitem <= r.length).all()
            for W, pos, whole in _words(d, k0, s0, rt, sc):
                np.add.at(bits, W * 32 + pos, 1)
                words.setdefault(W, []).append((t, whole))
        assert (written == 1).all()
        assert (bits == 1).all()
        for W, touched in words.items():
            # a word a tile stores whole is no other tile's
            if any(whole for _, whole in touched):
                assert len(touched) == 1, (W, touched)
        seen_requests.add(i)
    assert seen_requests == set(plan.num_ids.tolist())
    assert len(work) == sum(
        int(plan.desc[i][asm.D_RTILES])
        * -(-len(requests[i].planes) // int(plan.desc[i][asm.D_SC]))
        for i in plan.num_ids.tolist())


@pytest.mark.parametrize("n", ROWS)
def test_validity_words_in_any_order_of_tiles(n):
    """The bitmap the tiles build into a zeroed buffer, stores and ORs in
    a random order of the tiles, is the packed validity."""
    rng = np.random.default_rng(n)
    for slots in (1, 3, 100):
        requests, plan = _scalar_plan(n, slots)
        for i in plan.num_ids.tolist():
            d, r = plan.desc[i], requests[i]
            ok = rng.random(r.length) < 0.6
            nwords = -(-r.length // 32)
            bitmap = np.zeros(nwords, dtype=np.uint64)
            tiles = plan.num_work[plan.num_work[:, 0] == i, 1]
            for t in rng.permutation(tiles).tolist():
                for W, pos, whole in _words(d, *_tile(d, t)):
                    e = W * 32 + pos
                    word = int((ok[e].astype(np.uint64)
                                << pos.astype(np.uint64)).sum())
                    if whole:
                        bitmap[W] = word
                    else:
                        bitmap[W] |= np.uint64(word)
            want = np.zeros(nwords * 32, dtype=bool)
            want[:r.length] = ok
            packed = (want.reshape(nwords, 32).astype(np.uint64)
                      << np.arange(32, dtype=np.uint64)).sum(1)
            assert (bitmap == packed).all(), (slots, i)


def test_wide_arrays_are_read_in_whole_runs():
    """A 2,000-slot array's tile reads each of its 32 slots' 128 rows as
    one run of 512 bytes of int32 values (whole sectors), not 128 values a
    sector apart."""
    requests, plan = _scalar_plan(257, 2000)
    fused = [i for i in plan.num_ids.tolist()
             if isinstance(requests[i].planes, asm.SlotPlanes)]
    assert fused
    for i in fused:
        d = plan.desc[i]
        assert d[asm.D_RSTRIDE] == 1
        assert (d[asm.D_RT], d[asm.D_SC]) == (128, 32)
        # slots evenly spaced: one step a plane kind
        assert d[asm.D_STEP + asm.P_VALUES] == \
            2 * 257 * requests[i].planes.arrays["values"].itemsize


# -- arrow_str_copy -----------------------------------------------------------

def _utf8_lengths(cps, keep):
    ul = np.where(cps < 0x80, 1, np.where(cps < 0x800, 2, 3))
    return (ul * keep).sum(1)


def _string_tiles(req, d, data_start, data_off):
    """Replay each 256-string tile: its range, the path it takes and the
    bytes its stores write. Returns the count of writes of every byte of
    the output buffer's data, and the paths taken."""
    w = req.width
    cs = 2 if req.src_kind == asm.SRC_CP16 else 1
    rows = np.arange(req.length) if req.rows is None else np.asarray(req.rows)
    mat = req.planes[0]["values"][rows].astype(np.int64)
    if req.mask is not None:
        mat[~np.asarray(req.mask)[rows].astype(bool)] = 0x20
    pos = np.arange(w)[None, :]
    keep = np.ones(mat.shape, dtype=bool)
    if req.trim != asm.TRIM_NONE:
        trims = (mat <= 0x20 if req.trim == asm.TRIM_BOTH
                 else (mat == 0x20) | (mat == 0x09))
        solid = ~trims
        first = np.where(solid, pos, w).min(1)
        last = np.where(solid, pos, -1).max(1)
        if req.trim in (asm.TRIM_BOTH, asm.TRIM_LEFT):
            keep &= pos >= first[:, None]
        if req.trim in (asm.TRIM_BOTH, asm.TRIM_RIGHT):
            keep &= pos <= last[:, None]
    lens = _utf8_lengths(mat, keep)
    total = int(lens.sum())
    writes = np.zeros(total, dtype=np.int64)
    paths = []
    for t0 in range(0, req.length, asm.TILE):
        n_in = min(asm.TILE, req.length - t0)
        tl = lens[t0:t0 + n_in]
        T, base = int(tl.sum()), int(lens[:t0].sum())
        dst = data_off + data_start + base
        mis = dst % 16
        if n_in * w * cs > asm.STR_CP_BYTES or mis + T > asm.STR_OUT_BYTES:
            paths.append("direct")
            for i in range(n_in):
                at = base + int(tl[:i].sum())
                writes[at:at + int(tl[i])] += 1
            continue
        paths.append("staged")
        # items: 16 code points of an all-ASCII string, else the string
        staged = np.zeros(mis + T, dtype=np.int64)
        for i in range(n_in):
            kept = np.nonzero(keep[t0 + i])[0]
            count = len(kept)
            at = mis + int(tl[:i].sum())
            if count and int(tl[i]) == count:
                for c in range(-(-count // 16)):
                    lo, hi = 16 * c, min(count, 16 * c + 16)
                    staged[at + lo:at + hi] += 1
            else:
                staged[at:at + int(tl[i])] += 1
        assert (staged[mis:] == 1).all() and (staged[:mis] == 0).all()
        # the write-out: whole aligned words, the ragged ends a byte each
        for q in range((mis + T + 15) // 16):
            g = dst - mis + 16 * q
            if g >= dst and g + 16 <= dst + T:
                assert g % 16 == 0
                writes[g - data_off - data_start:
                       g - data_off - data_start + 16] += 1
            else:
                for b in range(16):
                    if dst <= g + b < dst + T:
                        writes[g + b - data_off - data_start] += 1
    return writes, paths


@pytest.mark.parametrize("n", ROWS)
def test_string_tiles_write_every_byte_once(n):
    requests, buf = arrow_cases.grid(n, seed=n)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    res = asm.assemble(plan)
    paths = set()
    for m, i in enumerate(plan.str_ids.tolist()):
        if res.bad(i):
            continue
        req = requests[i]
        # the work table names (request, tile) in the tile sums' order
        t0, t1 = int(plan.str_starts[m]), int(plan.str_starts[m + 1])
        aux_work = plan.aux[plan.aux_off["str_work"]:].view(np.int32)
        assert aux_work[2 * t0:2 * t1].reshape(-1, 2).tolist() == \
            [[i, t] for t in range(t1 - t0)]
        start = int(res.counters[i, asm.C_START])
        writes, got = _string_tiles(req, plan.desc[i], start, plan.data_off)
        assert len(writes) == int(res.counters[i, asm.C_TOTAL])
        assert (writes == 1).all(), (i, req.width)
        paths.update(got)
    assert "staged" in paths
    if n >= asm.TILE:
        # 256 rows of 80 uint16 code points overflow the shared buffer
        assert "direct" in paths
