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

`arrow_str_lengths`: one launch computes the lengths and scans the
tiles' sums. A block takes its tile from a ticket, in order, stages the
tile's code points (or reads them directly when they overflow the
buffer), and looks back over its array's earlier tiles through one
64-bit status word a tile (flag, bad bit, value): a round loads 128
words at once and takes them 32 at a time, down to the nearest
inclusive prefix; the array's last tile writes its
total and bad flag, and the last tile to finish scans the totals into
data starts. The model replays that scan with the tiles finishing in
seeded random orders and holds every tile base, total, bad flag, data
start and the grand total to ``str_offsets_plain``'s.
"""
from types import SimpleNamespace

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


def _code_points(req):
    """(code points [L, w] with hidden rows blank, kept mask) of a string
    request."""
    w = req.width
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
    return mat, keep


def _string_tiles(req, d, data_start, data_off):
    """Replay each 256-string tile: its range, the path it takes and the
    bytes its stores write. Returns the count of writes of every byte of
    the output buffer's data, and the paths taken."""
    w = req.width
    cs = 2 if req.src_kind == asm.SRC_CP16 else 1
    mat, keep = _code_points(req)
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


# -- arrow_str_lengths: staged tiles and the segmented look-back --------------

AGGREGATE, INCLUSIVE = asm.STATUS_AGGREGATE, asm.STATUS_INCLUSIVE


def _pack(flag, bad, value):
    """A tile's status word, as the kernel's `publish` stores it."""
    return ((flag << asm.STATUS_FLAG_SHIFT) | (asm.STATUS_BAD if bad else 0)
            | (value & asm.STATUS_VALUE_MASK))


def _unpack(word):
    return (word >> asm.STATUS_FLAG_SHIFT, bool(word & asm.STATUS_BAD),
            word & asm.STATUS_VALUE_MASK)


def _length_tiles(req, d):
    """Replay the lengths kernel's tiles: the path each takes (its code
    points staged in shared memory, as one run or a run a row, or read
    from global memory when 256 x width x 1 or 2 bytes overflow the
    buffer), and how many times each string's length is computed."""
    w = req.width
    cs = 2 if req.src_kind == asm.SRC_CP16 else 1
    computed = np.zeros(req.length, dtype=np.int64)
    paths = []
    for j0 in range(0, req.length, asm.TILE):
        n_in = min(asm.TILE, req.length - j0)
        if n_in * w * cs > asm.STR_CP_BYTES:
            paths.append("direct")
        else:
            run = d[asm.D_ROWS] < 0 and (d[asm.D_RSTRIDE] == w or n_in == 1)
            paths.append("run" if run else "rows")
        computed[j0:j0 + n_in] += 1
    return computed, paths


def _tile_flags(req):
    """Each 256-string tile's sum and surrogate flag."""
    mat, keep = _code_points(req)
    lens = _utf8_lengths(mat, keep)
    sur = (keep & (mat >= 0xD800) & (mat <= 0xDFFF)).any(1)
    n = -(-req.length // asm.TILE)
    pad = n * asm.TILE - req.length
    return (np.pad(lens, (0, pad)).reshape(n, -1).sum(1).tolist(),
            np.pad(sur, (0, pad)).reshape(n, -1).any(1).tolist())


def _look_back(work, sums, bads, ids, tiles_of, rng, start_all=False,
               prefer=None):
    """Replay one launch of the lengths kernel's scan: tile t (its ticket)
    is entry t of `work` ((request, tile of the request) pairs), with sum
    sums[t] and surrogate flag bads[t]. Tiles take their tickets in order;
    at each step a random started tile takes one step (a word loaded as 0
    is read again until it is not: that tile waits), and a new tile may
    take its ticket (`start_all`: every tile first). `prefer`: a tile
    that moves whenever it can. Returns (bases, {request: [bad, total,
    start]}, grand total, publish events in order)."""
    T = len(work)
    status = [0] * T
    bases = [None] * T
    counters = {i: [0, 0, 0] for i in ids}
    events = []
    state = {"done": 0, "grand": None}

    def tile(t):
        req, k = work[t]
        agg, bad = sums[t], bads[t]
        first = t - k
        base, base_bad = 0, False
        if k > 0:
            status[t] = _pack(AGGREGATE, bad, agg)
            events.append((t, AGGREGATE))
            yield True
            top = t - 1
            while True:
                # a round loads its words at once (a snapshot), then takes
                # them 32 at a time, spinning only on those still 0
                dist = range(asm.STR_LOOK_ROUND)
                loaded = [status[top - x] if top - x >= first
                          else _pack(INCLUSIVE, False, 0) for x in dist]
                yield True
                found = False
                for c0 in range(0, asm.STR_LOOK_ROUND, 32):
                    words = []
                    for x in range(c0, c0 + 32):
                        while loaded[x] == 0:
                            loaded[x] = status[top - x]
                            if loaded[x] == 0:
                                yield False
                        words.append(loaded[x])
                    seen = [_unpack(w) for w in words]
                    inclusive = [n for n, (f, _, _) in enumerate(seen)
                                 if f == INCLUSIVE]
                    stop = inclusive[0] if inclusive else 31
                    base += sum(v for _, _, v in seen[:stop + 1])
                    base_bad |= any(b for _, b, _ in seen[:stop + 1])
                    if inclusive:
                        found = True
                        break
                yield True
                if found:
                    break
                top -= asm.STR_LOOK_ROUND
        total = base + agg
        req_bad = base_bad or bad
        status[t] = _pack(INCLUSIVE, req_bad, total)
        events.append((t, INCLUSIVE))
        bases[t] = base
        if k == tiles_of[req] - 1:
            rebuild = req_bad or total > 2 ** 31 - 1
            if rebuild:
                counters[req][0] = 1
            counters[req][1] = 0 if rebuild else total
        yield True
        state["done"] += 1
        if state["done"] == T:
            start = 0
            for i in ids:
                counters[i][2] = start
                start += counters[i][1]
            state["grand"] = start

    running = {}
    ticket = 0
    while ticket < T or running:
        if ticket < T and (start_all or not running or rng.random() < 0.3):
            running[ticket] = tile(ticket)
            ticket += 1
            continue
        order = list(running)
        rng.shuffle(order)
        if prefer in running:
            order.remove(prefer)
            order.insert(0, prefer)
        for t in order:
            try:
                moved = next(running[t])
            except StopIteration:
                del running[t]
                break
            if moved:
                break
        else:
            # every started tile spins: only a new ticket can move
            assert ticket < T, "the look-back deadlocked"
            running[ticket] = tile(ticket)
            ticket += 1
    assert all(b is not None for b in bases)
    return bases, counters, state["grand"], events


def _plain_scan(ids, starts, sums, bad_requests):
    """`str_offsets_plain` over the tile sums, each request's bad flag set
    as the lengths step leaves it: (bases, {request: [bad, total, start]},
    grand total)."""
    k = max(ids) + 1
    plan = SimpleNamespace(str_ids=np.asarray(ids), str_starts=starts,
                           grand_slot=asm.C_NF * k)
    out = torch.zeros(8 * (asm.C_NF * k + 1), dtype=torch.uint8)
    counters = out.view(torch.int64)
    for i in bad_requests:
        counters[asm.C_NF * i + asm.C_BAD] = 1
    tile_sums = torch.tensor(sums, dtype=torch.int64)
    asm.str_offsets_plain(plan, out, tile_sums)
    got = {i: [int(counters[asm.C_NF * i + c])
               for c in (asm.C_BAD, asm.C_TOTAL, asm.C_START)] for i in ids}
    return tile_sums.tolist(), got, int(counters[plan.grand_slot])


def _synthetic(tiles, seed, big=()):
    """(ids, starts, work, sums, bads) of requests of `tiles` tiles each,
    random sums (those in `big` past 2^31 - 1 in all)."""
    rng = np.random.default_rng(seed)
    ids = [2 * m + 1 for m in range(len(tiles))]
    starts = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    work, sums = [], []
    for m, n in enumerate(tiles):
        work += [(ids[m], t) for t in range(n)]
        top = 12_000_000 if m in big else 256 * 40 * 3
        sums += rng.integers(0, top, n).tolist()
    return ids, starts, work, sums, [False] * len(work)


def _check_look_back(ids, starts, work, sums, bads, seeds, **kw):
    tiles_of = dict(zip(ids, np.diff(starts).tolist()))
    bad_requests = [work[t][0] for t in range(len(work)) if bads[t]]
    want = _plain_scan(ids, starts, sums, bad_requests)
    for seed in seeds:
        bases, counters, grand, events = _look_back(
            work, sums, bads, ids, tiles_of, np.random.default_rng(seed), **kw)
        assert (bases, counters, grand) == want, seed
    return want, events


@pytest.mark.parametrize("value", [0, 2 ** 31 - 1, 2 ** 31,
                                   asm.STATUS_VALUE_MASK])
@pytest.mark.parametrize("bad", [False, True])
def test_status_word_packs_and_unpacks(value, bad):
    for flag in (AGGREGATE, INCLUSIVE):
        word = _pack(flag, bad, value)
        assert 0 < word < 2 ** 64
        assert _unpack(word) == (flag, bad, value)
        # the int64 scratch word the kernel stores holds the same bits
        as_int64 = np.array([word], dtype=np.uint64).view(np.int64)
        assert int(as_int64.view(np.uint64)[0]) == word
    # the value field holds any request's int64 total a batch can have
    assert asm.STATUS_VALUE_MASK == 2 ** 61 - 1
    assert asm.STATUS_BAD >> asm.STATUS_FLAG_SHIFT == 0


@pytest.mark.parametrize("n", ROWS)
def test_lengths_tiles_compute_each_length_once(n):
    requests, buf = arrow_cases.grid(n, seed=n)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    res = asm.assemble(plan)
    paths = set()
    for i in plan.str_ids.tolist():
        req = requests[i]
        computed, got = _length_tiles(req, plan.desc[i])
        assert (computed == 1).all()
        paths.update(got)
        offs = res.values(i).view(np.int32)
        if not res.bad(i):
            mat, keep = _code_points(req)
            assert (np.diff(offs) == _utf8_lengths(mat, keep)).all()
    assert {"run", "rows"} <= paths
    if n >= asm.TILE:
        # 256 rows of 80 uint16 code points overflow the staged buffer
        assert "direct" in paths


@pytest.mark.parametrize("n", ROWS)
def test_look_back_equals_the_plain_scan(n):
    """The grid's string requests: tiles started in order and finishing
    in seeded random orders give the plain scan's bases, totals, bad
    flags, data starts and grand total."""
    requests, buf = arrow_cases.grid(n, seed=n)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    T = plan.str_tiles
    work = plan.aux[plan.aux_off["str_work"]:].view(np.int32)[:2 * T]
    work = [tuple(x) for x in work.reshape(-1, 2).tolist()]
    sums, bads = [], []
    for i in plan.str_ids.tolist():
        s, b = _tile_flags(requests[i])
        sums += s
        bads += b
    # the model's tile sums are the plain lengths step's
    state = asm.new_state(plan, torch.device("cpu"))
    asm.str_lengths_plain(plan.src, torch.from_numpy(plan.aux), plan,
                          state[0], state[1])
    assert state[1][:T].tolist() == sums
    assert any(bads)
    (bases, counters, grand), _ = _check_look_back(
        plan.str_ids.tolist(), plan.str_starts, work, sums, bads,
        seeds=range(4))
    # and the plain step on the plan's own state agrees
    asm.str_offsets_plain(plan, state[0], state[1])
    assert state[1][:T].tolist() == bases
    res = asm.Result(plan, state[0].numpy())
    assert int(res.host[8 * plan.grand_slot:][:8].view(np.int64)[0]) == grand
    for i, (bad, total, start) in counters.items():
        assert res.counters[i, asm.C_BAD] == bad
        assert res.counters[i, asm.C_TOTAL] == total
        assert res.counters[i, asm.C_START] == start


def test_look_back_over_hundreds_of_tiles():
    """Several requests of hundreds of tiles (one empty, one of one tile,
    one whose total passes 2^31 - 1), many finish orders."""
    ids, starts, work, sums, bads = _synthetic([300, 0, 1, 450, 520], 7,
                                               big={4})
    (_, counters, _), _ = _check_look_back(ids, starts, work, sums, bads,
                                           seeds=range(6))
    assert counters[ids[4]][:2] == [1, 0]
    assert counters[ids[1]] == [0, 0, counters[ids[0]][1]]


def test_surrogate_in_the_first_tile_reaches_the_last():
    """A surrogate in a request's first tile, its last tile running ahead
    of every other: the bad bit rides the status words to the last
    tile."""
    ids, starts, work, sums, bads = _synthetic([3, 70, 2], 11)
    first, last = int(starts[1]), int(starts[2]) - 1
    bads[first] = True
    (_, counters, _), events = _check_look_back(
        ids, starts, work, sums, bads, seeds=range(3), start_all=True,
        prefer=last)
    assert events.index((last, AGGREGATE)) < events.index((first, INCLUSIVE))
    assert counters[ids[1]][:2] == [1, 0]


def test_bad_request_between_good_ones_reserves_no_data():
    ids, starts, work, sums, bads = _synthetic([40, 35, 50], 13)
    bads[int(starts[1]) + 20] = True
    (_, counters, grand), _ = _check_look_back(ids, starts, work, sums,
                                               bads, seeds=range(5))
    good0, bad, good2 = (counters[i] for i in ids)
    assert bad[:2] == [1, 0]
    assert bad[2] == good2[2] == good0[1]
    assert grand == good0[1] + good2[1]


def test_many_wave_strings_case():
    """`arrow_cases.strings`, the card's many-wave case at a small size:
    one request, its tiles staged as one run, the plain step's lengths."""
    requests, buf = arrow_cases.strings(3000, 16, seed=3)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    assert not plan.staged and plan.str_tiles == -(-3000 // asm.TILE)
    computed, paths = _length_tiles(requests[0], plan.desc[0])
    assert (computed == 1).all() and set(paths) == {"run"}
    res = asm.assemble(plan)
    mat, keep = _code_points(requests[0])
    assert (np.diff(res.values(0).view(np.int32))
            == _utf8_lengths(mat, keep)).all()
    assert int(res.counters[0, asm.C_TOTAL]) == int(
        _utf8_lengths(mat, keep).sum())
