"""The work plan of the port's aggregate kernel, on the CPU.

The kernel (``cobrix_tpu_torch/csrc/aggregate.cu``) runs only on the card;
its plan is modelled here in numpy, step for step, from the tables that
``ops/aggregate.py::AggregateSpec`` builds on the host:

* classes (one kind and scale mode each; a launch apiece) and runs (a
  class's columns of one field), each column weighing its bytes a row;
* a class's flat line of (row bytes x 16-row units) positions, cut into
  equal shares, one a block, for a grid of G blocks (at most one block a
  position); a block takes the units that start in its share;
* a unit is read with whole 16-byte words where it is full and every
  plane's row is 16-byte aligned (the aligned body); otherwise (a
  column's last, partial unit, or a row that is not aligned) row by row;
* one partial a (block, run) at slot ``slot0[class] + run + block``, and
  the combine's reads: a field's runs in class order, each run's blocks
  from the block of its first position to the block of its last.

Checked: every (column, row < min(n, N)) is covered exactly once; every
partial slot is written once, inside the scratch the wrapper allocates,
and read by the combine exactly where written; walked in plan order (a
unit's min and max taken on its integers where the value is a
non-decreasing function of them, unscaled int32 units summed exactly),
the plan gives ``aggregate_plain``'s counts, min and max exactly and its
sums to rtol 1e-12 (another order of additions). Cases: N = 1, 15, 16,
17, 37 and 2,304 rows over the exp1, exp3 (NUM1, NUM2) and wide PIC P
specs, n as an int, a 0-d tensor, 0 and past N, grids of 1, 7 and 264
blocks and one grid a class; and the on-HBM pipeline's 63,232 rows
(50,002 live) over a subset of the columns with seeded planes.

Tolerance: exact, sums to rtol 1e-12.
"""
import functools

import numpy as np
import pytest
import torch

from cobrix_tpu_torch import parse_copybook
from cobrix_tpu_torch.api import parse_options
from cobrix_tpu_torch.ops import aggregate as ag
from cobrix_tpu_torch.parallel import DeviceAggregator
from cobrix_tpu_torch.reader.var_len_reader import VarLenReader
from cobrix_tpu_torch.testing.aggregate_cases import WIDE_COPYBOOK, wide_rows
from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                 EXP3_COPYBOOK,
                                                 generate_exp1, generate_exp3)

UNIT = ag.UNIT_ROWS
RDW = {"is_record_sequence": "true", "segment_field": "SEGMENT-ID",
       "redefine-segment-id-map:0": "STATIC-DETAILS => C",
       "redefine-segment-id-map:1": "CONTACTS => P"}
_PLANE = {"i32": 4, "i64": 8, "bool": 1}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _exp3_wide_records(n):
    """n 'C' records of exp3 (16,064 bytes), from a walk of the headers."""
    raw = generate_exp3(40, seed=6)
    rows, pos = [], 0
    while pos + 4 <= len(raw):
        length = raw[pos + 2] | raw[pos + 3] << 8
        if length >= 1000:
            rows.append(np.frombuffer(raw[pos + 4:pos + 4 + length], np.uint8))
        pos += 4 + length
    mat = np.zeros((len(rows), max(len(r) for r in rows)), np.uint8)
    for row, r in zip(mat, rows):
        row[:len(r)] = r
    return np.resize(mat, (n, mat.shape[1]))


def _aggregator(name):
    if name == "exp1":
        return DeviceAggregator(parse_copybook(EXP1_COPYBOOK), device="cpu")
    if name == "wide":
        return DeviceAggregator(parse_copybook(WIDE_COPYBOOK), device="cpu")
    reader = VarLenReader(EXP3_COPYBOOK, parse_options(RDW), device="cpu")
    return DeviceAggregator(reader.copybook, columns=["NUM1", "NUM2"],
                            active_segment="STATIC_DETAILS", device="cpu")


@functools.lru_cache(maxsize=None)
def _case(name, N):
    """(aggregator, decoded planes) of N records of the spec."""
    agg = _aggregator(name)
    if name == "exp1":
        rows = np.resize(generate_exp1(40, seed=4), (N, 1493))
    elif name == "wide":
        rows = np.resize(wide_rows(), (N, wide_rows().shape[1]))
    else:
        rows = _exp3_wide_records(N)
    x, _ = agg.put(rows)
    assert x.shape[0] == N
    return agg, agg.decoder.decode_planes(x).planes


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _live(n, N):
    n = int(n) if isinstance(n, torch.Tensor) else n
    return max(0, min(n, N))


def _grids(spec, grid):
    """Each class's grid: one size for all, or a size a class."""
    if callable(grid):
        return [grid(c) for c in range(spec.classes.shape[0])]
    return [grid] * spec.classes.shape[0]


def model_plan(spec, N, n, grids):
    """The kernel's walk. Returns (chunks, reads, slots): a chunk is
    (class, block, run, slot, col0, k0, k1), the units [k0, k1) of a run
    that a block takes (unit k: column col0 + k // units, rows from
    16 * (k % units)); reads maps each slot the combine reads to its
    output field's index; slots is the scratch's size."""
    units = -(-_live(n, N) // UNIT)
    chunks, slot0, base = [], [], 0
    for c, cls in enumerate(spec.classes):
        slot0.append(base - int(cls[ag._C_RUN0]))
        base += grids[c] - 1 + int(cls[ag._C_RUN1] - cls[ag._C_RUN0])
    for c, cls in enumerate(spec.classes):
        weight = int(cls[ag._C_WEIGHT])
        run0, run1 = int(cls[ag._C_RUN0]), int(cls[ag._C_RUN1])
        total = int(cls[ag._C_ROW_BYTES]) * units
        blocks = min(grids[c], total)
        for b in range(blocks):
            w0, w1 = b * total // blocks, (b + 1) * total // blocks
            assert w1 > w0  # every block a non-empty share
            # the run holding w0: the last starting at or before it
            lo, hi = run0, run1 - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if spec.runs[mid, ag._R_START] * units <= w0:
                    lo = mid
                else:
                    hi = mid - 1
            for r in range(lo, run1):
                start = int(spec.runs[r, ag._R_START]) * units
                if start >= w1:
                    break
                col0 = int(spec.runs[r, ag._R_COL0])
                k_max = (int(spec.runs[r, ag._R_COL1]) - col0) * units
                k0 = -(-(w0 - start) // weight) if w0 > start else 0
                k1 = min(-(-(w1 - start) // weight), k_max)
                chunks.append((c, b, r, slot0[c] + r + b, col0, k0, k1))
    reads = {}
    for fi in range(len(spec.field_ptr) - 1):
        for p in range(spec.field_ptr[fi], spec.field_ptr[fi + 1]):
            r = int(spec.field_runs[p])
            c = int(spec.runs[r, ag._R_CLASS])
            total = int(spec.classes[c, ag._C_ROW_BYTES]) * units
            if total == 0:
                continue
            blocks = min(grids[c], total)
            a = int(spec.runs[r, ag._R_START]) * units
            z = (int(spec.runs[r, ag._R_START])
                 + (int(spec.runs[r, ag._R_COL1] - spec.runs[r, ag._R_COL0]))
                 * int(spec.classes[c, ag._C_WEIGHT])) * units
            for b in range(((a + 1) * blocks - 1) // total,
                           (z * blocks - 1) // total + 1):
                assert slot0[c] + r + b not in reads
                reads[slot0[c] + r + b] = fi
    return chunks, reads, base


def _row_ptr(planes, plane, rows, r0):
    """Addresses of plane rows `rows` at rows r0 (arrays)."""
    N = planes[plane].shape[1]
    return planes[plane].data_ptr() + (rows * N + r0) * _PLANE[plane]


def model_walk(spec, planes, n, grids):
    """Walk the plan in order: each unit's count, sum and min and max
    keys (the min and max at the integer extremes where the kernel takes
    them, asserted equal to the keys' own), a partial a slot, the combine
    by field into fresh stats. Returns ((counts, sums, mins, maxs) numpy
    arrays, the units' (column, r0, cnt) arrays, the units read as whole
    words, the full units)."""
    N = planes["bool"].shape[1]
    live = _live(n, N)
    units = -(-live // UNIT)
    chunks, reads, n_slots = model_plan(spec, N, n, grids)
    slots = sorted({ch[3] for ch in chunks})
    assert len(slots) == len(chunks)  # one partial a (block, run)
    # every slot written is read by the combine, nothing else is read
    assert set(reads) == set(slots)
    assert all(0 <= s < n_slots for s in slots)
    desc, factor, table, _ = spec.tables_on(torch.device("cpu"))
    d = desc.to(torch.int64)
    ok_plane = planes["bool"].numpy()
    part = {s: [0.0, 0, ag._INT64_MAX, ag._INT64_MIN] for s in slots}
    all_cols, all_r0, all_cnt = [], [], []
    vector = full = 0
    j = np.arange(UNIT)
    for c, cls in enumerate(spec.classes):
        kind, mode = int(cls[ag._C_KIND]), int(cls[ag._C_MODE])
        mine = [ch for ch in chunks if ch[0] == c]
        if not mine:
            continue
        k = np.concatenate([np.arange(ch[5], ch[6]) for ch in mine])
        slot = np.concatenate([np.full(ch[6] - ch[5], ch[3]) for ch in mine])
        col = np.concatenate([ch[4] + np.arange(ch[5], ch[6]) // units
                              for ch in mine])
        r0 = (k % units) * UNIT
        cnt = np.minimum(UNIT, live - r0)
        all_cols.append(col)
        all_r0.append(r0)
        all_cnt.append(cnt)
        # the aligned body: full units whose every plane row is aligned
        rows = d[col].numpy()
        bits = _row_ptr(planes, "bool", rows[:, ag._D_VALID], r0) | \
            _row_ptr(planes, "i32" if kind == ag.KIND_I32 else "i64",
                     rows[:, ag._D_VALUE], r0)
        if kind == ag.KIND_WIDE:
            bits |= _row_ptr(planes, "i64", rows[:, ag._D_LO], r0) | \
                _row_ptr(planes, "bool", rows[:, ag._D_NEG], r0)
        if mode == ag.MODE_DOTS:
            bits |= _row_ptr(planes, "i32", rows[:, ag._D_DOTS], r0)
        full += int((cnt == UNIT).sum())
        vector += int(((cnt == UNIT) & (bits % 16 == 0)).sum())
        # the units' rows: values, integers and flags, [units, 16]
        uniq, inv = np.unique(col, return_inverse=True)
        ci = torch.from_numpy(uniq)
        v = ag._column_values(planes, d[ci], kind, mode, factor[ci],
                              table).numpy()
        plane = "i32" if kind == ag.KIND_I32 else "i64"
        x = planes[plane][d[ci, ag._D_VALUE]].to(torch.int64).numpy()
        at = np.minimum(r0[:, None] + j[None, :], N - 1)
        rr = np.arange(len(col))[:, None]
        ok = ok_plane[rows[:, ag._D_VALID][:, None], at] & \
            (j[None, :] < cnt[:, None])
        v, x = v[inv[:, None], at], x[inv[:, None], at]
        keys = ag.order_key(torch.from_numpy(np.ascontiguousarray(v))).numpy()
        count = ok.sum(1)
        lo = np.where(ok, keys, ag._INT64_MAX).min(1)
        hi = np.where(ok, keys, ag._INT64_MIN).max(1)
        if kind != ag.KIND_WIDE and mode in (ag.MODE_NONE, ag.MODE_CONST):
            # the kernel's shortcut: min and max at the integer extremes
            some = count > 0
            at_lo = np.where(ok, x, np.iinfo(np.int64).max).argmin(1)
            at_hi = np.where(ok, x, np.iinfo(np.int64).min).argmax(1)
            assert (keys[rr[:, 0], at_lo][some] == lo[some]).all()
            assert (keys[rr[:, 0], at_hi][some] == hi[some]).all()
        if kind == ag.KIND_I32 and mode == ag.MODE_NONE:
            sums = np.where(ok, x, 0).sum(1).astype(np.float64)
        else:
            sums = np.where(ok, v, 0.0).sum(1)
        # each slot's units in plan order
        for sl in np.unique(slot):
            m = slot == sl
            p = part[int(sl)]
            p[0] += float(np.sum(sums[m]))
            p[1] += int(count[m].sum())
            p[2], p[3] = min(p[2], lo[m].min()), max(p[3], hi[m].max())
    stats = ag.new_stats(spec.n_fields, "cpu")
    out_sums, out_counts = stats.sums.numpy(), stats.counts.numpy()
    out_mins, out_maxs = stats.mins.numpy(), stats.maxs.numpy()
    for s in sorted(reads, key=lambda s: (reads[s], s)):
        fi = reads[s]
        field = int(spec.runs[spec.field_runs[spec.field_ptr[fi]],
                              ag._R_FIELD])
        total, count, lo, hi = part[s]
        out_sums[field] += total
        out_counts[field] += count
        out_mins[field] = min(out_mins[field], lo)
        out_maxs[field] = max(out_maxs[field], hi)
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
    return ((out_counts, out_sums, out_mins, out_maxs),
            (cat(all_cols), cat(all_r0), cat(all_cnt)), vector, full)


def _coverage(spec, units, N, n):
    """Every (column, row < min(n, N)) in exactly one unit."""
    live = _live(n, N)
    col, r0, cnt = units
    seen = np.zeros((spec.n_cols, live), dtype=np.int64)
    j = np.arange(UNIT)
    take = j[None, :] < cnt[:, None]
    np.add.at(seen, (np.broadcast_to(col[:, None], take.shape)[take],
                     (r0[:, None] + j[None, :])[take]), 1)
    assert (seen == 1).all()


def _assert_plain(spec, planes, n, got):
    want = ag.aggregate_plain(planes, spec, n, ag.new_stats(spec.n_fields,
                                                            "cpu"))
    counts, sums, mins, maxs = got
    np.testing.assert_array_equal(counts, want.counts.numpy())
    np.testing.assert_array_equal(mins, want.mins.numpy())
    np.testing.assert_array_equal(maxs, want.maxs.numpy())
    np.testing.assert_allclose(sums, want.sums.numpy(), rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exp1", "exp3", "wide"])
def test_plan_tables(name):
    """Classes tile the sorted columns, runs tile each class by field, the
    row bytes add up, and each output field lists its runs once."""
    spec = _aggregator(name).spec
    d = spec.desc
    assert (np.diff(d[:, ag._D_KIND] * 4 + d[:, ag._D_MODE]) >= 0).all()
    col = 0
    for c, cls in enumerate(spec.classes):
        assert cls[ag._C_WEIGHT] == ag.row_weight(cls[ag._C_KIND],
                                                  cls[ag._C_MODE])
        start = 0
        for r in range(cls[ag._C_RUN0], cls[ag._C_RUN1]):
            run = spec.runs[r]
            assert run[ag._R_COL0] == col and run[ag._R_CLASS] == c
            assert run[ag._R_START] == start
            cols = d[run[ag._R_COL0]:run[ag._R_COL1]]
            assert (cols[:, ag._D_FIELD] == run[ag._R_FIELD]).all()
            assert (cols[:, ag._D_KIND] == cls[ag._C_KIND]).all()
            assert (cols[:, ag._D_MODE] == cls[ag._C_MODE]).all()
            start += (run[ag._R_COL1] - run[ag._R_COL0]) * cls[ag._C_WEIGHT]
            col = run[ag._R_COL1]
        assert start == cls[ag._C_ROW_BYTES]
    assert col == spec.n_cols
    assert spec.row_bytes == spec.classes[:, ag._C_ROW_BYTES].sum()
    assert sorted(spec.field_runs.tolist()) == list(range(len(spec.runs)))
    for fi in range(len(spec.field_ptr) - 1):
        runs = spec.field_runs[spec.field_ptr[fi]:spec.field_ptr[fi + 1]]
        assert len(set(spec.runs[runs, ag._R_FIELD])) == 1
        assert list(runs) == sorted(runs)  # class order
    if name == "exp1":  # every kind and mode but the wide digit ones
        assert len(spec.classes) == 10


N_KINDS = ["int", "tensor", "zero", "past"]
GRIDS = {"1": 1, "7": 7, "264": 264, "by_class": lambda c: 3 + 5 * c}
# exp3's 4,000 columns at 2,304 rows are the block query's shape, held on
# the card by chip_smoke.py phase 10; here exp1 takes that row count
CASES = [(name, N) for name in ("exp1", "exp3", "wide")
         for N in (1, 15, 16, 17, 37, 2304) if (name, N) != ("exp3", 2304)]


def _n(kind, N):
    return {"int": max(N - 3, 0), "tensor": torch.tensor(N, dtype=torch.int32),
            "zero": 0, "past": N + 9}[kind]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("n_kind", N_KINDS)
@pytest.mark.parametrize("name,N", CASES)
def test_plan_covers_and_matches_plain(name, N, n_kind, grid):
    agg, planes = _case(name, N)
    spec = agg.spec
    n = _n(n_kind, N)
    got, units, vector, full = model_walk(spec, planes, n,
                                          _grids(spec, GRIDS[grid]))
    _coverage(spec, units, N, n)
    _assert_plain(spec, planes, n, got)
    if N % UNIT == 0:  # the aligned body: every full unit as whole words
        assert vector == full
    if _live(n, N) == 0:
        assert len(units[0]) == 0


def _subset_spec(spec, cols):
    """The spec's columns `cols` over compact planes: (spec, plane rows a
    plane) with each column's rows renumbered."""
    rows = {"i32": 0, "i64": 0, "bool": 0}
    new = []

    def take(p):
        rows[p] += 1
        return rows[p] - 1

    for i in cols:
        d = spec.desc[i]
        kind, mode = int(d[ag._D_KIND]), int(d[ag._D_MODE])
        value = take("i32" if kind == ag.KIND_I32 else "i64")
        lo = take("i64") if kind == ag.KIND_WIDE else -1
        neg = take("bool") if kind == ag.KIND_WIDE else -1
        dots = take("i32") if mode == ag.MODE_DOTS else -1
        new.append(ag.AggregateColumn(value, lo, neg, take("bool"), dots,
                                      kind, mode, int(d[ag._D_SF]),
                                      int(d[ag._D_FIELD]),
                                      float(spec.factor[i])))
    return ag.AggregateSpec(new, [], spec.n_fields), rows


def test_pipeline_shape_column_subset():
    """63,232 rows, 50,002 live (a 0-d n), the grid of the card: a column
    of every class of exp1 over seeded planes."""
    spec = _aggregator("exp1").spec
    first = [int(spec.runs[c[ag._C_RUN0], ag._R_COL0]) for c in spec.classes]
    sub, rows = _subset_spec(spec, first + [first[0] + 1, first[4] + 1])
    N, n = 63232, torch.tensor(50002, dtype=torch.int32)
    rng = np.random.default_rng(12)
    planes = {
        "i32": torch.from_numpy(rng.integers(-10 ** 9, 10 ** 9,
                                             size=(rows["i32"], N),
                                             dtype=np.int32)),
        "i64": torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62,
                                             size=(rows["i64"], N),
                                             dtype=np.int64)),
        "bool": torch.from_numpy(rng.random((rows["bool"], N)) < 0.9)}
    # dot counts 0-6 where a column has them
    for d in sub.desc:
        if d[ag._D_DOTS] >= 0:
            planes["i32"][d[ag._D_DOTS]] = torch.from_numpy(
                rng.integers(0, 7, size=N, dtype=np.int32))
    got, units, vector, full = model_walk(sub, planes, n, _grids(sub, 264))
    _coverage(sub, units, N, n)
    _assert_plain(sub, planes, n, got)
    assert vector == full == sub.n_cols * (50002 // UNIT)
