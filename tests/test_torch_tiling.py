"""The staging plan of the port's fused CUDA kernel, on the CPU.

The kernel (``cobrix_tpu_torch/csrc/fused_decode.cu``) copies a tile of
records x one byte window of the row into shared memory, each record at
its 16-byte phase in a row of ``staged_pitch(span)`` bytes, and decodes
every column of the window from there with window-relative offsets. The
windows are planned on the host (``fused_decode.plan_windows``). The card
is needed to run the kernel, not to check its plan:

* planner tests: every column lies in exactly one window, no field is
  split, each staged tile fits the budget, the windows are ordered and
  as few as the budget allows, and exp1's row is one window and exp3's
  several;
* an emulation of the staging (the same chunk arithmetic, phases, pitch,
  window-relative offsets and row-end rule as the kernel, then each
  window's columns through the plain decoders) is held exactly against
  ``fused_decode_plain`` on the grid cases and on the exp1 and exp3
  layouts, at several alignments of the matrix's first byte.

Tolerance: exact; every output is integer or bit-pattern arithmetic.
"""
import numpy as np
import pytest
import torch

from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
from cobrix_tpu_torch.ops import fused_decode as fused_decode_module
from cobrix_tpu_torch.ops.fused_decode import (STAGE_BYTES, TILE_RECORDS,
                                               FusedLayout, StridedGroup,
                                               decode_group_plain,
                                               fused_decode_plain,
                                               plan_windows, staged_pitch)
from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK, EXP3_COPYBOOK,
                                                 generate_exp1)
from cobrix_tpu_torch.testing.kernel_cases import kernel_cases

CASES = kernel_cases()
_LAYOUTS = {}


def _profile_layout(name: str) -> FusedLayout:
    if name not in _LAYOUTS:
        cb = EXP1_COPYBOOK if name == "exp1" else EXP3_COPYBOOK
        _LAYOUTS[name] = ColumnarDecoder(parse_copybook(cb),
                                         device="cpu").fused
    return _LAYOUTS[name]


def _case_layout(name: str) -> FusedLayout:
    dicts, _ = CASES[name](8, 1)
    return FusedLayout([StridedGroup.from_dict(d) for d in dicts])


def _layout(name: str) -> FusedLayout:
    return (_profile_layout(name) if name in ("exp1", "exp3")
            else _case_layout(name))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [1, 4, 15, 16, 17, 45, 1493, 1505, 3000])
def test_staged_pitch_holds_the_span_at_any_phase_in_odd_chunks(span):
    pitch = staged_pitch(span)
    assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
    assert pitch >= span + 15
    assert pitch - 32 < span + 15  # no more than one extra chunk


def _check_plan(offsets, widths, plan, stage_bytes=STAGE_BYTES):
    offsets, widths = np.asarray(offsets), np.asarray(widths)
    n = len(offsets)
    order, wins = plan.order, plan.windows
    assert sorted(order.tolist()) == list(range(n))
    assert np.all(np.diff(offsets[order]) >= 0)  # sorted by offset
    assert wins.dtype == np.int32 and wins.shape[1] == 5
    # the windows partition the columns, in order, none empty
    assert wins[0, 3] == 0 and wins[-1, 4] == n
    assert np.all(wins[1:, 3] == wins[:-1, 4])
    assert np.all(wins[:, 4] > wins[:, 3])
    assert np.all(np.diff(wins[:, 0]) >= 0)
    for lo, span, pitch, begin, end in wins.tolist():
        cols = order[begin:end]
        starts, ends = offsets[cols], offsets[cols] + widths[cols]
        # no field split; the window is exactly its fields' extent
        assert lo == starts.min() and lo + span == ends.max()
        assert pitch == staged_pitch(span)
        if len(cols) > 1:
            assert TILE_RECORDS * pitch <= stage_bytes
    return wins


@pytest.mark.parametrize("name", ["exp1", "exp3", "wide_row", "odd_row",
                                  "row_end", "irregular",
                                  "display_ebcdic-w38-s1-f0"])
def test_plan_partitions_columns_into_windows_that_fit(name):
    layout = _layout(name)
    _check_plan(layout.desc[:, 0], layout.desc[:, 3], layout.plan)


def test_exp1_row_is_one_window_and_exp3_row_several():
    exp1 = _profile_layout("exp1").plan.windows
    assert exp1.tolist() == [[0, 1493, 1520, 0, 190]]
    exp3 = _profile_layout("exp3").plan.windows
    assert len(exp3) == 11
    assert exp3[:, 4].max() == 4001
    # greedy cuts: every window but the last is as wide as the budget
    # lets 4-byte fields 4 bytes apart be (1,505 bytes at a 1,520 pitch)
    assert np.all(exp3[:-1, 1] == 1504) and np.all(exp3[:-1, 2] == 1520)


def test_wide_row_case_cuts_between_neighbouring_fields():
    layout = _case_layout("wide_row")
    wins = layout.plan.windows
    assert len(wins) >= 2
    # each cut falls in the gap between the last field of one window and
    # the first of the next: fields lie on both sides of it
    gaps = wins[1:, 0] - (wins[:-1, 0] + wins[:-1, 1])
    assert np.all((gaps >= 0) & (gaps < 16))


@pytest.mark.parametrize("stage_bytes", [STAGE_BYTES, 24 * 1024, 8 * 1024])
def test_plan_uses_as_few_windows_as_the_budget_allows(stage_bytes,
                                                        monkeypatch):
    layout = _profile_layout("exp3")
    off, wid = layout.desc[:, 0], layout.desc[:, 3]
    monkeypatch.setattr(fused_decode_module, "STAGE_BYTES", stage_bytes)
    plan = plan_windows(off, wid)
    _check_plan(off, wid, plan, stage_bytes)
    # fields are 4 bytes apart and 4 wide: the greedy count is the least
    per_window = (stage_bytes // TILE_RECORDS - 31) // 4 * 4
    extent = int((off + wid).max() - off.min())
    assert len(plan.windows) == -(-extent // per_window)


def test_a_field_wider_than_the_budget_gets_a_window_of_its_own():
    groups = [StridedGroup([0, 10], 4, "binary"),
              StridedGroup([20], 3000, "bcd", out="wide"),
              StridedGroup([3030], 2, "bcd")]
    layout = FusedLayout(groups)
    wins = _check_plan(layout.desc[:, 0], layout.desc[:, 3], layout.plan)
    big = [w for w in wins.tolist() if w[1] == 3000]
    assert len(big) == 1 and big[0][4] - big[0][3] == 1
    assert TILE_RECORDS * big[0][2] > STAGE_BYTES
    assert layout.max_pitch == big[0][2]


def test_tables_keep_descriptor_semantics_in_window_order():
    layout = _profile_layout("exp1")
    desc, wins = layout.tables_on(torch.device("cpu"))
    assert desc.dtype == torch.int32 and wins.dtype == torch.int32
    assert torch.equal(desc, torch.from_numpy(layout.desc[layout.plan.order]))
    assert layout.tables_on(torch.device("cpu"))[0] is desc  # cached


# ---------------------------------------------------------------------------
# the staged addressing, emulated
# ---------------------------------------------------------------------------

def _column_groups(layout: FusedLayout) -> np.ndarray:
    """The group index of each descriptor row."""
    return np.repeat(np.arange(len(layout.groups)),
                     [g.count for g in layout.groups])


def _stage(flat: np.ndarray, base: int, n: int, row_len: int, lo: int,
           span: int, pitch: int) -> tuple:
    """Each record's window as the kernel stages it: the aligned 16-byte
    chunks from the one holding byte `lo` of the record, enough to cover
    the span at any phase, bytes outside the matrix read 0; returns the
    [n, pitch] shared rows and each record's phase."""
    per_row = (span + 30) // 16
    first = base + np.arange(n, dtype=np.int64) * row_len + lo
    start = first & ~np.int64(15)
    addr = start[:, None] + np.arange(per_row * 16)[None, :]
    inside = (addr >= base) & (addr < base + n * row_len)
    buf = np.zeros((n, pitch), dtype=np.uint8)
    buf[:, :per_row * 16] = np.where(
        inside, flat[np.clip(addr - base, 0, max(flat.size - 1, 0))], 0)
    return buf, (first & 15).astype(np.int64)


def emulate_staged_decode(data: np.ndarray, layout: FusedLayout,
                          base: int = 0) -> dict:
    """The kernel's planes, computed from its staged shared rows: `base` is
    the matrix's first byte modulo 16 (a slice x[1:] gives 1, ...)."""
    n, row_len = data.shape
    flat = np.ascontiguousarray(data).reshape(-1)
    planes = layout.empty_planes(n, "cpu")
    desc = layout.desc[layout.plan.order]
    gid = _column_groups(layout)[layout.plan.order]
    for lo, span, pitch, begin, end in layout.plan.windows.tolist():
        buf, phase = _stage(flat, base, n, row_len, lo, span, pitch)
        lim = row_len - lo  # window positions at or past lim read 0
        for g_index in sorted(set(gid[begin:end].tolist())):
            ks = [k for k in range(begin, end) if gid[k] == g_index]
            g = layout.groups[g_index]
            wpos = desc[ks, 0][None, :, None] - lo + np.arange(
                g.width)[None, None, :]                       # [1, k, w]
            at = phase[:, None, None] + wpos                  # [n, k, w]
            slab = np.where(wpos < lim,
                            np.take_along_axis(
                                buf, np.clip(at, 0, pitch - 1).reshape(n, -1),
                                axis=1).reshape(at.shape), 0)
            outs = decode_group_plain(torch.from_numpy(slab.astype(np.uint8)),
                                      g)
            rows = (desc[ks][:, [6, 7, 8, 9]] if g.out == "wide"
                    else desc[ks][:, [6, 9]])
            plane_of = g.out_planes()
            for k, out in enumerate(outs):
                if k < rows.shape[1]:
                    dst = rows[:, k]
                else:  # the dots plane
                    dst = desc[ks, 10]
                planes[plane_of[k]][torch.from_numpy(dst.astype(np.int64))] = \
                    out.t().to(planes[plane_of[k]].dtype)
    return planes


def _assert_same_tuples(got, want, what):
    for gi, (g_out, w_out) in enumerate(zip(got, want)):
        assert len(g_out) == len(w_out), (what, gi)
        for k, (a, b) in enumerate(zip(g_out, w_out)):
            assert a.dtype == b.dtype, (what, gi, k, a.dtype, b.dtype)
            assert torch.equal(a, b), f"{what}: group {gi} output {k}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_addressing_matches_plain_on_the_grid(name):
    dicts, data = CASES[name](40, 21)
    layout = FusedLayout([StridedGroup.from_dict(d) for d in dicts])
    base = (1, 7, 13, 0)[sorted(CASES).index(name) % 4]
    got = layout.split(emulate_staged_decode(data, layout, base))
    want = fused_decode_plain(torch.from_numpy(data), layout.groups)
    _assert_same_tuples(got, want, name)


@pytest.mark.parametrize("base", [0, 1, 8])
def test_staged_addressing_matches_plain_on_exp1(base):
    layout = _profile_layout("exp1")
    data = generate_exp1(300, seed=5)
    data[-40:] = np.random.default_rng(5).integers(0, 256, size=(40, 1493),
                                                   dtype=np.uint8)
    got = layout.split(emulate_staged_decode(data, layout, base))
    want = fused_decode_plain(torch.from_numpy(data), layout.groups)
    _assert_same_tuples(got, want, f"exp1 base {base}")


@pytest.mark.parametrize("base", [0, 3])
def test_staged_addressing_matches_plain_on_exp3(base):
    layout = _profile_layout("exp3")
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=(200, 16064), dtype=np.uint8)
    got = layout.split(emulate_staged_decode(data, layout, base))
    want = fused_decode_plain(torch.from_numpy(data), layout.groups)
    _assert_same_tuples(got, want, f"exp3 base {base}")
