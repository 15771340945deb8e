"""The port's fused numeric decode against the JAX package's Pallas kernel.

Every case of the shared grid (``cobrix_tpu_torch.testing.kernel_cases``)
builds both specs from one dict and one seeded record matrix. On the CPU
the port's wrapper takes its plain version (gather + batch_torch); the
JAX side runs ``pallas_tpu.build_fused_decode`` in interpret mode, as
``tests/test_pallas_kernels.py`` runs it. Tolerance: exact. Every output
is integer or bit-pattern arithmetic, and dtypes are compared after the
host view (wide hi/lo as uint64). The CUDA kernel itself is held against
the plain version on the card (the ``cuda`` test below and
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from cobrix_tpu.ops import pallas_tpu
from cobrix_tpu_torch.ops.fused_decode import (FusedLayout, StridedGroup,
                                               fused_decode,
                                               fused_decode_plain)
from cobrix_tpu_torch.testing.kernel_cases import (jax_subset, kernel_cases,
                                                   kernel_input)

from conftest import jax_usable

N_ROWS = 48
CASES = kernel_cases()


def _host(groups, outs):
    """Port tuples -> numpy with the JAX package's host dtypes."""
    res = []
    for g, out in zip(groups, outs):
        arrs = [o.cpu().numpy() if isinstance(o, torch.Tensor) else o
                for o in out]
        if g.out == "wide":
            arrs[0] = arrs[0].view(np.uint64)
            arrs[1] = arrs[1].view(np.uint64)
        res.append(arrs)
    return res


def _assert_same(got, want, name):
    assert len(got) == len(want), name
    for gi, (g_out, w_out) in enumerate(zip(got, want)):
        assert len(g_out) == len(w_out), (name, gi)
        for k, (a, b) in enumerate(zip(g_out, w_out)):
            b = np.asarray(b)
            assert a.dtype == b.dtype, (name, gi, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {gi} {k}")


@pytest.mark.skipif(not jax_usable(), reason="jax backend unusable")
@pytest.mark.parametrize("name", jax_subset())
def test_plain_matches_pallas_kernel(name):
    dicts, data = CASES[name](N_ROWS, 11)
    fn = pallas_tpu.build_fused_decode(
        [pallas_tpu.StridedGroup(**d) for d in dicts], data.shape[1])
    want = [[np.asarray(o) for o in out] for out in fn(data)]
    groups = [StridedGroup.from_dict(d) for d in dicts]
    got = _host(groups, fused_decode_plain(torch.from_numpy(data), groups))
    _assert_same(got, want, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_planes_on_cpu(name):
    """The wrapper's CPU route writes the plain tuples into the planes;
    `split` gives them back, on the device and on the host."""
    dicts, data = CASES[name](16, 5)
    groups = [StridedGroup.from_dict(d) for d in dicts]
    layout = FusedLayout(groups)
    t = torch.from_numpy(data)
    before = fused_decode.launches
    planes = fused_decode(t, layout)
    assert fused_decode.launches == before  # the plain version launches nothing
    want = _host(groups, fused_decode_plain(t, groups))
    _assert_same(_host(groups, layout.split(planes)), want, name)
    host = layout.split({k: v.numpy() for k, v in planes.items()})
    _assert_same([list(o) for o in host], want, name)


def test_layout_descriptors_and_bound():
    groups = [StridedGroup([0, 8], 4, "binary"),
              StridedGroup([4], 20, "display_ebcdic", out="wide",
                           signed=True, dyn_sf=-3)]
    layout = FusedLayout(groups)
    assert layout.rows == {"i32": 3, "i64": 2, "bool": 4}
    assert layout.desc.shape == (3, 12)
    # binary: value rows 0,1 of i32; valid rows 0,1 of bool
    assert layout.desc[1].tolist()[:11] == [8, 0, 0, 4, 10, 0, 1, -1, -1, 1, -1]
    # display wide: hi/lo rows of i64, neg/valid of bool, dots row of i32
    assert layout.desc[2].tolist()[:11] == [4, 2, 2, 20, 11, -3, 0, 1, 2, 3, 2]
    assert layout.bytes_per_record() == (28, 3 * 4 + 2 * 8 + 4)


@pytest.mark.parametrize("bad", [
    dict(offsets=[0], width=5, kind="binary", out="i32"),
    dict(offsets=[0], width=4, kind="binary", out="i64"),
    dict(offsets=[0], width=17, kind="binary", out="wide"),
    dict(offsets=[0], width=10, kind="display_ascii", out="i32"),
    dict(offsets=[0], width=4, kind="zoned", out="i32"),
    dict(offsets=[], width=4, kind="bcd", out="i32"),
])
def test_spec_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        StridedGroup.from_dict(bad)


def test_wrapper_rejects_bad_inputs():
    layout = FusedLayout([StridedGroup([0], 2, "binary")])
    with pytest.raises(ValueError):
        fused_decode(torch.zeros((4, 8), dtype=torch.int32), layout)
    with pytest.raises(ValueError):
        fused_decode(torch.zeros((4, 8, 2), dtype=torch.uint8), layout)
    with pytest.raises(ValueError):
        fused_decode(torch.zeros((8, 4), dtype=torch.uint8).t(), layout)
    with pytest.raises(TypeError):
        fused_decode(np.zeros((4, 8), dtype=np.uint8), layout)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every case of the grid through the CUDA kernel and its plain
    version on the card (``chip_smoke.py`` runs the same at 4,096 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    for name, case in CASES.items():
        dicts, data = case(1024, 3)
        groups = [StridedGroup.from_dict(d) for d in dicts]
        layout = FusedLayout(groups)
        t = kernel_input(name, data, "cuda")
        got = layout.split(fused_decode(t, layout))
        want = fused_decode_plain(t, groups)
        torch.cuda.synchronize()
        for a_out, b_out in zip(got, want):
            for a, b in zip(a_out, b_out):
                assert a.dtype == b.dtype and torch.equal(a, b), name
