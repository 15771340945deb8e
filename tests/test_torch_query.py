"""The port's device-resident query path against the JAX package's.

The same numpy-seeded bytes go through ``cobrix_tpu.parallel`` (JAX on the
CPU, its default "jax" backend, as ``tests/test_device_query.py`` runs
it) and through ``cobrix_tpu_torch.parallel`` with ``device="cpu"``,
where the aggregate kernel's wrapper takes its plain version
(``ops.aggregate.aggregate_plain``). The cases are those of
``tests/test_device_query.py``, the wide and PIC P aggregate and the wide
``decode_stats`` of ``tests/test_wide_numerics.py``, ``decode_stats`` on
exp1, and ``build_wide_pipeline`` of ``tests/test_device_framing.py``.

Tolerances, per assertion: counts and records exact; min and max exact
where the scale is a constant power of ten, and within 4 ULP where the
JAX program takes ``jnp.power(10.0, -k)`` (the DISPLAY dot plane and the
PIC P digit counts: the port's table holds Python's ``10.0 ** -k``);
sums to ``rtol 1e-12`` (another order of additions). The CUDA kernels are
held against their plain versions by the ``cuda`` tests at the end (they
skip here) and by ``chip_smoke.py`` phase 10.
"""
import struct

import numpy as np
import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu import native
from cobrix_tpu.copybook.copybook import parse_copybook as jax_parse
from cobrix_tpu.copybook.datatypes import FloatingPointFormat as JaxFP
from cobrix_tpu.ops import device_framing as jdf
from cobrix_tpu.parallel import DeviceAggregator as JaxAggregator
from cobrix_tpu.parallel import ShardedColumnarDecoder as JaxSharded
from cobrix_tpu.parallel import aggregate_file as jax_aggregate_file
from cobrix_tpu.reader.columnar import ColumnarDecoder as JaxDecoder
from cobrix_tpu.reader.columnar import _digit_count, _digit_count_limbs
from cobrix_tpu.testing.generators import (EXP1_COPYBOOK, EXP3_COPYBOOK,
                                           encode_bcd_digits,
                                           encode_comp3_unsigned,
                                           encode_comp_be,
                                           encode_display_unsigned,
                                           generate_exp1, generate_exp3)
from cobrix_tpu_torch import parse_copybook as port_parse
from cobrix_tpu_torch.copybook.datatypes import FloatingPointFormat
from cobrix_tpu_torch.ops import aggregate as ag
from cobrix_tpu_torch.ops import device_framing as pdf
from cobrix_tpu_torch.parallel import (DeviceAggregator,
                                       ShardedColumnarDecoder,
                                       aggregate_file, merge_aggregates,
                                       pad_batch_to_multiple,
                                       sharded_decode)
from cobrix_tpu_torch.parallel.mesh import mesh_device
from cobrix_tpu_torch.reader.columnar import ColumnarDecoder
from cobrix_tpu_torch.testing.aggregate_cases import WIDE_COPYBOOK, wide_rows

pytestmark = pytest.mark.jax

COPYBOOK = """
        01  R.
            05  A       PIC 9(4)      COMP.
            05  B       PIC S9(5)V99  COMP-3.
            05  C       PIC 9(3).
            05  CV      PIC 9(3)V99.
            05  D       COMP-2.
            05  BAD     PIC 9(5)      COMP-3.
            05  E OCCURS 3.
               10  X    PIC 9(7)      COMP.
"""

N = 37  # not a multiple of any block below: padding is forced
CPU = "cpu"


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    a = rng.integers(1, 9999, size=N)
    b = rng.integers(1, 9999999, size=N)
    c = rng.integers(1, 999, size=N)
    cv = rng.integers(1, 99999, size=N)
    d = rng.uniform(-1000.0, 1000.0, size=N)
    x = rng.integers(1, 9999999, size=(N, 3))
    parts = [
        encode_comp_be(a, 2),
        encode_comp3_unsigned(b, 7),
        encode_display_unsigned(c, 3),
        encode_display_unsigned(cv, 5),
        np.frombuffer(b"".join(struct.pack(">d", v) for v in d),
                      dtype=np.uint8).reshape(N, 8),
        np.full((N, 3), 0xFF, dtype=np.uint8),
        encode_comp_be(x[:, 0], 4),
        encode_comp_be(x[:, 1], 4),
        encode_comp_be(x[:, 2], 4),
    ]
    return np.concatenate(parts, axis=1), dict(a=a, b=b, c=c, cv=cv, d=d,
                                               x=x)


@pytest.fixture(scope="module")
def books():
    return (jax_parse(COPYBOOK, floating_point_format=JaxFP.IEEE754),
            port_parse(COPYBOOK,
                       floating_point_format=FloatingPointFormat.IEEE754))


def _ulps(a: float, b: float) -> int:
    ia, ib = (int(np.float64(v).view(np.int64)) for v in (a, b))
    ia = ia if ia >= 0 else -(ia & 0x7FFFFFFFFFFFFFFF)
    ib = ib if ib >= 0 else -(ib & 0x7FFFFFFFFFFFFFFF)
    return abs(ia - ib)


def assert_same_aggregates(got, want, ulps=None):
    """Counts exact, None where JAX has None, min and max exact (or
    within `ulps` for the fields named there), sums to rtol 1e-12."""
    ulps = ulps or {}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g["count"] == w["count"], name
        for key in ("sum", "min", "max"):
            if w[key] is None:
                assert g[key] is None, (name, key)
                continue
            if key == "sum":
                assert g[key] == pytest.approx(w[key], rel=1e-12, abs=0), name
            elif name in ulps:
                assert _ulps(g[key], w[key]) <= ulps[name], (name, key)
            else:
                assert g[key] == w[key], (name, key)


# ---------------------------------------------------------------------------
# the cases of tests/test_device_query.py
# ---------------------------------------------------------------------------

def test_aggregate_equals_the_jax_package(books, dataset):
    data, _ = dataset
    jcb, pcb = books
    assert_same_aggregates(DeviceAggregator(pcb, device=CPU).aggregate(data),
                           JaxAggregator(jcb).aggregate(data))


@pytest.mark.parametrize("block", [64, 40])
def test_aggregate_masks_batch_padding(books, dataset, block):
    """Padding rows decode as valid zeros: the mask comes from n."""
    data, v = dataset
    jcb, pcb = books
    agg = DeviceAggregator(pcb, device=CPU)
    x, n = agg.put(data, block=block)
    assert x.shape[0] == block and n == N
    res = agg.aggregate_device(x, n)
    for name in ("A", "B", "C", "D", "X"):
        assert res[name]["count"] == (3 * N if name == "X" else N), name
    assert res["A"]["min"] == v["a"].min()
    assert res["A"]["max"] == v["a"].max()
    assert res["A"]["sum"] == v["a"].sum()
    assert res["B"]["sum"] == pytest.approx(v["b"].sum() / 100.0, rel=1e-12)
    assert res["CV"]["min"] == pytest.approx(v["cv"].min() / 100.0,
                                             rel=1e-15)
    assert res["X"]["sum"] == v["x"].sum()
    assert res["X"]["min"] == v["x"].min()
    assert_same_aggregates(res, JaxAggregator(jcb).aggregate(data))


def test_live_count_as_a_device_scalar(books, dataset):
    """`n` as a 0-d int32 tensor (what build_wide_pipeline leaves on the
    device) masks as the host int does."""
    data, _ = dataset
    agg = DeviceAggregator(books[1], device=CPU)
    x, n = agg.put(data, block=64)
    for k in (N, 20, 0):
        host = agg.aggregate_device(x, k)
        dev = agg.aggregate_device(x, torch.tensor(k, dtype=torch.int32))
        assert host == dev
    assert agg.aggregate_device(x, 0)["A"] == {
        "sum": None, "count": 0, "min": None, "max": None}


def test_aggregate_doubles_on_device(books, dataset):
    data, v = dataset
    res = DeviceAggregator(books[1], device=CPU).aggregate(data)
    assert res["D"]["count"] == N
    assert res["D"]["sum"] == pytest.approx(v["d"].sum(), rel=1e-12)
    assert res["D"]["min"] == v["d"].min()
    assert res["D"]["max"] == v["d"].max()


def test_all_invalid_field_reports_none_not_inf(books, dataset):
    data, _ = dataset
    res = DeviceAggregator(books[1], device=CPU).aggregate(data)
    assert res["BAD"] == {"sum": None, "count": 0, "min": None, "max": None}


def test_aggregate_projects_to_selected_columns(books, dataset):
    data, v = dataset
    jcb, pcb = books
    res = DeviceAggregator(pcb, columns=["A"], device=CPU).aggregate(data)
    assert set(res) == {"A"}
    assert res["A"]["sum"] == v["a"].sum() and res["A"]["count"] == N
    assert_same_aggregates(res, JaxAggregator(jcb, columns=["A"])
                           .aggregate(data))


def test_streamed_blocks_merge_to_single_shot(books, dataset):
    data, _ = dataset
    agg = DeviceAggregator(books[1], device=CPU)
    one = agg.aggregate(data)
    parts = []
    for i in range(0, N, 16):
        x, n = agg.put(data[i:i + 16], block=16)
        parts.append(agg.aggregate_device(x, n))
    merged = merge_aggregates(parts)
    for name in one:
        assert merged[name]["count"] == one[name]["count"], name
        for k in ("min", "max"):
            assert merged[name][k] == one[name][k], (name, k)
        if one[name]["sum"] is None:
            assert merged[name]["sum"] is None
        else:
            assert merged[name]["sum"] == pytest.approx(one[name]["sum"],
                                                        rel=1e-12)


def test_aggregate_file_helper(books, dataset):
    data, v = dataset
    jcb, pcb = books
    res = aggregate_file(pcb, data.tobytes(), device=CPU)
    assert res["A"]["sum"] == v["a"].sum()
    assert res["X"]["count"] == 3 * N
    assert_same_aggregates(res, jax_aggregate_file(jcb, data.tobytes()))


@pytest.mark.parametrize("columns", [["A", "X"], ["X"], ["B", "D"], None])
def test_byte_projection_equals_the_jax_package(books, dataset, columns):
    """The same merged ranges, cut-off and gather_index as the JAX
    package, and the same aggregates, one shot and streamed."""
    data, _ = dataset
    jcb, pcb = books
    agg = DeviceAggregator(pcb, columns=columns, device=CPU)
    jagg = JaxAggregator(jcb, columns=columns)
    assert agg.record_extent == jagg.record_extent
    if jagg.gather_index is None:
        assert agg.gather_index is None
    else:
        np.testing.assert_array_equal(agg.gather_index, jagg.gather_index)
        assert len(agg.gather_index) < agg.record_extent
    want = jagg.aggregate(data)
    assert_same_aggregates(agg.aggregate(data), want)
    parts = [agg.aggregate_device(*agg.put(data[i:i + 16], block=16))
             for i in range(0, N, 16)]
    assert_same_aggregates(merge_aggregates(parts), want)


def test_projection_leaves_later_reads_unchanged(books, dataset):
    """The byte projection rewrites the plan's offsets in place: only the
    aggregator's clone of the plan, and with a new fused layout and new
    device tables, never a later decoder's."""
    data, _ = dataset
    pcb = books[1]
    before = ColumnarDecoder(pcb, device=CPU)
    rows = before.decode(data).to_rows()
    agg = DeviceAggregator(pcb, columns=["A", "X"], device=CPU)
    assert agg.gather_index is not None
    after = ColumnarDecoder(pcb, device=CPU)
    assert [(c.name, c.offset) for c in after.plan.columns] == \
        [(c.name, c.offset) for c in before.plan.columns]
    assert after.decode(data).to_rows() == rows
    dec = agg.decoder
    old = dec.fused
    old_tables = old.tables_on(torch.device(CPU))
    offsets = [c.offset for c in dec.plan.columns]
    dec.rebuild_groups()
    assert dec.fused is not old
    new_tables = dec.fused.tables_on(torch.device(CPU))
    assert all(a is not b for a, b in zip(old_tables, new_tables))
    assert [c.offset for c in dec.plan.columns] == offsets


def test_projected_aggregator_then_read_cobol(books, dataset, tmp_path):
    data, _ = dataset
    path = tmp_path / "r.dat"
    path.write_bytes(data.tobytes())
    opts = dict(copybook_contents=COPYBOOK,
                floating_point_format="ieee754")
    want = cobrix_tpu.read_cobol(str(path), backend="numpy", **opts)
    DeviceAggregator(books[1], columns=["X"], device=CPU)
    got = cobrix_tpu_torch.read_cobol(str(path), device=CPU, **opts)
    assert got.to_rows() == want.to_rows()


# ---------------------------------------------------------------------------
# wide numerics, PIC P and decode_stats (tests/test_wide_numerics.py)
# ---------------------------------------------------------------------------

def test_wide_and_pic_p_aggregate_equal_the_jax_package():
    rows = wide_rows()
    got = DeviceAggregator(port_parse(WIDE_COPYBOOK), device=CPU) \
        .aggregate(rows)
    jcb = jax_parse(WIDE_COPYBOOK)
    assert_same_aggregates(got, JaxAggregator(jcb).aggregate(rows),
                           ulps={"P_BIN": 4, "P_DISP": 4})
    # and the host decode of the same rows
    host = JaxDecoder(jcb, backend="numpy").decode(rows)
    for name in ("WIDE_BCD", "P_BIN", "P_DISP"):
        col = next(c.index for c in host.decoder.plan.columns
                   if c.name == name)
        vals = [float(v) for v in host.column_values(col) if v is not None]
        assert got[name]["count"] == len(vals)
        assert got[name]["sum"] == pytest.approx(sum(vals), rel=1e-12)
        assert got[name]["min"] == pytest.approx(min(vals), rel=1e-12)
        assert got[name]["max"] == pytest.approx(max(vals), rel=1e-12)


def _stats_records():
    n = 16
    rng = np.random.default_rng(3)
    digits = rng.integers(0, 10, size=(n, 20)).astype(np.uint8)
    return np.concatenate([
        encode_bcd_digits(digits, np.full(n, 0x0C, dtype=np.uint8)),
        rng.integers(0, 256, size=(n, 2), dtype=np.uint8).astype(np.uint8),
    ], axis=1)


def test_decode_stats_counts_wide_groups():
    cb = """
       01 REC.
          05 W PIC S9(20) COMP-3.
          05 N PIC 9(4)   BINARY.
"""
    data = _stats_records()
    got = ShardedColumnarDecoder(port_parse(cb), device=CPU) \
        .decode_stats(data)
    assert got == JaxSharded(jax_parse(cb)).decode_stats(data)
    assert got["records"] == data.shape[0]
    assert got["bcd_w11"] == data.shape[0]
    assert got["valid_values"] == 2 * data.shape[0]


def test_exp1_decode_stats_equal_the_jax_package():
    """exp1 (tests/test_exp1_generator.py) with a junk tail, whole and
    from a padded device batch with n on the host and on the device."""
    data = np.concatenate([generate_exp1(32, seed=11),
                           np.random.default_rng(2).integers(
                               0, 256, size=(9, 1493), dtype=np.uint8)])
    want = JaxSharded(jax_parse(EXP1_COPYBOOK)).decode_stats(data)
    dec = ShardedColumnarDecoder(port_parse(EXP1_COPYBOOK), device=CPU)
    assert dec.decode_stats(data) == want
    x = torch.from_numpy(pad_batch_to_multiple(data, 64))
    n = data.shape[0]
    assert dec.decode_stats(x, n) == want
    assert dec.decode_stats(x, torch.tensor(n, dtype=torch.int32)) == want
    # a generated batch has no null numeric value
    numeric = sum(len(g.columns) for g in dec.kernel_groups
                  if g.codec.name.startswith(("BINARY", "BCD", "DISPLAY_NUM",
                                              "FLOAT", "DOUBLE")))
    assert dec.decode_stats(generate_exp1(32, seed=11))["valid_values"] \
        == 32 * numeric


def test_sharded_put_and_decode():
    data = generate_exp1(5, seed=3)
    dec = ShardedColumnarDecoder(port_parse(EXP1_COPYBOOK), device=CPU)
    x, n = dec.put(data)
    assert n == 5 and x.shape == data.shape and dec.n_devices == 1
    np.testing.assert_array_equal(x.numpy(), data)
    want = JaxDecoder(jax_parse(EXP1_COPYBOOK), backend="numpy") \
        .decode(data).to_rows()
    assert sharded_decode(port_parse(EXP1_COPYBOOK), data,
                          device=CPU).to_rows() == want


def test_mesh_of_one_device_only():
    cpu = torch.device(CPU)
    assert mesh_device(None, CPU) == cpu
    assert mesh_device([cpu]) == cpu
    with pytest.raises(NotImplementedError, match="A7"):
        mesh_device([cpu, cpu])
    with pytest.raises(NotImplementedError, match="A7"):
        DeviceAggregator(port_parse(COPYBOOK), mesh=[cpu, cpu])


# ---------------------------------------------------------------------------
# the plain version's arithmetic against the JAX package's helpers
# ---------------------------------------------------------------------------

def test_digit_counts_equal_the_jax_package():
    edges = [0, 1, -1, 9, 10, -10, 2 ** 31 - 1, -2 ** 31, 2 ** 63 - 1,
             -2 ** 63]
    edges += [s * (10 ** k + d) for k in range(1, 19) for d in (-1, 0)
              for s in (1, -1)]
    vals = np.array(edges, dtype=np.int64)
    np.testing.assert_array_equal(
        ag.digit_count(torch.from_numpy(vals)).numpy(), _digit_count(vals))
    rng = np.random.default_rng(5)
    mags = [0, 1, 2 ** 64 - 1, 2 ** 64, 2 ** 128 - 1] + [
        10 ** k + d for k in range(1, 39) for d in (-1, 0)] + [
        int(rng.integers(0, 2 ** 62)) << int(rng.integers(0, 66))
        for _ in range(40)]
    mags = [m % 2 ** 128 for m in mags]
    hi = np.array([m >> 64 for m in mags], dtype=np.uint64)
    lo = np.array([m & (2 ** 64 - 1) for m in mags], dtype=np.uint64)
    got = ag.digit_count_limbs(torch.from_numpy(hi.view(np.int64)),
                               torch.from_numpy(lo.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _digit_count_limbs(hi, lo))


def test_unsigned_conversion_rounds_once():
    rng = np.random.default_rng(9)
    bits = np.concatenate([rng.integers(0, 2 ** 63, size=500,
                                        dtype=np.int64).view(np.uint64),
                           rng.integers(0, 2 ** 63, size=500,
                                        dtype=np.int64).view(np.uint64)
                           | np.uint64(1 << 63),
                           np.array([0, 1, 2 ** 53 + 1, 2 ** 64 - 1,
                                     2 ** 63, 2 ** 63 + 1025],
                                    dtype=np.uint64)])
    got = ag.unsigned_to_double(torch.from_numpy(bits.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), bits.astype(np.float64))


def test_order_keys_keep_float_order():
    vals = np.array([-np.inf, -1e300, -2.5, -0.0, 0.0, 1e-300, 3.0, np.inf])
    keys = ag.order_key(torch.from_numpy(vals)).numpy()
    assert (np.diff(keys) > 0).all()
    np.testing.assert_array_equal(ag.key_values(keys), vals)
    assert np.isnan(ag.key_values(np.array([ag.NAN_MIN_KEY,
                                            ag.NAN_MAX_KEY]))).all()


def test_nan_doubles_propagate_as_in_the_jax_package():
    """On one device, as the port runs. (On the tests' 8-device CPU mesh
    the JAX package's cross-device min and max drop a shard's NaN.)"""
    from cobrix_tpu.parallel import data_mesh

    cb = """
       01 R.
          05 D COMP-2.
"""
    vals = [1.5, float("nan"), -2.0]
    data = np.frombuffer(b"".join(struct.pack(">d", v) for v in vals),
                         dtype=np.uint8).reshape(3, 8)
    got = DeviceAggregator(port_parse(
        cb, floating_point_format=FloatingPointFormat.IEEE754),
        device=CPU).aggregate(data)["D"]
    want = JaxAggregator(jax_parse(cb, floating_point_format=JaxFP.IEEE754),
                         mesh=data_mesh(1)).aggregate(data)["D"]
    assert got["count"] == want["count"] == 3
    for k in ("sum", "min", "max"):
        assert np.isnan(got[k]) and np.isnan(want[k]), k


# ---------------------------------------------------------------------------
# build_wide_pipeline (tests/test_device_framing.py)
# ---------------------------------------------------------------------------

def _jax_pipeline(raw, *args, **kw):
    import jax.numpy as jnp

    packed, count = jdf.build_wide_pipeline(*args, **kw)(
        jnp.asarray(np.frombuffer(raw, dtype=np.uint8)))
    return np.asarray(packed), int(count)


def _port_pipeline(raw, *args, **kw):
    image = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    packed, count = pdf.build_wide_pipeline(*args, **kw)(image)
    assert count.dtype == torch.int32 and count.dim() == 0
    return packed.numpy(), int(count)


def _zero_header(raw, k):
    offsets, _ = native.rdw_scan(raw, big_endian=False)
    out = bytearray(raw)
    p = int(offsets[k]) - 4
    out[p:p + 4] = b"\0\0\0\0"
    return bytes(out)


_TRUNCATED = (bytes([0, 0, 1200 % 256, 1200 // 256])
              + (bytes(range(1, 101)) * 12)[:900])

PIPELINE_CASES = {
    "plain": (generate_exp3(24, seed=5), 256, {}),
    "cap_below_the_wide_count": (generate_exp3(24, seed=5), 256,
                                 dict(cap=3)),
    "truncated_trailing_record": (_TRUNCATED, 1200, dict(cap=8)),
    "zero_header_mid_file": (_zero_header(generate_exp3(24, seed=5), 9),
                             256, {}),
    "big_endian_adjusted": (b"".join(
        (len(r) + 4).to_bytes(2, "big") + b"\0\0" + r
        for r in [bytes(1500), b"x" * 40, bytes(range(256)) * 5]), 1300,
        dict(big_endian=True, adjustment=-4, min_len=1000)),
    "columns": (generate_exp3(24, seed=5), 300,
                dict(columns=np.arange(10, 300, 7))),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_wide_pipeline_equals_the_jax_package(case):
    raw, extent, kw = PIPELINE_CASES[case]
    kw = dict(kw)
    cap = kw.pop("cap", 16)
    want, wn = _jax_pipeline(raw, extent, cap, **kw)
    got, gn = _port_pipeline(raw, extent, cap, **kw)
    assert gn == wn
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case == "truncated_trailing_record":
        assert gn == 1 and not got[0, 900:].any()
    if case == "cap_below_the_wide_count":
        assert gn == 3


def test_wide_pipeline_byte_projection_feeds_aggregator():
    """The projected pipeline output is the aggregator's packed layout:
    submitted with the live count left on the device, it aggregates as
    the JAX package's pipeline and aggregator do."""
    import jax.numpy as jnp

    from cobrix_tpu.reader.parameters import (
        MultisegmentParameters as JaxSeg, ReaderParameters as JaxParams)
    from cobrix_tpu.reader.var_len_reader import VarLenReader as JaxReader
    from cobrix_tpu_torch.reader.parameters import (MultisegmentParameters,
                                                    ReaderParameters)
    from cobrix_tpu_torch.reader.var_len_reader import VarLenReader

    seg = dict(segment_id_field="SEGMENT-ID",
               segment_id_redefine_map={"C": "STATIC_DETAILS",
                                        "P": "CONTACTS"})
    jreader = JaxReader(EXP3_COPYBOOK, JaxParams(
        is_record_sequence=True, multisegment=JaxSeg(**seg)))
    preader = VarLenReader(EXP3_COPYBOOK, ReaderParameters(
        is_record_sequence=True, multisegment=MultisegmentParameters(**seg)),
        device=CPU)
    raw = generate_exp3(24, seed=6)
    buf = np.frombuffer(raw, dtype=np.uint8)
    for columns in (["NUM1"], ["NUM1", "NUM2"]):
        jagg = JaxAggregator(jreader.copybook, columns=columns,
                             active_segment="STATIC_DETAILS")
        agg = DeviceAggregator(preader.copybook, columns=columns,
                               active_segment="STATIC_DETAILS", device=CPU)
        assert (agg.gather_index is None) == (jagg.gather_index is None)
        offsets, lengths = native.rdw_scan(raw, big_endian=False)
        wide = np.nonzero(lengths >= 1000)[0]
        cap = -(-(len(wide) + 3) // 8) * 8
        packed, count = jdf.build_wide_pipeline(
            jagg.record_extent, cap=cap, columns=jagg.gather_index)(
            jnp.asarray(buf))
        want = jagg.fetch(jagg.submit(packed, np.int32(count)))
        fn = pdf.build_wide_pipeline(agg.record_extent, cap=cap,
                                     columns=agg.gather_index)
        x, live = fn(torch.from_numpy(buf.copy()))
        got = agg.fetch(agg.submit(x, live))
        assert_same_aggregates(got, want)
        # and the block path over the host-framed records
        host_mat = buf[offsets[wide][:, None]
                       + np.arange(agg.record_extent)[None, :]]
        assert_same_aggregates(agg.aggregate(host_mat), want)


def test_device_scan_and_pack_keep_the_jax_signatures():
    raw = _zero_header(generate_exp3(24, seed=5), 9)
    for a, b in zip(pdf.rdw_scan_device(raw, device=CPU),
                    jdf.rdw_scan_device(raw)):
        np.testing.assert_array_equal(a, b)
    raw = generate_exp3(24, seed=3)
    offsets, lengths = native.rdw_scan(raw, big_endian=False)
    got = pdf.pack_records_device(raw, offsets, lengths, 300, device=CPU)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdf.pack_records_device(
            raw, offsets, lengths, 300)))
    with pytest.raises(ValueError, match="2 GiB"):
        pdf.scan_capped(torch.empty(2 ** 31, dtype=torch.uint8), 1, 1)


# ---------------------------------------------------------------------------
# read_cobol(select=...)
# ---------------------------------------------------------------------------

RDW = {"is_record_sequence": "true", "segment_field": "SEGMENT-ID",
       "segment_id_level0": "C", "segment_id_level1": "P",
       "segment_id_prefix": "SEL", "generate_record_id": "true",
       "redefine-segment-id-map:0": "STATIC-DETAILS => C",
       "redefine-segment-id-map:1": "CONTACTS => P"}

ODO_COPYBOOK = """
       01 R.
          05 CNT   PIC 9(1).
          05 NAME  PIC X(3).
          05 ITEMS OCCURS 0 TO 5 TIMES DEPENDING ON CNT.
             10 V  PIC 9(3) COMP-3.
             10 W  PIC X(2).
"""


def _odo_file(tmp_path):
    rng = np.random.default_rng(4)
    rows = []
    for i in range(30):
        cnt = int(rng.integers(0, 7))  # 6: out of range, as the max
        row = bytes([0xF0 + cnt]) + bytes([0xC1 + i % 9] * 3)
        for k in range(5):
            row += bytes.fromhex(f"{int(rng.integers(0, 999)):03d}c")
            row += bytes([0xC1 + k, 0xC2])
        rows.append(row)
    path = tmp_path / "odo.dat"
    path.write_bytes(b"".join(rows))
    return str(path)


@pytest.fixture(scope="module")
def select_files(tmp_path_factory):
    from cobrix_tpu.testing.generators import generate_exp2

    d = tmp_path_factory.mktemp("select")
    paths = {}
    for name, data in [("exp1", generate_exp1(40, seed=3).tobytes()),
                       ("exp2", generate_exp2(300, seed=3)),
                       ("exp3", generate_exp3(30, seed=3))]:
        paths[name] = str(d / f"{name}.dat")
        with open(paths[name], "wb") as f:
            f.write(data)
    paths["odo"] = _odo_file(d)
    return paths


SELECT_CASES = {
    "fixed_fields": ("exp1", EXP1_COPYBOOK, "ID,NUM_BIN_INT07,STRING_VAL", {}),
    "fixed_pipelined": ("exp1", EXP1_COPYBOOK, "NUM_BCD_SINT14",
                        dict(pipeline_workers="2", chunk_size_mb="0.01")),
    "fixed_unknown_name": ("exp1", EXP1_COPYBOOK, "NO_SUCH_FIELD", {}),
    "odo_array_field": ("odo", ODO_COPYBOOK, "V", {}),
    "odo_other_field": ("odo", ODO_COPYBOOK, "NAME", {}),
    "odo_group": ("odo", ODO_COPYBOOK, "ITEMS", {}),
    "rdw_two_segments": ("exp2", "EXP2", "COMPANY-NAME,PHONE-NUMBER", RDW),
    "rdw_group": ("exp3", EXP3_COPYBOOK, "STATIC-DETAILS", RDW),
    "rdw_occurs": ("exp3", EXP3_COPYBOOK, "NUM1", RDW),
    "rdw_pipelined": ("exp3", EXP3_COPYBOOK, "NUM2,SEGMENT-ID",
                      dict(RDW, pipeline_workers="2",
                           input_split_records="7")),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_read_cobol_select_equals_the_jax_package(case, select_files):
    from cobrix_tpu.testing.generators import EXP2_COPYBOOK

    name, cb, select, opts = SELECT_CASES[case]
    cb = EXP2_COPYBOOK if cb == "EXP2" else cb
    # the reference reads sequentially: its pipelined read assembles
    # Arrow tables in worker threads, which a projected plan can crash
    # (a segfault in cobrix_tpu/reader/arrow_out.py seen under xdist)
    ref = {k: v for k, v in opts.items()
           if k not in ("pipeline_workers", "chunk_size_mb")}
    want = cobrix_tpu.read_cobol(select_files[name], copybook_contents=cb,
                                 select=select, backend="numpy", **ref)
    got = cobrix_tpu_torch.read_cobol(select_files[name],
                                      copybook_contents=cb, select=select,
                                      device=CPU, **opts)
    assert got.to_rows() == want.to_rows()
    assert got.to_dicts() == want.to_dicts()
    full = cobrix_tpu_torch.read_cobol(select_files[name],
                                       copybook_contents=cb, device=CPU,
                                       **opts)
    assert got.to_rows() != full.to_rows()


@pytest.mark.parametrize("option,value", [("filter", "ID > 5"),
                                          ("use_stats", "true")])
def test_filter_and_stats_options_still_raise(option, value, select_files,
                                              tmp_path):
    if option == "use_stats":
        # taken since the statistics slice: a profile collected by the
        # port serves its projected, filtered read, which equals the JAX
        # package's stats-off read
        opts = dict(copybook_contents=EXP1_COPYBOOK, select="ID",
                    filter="ID > 5")
        cache = str(tmp_path / "cache")
        cobrix_tpu_torch.read_cobol(select_files["exp1"], device=CPU,
                                    cache_dir=cache, collect_stats="true",
                                    **opts)
        got = cobrix_tpu_torch.read_cobol(select_files["exp1"], device=CPU,
                                          cache_dir=cache,
                                          **{option: value}, **opts)
        want = cobrix_tpu.read_cobol(select_files["exp1"], backend="numpy",
                                     **opts)
        assert got.to_rows() == want.to_rows()
        assert got.to_arrow().equals(want.to_arrow())
        assert got.metrics.pushdown["chunks_considered"] == 1
        return
    if option == "filter":
        # taken since the filter slice: with `select` the read equals the
        # JAX package's filtered, projected read
        opts = dict(copybook_contents=EXP1_COPYBOOK, select="ID",
                    **{option: value})
        got = cobrix_tpu_torch.read_cobol(select_files["exp1"], device=CPU,
                                          **opts)
        want = cobrix_tpu.read_cobol(select_files["exp1"], backend="numpy",
                                     **opts)
        assert 0 < len(got) < 40
        assert got.to_rows() == want.to_rows()
        assert got.to_arrow().equals(want.to_arrow())


# ---------------------------------------------------------------------------
# on the card (skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_aggregate_kernel_matches_plain_on_card(books, dataset):
    """The aggregate kernel against aggregate_plain on the same planes:
    counts, min and max exact, sums to rtol 1e-12, in blocks of 1,024
    rows with a host `n`, and at N = 37 rows (no multiple of 16) with `n`
    a 0-d int32 on the card at N, below it, 0 and past N (chip_smoke.py
    phase 10 does the same at exp3's and exp1's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the aggregate kernel has no CPU "
                    "mode")
    for cb, data, columns in [(books[1], dataset[0], None),
                              (port_parse(WIDE_COPYBOOK), wide_rows(), None),
                              (port_parse(EXP1_COPYBOOK),
                               generate_exp1(500, seed=2), None)]:
        agg = DeviceAggregator(cb, columns=columns, device="cuda")
        rows37 = np.resize(data, (N, data.shape[1]))
        cases = [agg.put(data, block=1024)]
        x37, _ = agg.put(rows37)
        assert x37.shape[0] == N
        cases += [(x37, torch.tensor(k, dtype=torch.int32, device="cuda"))
                  for k in (N, 20, 0, N + 9)]
        for x, n in cases:
            dp = agg.decoder.decode_planes(x)
            a = ag.aggregate(dp.planes, agg.spec, n,
                             ag.new_stats(agg.spec.n_fields, x.device))
            b = ag.aggregate_plain(dp.planes, agg.spec, n,
                                   ag.new_stats(agg.spec.n_fields, x.device))
            torch.cuda.synchronize()
            assert torch.equal(a.counts, b.counts)
            assert torch.equal(a.mins, b.mins) and torch.equal(a.maxs, b.maxs)
            torch.testing.assert_close(a.sums, b.sums, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_capped_scan_matches_the_full_scan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    raw = generate_exp3(300, seed=8)
    image = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).cuda()
    offs, lens, _ = pdf.scan_window(image, 0, True)
    header = pdf._header_lengths(image, False, 0)[offs - 4]
    wide = torch.nonzero(header >= 1000).flatten()
    for cap in (0, 7, int(wide.numel()), int(wide.numel()) + 9):
        o, ln, live = pdf.scan_capped(image, 1000, cap)
        k = min(cap, int(wide.numel()))
        assert int(live) == k
        assert torch.equal(o[:k], offs[wide[:k]])
        assert torch.equal(ln[:k], lens[wide[:k]])
        assert not o[k:].any() and not ln[k:].any()
