"""The Arrow assembly of the port (``ops.arrow_assemble``) on the CPU: its
plain version against a Python reference over the case grid, and the
tables it builds against the JAX package's.

The grid (``testing/arrow_cases.py``) holds every source and output
kind, decimal mode and shift window, validity pattern, hidden row, row
table, flat array and string shape; each assembly's output buffer must
give, element for element, the values, nulls, bad flags, null counts,
offsets and UTF-8 bytes the rules of ``csrc/arrow_assemble.cu`` give in
Python. The same bytes, made with numpy from a seed, go to
``cobrix_tpu.read_cobol`` (numpy backend, one thread) and to
``cobrix_tpu_torch.read_cobol(..., device="cpu")``, whose `to_arrow()`
builds every leaf it can through the assembly: the tables must be equal
(schema with metadata, floats by bit pattern). The ``cuda`` case holds
the four kernels to the plain version on a card and skips here.
"""
import struct
from decimal import Decimal

import numpy as np
import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu_torch.copybook.ast import Group
from cobrix_tpu_torch.copybook.copybook import parse_copybook
from cobrix_tpu_torch.ops import arrow_assemble as asm
from cobrix_tpu_torch.reader import arrow_out
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import arrow_cases
from cobrix_tpu_torch.testing import generators as gen

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

_BOTH = "".join(map(chr, range(0x21)))


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


# -- the plain version against a Python reference -----------------------------

def _element(req, j):
    """(row, visible, slot planes) of element j."""
    k, s = divmod(j, len(req.planes))
    row = int(req.rows[k]) if req.rows is not None else k
    visible = req.mask is None or bool(req.mask[row])
    return row, visible, req.planes[s]


def _digits(m: int) -> int:
    return len(str(m))


def _number_reference(req):
    """(bad, [None | int]) of a number request: the unscaled decimal,
    the integer, or the float's bits."""
    bad, out = False, []
    for j in range(req.length):
        row, visible, p = _element(req, j)
        valid = visible and bool(p["valid"][row])
        if not visible:
            out.append(None)
            continue
        raw = p["values"][row]
        if req.src_kind == asm.SRC_WIDE:
            mag = (int(np.int64(p["hi"][row]).view(np.uint64)) << 64) | int(
                np.int64(raw).view(np.uint64))
            neg = bool(p["neg"][row])
            v = None
        elif req.src_kind in (asm.SRC_F32, asm.SRC_F64):
            v = raw
        else:
            v = int(raw)
            mag, neg = abs(v), v < 0
        value = None
        if req.out_kind == asm.OUT_I32:
            value = (v + 2 ** 31) % 2 ** 32 - 2 ** 31
        elif req.out_kind == asm.OUT_I64:
            value = v
        elif req.out_kind == asm.OUT_F32:
            with np.errstate(over="ignore"):
                value = int(np.float32(v).view(np.uint32))
        elif req.out_kind == asm.OUT_F64:
            value = int(np.float64(v).view(np.uint64))
        else:
            shift = req.shift
            if req.dec_mode == asm.DEC_DOTS:
                shift -= int(p["dots"][row])
            elif req.dec_mode == asm.DEC_DIGITS:
                shift -= _digits(mag)
            if valid:
                value = mag * 10 ** max(shift, 0)
                if not 0 <= shift <= 38 or value >= 2 ** 128 \
                        or value >= 10 ** req.maxd:
                    bad = True
            if value is not None and neg:
                value = -value
        out.append(value if valid else None)
    return bad, out


def _string_reference(req):
    """(bad, [bytes]) of a string request."""
    bad, out = False, []
    for j in range(req.length):
        row, visible, p = _element(req, j)
        text = ("".join(map(chr, p["values"][row].tolist())) if visible
                else " " * req.width)
        if req.trim == asm.TRIM_BOTH:
            text = text.strip(_BOTH)
        elif req.trim == asm.TRIM_LEFT:
            text = text.lstrip(" \t")
        elif req.trim == asm.TRIM_RIGHT:
            text = text.rstrip(" \t")
        if any(0xD800 <= ord(c) <= 0xDFFF for c in text):
            bad = True
        out.append(text.encode("utf-8", "surrogatepass"))
    return bad, out


def _check_result(res: asm.Result):
    for i, req in enumerate(res.plan.requests):
        if req.is_string:
            bad, want = _string_reference(req)
            assert res.bad(i) == bad, i
            if bad:
                continue
            offs = res.values(i).view(np.int32)
            data = res.data(i).tobytes()
            assert offs[0] == 0 and offs[-1] == len(data), i
            got = [data[offs[j]:offs[j + 1]] for j in range(req.length)]
            assert got == want, i
            continue
        bad, want = _number_reference(req)
        assert res.bad(i) == bad, (i, req.shift, req.maxd)
        if bad:
            continue
        bits = np.unpackbits(res.bitmap(i), bitorder="little")[:req.length]
        assert bits.tolist() == [v is not None for v in want], i
        assert res.null_count(i) == sum(v is None for v in want), i
        raw = res.values(i)
        item = asm.OUT_ITEMSIZE[req.out_kind]
        for j, v in enumerate(want):
            cell = raw[j * item:(j + 1) * item].tobytes()
            if req.out_kind == asm.OUT_DEC:
                got = int.from_bytes(cell, "little", signed=True)
            elif req.out_kind in (asm.OUT_I32, asm.OUT_I64):
                got = int.from_bytes(cell, "little", signed=True)
            else:
                got = int.from_bytes(cell, "little")
            # a null's cell is zero
            assert got == (0 if v is None else v), (i, j)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 257])
def test_plain_version_against_python(n):
    requests, buf = arrow_cases.grid(n, seed=n)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    assert not plan.staged
    res = asm.assemble(plan)
    _check_result(res)
    assert any(res.bad(i) for i in range(len(requests)))
    assert not all(res.bad(i) for i in range(len(requests)))


@pytest.mark.parametrize("n,slots", [(33, 1), (33, 2), (33, 3), (9, 2000)])
def test_evenly_spaced_slots_against_python(n, slots):
    """Flat arrays whose slots are evenly spaced columns of column-major
    fused planes (`SlotPlanes`), beside the per-slot form, at 1, 2, 3 and
    2,000 slots: one base and one step a plane kind, not staged."""
    requests, buf = arrow_cases.grid(n, seed=n + slots, slots=slots)
    fused = [r for r in requests if isinstance(r.planes, asm.SlotPlanes)]
    assert len(fused) == 4 and all(len(r.planes) == slots for r in fused)
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    assert not plan.staged
    for i, r in enumerate(requests):
        if isinstance(r.planes, asm.SlotPlanes):
            a = r.planes.arrays["values"]
            assert plan.desc[i][asm.D_RSTRIDE] == 1
            assert plan.desc[i][asm.D_STEP + asm.P_VALUES] == (
                2 * n * a.itemsize if slots > 1 else 0)
    _check_result(asm.assemble(plan))


def test_planes_outside_the_buffer_are_staged():
    """A joined batch's planes lie in no one buffer: the plan copies
    only the planes its requests read into a staging buffer, and the
    arrays are the same."""
    requests, buf = arrow_cases.grid(33, seed=5)
    for r in requests:
        r.planes = [{k: np.array(v) for k, v in slot.items()}
                    for slot in r.planes]
    plan = asm.build_plan(requests, None, torch.device("cpu"))
    assert plan.staged
    _check_result(asm.assemble(plan))


def test_slot_planes_outside_the_buffer_are_staged():
    """`SlotPlanes` whose [rows, S] arrays lie outside the batch's buffer
    (row-major copies) are staged slot after slot, and give the same
    arrays."""
    requests, buf = arrow_cases.grid(33, seed=6, slots=3)
    for r in requests:
        if isinstance(r.planes, asm.SlotPlanes):
            r.planes = asm.SlotPlanes({k: np.array(a) for k, a in
                                       r.planes.arrays.items()})
    plan = asm.build_plan(requests, buf, torch.device("cpu"))
    assert plan.staged
    for i, r in enumerate(requests):
        if isinstance(r.planes, asm.SlotPlanes):
            assert plan.desc[i][asm.D_STEP + asm.P_VALUES] == \
                33 * r.planes.arrays["values"].itemsize
    _check_result(asm.assemble(plan))


@pytest.mark.parametrize("maxd", [0, 39])
def test_a_decimal_request_needs_its_precision_bound(maxd):
    """Every decimal is bounded by its declared precision (ROADMAP C5):
    a decimal request without a bound in 1..38 is refused."""
    requests, buf = arrow_cases.grid(9, seed=7)
    dec = next(r for r in requests if r.out_kind == asm.OUT_DEC)
    dec.maxd = maxd
    with pytest.raises(ValueError, match="precision bound is 1..38"):
        asm.build_plan(requests, buf, torch.device("cpu"))


@pytest.mark.cuda
def test_kernels_equal_the_plain_version_on_the_card():
    """The kernels against the plain version, from the same state, to
    the byte: the output buffer and the tile bases (the lengths kernel's
    scratch is its own; ``chip_smoke.py`` phase 14 runs this grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 14 holds "
                    "the kernels to the plain version on the card")
    device = torch.device("cuda")
    for n in (1, 31, 32, 33, 257, 4097):
        requests, buf = arrow_cases.grid(n, seed=n)
        plan = asm.build_plan(requests, buf.pin_memory(), device)
        src, aux = asm.upload(plan)
        kernel_state = asm.new_state(plan, device)
        plain_state = tuple(t.clone() for t in kernel_state)
        used = asm.run_steps(plan, src, aux, kernel_state)
        assert asm.run_steps(plan, src, aux, plain_state, plain=True) == used
        assert torch.equal(kernel_state[0][:used], plain_state[0][:used])
        assert torch.equal(kernel_state[1], plain_state[1])


# -- tables against the JAX package -------------------------------------------

def _typed(v):
    """A value tree with each leaf's type; floats by bit pattern."""
    if isinstance(v, dict):
        return ("dict", [(k, _typed(x)) for k, x in v.items()])
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_typed(x) for x in v])
    if isinstance(v, float):
        return ("float", struct.pack(">d", v))
    if isinstance(v, Decimal):
        return ("Decimal", repr(v))
    return (type(v).__name__, v)


def _same_table(got, want):
    assert got.schema.equals(want.schema, check_metadata=True)
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert _typed(got.column(name).to_pylist()) == \
            _typed(want.column(name).to_pylist()), name


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _check(path, options):
    want = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **options).to_arrow()
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
    table = got.to_arrow()
    _same_table(table, want)
    return got, table


def _requests(data):
    """The assembly requests of the first part's table."""
    part = data.parts[0]
    batch = part if hasattr(part, "decoder") else part.segments[0].batch
    builder = arrow_out.ArrowBatchBuilder(batch, None)
    builder.body_columns(data.output_schema.policy)
    return builder.leaves


KINDS_COPYBOOK = """
       01 REC.
          05 I16      PIC S9(4) COMP.
          05 U32      PIC 9(9) COMP.
          05 I64      PIC S9(15) COMP-3.
          05 F32      COMP-1.
          05 F64      COMP-2.
          05 D-STAT   PIC S9(5)V99 COMP-3.
          05 D-SHIFT  PIC S9(3)PPP COMP-3.
          05 D-WIDE   PIC S9(21)V99 COMP-3.
          05 D-W37    PIC S9(35)V99 COMP-3.
          05 D-DOTS   PIC 9(4).99.
          05 D-DOTS-L PIC 9(10).99.
          05 D-DOTS-W PIC 9(18).9(4).
          05 P-BIN    PIC SPP9(5) COMP.
          05 P-BIN-W  PIC SPPP9(18) COMP.
          05 P-DISP   PIC SVPP9(5).
          05 B-WIDE   PIC S9(20)V99 COMP.
          05 TEXT     PIC X(12).
          05 CODE     PIC X(3).
"""
# binary decimal fields hold no more digits than they declare here
# (ROADMAP C5 is its own case)
_BINARY_DIGITS = {"I16": 4, "U32": 9, "P-BIN": 5, "P-BIN-W": 18,
                  "B-WIDE": 22}
_EBCDIC_TEXT = np.array([0x40] * 5 + [0x05, 0xC1, 0xC2, 0x81, 0x82, 0xF1,
                                      0x4B, 0x42, 0x51, 0x9F, 0xFF],
                        dtype=np.uint8)


def _leaves(cb):
    out = []

    def walk(g):
        for st in g.children:
            if isinstance(st, Group):
                walk(st)
            else:
                out.append(st)
    for root in cb.ast.children:
        walk(root)
    return out


def _kinds_records(n: int, seed: int) -> bytes:
    """Records of `KINDS_COPYBOOK`: each field encoded from random values
    (signs, blanks and dots included), every tenth row junk in its packed
    fields, floats and strings."""
    cb = parse_copybook(KINDS_COPYBOOK)
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n, cb.record_size), dtype=np.uint8)
    junk = rng.random(n) < 0.1
    for st in _leaves(cb):
        off = st.binary_properties.offset
        w = st.binary_properties.actual_size
        name = st.name.replace("_", "-")
        if name in _BINARY_DIGITS:
            d = _BINARY_DIGITS[name]
            lo = 0 if name == "U32" else -(10 ** d - 1)
            vals = [int(rng.integers(0, 10 ** min(d, 18))) * (
                10 ** (d - 18) if d > 18 else 1) for _ in range(n)]
            vals = [max(lo, v if rng.random() < 0.5 else -v) for v in vals]
            field = np.array([list(v.to_bytes(w, "big", signed=True))
                              for v in vals], dtype=np.uint8)
            rec[:, off:off + w] = field
            continue
        if name.startswith(("I64", "D-STAT", "D-SHIFT", "D-WIDE", "D-W37")):
            digits = rng.integers(0, 10, (n, 2 * w - 1)).astype(np.uint8)
            signs = rng.choice(np.array([0xC, 0xD, 0xF], dtype=np.uint8), n)
            field = gen.encode_bcd_digits(digits, signs)
        elif name.startswith("D-DOTS"):
            field = (0xF0 + rng.integers(0, 10, (n, w))).astype(np.uint8)
            field[:, w - (5 if name == "D-DOTS-W" else 3)] = 0x4B
            field[rng.random(n) < 0.1] = 0x40
        elif name == "P-DISP":
            field = (0xF0 + rng.integers(0, 10, (n, w))).astype(np.uint8)
            field[:, -1] = (rng.choice([0xC0, 0xD0], n)
                            + rng.integers(0, 10, n)).astype(np.uint8)
        elif name in ("TEXT", "CODE"):
            field = rng.choice(_EBCDIC_TEXT, (n, w))
            field[rng.random(n) < 0.2] = 0x40
        else:
            continue   # floats: any bytes
        # a junk DISPLAY decimal may hold more fraction digits than its
        # scale: the JAX package's to_arrow raises there (C5), so only
        # packed fields and strings get junk rows
        keep = (~junk if name.startswith(("I64", "D-STAT", "D-SHIFT",
                                          "D-WIDE", "D-W37", "TEXT", "CODE"))
                else np.ones(n, dtype=bool))
        rec[keep, off:off + w] = field[keep]
    return rec.tobytes()


@pytest.mark.parametrize("trim", ["none", "left", "right", "both"])
def test_every_kind_and_mode_against_the_jax_package(tmp_path, trim):
    path = _write(tmp_path, "k.dat", _kinds_records(120, seed=3))
    data, table = _check(path, dict(copybook_contents=KINDS_COPYBOOK,
                                    string_trimming_policy=trim,
                                    schema_retention_policy="collapse_root"))
    assert table.num_rows == 120
    leaves = _requests(data)
    kinds = {(r.src_kind, r.out_kind, r.dec_mode, r.maxd > 0)
             for r in leaves.requests}
    assert {(asm.SRC_I32, asm.OUT_I32, asm.DEC_NONE, False),
            (asm.SRC_I64, asm.OUT_I64, asm.DEC_NONE, False),
            (asm.SRC_F32, asm.OUT_F32, asm.DEC_NONE, False),
            (asm.SRC_F64, asm.OUT_F64, asm.DEC_NONE, False),
            # every decimal is bounded by its precision (ROADMAP C5)
            (asm.SRC_I32, asm.OUT_DEC, asm.DEC_STATIC, True),
            (asm.SRC_WIDE, asm.OUT_DEC, asm.DEC_STATIC, True),
            (asm.SRC_I64, asm.OUT_DEC, asm.DEC_DOTS, True),
            (asm.SRC_WIDE, asm.OUT_DEC, asm.DEC_DOTS, True),
            (asm.SRC_I32, asm.OUT_DEC, asm.DEC_DIGITS, True),
            (asm.SRC_I64, asm.OUT_DEC, asm.DEC_DIGITS, True),
            (asm.SRC_I32, asm.OUT_DEC, asm.DEC_DOTS, True),
            (asm.SRC_CP16, asm.OUT_UTF8, asm.DEC_NONE, False)} <= kinds
    assert not any(leaves.result.bad(i)
                   for i in range(len(leaves.requests)))


def test_an_overflowing_binary_decimal_is_null(tmp_path):
    """ROADMAP C5: a 10-byte binary field holding more digits than its
    PIC declares (24 for 22). The JAX package's sequential ``read_cobol(backend=
    "numpy", parallelism="1")`` raises ArrowInvalid in `to_arrow` there;
    the assembly marks the column bad, the value-list route makes that
    value null, and every other value is the JAX package's row value."""
    cb = parse_copybook(KINDS_COPYBOOK)
    raw = np.frombuffer(_kinds_records(40, seed=8), dtype=np.uint8).reshape(
        40, cb.record_size).copy()
    st = next(s for s in _leaves(cb) if s.name == "B_WIDE")
    off, w = st.binary_properties.offset, st.binary_properties.actual_size
    raw[7, off:off + w] = list((5 * 10 ** 23).to_bytes(w, "big", signed=True))
    path = _write(tmp_path, "c5.dat", raw.tobytes())
    options = dict(copybook_contents=KINDS_COPYBOOK,
                   schema_retention_policy="collapse_root")
    jax_data = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                     **options)
    with pytest.raises(Exception, match="(?i)precision|invalid|overflow"):
        jax_data.to_arrow()
    want = [row[[f.name for f in jax_data.schema.fields].index("B_WIDE")]
            for row in jax_data.to_rows()]
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
    leaves = _requests(got)
    bad = [leaves.requests[i] for i in range(len(leaves.requests))
           if leaves.result.bad(i)]
    assert len(bad) == 1 and bad[0].src_kind == asm.SRC_WIDE
    column = got.to_arrow().column("B_WIDE").to_pylist()
    assert column[7] is None and want[7] is not None
    assert column[:7] + column[8:] == want[:7] + want[8:]


@pytest.mark.parametrize("page", ["cp037", "cp875", "common_extended",
                                  "cp1047"])
@pytest.mark.parametrize("trim", ["none", "left", "right", "both"])
def test_non_ascii_code_pages(tmp_path, page, trim):
    """Strings of every byte value under national code pages (two- and
    three-byte UTF-8 code points) take the device route, not the value
    list."""
    rng = np.random.default_rng(len(page))
    copybook = """
       01 REC.
          05 A   PIC X(9).
          05 B   PIC X(1).
          05 C   PIC X(20).
"""
    rec = rng.integers(0, 256, (80, 30), dtype=np.uint8)
    rec[rng.random(80) < 0.3, :4] = 0x40
    rec[rng.random(80) < 0.3, -5:] = 0x05
    rec[5] = 0x40
    path = _write(tmp_path, "s.dat", rec.tobytes())
    data, _ = _check(path, dict(copybook_contents=copybook,
                                ebcdic_code_page=page,
                                string_trimming_policy=trim))
    leaves = _requests(data)
    assert [r.src_kind for r in leaves.requests] == [asm.SRC_CP16] * 3


def test_hidden_rows_of_a_decode_once_hierarchy(tmp_path):
    """The 7-segment hierarchy decodes every record at the full plan: the
    leaves of each segment are requested at its struct's positions, with
    the redefine masks hiding the rows of other segments."""
    seg = {f"redefine_segment_id_map:{i}": f"{name} => {sid}"
           for i, (sid, name) in enumerate(
               gen.HIERARCHICAL_SEGMENT_MAP.items())}
    children = {f"segment-children:{i}": f"{parent} => {child}"
                for i, (child, parent) in enumerate(
                    gen.HIERARCHICAL_PARENT_MAP.items())}
    path = _write(tmp_path, "h.dat", gen.generate_hierarchical(30, seed=9))
    seen = []
    real = arrow_out._Leaves.run

    def run(self):
        seen.append(self)
        return real(self)
    options = dict(copybook_contents=gen.HIERARCHICAL_COPYBOOK,
                   is_record_sequence="true", segment_field="SEGMENT-ID",
                   generate_record_id="true", **seg, **children)
    try:
        arrow_out._Leaves.run = run
        for trim in ("none", "both"):
            _check(path, dict(options, string_trimming_policy=trim))
    finally:
        arrow_out._Leaves.run = real
    requests = [r for leaves in seen for r in leaves.requests]
    assert any(r.rows is not None and r.mask is not None and r.is_string
               for r in requests)
    assert any(r.rows is not None and not r.is_string for r in requests)


def test_exp3_two_thousand_slot_plane(tmp_path):
    """exp3's STRATEGY-DETAIL OCCURS 2000 of COMP and COMP-3 becomes two
    flat requests of 2,000 slots each (slot s of record i at i*S+s)."""
    path = _write(tmp_path, "e3.dat", gen.generate_exp3(40, seed=21))
    options = dict(copybook_contents=gen.EXP3_COPYBOOK,
                   is_record_sequence="true", segment_field="SEGMENT-ID",
                   segment_id_prefix="ASM", generate_record_id="true",
                   **{"redefine-segment-id-map:0": "STATIC-DETAILS => C",
                      "redefine-segment-id-map:1": "CONTACTS => P"})
    data, table = _check(path, options)
    part = data.parts[0]
    seg = next(s for s in part.segments
               if s.active and s.active.upper().startswith("STATIC"))
    batch = seg.batch
    builder = arrow_out.ArrowBatchBuilder(batch, seg.active)
    builder.body_columns(data.output_schema.policy)
    flats = [r for r in builder.leaves.requests if len(r.planes) == 2000]
    assert len(flats) == 2
    assert {r.length for r in flats} == {batch.n_records * 2000}


def test_exp3_plan_reads_no_slot_plane(tmp_path):
    """The plan of an exp3 'C' batch takes each 2,000-slot array's planes
    as one base and one step a plane kind: building it indexes no slot's
    plane, its aux tables are the same size at 2,000 slots as at 2, and
    the per-slot form of the same planes assembles the same bytes."""
    path = _write(tmp_path, "e3.dat", gen.generate_exp3(30, seed=5))
    options = dict(copybook_contents=gen.EXP3_COPYBOOK,
                   is_record_sequence="true", segment_field="SEGMENT-ID",
                   segment_id_prefix="ASM",
                   **{"redefine-segment-id-map:0": "STATIC-DETAILS => C",
                      "redefine-segment-id-map:1": "CONTACTS => P"})
    data = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
    seg = next(s for s in data.parts[0].segments
               if s.active and s.active.upper().startswith("STATIC"))
    builder = arrow_out.ArrowBatchBuilder(seg.batch, seg.active)
    builder.body_columns(data.output_schema.policy)
    requests = builder.leaves.requests
    flats = [r for r in requests if len(r.planes) == 2000]
    assert len(flats) == 2
    assert all(isinstance(r.planes, asm.SlotPlanes) for r in flats)
    flat_ids = {id(r) for r in flats}
    calls = []
    real = asm.SlotPlanes.__getitem__

    def counted(self, s):
        calls.append(s)
        return real(self, s)
    asm.SlotPlanes.__getitem__ = counted
    try:
        plan = asm.build_plan(requests, seg.batch.host_buffer,
                              torch.device("cpu"))
    finally:
        asm.SlotPlanes.__getitem__ = real
    assert calls == [] and not plan.staged
    # the same arrays at 2 slots: the same aux tables but the work table
    two = [asm.Request(r.length // 1000, asm.SlotPlanes(
        {k: a[:, :2] for k, a in r.planes.arrays.items()}), r.src_kind,
        r.out_kind, r.dec_mode, r.shift, r.maxd, r.rows, r.mask)
        if id(r) in flat_ids else r for r in requests]
    small = asm.build_plan(two, seg.batch.host_buffer, torch.device("cpu"))
    work_bytes = lambda p: p.num_work.nbytes  # noqa: E731
    assert plan.aux.nbytes - work_bytes(plan) <= \
        small.aux.nbytes - work_bytes(small) + 8
    per_slot = [asm.Request(r.length, [r.planes[s] for s in range(2000)],
                            r.src_kind, r.out_kind, r.dec_mode, r.shift,
                            r.maxd, r.rows, r.mask)
                if id(r) in flat_ids else r for r in requests]
    want = asm.assemble(asm.build_plan(per_slot, seg.batch.host_buffer,
                                       torch.device("cpu")))
    got = asm.assemble(plan)
    assert np.array_equal(got.host, want.host)
