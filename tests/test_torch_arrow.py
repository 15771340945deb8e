"""Arrow, pandas and JSON output of the port against the JAX package, on
the CPU.

The same generated bytes and option dict go to ``cobrix_tpu.read_cobol``
(numpy backend) and to ``cobrix_tpu_torch.read_cobol(..., device="cpu")``:
`to_arrow()` must give the same schema, metadata included, and the same
values, NaN by bit pattern; `to_pandas()` and `to_json_lines()` the same
frame and lines. The JAX package's read runs on one thread
(``parallelism="1"``, no pipeline): its parallel Arrow assembly races
pyarrow's lazy pandas import (ROADMAP C4).
"""
import random
import struct
from decimal import Decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.encode import encode_file
from cobrix_tpu.testing import generators as gen
from cobrix_tpu.testing.genspec import CopybookSpec
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu.reader import var_len_reader as jax_vlr
from cobrix_tpu_torch.testing.aggregate_cases import WIDE_COPYBOOK, wide_rows

from util import hard_timeout

# pyarrow imports pandas at its first masked pa.array: take that first
# call here, on the collecting thread of every test process, before any
# test runs a reader whose threads build arrays (ROADMAP C4)
warm_pyarrow()

REDEFINES = {"redefine-segment-id-map:0": "STATIC-DETAILS => C",
             "redefine-segment-id-map:1": "CONTACTS => P"}
LEVELS = {"segment_id_level0": "C", "segment_id_level1": "P"}
EXP2 = dict(copybook_contents=gen.EXP2_COPYBOOK, is_record_sequence="true",
            segment_field="SEGMENT-ID", segment_id_prefix="ARW",
            generate_record_id="true", **REDEFINES)
EXP3 = dict(EXP2, copybook_contents=gen.EXP3_COPYBOOK)
EXP1 = dict(copybook_contents=gen.EXP1_COPYBOOK)


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


def _typed(v):
    """A value tree with each leaf's type; floats by bit pattern, so
    that NaNs compare."""
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
    assert got.schema.equals(want.schema, check_metadata=True), \
        f"{got.schema}\n!=\n{want.schema}"
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert _typed(got.column(name).to_pylist()) == \
            _typed(want.column(name).to_pylist()), name


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _reads(path, options, **port_only):
    want = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **options)
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **options,
                                      **port_only)
    return want, got


def _check(path, options, **port_only):
    """The port's table, frame and JSON lines equal the JAX package's;
    returns the port's table."""
    want, got = _reads(path, options, **port_only)
    table = got.to_arrow()
    _same_table(table, want.to_arrow())
    assert got.to_json_lines() == want.to_json_lines()
    return table


def _exp1_with_junk(n, seed):
    junk = np.random.default_rng(seed).integers(
        0, 256, size=(16, 1493), dtype=np.uint8)
    return np.concatenate([gen.generate_exp1(n, seed=seed), junk])


# -- fixed-length files ------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 7 * 1493 + 11],
                         ids=["one_chunk", "chunks"])
def test_exp1_with_its_junk_tail(tmp_path, monkeypatch, chunk):
    """The JAX package's to_arrow raises on the junk tail, whose binary
    decimal fields hold more digits than they declare; the port makes
    such a value null (ROADMAP C5). With that one change made to the
    JAX package's value-list route, and its narrow decimals held to the
    same rule (its assembly leaves them past their precision, an invalid
    array), the tables are equal; the port's is valid Arrow."""
    import cobrix_tpu.reader.arrow_out as jax_arrow_out
    import cobrix_tpu_torch.api as api
    from cobrix_tpu_torch.reader.arrow_out import _fits_decimal

    if chunk:
        monkeypatch.setattr(api, "FIXED_READ_CHUNK_BYTES", chunk)
    path = _write(tmp_path, "e1.dat", _exp1_with_junk(60, 5).tobytes())
    want, got = _reads(path, EXP1)
    with pytest.raises(pa.ArrowInvalid):
        want.to_arrow()
    assert _typed(got.to_rows()) == _typed(want.to_rows())

    def fallback(self, col, pa_type, relevant=None):
        values = self.batch.column_values(col, relevant=relevant)
        if pa.types.is_decimal(pa_type):
            values = [v if v is None or _fits_decimal(v, pa_type) else None
                      for v in values]
        return pa.array(values, type=pa_type)

    monkeypatch.setattr(jax_arrow_out.ArrowBatchBuilder, "_python_fallback",
                        fallback)
    nulled = [0]

    def c5(value, typ):
        """The port's rule on a JAX value: a decimal past its declared
        precision is null (structs and lists are fixed in place)."""
        if value is None:
            return None
        if pa.types.is_struct(typ):
            for f in typ:
                value[f.name] = c5(value[f.name], f.type)
        elif pa.types.is_list(typ) or pa.types.is_fixed_size_list(typ):
            for i in range(len(value)):
                value[i] = c5(value[i], typ.value_type)
        elif pa.types.is_decimal(typ) and not _fits_decimal(value, typ):
            nulled[0] += 1
            return None
        return value

    table, want_table = got.to_arrow(), want.to_arrow()
    table.validate(full=True)
    assert table.schema.equals(want_table.schema, check_metadata=True)
    assert table.num_rows == want_table.num_rows
    for name in want_table.column_names:
        typ = want_table.schema.field(name).type
        assert _typed(table.column(name).to_pylist()) == _typed(
            [c5(v, typ) for v in want_table.column(name).to_pylist()]), name
    assert nulled[0] > 0  # the junk tail's narrow decimals
    frame = want_table.to_pandas()
    for name in frame.columns:
        typ = want_table.schema.field(name).type
        frame[name] = frame[name].map(lambda v, t=typ: c5(v, t))
    pd.testing.assert_frame_equal(got.to_pandas(), frame)
    assert got.to_json_lines() == want.to_json_lines()


def test_an_empty_file(tmp_path):
    for name, options in [("e1", EXP1), ("e2", EXP2)]:
        path = _write(tmp_path, f"{name}.dat", b"")
        table = _check(path, options)
        assert table.num_rows == 0


@pytest.mark.parametrize("policy", ["keep_original", "collapse_root"])
def test_wide_comp3_and_pic_p_rows(tmp_path, policy):
    path = _write(tmp_path, "w.dat", wide_rows().tobytes())
    table = _check(path, dict(copybook_contents=WIDE_COPYBOOK,
                              schema_retention_policy=policy))
    assert table.num_rows == 12


# -- RDW files ---------------------------------------------------------------

@pytest.mark.parametrize("profile", ["exp2", "exp3"])
@pytest.mark.parametrize("levels", [False, True], ids=["ids", "levels"])
def test_rdw_with_redefines_prefix_and_record_ids(tmp_path, profile, levels):
    if profile == "exp2":
        data, options = gen.generate_exp2(300, seed=21), EXP2
    else:
        data, options = gen.generate_exp3(24, seed=22), EXP3
    path = _write(tmp_path, f"{profile}.dat", data)
    _check(path, dict(options, **(LEVELS if levels else {})))


@pytest.mark.parametrize("select", ["COMPANY-NAME,PHONE-NUMBER",
                                    "STATIC-DETAILS", "CONTACTS"])
def test_rdw_select(tmp_path, select):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(200, seed=23))
    _check(path, dict(EXP2, **LEVELS, select=select))


def test_exp3_select_leaves_the_wide_plane_null(tmp_path):
    path = _write(tmp_path, "e3.dat", gen.generate_exp3(12, seed=24))
    table = _check(path, dict(EXP3, select="COMPANY-ID"))
    assert table.num_rows == 12


def test_segment_filter_with_collapse_root(tmp_path):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(300, seed=25))
    _check(path, dict(EXP2, **LEVELS, segment_filter="P",
                      schema_retention_policy="collapse_root"))


def test_several_files_and_split_shards(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(3):
        (d / f"f{i}.dat").write_bytes(gen.generate_exp2(90 + i, seed=30 + i))
    _check(str(d), dict(EXP2, **LEVELS, input_split_records="17"))


# -- random copybooks (testing/genspec.py) ----------------------------------

GENSPEC_PAGES = ("common", "cp037", "cp500", "cp1047", "cp875",
                 "common_extended", "cp037_extended", "cp1047")


@pytest.mark.parametrize("framing", ["fixed", "rdw"])
@pytest.mark.parametrize("seed", range(8))
def test_genspec_copybooks(tmp_path, seed, framing):
    """8 seeded random copybooks, fixed-length and RDW, under random
    trimming, retention and float formats, on common, single-byte
    national and extended code pages (non-ASCII code points are UTF-8 in
    Arrow)."""
    rng = random.Random(9000 + seed)
    page = GENSPEC_PAGES[seed]
    spec = CopybookSpec.random(rng, allow_depending=False, code_page=page)
    bodies = [spec.random_body(rng) for _ in range(12)]
    data = encode_file(spec.copybook_text, bodies,
                       **spec.encode_options(framing))
    raw = np.frombuffer(data, dtype=np.uint8).copy()
    if framing == "fixed":
        # every byte value in the records: extended and non-ASCII code
        # points, invalid digits and signs
        nrng = np.random.default_rng(seed)
        at = np.arange(nrng.integers(0, 5), raw.size, 5)
        raw[at] = nrng.integers(0, 256, at.size, dtype=np.uint8)
    options = spec.read_options(framing)
    options["ebcdic_code_page"] = page
    options["string_trimming_policy"] = rng.choice(
        ["none", "left", "right", "both"])
    options["schema_retention_policy"] = rng.choice(
        ["keep_original", "collapse_root"])
    options["floating_point_format"] = rng.choice(
        ["ibm", "ieee754", "ibm_little_endian", "ieee754_little_endian"])
    path = _write(tmp_path, "gen.dat", raw.tobytes())
    table = _check(path, options)
    assert table.num_rows == 12


# -- the pipelined read: assemble stage and batch_callback ---------------------

def _tap():
    got = {}

    def on_batch(i, table):
        assert i not in got
        got[i] = table
    return got, on_batch


def _concat(tables):
    ordered = [tables[i] for i in sorted(tables) if tables[i] is not None]
    return pa.concat_tables(ordered)


@pytest.mark.parametrize("workers", ["0", "3"])
def test_batch_callback_fixed(tmp_path, workers):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(80, seed=7).tobytes())
    got, on_batch = _tap()
    data = cobrix_tpu_torch.read_cobol(
        path, device="cpu", batch_callback=on_batch,
        pipeline_workers=workers, chunk_size_mb="0.02", **EXP1)
    table = data.to_arrow()
    want = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **EXP1).to_arrow()
    _same_table(table, want)
    _same_table(_concat(got), table)
    assert len(got) == (len(data.batches) if workers == "3" else 1)
    if workers == "3":
        # the assemble stage cached every chunk's table
        assert all(b._arrow_cache is not None for b in data.batches)


@pytest.mark.parametrize("workers", ["0", "2"])
def test_batch_callback_rdw(tmp_path, workers):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(400, seed=26))
    options = dict(EXP2, **LEVELS, input_split_records="50")
    got, on_batch = _tap()
    data = cobrix_tpu_torch.read_cobol(
        path, device="cpu", batch_callback=on_batch,
        pipeline_workers=workers, **options)
    want = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **options).to_arrow()
    _same_table(data.to_arrow(), want)
    _same_table(_concat(got), want)
    assert len(got) == len(data.results)


def test_a_lost_shard_is_delivered_as_none(tmp_path, monkeypatch):
    """Under shard_error_policy='partial' a shard whose decode fails
    twice arrives as (index, None); the other tables concatenate to
    to_arrow(), whose schema carries the JAX package's diagnostics."""
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(200, seed=27))
    options = dict(EXP2, input_split_records="50",
                   shard_error_policy="partial")
    port_read, jax_read = (port_vlr.VarLenReader.read_shard,
                           jax_vlr.VarLenReader.read_result_columnar)

    def port_flaky(self, staged, file_id, offset_from, record_index, *a,
                   **k):
        if record_index == 100:
            raise RuntimeError("poison shard")
        return port_read(self, staged, file_id, offset_from, record_index,
                         *a, **k)

    def jax_flaky(self, stream, *a, **k):
        if k.get("start_record_id") == 100:
            raise RuntimeError("poison shard")
        return jax_read(self, stream, *a, **k)

    monkeypatch.setattr(port_vlr.VarLenReader, "read_shard", port_flaky)
    monkeypatch.setattr(jax_vlr.VarLenReader, "read_result_columnar",
                        jax_flaky)
    got, on_batch = _tap()
    data = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                       pipeline_workers="2",
                                       batch_callback=on_batch, **options)
    want = cobrix_tpu.read_cobol(path, backend="numpy", pipeline_workers="1",
                                 **options).to_arrow()
    table = data.to_arrow()
    assert got[2] is None and sorted(got) == [0, 1, 2, 3]
    assert table.num_rows == 150
    assert b"cobrix_tpu.read_diagnostics" in table.schema.metadata
    _same_table(table, want)
    _same_table(_concat(got), table.replace_schema_metadata(None))


def test_batch_callback_must_be_callable(tmp_path):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(2, seed=1).tobytes())
    with pytest.raises(ValueError) as got:
        cobrix_tpu_torch.read_cobol(path, device="cpu", batch_callback=3,
                                    **EXP1)
    with pytest.raises(ValueError) as want:
        cobrix_tpu.read_cobol(path, batch_callback=3, **EXP1)
    assert str(got.value) == str(want.value)


# -- on the card (skipped here) ------------------------------------------------

@pytest.mark.cuda
def test_card_tables_equal_the_cpu_tables(tmp_path):
    """On a card: the tables of a sequential and a pipelined read equal
    the CPU read's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 11 runs "
                    "this path on the card")
    cases = [("e1.dat", _exp1_with_junk(300, 8).tobytes(), EXP1),
             ("e2.dat", gen.generate_exp2(3000, seed=28),
              dict(EXP2, **LEVELS, input_split_records="300"))]
    for name, data, options in cases:
        path = _write(tmp_path, name, data)
        want = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
        for workers in ("0", "3"):
            got = cobrix_tpu_torch.read_cobol(path, pipeline_workers=workers,
                                              **options)
            _same_table(got.to_arrow(), want.to_arrow())
