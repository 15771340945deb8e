"""Filter pushdown of the port against the JAX package, on the CPU.

The same bytes, made with numpy from the port's generators, go through
``cobrix_tpu.read_cobol(..., filter=...)`` (numpy backend, one thread)
and ``cobrix_tpu_torch.read_cobol(..., filter=..., device="cpu")``:
sequentially, pipelined and in index shards. The filtered tables (schema
and metadata included), rows and JSON lines must be equal, value for
value and null for null, and so must the pruning counters
(``ReadMetrics.pushdown``). The expression layer must give the JAX
package's canonical strings and wire JSON byte for byte, and the same
errors. On the CPU the two stages run the fused decode's and the pack's
plain versions, whose launch counters show the stages: a filtered
fixed-length chunk decodes twice (once if it keeps nothing) and a
segment-only filter makes no stage-1 decode.
"""
import ast
import decimal
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import cobrix_tpu
import cobrix_tpu.query as jq
import cobrix_tpu.utils as jutils
import cobrix_tpu_torch
import cobrix_tpu_torch.query as tq
import cobrix_tpu_torch.utils as tutils
from cobrix_tpu_torch.ops.device_framing import pack_records_plain
from cobrix_tpu_torch.ops.fused_decode import fused_decode_plain
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import generators as gen

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXED = dict(copybook_contents=gen.TRANSDATA_COPYBOOK,
             schema_retention_policy="collapse_root")
FIXED_SEGS = dict(copybook_contents=gen.FIXED_SEGMENTS_COPYBOOK,
                  **gen.FIXED_SEGMENTS_OPTIONS)
VRL = dict(copybook_contents=gen.EXP3_COPYBOOK,
           is_record_sequence="true", segment_field="SEGMENT_ID",
           schema_retention_policy="collapse_root",
           redefine_segment_id_map="STATIC-DETAILS => C",
           **{"redefine-segment-id-map:1": "CONTACTS => P"})
HIER = dict(copybook_contents=gen.HIERARCHICAL_COPYBOOK,
            is_record_sequence="true", segment_field="SEGMENT-ID",
            **{f"redefine_segment_id_map:{i}": f"{name} => {sid}"
               for i, (sid, name) in enumerate(
                   gen.HIERARCHICAL_SEGMENT_MAP.items())},
            **{f"segment-children:{i}": f"{parent} => {child}"
               for i, (child, parent) in enumerate(
                   gen.HIERARCHICAL_PARENT_MAP.items())})
DYNAMIC = dict(copybook_contents=gen.DYNAMIC_OCCURS_COPYBOOK,
               variable_size_occurs="true")
TEXT = dict(copybook_contents=gen.TEXT_COPYBOOK, is_text="true",
            encoding="ascii")

EXECUTION = {
    "sequential": {},
    "pipelined": {"pipeline_workers": "2", "chunk_size_mb": "0.01"},
    "shards": {"input_split_records": "60"},
}


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(240, request.node.name):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pushdown")

    def write(name, data):
        path = str(d / name)
        with open(path, "wb") as f:
            f.write(bytes(data))
        return path
    trans = gen.generate_transactions(600, seed=11).tobytes()
    # each record behind a 2-byte prefix and before a 3-byte suffix
    framed = np.zeros((600, 50), dtype=np.uint8)
    framed[:, :2] = 0xAB
    framed[:, 2:47] = np.frombuffer(trans, dtype=np.uint8).reshape(600, 45)
    framed[:, 47:] = 0xCD
    return {
        "offsets": write("offsets.dat", framed.tobytes()),
        "text": write("text.dat", gen.generate_text(400, seed=4)),
        "fixed": write("fixed.dat", trans),
        "segments": write("segments.dat",
                          gen.generate_fixed_segments(600, seed=5)),
        # a torn last record: 'USD' and one more byte of the next record
        "torn": write("torn.dat", trans + b"\xe4\xe2\xc4\x00"),
        "exp3": write("exp3.dat", gen.generate_exp3(250, seed=11)),
        "hier": write("hier.dat", gen.generate_hierarchical(40, seed=13)),
        "dynamic": write("dynamic.dat",
                         gen.generate_dynamic_occurs(150, seed=8)),
    }


def _hier_median(path):
    """The median TAXPAYER of the hierarchy's companies, so that the
    residual filter keeps about half of them."""
    full = cobrix_tpu.read_cobol(path, backend="numpy", **HIER).to_arrow()
    tax = pc.struct_field(pc.struct_field(full["ENTITY"], "COMPANY"),
                          "TAXPAYER").to_pylist()
    return int(np.median([v for v in tax if v is not None]))


# (file, options, filter): every layout and route of the slice
LAYOUTS = {
    "fixed": ("fixed", FIXED, "CURRENCY in ('USD', 'EUR') and AMOUNT > 0"),
    "fixed_segments": ("segments", FIXED_SEGS,
                       "AGE > 500 or EMPLOYEES < 400000"),
    "torn_permissive": ("torn", dict(
        FIXED, record_error_policy="permissive",
        corrupt_record_column="_corrupt_record"),
        "CURRENCY == 'USD' or AMOUNT == null"),
    "torn_drop": ("torn", dict(FIXED, record_error_policy="drop_malformed"),
                  "CURRENCY == 'USD'"),
    "fixed_record_offsets": ("offsets", dict(
        FIXED, record_start_offset="2", record_end_offset="3"),
        "CURRENCY in ('USD', 'EUR') and AMOUNT > 100"),
    # the override cuts AMOUNT off every record: stage 1 sees it null
    "fixed_short_records": ("fixed", dict(FIXED, record_length="40"),
                            "WEALTH_QFY > 1 and AMOUNT == null"),
    "text_framing": ("text", TEXT, "AMOUNT > 0 and ID != 0"),
    "exp3_segment_value": ("exp3", VRL,
                           "segment('C') and COMPANY_NAME >= 'M'"),
    "exp3_segment_owned": ("exp3", VRL, "TAXPAYER_TYPE == 'A'"),
    "hierarchy_residual": ("hier", HIER, None),
    "row_walk": ("dynamic", DYNAMIC, "CUSTOMER > 'M' and ITEM_COUNT > 5"),
}


def _reads(path, opts, **extra):
    jax = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                **opts, **extra)
    port = cobrix_tpu_torch.read_cobol(path, device="cpu", **opts, **extra)
    return jax, port


def _same(jax, port):
    jt, tt = jax.to_arrow(), port.to_arrow()
    assert tt.equals(jt, check_metadata=True)
    assert port.to_rows() == jax.to_rows()
    assert port.to_json_lines() == jax.to_json_lines()
    assert len(port) == len(jax) == tt.num_rows
    assert port.metrics.pushdown == jax.metrics.pushdown
    return tt


@pytest.mark.parametrize("mode", list(EXECUTION))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_filtered_read_matches_jax(files, layout, mode):
    key, opts, flt = LAYOUTS[layout]
    path = files[key]
    if flt is None:
        flt = f"TAXPAYER > {_hier_median(path)}"
    jax, port = _reads(path, opts, filter=flt, **EXECUTION[mode])
    table = _same(jax, port)
    pd = port.metrics.pushdown
    assert 0 < table.num_rows < pd["records_scanned"]
    if layout in ("hierarchy_residual", "row_walk"):
        # no static columnar plan: the filter runs on the assembled table
        assert pd["records_pruned_residual"] == pd["records_pruned"] > 0
    else:
        assert pd["records_pruned_residual"] == 0


@pytest.mark.parametrize("mode", list(EXECUTION))
def test_filter_equals_posthoc_filter(files, mode):
    """The pushed-down read equals the unfiltered read filtered with
    pyarrow afterwards."""
    extra = EXECUTION[mode]
    full = cobrix_tpu_torch.read_cobol(files["exp3"], device="cpu", **VRL,
                                       **extra).to_arrow()
    got = cobrix_tpu_torch.read_cobol(
        files["exp3"], device="cpu", **VRL, **extra,
        filter=tq.segment_is("C") & (tq.col("COMPANY_ID") != "")
    ).to_arrow()
    mask = pc.and_kleene(pc.equal(full["SEGMENT_ID"], "C"),
                         pc.not_equal(full["COMPANY_ID"], ""))
    assert got.equals(full.filter(pc.fill_null(mask, False)))


@pytest.mark.parametrize("mode", list(EXECUTION))
def test_record_ids_survive_filtering(files, mode):
    opts = dict(VRL, generate_record_id="true")
    full = cobrix_tpu_torch.read_cobol(files["exp3"], device="cpu", **opts,
                                       **EXECUTION[mode]).to_arrow()
    jax, port = _reads(files["exp3"], opts, filter="segment('C')",
                       **EXECUTION[mode])
    got = _same(jax, port)
    expect = full.filter(pc.equal(full["SEGMENT_ID"], "C"))
    assert got["Record_Id"].equals(expect["Record_Id"])
    assert got["File_Id"].equals(expect["File_Id"])


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_select_late_materialization(files, mode):
    jax, port = _reads(files["fixed"], FIXED, select="COMPANY_NAME",
                       filter="CURRENCY in ('USD', 'EUR') and AMOUNT > 0",
                       **EXECUTION[mode])
    got = _same(jax, port)
    full = cobrix_tpu_torch.read_cobol(files["fixed"], device="cpu",
                                       **FIXED).to_arrow()
    mask = pc.and_kleene(
        pc.is_in(full["CURRENCY"], value_set=pa.array(["USD", "EUR"])),
        pc.greater(full["AMOUNT"], pa.scalar(decimal.Decimal(0))))
    expect = full.filter(mask)
    assert got["COMPANY_NAME"].equals(expect["COMPANY_NAME"])
    # the filter columns were decoded for the predicate, not assembled
    assert got["CURRENCY"].null_count == got.num_rows
    assert got["AMOUNT"].null_count == got.num_rows


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
@pytest.mark.parametrize("key,opts,flt", [
    ("fixed", FIXED, "CURRENCY == 'XXX'"),
    ("exp3", VRL, "segment('Q')"),
    ("hier", HIER, "TAXPAYER < 0"),
], ids=["fixed", "exp3", "hierarchy"])
def test_empty_result_is_the_schemas_empty_table(files, key, opts, flt,
                                                 mode):
    got = []
    port = cobrix_tpu_torch.read_cobol(
        files[key], device="cpu", filter=flt, **opts, **EXECUTION[mode],
        batch_callback=lambda i, t: got.append(t))
    jax = cobrix_tpu.read_cobol(files[key], backend="numpy", filter=flt,
                                **opts, **EXECUTION[mode])
    table = _same(jax, port)
    assert table.num_rows == 0 and port.to_rows() == []
    assert got and all(t.num_rows == 0 and t.schema.equals(table.schema)
                       for t in got)


def test_batch_callback_tables_concatenate_to_the_table(files):
    got = {}
    data = cobrix_tpu_torch.read_cobol(
        files["fixed"], device="cpu", filter="CURRENCY == 'USD'",
        pipeline_workers="2", chunk_size_mb="0.005", **FIXED,
        batch_callback=lambda i, t: got.__setitem__(i, t))
    assert len(got) > 1
    table = pa.concat_tables([got[i] for i in sorted(got)])
    assert table.equals(data.to_arrow())


def test_filter_spellings_agree(files):
    """Grammar text, wire JSON and an Expr give one read."""
    expr = tq.col("CURRENCY").isin(["USD", "EUR"]) & (tq.col("AMOUNT") > 0)
    tables = [cobrix_tpu_torch.read_cobol(files["fixed"], device="cpu",
                                          filter=f, **FIXED).to_arrow()
              for f in (str(expr), expr.canonical(), expr)]
    assert tables[0].num_rows > 0
    assert all(t.equals(tables[0]) for t in tables[1:])


def test_keyword_named_field_survives_the_option_layer():
    from cobrix_tpu_torch.api import Options, _normalize_filter_option

    e = tq.col("SEGMENT") == "C"
    wire = _normalize_filter_option(Options({"filter": e}).get("filter"))
    assert tq.expr.from_wire(wire).canonical() == e.canonical()


# -- launches: stage 1 and stage 2 on the plain versions -----------------


def _launches(fn):
    fused_decode_plain.launches = pack_records_plain.launches = 0
    data = fn()
    return data, fused_decode_plain.launches, pack_records_plain.launches


@pytest.mark.parametrize("flt,fused,pack", [
    ("CURRENCY == 'USD' and AMOUNT > 100", 2, 2),
    ("AMOUNT < 0", 1, 1),
], ids=["kept", "none_kept"])
def test_fixed_chunk_launches_both_stages(files, flt, fused, pack):
    """One chunk: stage 1 (pack and fused decode of the filter columns)
    and stage 2 (pack and fused decode of the kept records); a chunk that
    keeps nothing launches no stage 2."""
    data, f, p = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["fixed"], device="cpu", filter=flt, **FIXED))
    assert (f, p) == (fused, pack)
    assert data.metrics.pushdown["records_scanned"] == 600


def test_fixed_segment_only_filter_makes_no_stage1(files):
    """A segment-only filter drops on the segment ids: the one launch
    of each kind is stage 2 of the segment it keeps."""
    data, f, p = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["segments"], device="cpu", filter="segment('C')",
        **FIXED_SEGS))
    assert (f, p) == (1, 1)
    _, f, p = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["segments"], device="cpu", filter="AGE > 500", **FIXED_SEGS))
    # stage 1 packs both segments' records; AGE is in the person
    # redefine, so the company plan has no fused group: the fused decode
    # runs for the persons' stage 1 and stage 2 alone
    assert (f, p) == (2, 3)


def test_vrl_segment_only_filter_makes_no_stage1(files):
    """On an RDW read a segment-only filter launches what the legacy
    segment_filter option launches: the kept segment's decode alone."""
    _, f, p = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["exp3"], device="cpu", filter="segment('C')", **VRL))
    _, f0, p0 = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["exp3"], device="cpu", segment_filter="C", **VRL))
    assert (f, p) == (f0, p0) and f > 0
    _, f1, p1 = _launches(lambda: cobrix_tpu_torch.read_cobol(
        files["exp3"], device="cpu", filter="segment('C') and "
        "TAXPAYER_NUM > 1000", **VRL))
    # plus stage 1 of the 'C' records: one pack and one fused decode
    assert (f1, p1) == (f + 1, p + 1)


def test_plan_cache_no_cross_contamination(files):
    """Same copybook, different select and filter: each read's output
    reflects its own projection and predicate; the stage-1 program never
    leaks into the selected plan."""
    def read(**kw):
        return cobrix_tpu_torch.read_cobol(files["fixed"], device="cpu",
                                           **FIXED, **kw)
    a = read(select="CURRENCY").to_arrow()
    b = read(select="COMPANY_ID").to_arrow()
    c = read().to_arrow()
    assert a["CURRENCY"].null_count == 0
    assert a["COMPANY_ID"].null_count == a.num_rows
    assert b["COMPANY_ID"].null_count == 0
    assert b["CURRENCY"].null_count == b.num_rows
    assert c["CURRENCY"].equals(a["CURRENCY"])
    fa = read(filter="CURRENCY == 'USD'", select="COMPANY_ID").to_arrow()
    assert fa["CURRENCY"].null_count == fa.num_rows
    assert fa["COMPANY_ID"].null_count == 0
    usd = {r["CURRENCY"] for r in read(filter="CURRENCY == 'USD'").to_dicts()}
    eur = {r["CURRENCY"] for r in read(filter="CURRENCY == 'EUR'").to_dicts()}
    assert usd == {"USD"} and eur == {"EUR"}


# -- bind errors ----------------------------------------------------------


@pytest.mark.parametrize("key,opts,flt", [
    ("fixed", FIXED, "NO_SUCH_FIELD == 1"),
    ("fixed", FIXED, "segment('C')"),
    ("fixed", dict(FIXED, schema_retention_policy="keep_original"),
     "TRANSDATA == 1"),
    ("exp3", VRL, "NUM1 > 0"),
    ("exp3", VRL, "segment('C') or COMPANY_ID == 'x'"),
    ("exp3", VRL, "not segment('C')"),
    ("hier", HIER, "segment('1') and TAXPAYER > 0"),
    ("fixed", FIXED, "AMOUNT >"),
    ("fixed", FIXED, "A in ()"),
    ("fixed", FIXED, '{"op": "=="}'),
], ids=["unknown_field", "segment_without_segment_field", "group",
        "occurs", "nested_segment_or", "nested_segment_not",
        "hierarchy_segment", "grammar", "empty_in", "incomplete_wire"])
def test_bind_errors_are_the_jax_packages(files, key, opts, flt):
    with pytest.raises(ValueError) as jax_err:
        cobrix_tpu.read_cobol(files[key], backend="numpy", filter=flt,
                              **opts).to_arrow()
    with pytest.raises(ValueError) as port_err:
        cobrix_tpu_torch.read_cobol(files[key], device="cpu", filter=flt,
                                    **opts).to_arrow()
    assert str(port_err.value) == str(jax_err.value)


# -- the expression layer -------------------------------------------------

EXPRESSIONS = [
    "CURRENCY == 'USD'",
    "AMOUNT > 100",
    "AMOUNT >= -1.25",
    "A != 3 and B < 4 or not (C <= 5)",
    "CURRENCY in ('USD', 'EUR') and (AMOUNT > 100 or not (WEALTH_QFY == 1))",
    "NAME == \"it's\"",
    'NAME == "say \\"hi\\""',
    "X == null",
    "X != null",
    "FLAG == true or FLAG == false",
    "ID in (1, 2, 3)",
    "segment('C', 'P') and TAXPAYER_TYPE == 'A'",
    "segment('C')",
    "AMOUNT == 12345678901234.56",
    "A == 1 and (B == 2 and C == 3)",
]


@pytest.mark.parametrize("text", EXPRESSIONS)
def test_expression_canonical_and_wire_match(text):
    j = jq.parse_filter(text)
    t = tq.parse_filter(text)
    assert t.canonical() == j.canonical()
    assert json.dumps(t.to_wire()) == json.dumps(j.to_wire())
    assert str(t) == str(j)
    assert tq.normalize_filter(text) == jq.normalize_filter(text)
    assert tq.parse_filter(str(t)).canonical() == t.canonical()
    assert tq.expr.from_wire(t.canonical()).canonical() == t.canonical()
    assert t.fields() == j.fields()


BUILT = [
    lambda m: (m.col("A") == "x") & ~(m.col("B") <= 3)
    | m.col("C").isin([1, 2]),
    lambda m: m.segment_is("C", "P") & (m.col("N") > 2.5),
    lambda m: (m.col("D") == None) | (m.col("E") != "it's"),  # noqa: E711
    lambda m: m.col("F").isin(["a", "b'c"]) & (m.col("G") >= -7),
    lambda m: 3 < m.col("H"),
]


@pytest.mark.parametrize("build", BUILT, ids=[f"built{i}" for i in
                                                range(len(BUILT))])
def test_builder_canonical_and_wire_match(build):
    j, t = build(jq), build(tq)
    assert t.canonical() == j.canonical()
    assert str(t) == str(j)
    assert tq.normalize_filter(t) == jq.normalize_filter(j)


PYARROW = [
    lambda: (pc.field("A") == "x") & (pc.field("B") > 5),
    lambda: pc.field("CUR").isin(["USD", "EUR"]),
    lambda: ~(pc.field("N") < 3),
    lambda: (pc.field("A") == 1) | (pc.field("B") != 2.5),
]


@pytest.mark.parametrize("make", PYARROW, ids=[f"pyarrow{i}" for i in
                                                range(len(PYARROW))])
def test_pyarrow_reprs_parse_alike(make):
    text = str(make())
    assert tq.parse_filter(text).canonical() == \
        jq.parse_filter(text).canonical()
    assert tq.expr.from_wire(tq.normalize_filter(text)).to_pyarrow() \
        .equals(jq.expr.from_wire(jq.normalize_filter(text)).to_pyarrow())


@pytest.mark.parametrize("bad", ["AMOUNT >", "and A == 1", "A ==", "A in ()",
                                 "A == 'x' garbage", "NAME == ALIAS",
                                 '{"op": "in", "field": "A"}',
                                 '{"op": "and"}', '{"op": "not"}'])
def test_parse_errors_match(bad):
    with pytest.raises(ValueError) as jax_err:
        jq.normalize_filter(bad)
    with pytest.raises(ValueError) as port_err:
        tq.normalize_filter(bad)
    assert str(port_err.value) == str(jax_err.value)


def test_keyword_combination_raises():
    with pytest.raises(TypeError, match="bitwise"):
        bool(tq.col("A") == 1)


# -- the rest of the package surface (A9) ---------------------------------


def test_package_exports_the_jax_names_but_the_later_slices():
    later = {"explain", "ScanReport", "ScanProgress", "Tracer",
             "prometheus_text", "ContinuousIngestor", "tail_cobol",
             "SourceTruncated", "DatasetSink", "sink_cobol",
             "SinkCorruption", "SinkSchemaError", "read_dataset"}
    assert set(cobrix_tpu.__all__) - set(cobrix_tpu_torch.__all__) == later
    for name in ("CommentPolicy", "DebugFieldsPolicy", "Encoding", "Usage",
                 "ReadDiagnostics", "RecordErrorPolicy", "ShardErrorPolicy",
                 "ShardFailureInfo", "ReadMetrics", "profile_trace",
                 "query"):
        assert getattr(cobrix_tpu_torch, name) is not None
    public = {n for n in dir(jq) if not n.startswith("_")}
    assert public - {"expr", "pushdown", "dataset"} <= set(dir(tq))
    assert set(tutils.__all__) == set(jutils.__all__)


def test_file_utils_match(tmp_path):
    (tmp_path / "a.dat").write_bytes(b"x" * 90)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.dat").write_bytes(b"x" * 91)
    (tmp_path / ".hidden").write_bytes(b"x" * 7)
    (tmp_path / "_skip").write_bytes(b"x" * 7)
    d = str(tmp_path)
    assert tutils.list_input_files(d) == jutils.list_input_files(d)
    assert tutils.total_size(d) == jutils.total_size(d) == 181
    assert tutils.get_number_of_files(d) == jutils.get_number_of_files(d)
    for divisor in (3, 7, 45):
        assert tutils.find_non_divisible_files(d, divisor) == \
            jutils.find_non_divisible_files(d, divisor)
    with pytest.raises(ValueError):
        tutils.find_non_divisible_files(d, 0)
    assert cobrix_tpu_torch.api.list_input_files is tutils.list_input_files


@pytest.mark.parametrize("key,opts", [("exp3", dict(VRL, select="")),
                                      ("dynamic", DYNAMIC),
                                      ("segments", FIXED_SEGS)],
                         ids=["exp3", "occurs", "segments"])
def test_flatten_and_strings_match(files, key, opts):
    opts = {k: v for k, v in opts.items() if v != ""}
    jax, port = _reads(files[key], opts)
    for fn in ("flatten_schema", "convert_fields_to_strings"):
        j = getattr(jutils, fn)(jax)
        t = getattr(tutils, fn)(port)
        assert t.schema.field_names() == j.schema.field_names()
        assert t.to_rows() == j.to_rows()
        assert t.to_json_lines() == j.to_json_lines()
        assert len(t) == len(j.to_rows())
        assert t.to_arrow().equals(j.to_arrow())


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The query and utils modules are port copies: no jax, no
    cobrix_tpu."""
    seen = 0
    for sub in ("query", "utils"):
        pkg = os.path.join(REPO, "cobrix_tpu_torch", sub)
        for name in sorted(os.listdir(pkg)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(pkg, name), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("jax", "jaxlib", "cobrix_tpu"), \
                        f"{sub}/{name} imports {m}"
            seen += 1
    assert seen >= 8
