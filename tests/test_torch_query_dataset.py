"""The port's ``pyarrow.dataset``-shaped scan surface
(``cobrix_tpu_torch.query.dataset``) against the JAX package's, on the
CPU: the same bytes, the same scanner calls, equal tables, batches,
counts and aggregates; a pyarrow expression lowered into the pushdown,
an unsupported one and a generated-column one filtered afterwards, and
record identity across files.
"""
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pytest

import cobrix_tpu
import cobrix_tpu.query as jq
import cobrix_tpu_torch
import cobrix_tpu_torch.query as tq
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import generators as gen

from util import hard_timeout

warm_pyarrow()

FIXED = dict(copybook_contents=gen.TRANSDATA_COPYBOOK,
             schema_retention_policy="collapse_root")
VRL = dict(copybook_contents=gen.EXP3_COPYBOOK,
           is_record_sequence="true", segment_field="SEGMENT_ID",
           schema_retention_policy="collapse_root",
           redefine_segment_id_map="STATIC-DETAILS => C",
           **{"redefine-segment-id-map:1": "CONTACTS => P"})


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(180, request.node.name):
        yield


@pytest.fixture(scope="module")
def fixed_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("dataset") / "trans.dat"
    path.write_bytes(gen.generate_transactions(600, seed=21).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def vrl_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("dataset") / "exp3.dat"
    path.write_bytes(bytes(gen.generate_exp3(200, seed=21)))
    return str(path)


def _datasets(path, **opts):
    return (jq.dataset(path, backend="numpy", **opts),
            tq.dataset(path, device="cpu", **opts))


FILTERS = {
    "none": None,
    "pyarrow": lambda: pc.field("CURRENCY") == "USD",
    "pyarrow_isin": lambda: pc.field("CURRENCY").isin(["USD", "EUR"]),
    "grammar": lambda: "AMOUNT > 1000 and WEALTH_QFY == 1",
    "expr": lambda: tq.col("COMPANY_NAME") >= "M",
    "unsupported": lambda: pc.field("COMPANY_ID").is_valid(),
}


def _filter(name):
    make = FILTERS[name]
    return None if make is None else make()


def _jax_filter(name):
    """The JAX package takes its own Expr objects."""
    f = _filter(name)
    return jq.col("COMPANY_NAME") >= "M" if name == "expr" else f


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("columns", [None, ["COMPANY_ID", "AMOUNT"]],
                         ids=["all", "projected"])
def test_scanner_tables_match(fixed_file, name, columns):
    jd, td = _datasets(fixed_file, **FIXED)
    assert td.schema.equals(jd.schema)
    got = td.scanner(columns=columns, filter=_filter(name)).to_table()
    expect = jd.scanner(columns=columns, filter=_jax_filter(name)).to_table()
    assert got.equals(expect)
    assert got.num_rows > 0
    batches = list(td.to_batches(columns=columns, filter=_filter(name),
                                 batch_size=64))
    assert len(batches) > 1 or got.num_rows <= 64
    assert pa.Table.from_batches(batches, schema=got.schema).equals(got)
    assert td.count_rows(filter=_filter(name)) == \
        jd.count_rows(filter=_jax_filter(name)) == got.num_rows
    assert td.head(7, columns=columns, filter=_filter(name)).equals(
        got.slice(0, 7))


def test_pushdown_matches_posthoc(fixed_file):
    _, td = _datasets(fixed_file, **FIXED)
    full = cobrix_tpu_torch.read_cobol(fixed_file, device="cpu",
                                       **FIXED).to_arrow()
    expr = pc.field("CURRENCY") == "USD"
    got = td.scanner(columns=["COMPANY_ID", "AMOUNT"],
                     filter=expr).to_table()
    expect = pads.dataset(full).to_table(
        columns=["COMPANY_ID", "AMOUNT"], filter=expr)
    assert got.equals(expect)


def test_unsupported_expression_falls_back_posthoc(fixed_file):
    from cobrix_tpu_torch.query.dataset import _lower_filter

    expr = pc.field("NAME") == pc.field("ALIAS")
    wire, posthoc = _lower_filter(expr)
    assert wire is None and posthoc is not None
    wire, posthoc = _lower_filter(pc.field("A") == 1)
    assert wire is not None and posthoc is None


@pytest.mark.parametrize("aggs,name", [
    (["count", "min:AMOUNT", "max:AMOUNT", "sum:AMOUNT"], "none"),
    (["count", "sum:AMOUNT", "max:COMPANY_NAME"], "pyarrow"),
    (["min:WEALTH_QFY", "count"], "grammar"),
], ids=["all", "pyarrow", "grammar"])
def test_aggregate_matches(fixed_file, aggs, name):
    jd, td = _datasets(fixed_file, **FIXED)
    got = td.aggregate(aggs, filter=_filter(name))
    assert got == jd.aggregate(aggs, filter=_jax_filter(name))
    table = td.to_table(filter=_filter(name))
    if "sum:AMOUNT" in got:
        assert got["sum:AMOUNT"] == pc.sum(table["AMOUNT"]).as_py()
    assert got["count"] == table.num_rows


@pytest.mark.parametrize("bad", [["avg:AMOUNT"], [], ["min:"]])
def test_aggregate_spec_errors(fixed_file, bad):
    jd, td = _datasets(fixed_file, **FIXED)
    with pytest.raises(ValueError) as jax_err:
        jd.aggregate(bad)
    with pytest.raises(ValueError) as port_err:
        td.aggregate(bad)
    assert str(port_err.value) == str(jax_err.value)


def test_aggregate_unknown_field(fixed_file):
    _, td = _datasets(fixed_file, **FIXED)
    with pytest.raises(KeyError):
        td.aggregate(["sum:NOPE"])


def test_generated_column_filter_falls_back_posthoc(fixed_file):
    jd, td = _datasets(fixed_file, generate_record_id="true", **FIXED)
    expr = pc.field("Record_Id") < 5
    t = td.to_table(filter=expr)
    assert t["Record_Id"].to_pylist() == [0, 1, 2, 3, 4]
    assert t.equals(jd.to_table(filter=expr))
    assert td.count_rows(filter=expr) == 5


def test_segment_filter_on_rdw(vrl_file):
    jd, td = _datasets(vrl_file, **VRL)
    for f in ("segment('C') and TAXPAYER_TYPE == 'A'",
              tq.segment_is("P")):
        jf = f if isinstance(f, str) else jq.segment_is("P")
        got = td.scanner(columns=["SEGMENT_ID", "COMPANY_ID"],
                         filter=f).to_table()
        assert got.num_rows > 0
        assert got.equals(jd.scanner(columns=["SEGMENT_ID", "COMPANY_ID"],
                                     filter=jf).to_table())


def test_fragments_and_reader(fixed_file):
    _, td = _datasets(fixed_file, **FIXED)
    frags = td.get_fragments()
    assert len(frags) == 1 and frags[0].physical_schema.equals(td.schema)
    expr = pc.field("CURRENCY").isin(["USD", "EUR"])
    via_frag = frags[0].scanner(columns=["CURRENCY"], filter=expr).to_table()
    via_reader = td.scanner(columns=["CURRENCY"],
                            filter=expr).to_reader().read_all()
    assert via_frag.equals(via_reader)
    assert set(via_frag["CURRENCY"].to_pylist()) <= {"USD", "EUR"}
    assert frags[0].count_rows(filter=expr) == via_frag.num_rows
    assert frags[0].to_table(columns=["CURRENCY"],
                             filter=expr).equals(via_frag)


def test_unknown_column_rejected(fixed_file):
    _, td = _datasets(fixed_file, **FIXED)
    with pytest.raises(KeyError):
        td.scanner(columns=["NOPE"])


def test_multifile_record_identity(tmp_path):
    """to_batches agrees with to_table on File_Id / Record_Id across
    files, and both with the JAX package's."""
    paths = []
    for i in range(2):
        p = tmp_path / f"part{i}.dat"
        p.write_bytes(gen.generate_transactions(50, seed=40 + i).tobytes())
        paths.append(str(p))
    jd, td = _datasets(paths, generate_record_id="true", **FIXED)
    via_table = td.to_table()
    via_batches = pa.Table.from_batches(list(td.to_batches()))
    assert via_batches.equals(via_table)
    assert via_table.equals(jd.to_table())
    assert sorted(set(via_table["File_Id"].to_pylist())) == [0, 1]
    expr = pc.field("CURRENCY") == "USD"
    assert td.to_table(filter=expr).equals(jd.to_table(filter=expr))


def test_dataset_reads_on_the_requested_device(fixed_file):
    _, td = _datasets(fixed_file, **FIXED)
    assert str(td.device) == "cpu"
    assert repr(td).startswith("<CobolDataset files=1")
    with pytest.raises(FileNotFoundError):
        tq.dataset(str(fixed_file) + ".missing*", device="cpu", **FIXED)
    assert cobrix_tpu.query.dataset is jq.dataset
