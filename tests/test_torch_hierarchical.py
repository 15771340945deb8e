"""Hierarchical (segment-children) reads and the host row walk of the port
against the JAX package, on the CPU.

The same bytes go to ``cobrix_tpu.read_cobol`` (numpy backend, one
thread) and to ``cobrix_tpu_torch.read_cobol(..., device="cpu")``:
sequential, split by ``input_split_records`` and pipelined. The rows
(Record_Id included), the JSON lines, the Arrow table (schema and
metadata included) and the ledger must be equal, or both reads must
raise the same error; and each read's ``assembly_stats`` (a columnar
assembly, or a bail to the row path by reason) must equal the JAX
package's. The decode-once reads decode every record at the full plan:
the JAX package's numpy route masks each segment's columns to its own
rows and the port does not, as the JAX package's device route does not,
so the tables show that the rows of other segments are never read.
"""
import numpy as np
import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.reader import hierarchical_arrow as jax_hier
from cobrix_tpu.testing import generators as jax_gen
from cobrix_tpu_torch.copybook.copybook import parse_copybook
from cobrix_tpu_torch.reader import hierarchical_arrow as port_hier
from cobrix_tpu_torch.reader import var_len_reader
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.reader.columnar import ColumnarDecoder, DecodedBatch
from cobrix_tpu_torch.testing import faults
from cobrix_tpu_torch.testing import generators as gen

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

SEG_OPTS = {f"redefine_segment_id_map:{i}": f"{name} => {sid}"
            for i, (sid, name) in enumerate(
                gen.HIERARCHICAL_SEGMENT_MAP.items())}
CHILD_OPTS = {f"segment-children:{i}": f"{parent} => {child}"
              for i, (child, parent) in enumerate(
                  gen.HIERARCHICAL_PARENT_MAP.items())}
HIER = dict(copybook_contents=gen.HIERARCHICAL_COPYBOOK,
            is_record_sequence="true", segment_field="SEGMENT-ID",
            **SEG_OPTS, **CHILD_OPTS)
EXP3_HIER = dict(copybook_contents=gen.EXP3_COPYBOOK,
                 is_record_sequence="true", segment_field="SEGMENT-ID",
                 generate_record_id="true",
                 **{"redefine_segment_id_map:0": "STATIC-DETAILS => C",
                    "redefine_segment_id_map:1": "CONTACTS => P",
                    "segment-children:0": "STATIC-DETAILS => CONTACTS"})
MULTIROOT_COPYBOOK = """
       01  RECORD.
           05  SEG-ID        PIC X(1).
           05  COMPANY.
               10  NAME      PIC X(8).
           05  CONTACT REDEFINES COMPANY.
               10  PHONE     PIC X(9).
"""
MULTIROOT = dict(copybook_contents=MULTIROOT_COPYBOOK,
                 is_record_sequence="true", segment_field="SEG-ID",
                 generate_record_id="true",
                 schema_retention_policy="collapse_root",
                 **{"redefine-segment-id-map:1": "COMPANY => C,D",
                    "redefine-segment-id-map:2": "CONTACT => P",
                    "segment-children:1": "COMPANY => CONTACT"})
NO_BAIL = {"columnar": 0, "bail_multi_sid_parent": 0,
           "bail_odo_cross_segment": 0, "bail_schema_shape": 0}


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _rdw_le(body: bytes) -> bytes:
    return bytes([0, 0]) + len(body).to_bytes(2, "little") + body


def _rdw_be(body: bytes) -> bytes:
    return len(body).to_bytes(2, "big") + bytes([0, 0]) + body


def _multiroot_file(n_roots: int, children: int) -> bytes:
    """Root records 'C' and 'D' in turn, each with `children` 'P'
    records (``tests/test_indexed_scan.py``'s multisegment file)."""
    out = []
    for r in range(n_roots):
        sid = "C" if r % 2 == 0 else "D"
        out.append(_rdw_le(jax_gen.ebcdic_encode(f"{sid}COMP{r:04d}")))
        for c in range(children):
            out.append(_rdw_le(jax_gen.ebcdic_encode(
                f"PPHONE{r:03d}{c:01d}")))
    return b"".join(out)


def _outcome(read, stats):
    stats.assembly_stats(reset=True)
    try:
        data = read()
        table = data.to_arrow()
        return ("ok", data.to_rows(), data.to_json_lines(), table,
                data.diagnostics.as_dict() if data.diagnostics else None,
                stats.assembly_stats())
    except Exception as exc:
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "offset", None))


def _same(path, options, split=None, jax_options=None, workers="2",
          jax_whole=False):
    """The port's read equals the JAX package's read of `jax_options`
    (the same options by default): sequential, and with `split` also
    split by `input_split_records` and pipelined over those splits.
    `jax_whole`: the JAX package reads the file whole for every variant
    (its split read has a fault there). Returns the port's outcomes."""
    jax_options = jax_options or options
    variants = [({}, {})]
    if split is not None:
        jax_split = ({"enable_indexes": "false"} if jax_whole
                     else {"input_split_records": split})
        variants += [(jax_split, {"input_split_records": split}),
                     (jax_split, {"input_split_records": split,
                                  "pipeline_workers": workers})]
    got_all = []
    for jax_extra, port_extra in variants:
        want = _outcome(lambda: cobrix_tpu.read_cobol(
            path, backend="numpy", parallelism="1", **jax_options,
            **jax_extra), jax_hier)
        got = _outcome(lambda: cobrix_tpu_torch.read_cobol(
            path, device="cpu", **options, **port_extra), port_hier)
        assert got[0] == want[0], (port_extra, got[:3], want[:3])
        if want[0] == "error":
            assert got[1:] == want[1:]
        else:
            _, rows, lines, table, ledger, stats = got
            assert rows == want[1], port_extra
            assert lines == want[2], port_extra
            assert table.schema.equals(want[3].schema, check_metadata=True)
            assert table.equals(want[3]), port_extra
            assert ledger == want[4]
            assert stats == want[5], port_extra
        got_all.append(got)
    return got_all


# -- the generators ------------------------------------------------------------

@pytest.mark.parametrize("seed", [100, 7])
def test_generator_bytes_equal_the_jax_generator(seed):
    assert gen.generate_hierarchical(50, seed=seed) == \
        jax_gen.generate_hierarchical(50, seed=seed)
    assert gen.HIERARCHICAL_COPYBOOK == jax_gen.HIERARCHICAL_COPYBOOK
    assert gen.HIERARCHICAL_SEGMENT_MAP == jax_gen.HIERARCHICAL_SEGMENT_MAP
    assert gen.HIERARCHICAL_PARENT_MAP == jax_gen.HIERARCHICAL_PARENT_MAP


# -- the decode-once route ----------------------------------------------------

@pytest.mark.parametrize("companies,seed", [(40, 13), (120, 3)])
@pytest.mark.parametrize("record_id", [False, True], ids=["no_id", "id"])
@pytest.mark.parametrize("policy", ["keep_original", "collapse_root"])
def test_seven_segment_hierarchy(tmp_path, companies, seed, record_id,
                                 policy):
    """TestDataGen17Hierarchical: company -> departments (employees,
    offices) and customers (contacts, contracts), decoded once."""
    path = _write(tmp_path, "h.dat",
                  gen.generate_hierarchical(companies, seed=seed))
    options = dict(HIER, schema_retention_policy=policy)
    if record_id:
        options["generate_record_id"] = "true"
    got = _same(path, options, split="37")
    assert all(g[5]["columnar"] >= 1 for g in got)
    assert got[0][5] == dict(NO_BAIL, columnar=1)


def test_exp3_contacts_under_static_details(tmp_path):
    """exp3 with its 'P' records as children of the 'C' records
    (``tests/test_var_len_reader.py``'s exp3 hierarchy): the 2,000-slot
    strategy table of every root."""
    path = _write(tmp_path, "e3.dat", gen.generate_exp3(60, seed=14))
    got = _same(path, EXP3_HIER, split="17")
    assert got[0][5] == dict(NO_BAIL, columnar=1)


def test_multi_id_root(tmp_path):
    """``COMPANY => C,D``: a root reachable from two segment ids, every
    root id a split point."""
    path = _write(tmp_path, "m.dat", _multiroot_file(30, 2))
    _same(path, MULTIROOT, split="6")


def test_multi_id_root_index_splits_on_every_root():
    from cobrix_tpu_torch.api import parse_options

    params = parse_options({k: v for k, v in MULTIROOT.items()
                            if k not in ("copybook_contents",
                                         "schema_retention_policy")})
    reader = var_len_reader.VarLenReader(MULTIROOT_COPYBOOK, params,
                                         device="cpu")
    is_hierarchical, root_ids = reader._index_split_config()
    assert is_hierarchical and set(root_ids.split(",")) == {"C", "D"}


def test_non_root_parent_of_several_ids_bails(tmp_path):
    """A non-root parent type reachable from two segment ids: the
    columnar assembly bails to the row path, as the JAX package's."""
    copybook = """
       01  RECORD.
           05  SEG-ID        PIC X(1).
           05  COMPANY.
               10  NAME      PIC X(6).
           05  DEPT REDEFINES COMPANY.
               10  DNAME     PIC X(6).
           05  EMP REDEFINES COMPANY.
               10  ENAME     PIC X(6).
"""
    recs = ["CACME01", "DSALES1", "PANNA01", "EDEVS01", "PBOB001",
            "PCARL01", "CGLOB01", "EOPS001", "PDAVE01", "DLEGAL1"]
    path = _write(tmp_path, "n.dat", b"".join(
        _rdw_le(jax_gen.ebcdic_encode(r)) for r in recs))
    options = dict(copybook_contents=copybook, is_record_sequence="true",
                   segment_field="SEG-ID", generate_record_id="true",
                   **{"redefine-segment-id-map:0": "COMPANY => C",
                      "redefine-segment-id-map:1": "DEPT => D,E",
                      "redefine-segment-id-map:2": "EMP => P",
                      "segment-children:0": "COMPANY => DEPT",
                      "segment-children:1": "DEPT => EMP"})
    got = _same(path, options)
    assert got[0][5] == dict(NO_BAIL, bail_multi_sid_parent=1)


ODO_OUTSIDE = """
       01 RECORD.
          05 SEG-ID    PIC X(1).
          05 COMPANY.
             10 CNT    PIC 9(1).
             10 NAME   PIC X(4).
          05 CONTACT REDEFINES COMPANY.
             10 ITEM   PIC X(1) OCCURS 4 DEPENDING ON CNT.
"""
ODO_PREFIX = """
       01 RECORD.
          05 SEG-ID    PIC X(1).
          05 CNT       PIC 9(1).
          05 COMPANY.
             10 NAME   PIC X(4).
          05 CONTACT REDEFINES COMPANY.
             10 ITEM   PIC X(1) OCCURS 4 DEPENDING ON CNT.
"""
ODO_SAME = """
       01 RECORD.
          05 SEG-ID    PIC X(1).
          05 COMPANY.
             10 NAME   PIC X(5).
          05 CONTACT REDEFINES COMPANY.
             10 CNT    PIC 9(1).
             10 ITEM   PIC X(1) OCCURS 4 DEPENDING ON CNT.
"""
ODO_DEPENDEE = """
       01 RECORD.
          05 SEG-ID    PIC X(1).
          05 COMPANY.
             10 NAME   PIC X(5).
          05 CONTACT REDEFINES COMPANY.
             10 CNT    PIC 9(5).
          05 TAIL     PIC X(1) OCCURS 4 DEPENDING ON CNT.
"""


@pytest.mark.parametrize("copybook,recs,extra,stats", [
    (ODO_OUTSIDE, [("C", "2ACME"), ("P", "WXYZ"), ("C", "1GLOB"),
                   ("P", "QRST")], {},
     dict(NO_BAIL, bail_odo_cross_segment=1)),
    (ODO_PREFIX, [("C", "2ACME"), ("P", "4WXYZ"), ("C", "3GLOB"),
                  ("P", "1QRST")], {},
     dict(NO_BAIL, bail_odo_cross_segment=1)),
    (ODO_SAME, [("C", "ACME "), ("P", "2WXYZ"), ("C", "GLOBX"),
                ("P", "3QRST")], {}, dict(NO_BAIL, columnar=1)),
    (ODO_DEPENDEE, [("C", "ACME AB"), ("P", "00002XY"), ("C", "GLOBXCD"),
                    ("P", "00001Z")], {"variable_size_occurs": "true"},
     NO_BAIL),
], ids=["dependee_outside", "shared_prefix", "same_segment",
        "dependee_unmasked_row_walk"])
def test_depending_on_across_segments(tmp_path, copybook, recs, extra,
                                      stats):
    """``tests/test_review_regressions.py``'s DEPENDING ON cases: an
    array whose dependee lies outside its segment takes the row path; a
    dependee inside it stays columnar; with ``variable_size_occurs`` the
    read is the row walk, which reads dependees on every record."""
    path = _write(tmp_path, "odo.dat", b"".join(
        _rdw_be(jax_gen.ebcdic_encode(sid + body)) for sid, body in recs))
    options = dict(copybook_contents=copybook, is_record_sequence="true",
                   is_rdw_big_endian="true", segment_field="SEG-ID",
                   **{"redefine-segment-id-map:0": "COMPANY => C",
                      "redefine-segment-id-map:1": "CONTACT => P",
                      "segment-children:0": "COMPANY => CONTACT"},
                   **extra)
    got = _same(path, options)
    assert got[0][5] == stats


HIER_VAR_OCCURS = """
       01 RECORD.
          02 SEG PIC X(1).
          02 SEG1.
            03 COUNT1 PIC 9(1).
            03 GROUP1 OCCURS 0 TO 2 TIMES DEPENDING ON COUNT1.
               04 INNER-COUNT1 PIC 9(1).
               04 INNER-GROUP1 OCCURS 0 TO 3 TIMES
                                DEPENDING ON INNER-COUNT1.
                  05 FIELD1 PIC X.
          02 SEG2 REDEFINES SEG1.
            03 COUNT2 PIC 9(1).
            03 GROUP2 OCCURS 0 TO 2 TIMES DEPENDING ON COUNT2.
               04 INNER-COUNT2 PIC 9(1).
               04 INNER-GROUP2 OCCURS 0 TO 3 TIMES
                                DEPENDING ON INNER-COUNT2.
                  05 FIELD2 PIC X.
"""
HIER_VAR_OCCURS_DATA = bytes([
    0x00, 0x00, 0x02, 0x00, 0xF1, 0xF0,
    0x00, 0x00, 0x03, 0x00, 0xF1, 0xF1, 0xF0,
    0x00, 0x00, 0x04, 0x00, 0xF1, 0xF1, 0xF1, 0xC1,
    0x00, 0x00, 0x05, 0x00, 0xF1, 0xF1, 0xF2, 0xC1, 0xC2,
    0x00, 0x00, 0x08, 0x00, 0xF1, 0xF2, 0xF2, 0xC3, 0xC4, 0xF2,
    0xC5, 0xC6,
    0x00, 0x00, 0x08, 0x00, 0xF2, 0xF2, 0xF2, 0xC7, 0xC8, 0xF2,
    0xC9, 0xD1,
])


def test_hierarchical_variable_occurs(tmp_path):
    """``tests/test_ported_specs.py``'s hierarchical variable OCCURS
    bytes: nested DEPENDING ON tables in both segments, read by the row
    walk with the flush-trigger Record_Ids."""
    path = _write(tmp_path, "hv.dat", HIER_VAR_OCCURS_DATA)
    got = _same(path, dict(
        copybook_contents=HIER_VAR_OCCURS, is_record_sequence="true",
        schema_retention_policy="collapse_root",
        generate_record_id="true", variable_size_occurs="true",
        segment_field="SEG",
        **{"redefine_segment_id_map:1": "SEG1 => 1",
           "redefine-segment-id-map:2": "SEG2 => 2",
           "segment-children:1": "SEG1 => SEG2"}))
    assert [r[1] for r in got[0][1]] == [1, 2, 3, 4, 6]


@pytest.mark.parametrize("extra", [
    {"select": "COMPANY-NAME,CUSTOMER-NAME"},
    {"record_start_offset": "0"},
    {"record_start_offset": "1", "select": "ZIP"},
], ids=["select", "start_offset_0", "select_and_offset"])
def test_options_that_take_the_row_walk(tmp_path, extra):
    """``select`` and a record start offset leave the decode-once route
    for the row walk, which ignores the projection, as in the JAX
    package; a zero start offset does not."""
    raw = gen.generate_hierarchical(25, seed=31)
    if extra.get("record_start_offset") == "1":
        # one byte before every record's payload
        starts = faults.rdw_record_starts(raw)
        parts = [raw[a:b] for a, b in zip(starts, list(starts[1:])
                                           + [len(raw)])]
        raw = b"".join(_rdw_le(b"\x00" + p[4:]) for p in parts)
    path = _write(tmp_path, "w.dat", raw)
    got = _same(path, dict(HIER, generate_record_id="true", **extra),
                split="29")
    walked = "select" in extra or extra["record_start_offset"] != "0"
    assert (got[0][5] == NO_BAIL) == walked


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
def test_zeroed_header_inside_a_child_run(tmp_path, policy):
    """A permissive read over a zeroed RDW header among a root's
    children: the resync and its ledger entry as in the JAX package; the
    rows carry no reason (the corrupt-record column is all null)."""
    raw = gen.generate_hierarchical(30, seed=21)
    starts = faults.rdw_record_starts(raw)
    sids = [raw[s + 4] for s in starts]
    child = next(i for i in range(40, len(starts))
                 if sids[i] != 0xF1 and sids[i - 1] != 0xF1)
    path = _write(tmp_path, "z.dat", faults.zero_rdw(raw, starts[child]))
    options = dict(HIER, record_error_policy=policy,
                   generate_record_id="true")
    if policy == "permissive":
        options["corrupt_record_column"] = "_corrupt"
    got = _same(path, options, split="50")
    assert got[0][4]["corrupt_records"] >= 1


def test_children_across_windows(tmp_path, monkeypatch):
    """Windows of 4 KiB: a root's children lie in the windows after it,
    and the decode-once batch joins them."""
    monkeypatch.setattr(var_len_reader, "READ_WINDOW_BYTES", 4096)
    path = _write(tmp_path, "x.dat", gen.generate_hierarchical(60, seed=5))
    got = _same(path, dict(HIER, generate_record_id="true"))
    assert got[0][5] == dict(NO_BAIL, columnar=1)


def test_decode_batches_concatenate(tmp_path):
    """`DecodedBatch.concat` of a file's batches gives every column's
    values of the one batch over all its records, truncated records'
    host bytes included."""
    import torch

    copybook = parse_copybook(gen.HIERARCHICAL_COPYBOOK)
    decoder = ColumnarDecoder(copybook, device="cpu")
    raw = gen.generate_hierarchical(8, seed=2)
    starts = np.asarray(faults.rdw_record_starts(raw))
    offsets = starts + 4
    lengths = np.diff(np.append(starts, len(raw))) - 4
    image = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    whole = decoder.decode_raw(image, offsets, lengths)
    cut = len(offsets) // 3
    parts = DecodedBatch.concat([
        decoder.decode_raw(image, offsets[:cut], lengths[:cut]),
        decoder.decode_raw(image, offsets[cut:], lengths[cut:])])
    assert parts.n_records == whole.n_records
    assert np.array_equal(parts.lengths, whole.lengths)
    for col in range(len(decoder.plan.columns)):
        assert parts.column_values(col) == whole.column_values(col)


@pytest.mark.parametrize("record_id", [False, True], ids=["no_id", "id"])
def test_fixed_length_segment_children(tmp_path, record_id):
    """Fixed-length multisegment records with a parent map: with record
    ids the variable-length reader frames them by the fixed-length
    header parser and the row walk nests them; without, the fixed-length
    reader reads them flat. Either way as the JAX package does; the
    port's split reads are held to the JAX package's whole-file read,
    since its generic reader never ends on a fixed-length index shard
    (ROADMAP C6)."""
    data = gen.generate_fixed_segments(200, seed=9)
    path = _write(tmp_path, "f.dat", data.tobytes())
    options = dict(copybook_contents=gen.FIXED_SEGMENTS_COPYBOOK,
                   **gen.FIXED_SEGMENTS_OPTIONS,
                   **{"segment-children:0": "COMPANY => PERSON"})
    if record_id:
        options["generate_record_id"] = "true"
    _same(path, options, split="30" if record_id else None,
          jax_whole=True)


def test_flat_and_hierarchical_reads_do_not_share_a_plan(tmp_path):
    """One copybook read flat, hierarchical and flat again in one
    process: each read equals the JAX package's."""
    path = _write(tmp_path, "p.dat", gen.generate_hierarchical(15, seed=4))
    flat = {k: v for k, v in HIER.items()
            if not k.startswith("segment-children")}
    for options in (flat, HIER, flat):
        _same(path, options)


@pytest.mark.parametrize("options,message", [
    (dict(segment_id_level0="1", segment_id_level1="2",
          **{"redefine_segment_id_map:0": "COMPANY => 1",
             "redefine_segment_id_map:1": "DEPT => 2"}),
     "'segment_id_level\\*'/'segment_id_root' and 'segment-children:\\*' "
     "cannot be used together"),
    ({}, "'segment-children:\\*' requires 'redefine-segment-id-map:\\*'"),
], ids=["levels_with_children", "children_without_map"])
def test_option_checks(tmp_path, options, message):
    path = _write(tmp_path, "o.dat", gen.generate_hierarchical(3, seed=1))
    opts = dict(copybook_contents=gen.HIERARCHICAL_COPYBOOK,
                is_record_sequence="true", segment_field="SEGMENT-ID",
                **{"segment_children:0": "COMPANY => DEPT"}, **options)
    with pytest.raises(ValueError, match=message):
        cobrix_tpu.read_cobol(path, **opts)
    with pytest.raises(ValueError, match=message):
        cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)


# -- the row walk of a dynamic layout ------------------------------------------

@pytest.mark.parametrize("policy", ["fail_fast", "permissive"])
def test_dynamic_occurs_layout(tmp_path, policy):
    """A DEPENDING ON table followed by a trailer
    (`generate_dynamic_occurs`): the trailer's offset moves with each
    record's count, so the row walk decodes it, whole, split and
    pipelined."""
    path = _write(tmp_path, "d.dat", gen.generate_dynamic_occurs(
        150, seed=8))
    got = _same(path, dict(copybook_contents=gen.DYNAMIC_OCCURS_COPYBOOK,
                           variable_size_occurs="true",
                           generate_record_id="true",
                           record_error_policy=policy), split="40")
    assert len(got[0][1]) == 150 and got[0][5] == NO_BAIL
