"""The record-length, offset and copybook-shaping options of the port
against the JAX package, on the CPU.

Every option of this slice, alone and in the combinations the JAX
package checks, goes with the same bytes to ``cobrix_tpu.read_cobol``
(numpy backend, one thread) and to ``cobrix_tpu_torch.read_cobol(...,
device="cpu")``, sequential and pipelined: the rows, the JSON lines and
the Arrow table must be equal, or both reads must raise the same error
class with the same message.
"""
import os
import struct
from decimal import Decimal

import numpy as np
import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.testing import generators as gen
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import generators as pgen

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

EXP1 = dict(copybook_contents=gen.EXP1_COPYBOOK)
ASCII = dict(copybook_contents=pgen.ASCII_COPYBOOK, encoding="ascii")
SEGMENTS = dict(copybook_contents=pgen.FIXED_SEGMENTS_COPYBOOK,
                **pgen.FIXED_SEGMENTS_OPTIONS)
PIPE = dict(pipeline_workers="3", chunk_size_mb="0.01")


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


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


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _outputs(read):
    data = read()
    return data, _typed(data.to_rows()), data.to_json_lines(), \
        data.to_arrow()


def _same(path, options, pipelined=True):
    """The port's reads (sequential, and pipelined unless told not to)
    equal the JAX package's read, or raise its error; returns the port's
    sequential CobolData (None when the reads raise)."""
    def jax_read():
        # the JAX package's reference read runs on one thread
        return cobrix_tpu.read_cobol(path, backend="numpy",
                                     **dict(options, parallelism="1"))

    def port_read(**pipe):
        return cobrix_tpu_torch.read_cobol(path, device="cpu", **options,
                                           **pipe)

    try:
        _, rows, lines, table = _outputs(jax_read)
    except Exception as exc:
        # each package has its own error classes: compare by name
        with pytest.raises(Exception) as got:
            _outputs(port_read)
        assert type(got.value).__name__ == type(exc).__name__
        assert str(got.value) == str(exc)
        return None
    reads = [{}] + ([PIPE] if pipelined else [])
    first = None
    for pipe in reads:
        data, got_rows, got_lines, got_table = _outputs(
            lambda: port_read(**pipe))
        assert got_rows == rows
        assert got_lines == lines
        assert got_table.schema.equals(table.schema, check_metadata=True)
        assert _typed(got_table.to_pylist()) == _typed(table.to_pylist())
        first = first or data
    return first


# -- record_length ----------------------------------------------------------

RL_COPYBOOK = """      01  R.
                03 A        PIC X(2).
                03 B        PIC X(1).
      """
RL_DATA = b"AABBBCCDDDEEFFFZYY"


@pytest.mark.parametrize("length", ["2", "3", "6", "7"])
def test_record_length(tmp_path, length):
    path = _write(tmp_path, "r.dat", RL_DATA)
    _same(path, dict(copybook_contents=RL_COPYBOOK, encoding="ascii",
                     schema_retention_policy="collapse_root",
                     record_length=length))


@pytest.mark.parametrize("other", [
    {"is_record_sequence": "true"}, {"is_xcom": "true"},
    {"is_rdw_big_endian": "true"},
    {"is_rdw_part_of_record_length": "true"},
    {"rdw_adjustment": "-1", "is_rdw_big_endian": "false"}])
def test_record_length_refuses_the_rdw_options(tmp_path, other):
    path = _write(tmp_path, "r.dat", RL_DATA)
    _same(path, dict(copybook_contents=RL_COPYBOOK, record_length="2",
                     **other))


def test_record_length_with_record_ids_and_offsets(tmp_path):
    path = _write(tmp_path, "r.dat", b"HDR" + RL_DATA * 3 + b"FT")
    _same(path, dict(copybook_contents=RL_COPYBOOK, encoding="ascii",
                     record_length="3", generate_record_id="true",
                     file_start_offset="3", file_end_offset="2"))


# -- record and file offsets --------------------------------------------------

def _padded_exp1(n, seed, head, tail):
    rng = np.random.default_rng(seed)
    body = gen.generate_exp1(n, seed=seed)
    return np.concatenate([
        rng.integers(0, 256, size=(n, head), dtype=np.uint8), body,
        rng.integers(0, 256, size=(n, tail), dtype=np.uint8)], axis=1)


@pytest.mark.parametrize("head,tail", [(4, 0), (0, 3), (5, 7)])
def test_record_start_and_end_offsets(tmp_path, head, tail):
    path = _write(tmp_path, "e1.dat", _padded_exp1(30, 3, head, tail))
    _same(path, dict(EXP1, record_start_offset=str(head),
                     record_end_offset=str(tail)))


def test_record_offsets_with_a_shorter_record_length(tmp_path):
    """An override shorter than the copybook with a start offset: the
    fields past a record's end are null."""
    path = _write(tmp_path, "e1.dat", _padded_exp1(20, 4, 6, 0)[:, :700])
    _same(path, dict(EXP1, record_start_offset="6", record_length="700"))


@pytest.mark.parametrize("offsets", [
    {"record_start_offset": "-1"}, {"record_end_offset": "-2"}])
def test_negative_record_offsets_raise(tmp_path, offsets):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(3, seed=1))
    _same(path, dict(EXP1, **offsets))


@pytest.mark.parametrize("header,footer", [(100, 0), (0, 57), (1493, 2000),
                                           (7, 1493 * 2 + 3)])
def test_file_header_and_footer(tmp_path, header, footer):
    rng = np.random.default_rng(header + footer)
    data = np.concatenate([
        rng.integers(0, 256, size=header, dtype=np.uint8),
        gen.generate_exp1(25, seed=5).ravel(),
        rng.integers(0, 256, size=footer, dtype=np.uint8)])
    path = _write(tmp_path, "e1.dat", data)
    options = dict(EXP1, file_start_offset=str(header),
                   file_end_offset=str(footer))
    _same(path, options)
    _same(path, dict(options, generate_record_id="true",
                     record_start_offset="0"))


@pytest.mark.parametrize("split", ["4", "7"])
@pytest.mark.parametrize("header,tail", [(0, 0), (0, 11), (50, 0),
                                         (50, 11)])
def test_fixed_length_records_in_sparse_index_shards(tmp_path, split, header,
                                                     tail):
    """Fixed-length records read by the variable-length reader, split at
    sparse-index entries, sequential and pipelined: the rows of the JAX
    package's unsplit read (its generic reader never ends on such a
    shard, ROADMAP C6), except that a file header counts as one record
    in the index, so Record_Ids from the second shard on are one higher
    (reference IndexGenerator.scala:117-120); bytes after the last
    record let a split land on it."""
    data = np.concatenate([np.full(header, 0x40, dtype=np.uint8),
                           gen.generate_exp1(30, seed=6).ravel(),
                           np.full(tail, 0x40, dtype=np.uint8)])
    path = _write(tmp_path, "e1.dat", data)
    options = dict(EXP1, file_start_offset=str(header),
                   generate_record_id="true")
    want = cobrix_tpu.read_cobol(path, backend="numpy", **options).to_rows()
    per = int(split)
    first = per - (1 if header else 0)  # records in the first shard
    n_shards = 1 + max(0, -(-(30 - first - (0 if tail else 1)) // per))
    for pipe in ({}, PIPE):
        got = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                          input_split_records=split,
                                          **options, **pipe)
        assert got.metrics.shards == (n_shards if pipe else 1)
        rows = got.to_rows()
        shift = [1 if header and i >= first else 0 for i in range(30)]
        assert [r[1] for r in rows] == [r[1] + k for r, k in
                                        zip(want, shift)]
        assert _typed([r[2:] for r in rows]) == \
            _typed([r[2:] for r in want])


def test_record_ids_across_files(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(3):
        (d / f"f{i}.dat").write_bytes(
            gen.generate_exp1(7 + i, seed=10 + i).tobytes())
    _same(str(d), dict(EXP1, generate_record_id="true"))


# -- debug_ignore_file_size ---------------------------------------------------

@pytest.mark.parametrize("cut", [0, 700])
def test_debug_ignore_file_size(tmp_path, monkeypatch, cut):
    import cobrix_tpu_torch.api as api

    monkeypatch.setattr(api, "FIXED_READ_CHUNK_BYTES", 9 * 1493)
    data = gen.generate_exp1(40, seed=7).tobytes()
    path = _write(tmp_path, "e1.dat", data[:len(data) - cut])
    _same(path, dict(EXP1, debug_ignore_file_size="true"))
    _same(path, EXP1)  # the torn tail raises without the option


# -- segment_field on fixed-length records ------------------------------------

def test_fixed_length_segments(tmp_path):
    path = _write(tmp_path, "s.dat", pgen.generate_fixed_segments(300, 8))
    data = _same(path, SEGMENTS)
    assert len(data.results) == 1 and len(data.results[0].segments) == 2
    # a segment filter does not apply to the fixed-length reader
    _same(path, dict(SEGMENTS, segment_filter="C"))


def test_fixed_length_segments_with_record_ids_levels_and_filter(tmp_path):
    path = _write(tmp_path, "s.dat", pgen.generate_fixed_segments(300, 9))
    options = dict(SEGMENTS, generate_record_id="true",
                   segment_id_prefix="FX", segment_id_level0="C",
                   segment_id_level1="P")
    _same(path, options)
    _same(path, dict(options, segment_filter="P",
                     schema_retention_policy="collapse_root"))


def test_fixed_length_segments_with_record_offsets(tmp_path):
    rows = pgen.generate_fixed_segments(80, 10)
    padded = np.concatenate([np.full((80, 3), 0x40, dtype=np.uint8), rows,
                             np.zeros((80, 2), dtype=np.uint8)], axis=1)
    path = _write(tmp_path, "s.dat", padded)
    _same(path, dict(SEGMENTS, record_start_offset="3",
                     record_end_offset="2"))


# -- the input-file-name column -----------------------------------------------

def test_input_file_name_column(tmp_path):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(6, seed=11))
    # a plain fixed-length read refuses it, with the JAX package's message
    assert _same(path, dict(EXP1, with_input_file_name_col="F")) is None
    _same(path, dict(EXP1, with_input_file_name_col="F",
                     file_start_offset="0", file_end_offset="1493"))
    _same(path, dict(EXP1, with_input_file_name_col="F",
                     file_end_offset="1493", generate_record_id="true"))
    rdw = _write(tmp_path, "e2.dat", gen.generate_exp2(40, seed=12))
    _same(rdw, dict(copybook_contents=gen.EXP2_COPYBOOK,
                    is_record_sequence="true", segment_field="SEGMENT-ID",
                    segment_id_level0="C", segment_id_prefix="FN",
                    with_input_file_name_col="SRC"))
    _same(rdw, dict(copybook_contents=gen.EXP2_COPYBOOK,
                    is_record_sequence="true", generate_record_id="true",
                    with_input_file_name_col="SRC"))


# -- the data encoding -----------------------------------------------------------

def test_ascii_records(tmp_path):
    path = _write(tmp_path, "a.dat", pgen.generate_ascii(200, seed=13))
    data = _same(path, ASCII)
    assert len(data) == 200
    _same(path, dict(ASCII, schema_retention_policy="collapse_root",
                     string_trimming_policy="none"))
    _same(path, dict(ASCII, ascii_charset="cp1252"))


@pytest.mark.parametrize("encoding", ["ASCII", "ebcdic", "utf8"])
def test_encoding_values(tmp_path, encoding):
    path = _write(tmp_path, "a.dat", pgen.generate_ascii(5, seed=14))
    _same(path, dict(copybook_contents=pgen.ASCII_COPYBOOK,
                     encoding=encoding))


UTF16_COPYBOOK = """      01  R.
                03 NAME     PIC N(4).
                03 CODE     PIC X(2).
      """


@pytest.mark.parametrize("big_endian", ["true", "false"])
def test_utf16_byte_order(tmp_path, big_endian):
    text = "Éçàü" * 3
    rows = b"".join(
        (text[i:i + 4]).encode("utf-16-be" if big_endian == "true"
                               else "utf-16-le") + b"\xc1\xc2"
        for i in range(3))
    path = _write(tmp_path, "u.dat", rows)
    _same(path, dict(copybook_contents=UTF16_COPYBOOK,
                     is_utf16_big_endian=big_endian))


class ShiftedCodePage:
    """A custom code page: letters 64 places below their EBCDIC points
    (the reference's CustomCodePage test class)."""

    @property
    def table(self):
        t = [" "] * 256
        for start, chars in ((0x81, "ABCDEFGHI"), (0x91, "JKLMNOPQR"),
                             (0xA2, "STUVWXYZ"), (0xC1, "abcdefghi"),
                             (0xD1, "jklmnopqr"), (0xE2, "stuvwxyz"),
                             (0xF0, "0123456789")):
            for i, c in enumerate(chars):
                t[start + i] = c
        return "".join(t)


def test_ebcdic_code_page_class(tmp_path):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(8, seed=15))
    _same(path, dict(EXP1, ebcdic_code_page_class=(
        f"{__name__}.ShiftedCodePage"), string_trimming_policy="none"))


# -- copybook shaping ----------------------------------------------------------

FILLER_COPYBOOK = """      01  R.
                03 A        PIC X(2).
                03 FILLER   PIC X(1).
                03 FILLER.
                   05 B     PIC 9(2).
                   05 FILLER PIC X(1).
                03 G.
                   05 FILLER PIC X(2).
                03 C        PIC S9(3) COMP-3.
      """


@pytest.mark.parametrize("group,value", [("false", "true"), ("true", "true"),
                                         ("false", "false"),
                                         ("true", "false")])
def test_filler_dropping(tmp_path, group, value):
    rows = b"".join(b"\xc1\xc2\x40\xf1\xf2\x40\x40\x40\x12\x3c"
                    for _ in range(4))
    path = _write(tmp_path, "f.dat", rows)
    _same(path, dict(copybook_contents=FILLER_COPYBOOK,
                     drop_group_fillers=group, drop_value_fillers=value))


NT_COPYBOOK = """      01  R.
                03 NAME.
                   05 FIRST PIC X(3).
                   05 LAST  PIC X(3).
                03 ID.
                   05 NUM   PIC 9(4).
      """


@pytest.mark.parametrize("terms", ["NAME", "NAME,ID", "ID"])
def test_non_terminals(tmp_path, terms):
    path = _write(tmp_path, "n.dat", b"ABCDEF1234GHIJKL5678")
    _same(path, dict(copybook_contents=NT_COPYBOOK, encoding="ascii",
                     non_terminals=terms))


@pytest.mark.parametrize("debug", ["true", "hex", "raw", "false", "none",
                                   "binary"])
def test_debug_fields(tmp_path, debug):
    path = _write(tmp_path, "w.dat",
                  np.concatenate([gen.generate_exp1(4, seed=16)]))
    _same(path, dict(EXP1, debug=debug))


COMMENTED_COPYBOOK = (
    "000100 01  R.                                                     "
    "      SEQ00100\n"
    "000200     03 A        PIC X(2).                                  "
    "      SEQ00200\n"
    "000300     03 B        PIC 9(3).                                  "
    "      SEQ00300\n")


@pytest.mark.parametrize("opts", [
    {}, {"comments_lbound": "6", "comments_ubound": "72"},
    {"comments_lbound": "3", "comments_ubound": "72"},
    {"truncate_comments": "false"},
    {"truncate_comments": "false", "comments_lbound": "6"},
    {"truncate_comments": "false", "comments_ubound": "70"}])
def test_comment_bounds(tmp_path, opts):
    path = _write(tmp_path, "c.dat", b"AB123CD456")
    _same(path, dict(copybook_contents=COMMENTED_COPYBOOK, encoding="ascii",
                     **opts))


# -- options outside this slice -----------------------------------------------

@pytest.mark.parametrize("option,value", [
    ("collect_stats", "true"), ("filter", "A == 'x'"),
    ("use_stats", "true"), ("field_costs", "true"), ("trace_file", "t.json"),
    ("stream_batch_rows", "10"), ("hosts", "2"),
    ("speculative_quantile", "0.5")])
def test_options_outside_the_slice_still_raise(tmp_path, option, value):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(2, seed=17))
    if option == "filter":
        # taken since the filter slice: a filter on a field the copybook
        # lacks raises the JAX package's bind error, before any read
        with pytest.raises(ValueError, match="'A' is not found"):
            cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP1,
                                        **{option: value})
        return
    if option in ("field_costs", "trace_file"):
        # taken since the observability slice: the read equals the JAX
        # package's, and a trace file is written
        if option == "trace_file":
            value = str(tmp_path / value)
        _same(path, dict(EXP1, **{option: value}))
        if option == "trace_file":
            assert os.path.getsize(value) > 0
        return
    if option in ("collect_stats", "use_stats"):
        # taken since the statistics slice: without a cache_dir both
        # packages raise the same error naming the option; with one the
        # read equals the JAX package's (no filter: nothing is skipped)
        with pytest.raises(ValueError, match=option):
            cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP1,
                                        **{option: value})
        assert _same(path, dict(EXP1, **{option: value})) is None
        data = _same(path, dict(EXP1, cache_dir=str(tmp_path / "cache"),
                                **{option: value}))
        assert data.stats_profiles == (
            None if option == "use_stats"
            else {path: data.stats_profiles[path]})
        return
    with pytest.raises(ValueError, match=option):
        cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP1,
                                    **{option: value})


# -- parallelism, copybooks, pedantic and the locality options -----------------

HIER_SEG = {f"redefine_segment_id_map:{i}": f"{name} => {sid}"
            for i, (sid, name) in enumerate(
                pgen.HIERARCHICAL_SEGMENT_MAP.items())}
HIER_CHILDREN = {f"segment-children:{i}": f"{parent} => {child}"
                 for i, (child, parent) in enumerate(
                     pgen.HIERARCHICAL_PARENT_MAP.items())}


@pytest.mark.parametrize("parallelism", ["1", "2", "8"])
def test_parallelism_fixed_length(tmp_path, monkeypatch, parallelism):
    """exp1 in several chunks: `to_arrow` builds the parts' tables on
    that many threads, in part order."""
    import cobrix_tpu_torch.api as api

    monkeypatch.setattr(api, "FIXED_READ_CHUNK_BYTES", 9 * 1493)
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(50, seed=31))
    data = _same(path, dict(EXP1, parallelism=parallelism), pipelined=False)
    assert len(data.parts) == 6 and data.parallelism == int(parallelism)


@pytest.mark.parametrize("parallelism", ["1", "2", "8"])
def test_parallelism_rdw_indexed(tmp_path, parallelism):
    """exp2 in index shards: a clean file, and a permissive read of a
    faulted one, which the port reads again shard by shard, on that many
    threads."""
    from cobrix_tpu_torch.testing import faults

    rdw = dict(copybook_contents=gen.EXP2_COPYBOOK,
               is_record_sequence="true", segment_field="SEGMENT-ID",
               segment_id_prefix="PAR", generate_record_id="true",
               input_split_records="70", parallelism=parallelism,
               **{"redefine-segment-id-map:0": "STATIC-DETAILS => C",
                  "redefine-segment-id-map:1": "CONTACTS => P"})
    data = pgen.generate_exp2(400, seed=12)
    _same(_write(tmp_path, "e2.dat", data), rdw, pipelined=False)
    starts = faults.rdw_record_starts(data)
    bad = _write(tmp_path, "z.dat", faults.zero_rdw(data, starts[150]))
    _same(bad, dict(rdw, record_error_policy="permissive"),
          pipelined=False)


@pytest.mark.parametrize("parallelism", ["1", "2", "8"])
def test_parallelism_hierarchical(tmp_path, parallelism):
    """The 7-segment hierarchy in root-aligned index shards, read on
    that many threads."""
    path = _write(tmp_path, "h.dat", pgen.generate_hierarchical(40, seed=6))
    _same(path, dict(copybook_contents=pgen.HIERARCHICAL_COPYBOOK,
                     is_record_sequence="true", segment_field="SEGMENT-ID",
                     generate_record_id="true", input_split_records="37",
                     parallelism=parallelism, **HIER_SEG, **HIER_CHILDREN),
          pipelined=False)


def test_parallelism_must_be_a_number(tmp_path):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(2, seed=17))
    with pytest.raises(ValueError) as want:
        cobrix_tpu.read_cobol(path, backend="numpy", parallelism="many",
                              **EXP1)
    with pytest.raises(ValueError) as got:
        cobrix_tpu_torch.read_cobol(path, device="cpu", parallelism="many",
                                    **EXP1)
    assert str(got.value) == str(want.value)


COPYBOOK_A = """
       01 REC-A.
          05 A-ID    PIC X(2).
          05 A-NUM   PIC 9(3).
"""
COPYBOOK_B = """
       01 REC-B.
          05 B-TEXT  PIC X(5).
"""


def test_copybooks_with_two_files(tmp_path):
    a = tmp_path / "a.cpy"
    b = tmp_path / "b.cpy"
    a.write_text(COPYBOOK_A)
    b.write_text(COPYBOOK_B)
    path = _write(tmp_path, "c.dat", b"AB123HELLOCD456WORLD")
    _same(path, dict(copybooks=f"{a},{b}", encoding="ascii"))


@pytest.mark.parametrize("sources", [
    dict(copybook="a.cpy", copybook_contents=COPYBOOK_A),
    dict(copybooks="a.cpy", copybook_contents=COPYBOOK_A),
    dict(copybook="a.cpy", copybooks="a.cpy")],
    ids=["copybook_and_contents", "copybooks_and_contents",
         "copybook_and_copybooks"])
def test_copybook_sources_exclude_each_other(tmp_path, sources):
    (tmp_path / "a.cpy").write_text(COPYBOOK_A)
    path = _write(tmp_path, "c.dat", b"AB123")
    sources = {k: (str(tmp_path / v) if k != "copybook_contents" else v)
               for k, v in sources.items()}
    with pytest.raises(ValueError) as want:
        cobrix_tpu.read_cobol(path, backend="numpy", **sources)
    with pytest.raises(ValueError) as got:
        cobrix_tpu_torch.read_cobol(path, device="cpu", **sources)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra", [
    {"no_such_option": "1"},
    {"no_such_option": "1", "another_stray": "x"},
    {"segment_id_level0": "C"}],
    ids=["stray", "two_strays", "level_without_segment_field"])
def test_pedantic_names_unused_keys(tmp_path, extra):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(3, seed=2))
    _same(path, dict(EXP1, pedantic="true", **extra), pipelined=False)
    # without pedantic an unknown key is ignored, as in the JAX package
    _same(path, dict(EXP1, **extra), pipelined=False)


def test_pedantic_with_every_key_used(tmp_path):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(3, seed=2))
    _same(path, dict(EXP1, pedantic="true", parallelism="2",
                     improve_locality="false", optimize_allocation="true",
                     debug_ignore_file_size="false"), pipelined=False)


@pytest.mark.parametrize("locality", [
    {"improve_locality": "true"}, {"improve_locality": "false"},
    {"optimize_allocation": "true"},
    {"improve_locality": "false", "optimize_allocation": "false"}])
def test_locality_options_are_taken_and_dropped(tmp_path, locality):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(5, seed=4))
    _same(path, dict(EXP1, **locality))
