"""The generic per-record reader of the port against the JAX package, on
the CPU.

Records framed by a record-length field, text lines, the header parsers
by name, a custom header parser and a custom record extractor by dotted
path (one class written against each package's base class) and
variable-size OCCURS (the dynamic layouts through the host row walk) go
with the same bytes to ``cobrix_tpu.read_cobol``
(numpy backend, one thread) and to ``cobrix_tpu_torch.read_cobol(...,
device="cpu")``: sequential, through the sparse index
(``sparse_index_generator``) and pipelined, under every record error
policy. The rows, the JSON lines, the Arrow table and the ledger must be
equal, or both reads must raise the same error. Where the JAX package
has a fault (ROADMAP C6, C7, C8) the port is held to the JAX package's
read without the index instead.
"""
import json

import numpy as np
import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.reader.header_parsers import (
    RecordHeaderParser as JaxRecordHeaderParser,
    RecordMetadata as JaxRecordMetadata,
)
from cobrix_tpu.reader.raw_extractors import (
    RawRecordExtractor as JaxRawRecordExtractor,
)
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import custom_framing
from cobrix_tpu_torch.testing import faults
from cobrix_tpu_torch.testing import generators as gen

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

POLICIES = ["fail_fast", "permissive", "drop_malformed"]
SEGMENTS = {"segment_field": "SEGMENT-ID",
            "redefine-segment-id-map:0": "STATIC-DETAILS => C",
            "redefine-segment-id-map:1": "CONTACTS => P"}
PORT_CUSTOM = "cobrix_tpu_torch.testing.custom_framing"


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


class JaxCustomRdw5ByteParser(JaxRecordHeaderParser):
    """`custom_framing.CustomRdw5ByteParser` against the JAX package's
    base class."""

    additional_info = ""

    @property
    def header_length(self):
        return 5

    @property
    def is_header_defined_in_copybook(self):
        return False

    def get_record_metadata(self, header, file_offset, file_size,
                            record_num):
        if len(header) < 5:
            return JaxRecordMetadata(-1, False)
        length = header[3] + 256 * header[4]
        if length <= 0:
            raise ValueError(f"Custom RDW headers should never be zero "
                             f"at {file_offset}.")
        return JaxRecordMetadata(length, header[0] == 1)

    def on_receive_additional_info(self, additional_info):
        JaxCustomRdw5ByteParser.additional_info = additional_info


class JaxCustomRdw5ByteExtractor(JaxRawRecordExtractor):
    """`custom_framing.CustomRdw5ByteExtractor` against the JAX package's
    base class."""

    additional_info = ""

    def __init__(self, ctx):
        self.ctx = ctx
        JaxCustomRdw5ByteExtractor.additional_info = ctx.additional_info
        self._offset = ctx.input_stream.offset
        self._next = self._fetch()

    def _fetch(self):
        stream = self.ctx.input_stream
        while True:
            header = stream.next(5)
            if len(header) < 5:
                return None
            payload = stream.next(header[3] + 256 * header[4])
            if header[0] == 1:
                return payload, stream.offset

    @property
    def offset(self):
        return self._offset

    def has_next(self):
        return self._next is not None

    def __next__(self):
        if self._next is None:
            raise StopIteration
        (record, self._offset), self._next = self._next, self._fetch()
        return record


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _outcome(read):
    try:
        data = read()
        table = data.to_arrow()
        return ("ok", data.to_rows(), data.to_json_lines(), table,
                data.diagnostics.as_dict() if data.diagnostics else None)
    except Exception as exc:
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "offset", None))


def _same(path, options, pipelined=False, jax_options=None):
    """The port's read (and its pipelined read) equals the JAX package's
    read of `jax_options` (the same options by default), or raises its
    error; returns the port's outcome. `{custom}` in an option value
    names each package's own module of custom classes."""
    def fmt(opts, module):
        return {k: v.replace("{custom}", module) for k, v in opts.items()}

    want = _outcome(lambda: cobrix_tpu.read_cobol(
        path, backend="numpy", parallelism="1",
        **fmt(jax_options or options, __name__)))
    reads = [{}] + ([dict(pipeline_workers="3")] if pipelined else [])
    got = None
    for extra in reads:
        got = _outcome(lambda: cobrix_tpu_torch.read_cobol(
            path, device="cpu", **fmt(options, PORT_CUSTOM), **extra))
        assert got[0] == want[0], (got[:3], want[:3])
        if want[0] == "error":
            assert got[1:] == want[1:]
            continue
        _, rows, lines, table, ledger = got
        assert rows == want[1]
        assert lines == want[2]
        assert table.schema.equals(want[3].schema, check_metadata=True)
        assert table.equals(want[3])
        assert ledger == want[4]
    return got


# -- a record-length field ----------------------------------------------------

LENGTH_FIELD_COPYBOOK = """
       01  REC.
           05  REC-LEN     PIC 9(3).
           05  PAYLOAD     PIC X(10).
"""


def _length_field_records(n, seed=0):
    """The 13-byte REC-LEN records of ``test_pipeline_parity.py``, with
    some shorter and longer than the copybook."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for _ in range(n):
        size = int(rng.choice([13, 13, 13, 9, 17]))
        payload = bytes(0xC1 + int(b) for b in rng.integers(0, 9, size - 3))
        out += bytes(0xF0 + int(d) for d in str(size).zfill(3)) + payload
    return bytes(out)


@pytest.mark.parametrize("split", [None, "7"], ids=["whole", "indexed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_length_field(tmp_path, policy, split):
    path = _write(tmp_path, "lf.dat", _length_field_records(120, seed=1))
    options = dict(copybook_contents=LENGTH_FIELD_COPYBOOK,
                   record_length_field="REC-LEN", generate_record_id="true",
                   record_error_policy=policy)
    # the JAX package's split read is not a reference here (ROADMAP C7:
    # its index splits every 13 bytes, inside the 9- and 17-byte
    # records): the port's split reads equal its read without the index
    _same(path, dict(options, input_split_records=split) if split
          else options, pipelined=bool(split), jax_options=options)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("corruption", ["letters", "zero", "tail"])
def test_length_field_resync(tmp_path, policy, corruption):
    """Unreadable, non-positive and torn length fields: fail_fast raises
    the JAX package's FramingError, the permissive policies resync on
    the stream plane and ledger what they skipped or cut."""
    data = bytearray(_length_field_records(150, seed=2))
    if corruption == "letters":
        data[13 * 40:13 * 40 + 3] = b"\xc1\xc2\xc3"
    elif corruption == "zero":
        data[13 * 60:13 * 60 + 3] = b"\xf0\xf0\xf0"
    else:
        data = data[:-4]
    options = dict(copybook_contents=LENGTH_FIELD_COPYBOOK,
                   record_length_field="REC-LEN", record_error_policy=policy)
    if policy != "fail_fast":
        options["corrupt_record_column"] = "_corrupt"
    _same(_write(tmp_path, "lf.dat", data), options)


EXP3_LENGTH = dict(copybook_contents=gen.LENGTH_FIELD_EXP3_COPYBOOK,
                   record_length_field="RECORD-LENGTH", rdw_adjustment="4",
                   **SEGMENTS)


@pytest.mark.parametrize("policy", POLICIES)
def test_exp3_with_its_rdw_as_a_length_field(tmp_path, policy):
    """Big-endian exp3 records read through `RECORD-LENGTH PIC 9(4)
    COMP`: the 16,064-byte strategy table at full width, clean and with
    three length fields broken."""
    data = bytearray(gen.generate_exp3(150, seed=3, big_endian_rdw=True))
    starts = faults.rdw_record_starts(bytes(data), big_endian=True)
    if policy != "fail_fast":
        for k in (20, 70, 120):
            data[starts[k]:starts[k] + 2] = b"\x00\x00"
    _same(_write(tmp_path, "e3.dat", data),
          dict(EXP3_LENGTH, record_error_policy=policy,
               generate_record_id="true"))


@pytest.mark.parametrize("split", ["10", "17"])
def test_length_field_index_frames_records(tmp_path, split):
    """ROADMAP C7: the JAX package indexes a length-field file with the
    fixed-length header parser, so its splits land every copybook size
    of bytes, inside records, and the rows after them are lost. The
    port's index takes the records the length field frames: its split
    read, sequential and pipelined, equals the JAX package's read
    without the index; the JAX package's split read has fewer rows."""
    path = _write(tmp_path, "e3.dat",
                  gen.generate_exp3(60, seed=3, big_endian_rdw=True))
    options = dict(EXP3_LENGTH, generate_record_id="true",
                   input_split_records=split)
    got = _same(path, options, pipelined=True,
                jax_options=dict(EXP3_LENGTH, generate_record_id="true"))
    jax_split = cobrix_tpu.read_cobol(path, backend="numpy",
                                      parallelism="1", **options)
    assert len(jax_split) < len(got[1]) == 60


# -- text ----------------------------------------------------------------------

TEXT = dict(copybook_contents=gen.TEXT_COPYBOOK, is_text="true",
            encoding="ascii")


@pytest.mark.parametrize("split", [None, "13"], ids=["whole", "indexed"])
@pytest.mark.parametrize("endings", ["lf", "crlf", "mixed"])
def test_text_lines(tmp_path, endings, split):
    data = gen.generate_text(80, seed=5)
    if endings == "lf":
        data = data.replace(b"\r\n", b"\n")
    elif endings == "crlf":
        data = data.replace(b"\r\n", b"\n").replace(b"\n", b"\r\n")
    options = dict(TEXT)
    if split:
        options["input_split_records"] = split
    _same(_write(tmp_path, "t.txt", data), options, pipelined=bool(split))


@pytest.mark.parametrize("case", ["long_lines", "no_final_newline",
                                  "blank_lines", "lone_cr"])
def test_text_edges(tmp_path, case):
    lines = gen.generate_text(30, seed=6).split(b"\n")
    if case == "long_lines":
        lines[3] = lines[3] * 3
        lines[10] = b"A" * 200
    elif case == "blank_lines":
        lines[5:5] = [b"", b"\r"]
    elif case == "lone_cr":
        lines[7] = lines[7].replace(b"0", b"\r", 1)
    data = b"\n".join(lines)
    if case == "no_final_newline":
        data = data.rstrip(b"\n")
    _same(_write(tmp_path, "t.txt", data), dict(TEXT))


# -- header parsers and extractors ----------------------------------------------

@pytest.mark.parametrize("split", [None, "20"], ids=["whole", "indexed"])
@pytest.mark.parametrize("name,big_endian", [
    ("rdw", False), ("rdw_little_endian", False), ("rdw_big_endian", True)])
def test_rdw_header_parsers_by_name(tmp_path, name, big_endian, split):
    data = gen.generate_exp2(150, seed=7, big_endian_rdw=big_endian)
    options = dict(copybook_contents=gen.EXP2_COPYBOOK,
                   is_record_sequence="true", record_header_parser=name,
                   generate_record_id="true", **SEGMENTS)
    if split:
        options["input_split_records"] = split
    _same(_write(tmp_path, "r.dat", data), options, pipelined=bool(split))


@pytest.mark.parametrize("footer", [0, 7])
def test_fixed_length_header_parser(tmp_path, footer):
    data = gen.generate_exp1(30, seed=8).tobytes() + b"\x01" * footer
    options = dict(copybook_contents=gen.EXP1_COPYBOOK,
                   is_record_sequence="true",
                   record_header_parser="fixed_length",
                   generate_record_id="true")
    if footer:
        options["file_end_offset"] = str(footer)
    _same(_write(tmp_path, "f.dat", data), options)


def test_fixed_length_header_parser_in_shards(tmp_path):
    """ROADMAP C6: the JAX package's generic reader never ends on fixed-
    length records in an index shard; the port's ends at the shard's
    end, and its split reads equal the JAX package's read without the
    index, Record_Id aside (the index counts no file header here, so
    the ids are the same too)."""
    path = _write(tmp_path, "f.dat", gen.generate_exp1(30, seed=8))
    options = dict(copybook_contents=gen.EXP1_COPYBOOK,
                   is_record_sequence="true",
                   record_header_parser="fixed_length",
                   generate_record_id="true")
    _same(path, dict(options, input_split_records="7"), pipelined=True,
          jax_options=options)


@pytest.mark.parametrize("split", [None, "25"], ids=["whole", "indexed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_custom_header_parser(tmp_path, policy, split):
    data = gen.generate_custom_rdw(200, seed=9)
    options = dict(copybook_contents=gen.CUSTOM_RDW_COPYBOOK,
                   is_record_sequence="true",
                   record_header_parser="{custom}.CustomRdw5ByteParser",
                   rhp_additional_info="info for the parser",
                   generate_record_id="true", record_error_policy=policy,
                   **SEGMENTS)
    options_jax = dict(options, record_header_parser=(
        "{custom}.JaxCustomRdw5ByteParser"))
    if split:
        options["input_split_records"] = options_jax[
            "input_split_records"] = split
    _same(_write(tmp_path, "c.dat", data), options, pipelined=bool(split),
          jax_options=options_jax)
    assert custom_framing.CustomRdw5ByteParser.additional_info \
        == "info for the parser"


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
def test_custom_header_parser_resync(tmp_path, policy):
    """A zero length makes the custom parser raise; the permissive
    policies resync with the generic chain validator."""
    data = bytearray(gen.generate_custom_rdw(200, seed=10))
    data[500:505] = b"\x01\x00\x00\x00\x00"
    options = dict(copybook_contents=gen.CUSTOM_RDW_COPYBOOK,
                   is_record_sequence="true",
                   record_header_parser="{custom}.CustomRdw5ByteParser",
                   record_error_policy=policy, **SEGMENTS)
    _same(_write(tmp_path, "c.dat", data), options,
          jax_options=dict(options, record_header_parser=(
              "{custom}.JaxCustomRdw5ByteParser")))


@pytest.mark.parametrize("split", [None, "30"], ids=["whole", "indexed"])
def test_custom_record_extractor(tmp_path, split):
    data = gen.generate_custom_rdw(200, seed=11)
    options = dict(copybook_contents=gen.CUSTOM_RDW_COPYBOOK,
                   record_extractor="{custom}.CustomRdw5ByteExtractor",
                   re_additional_info="info for the extractor",
                   generate_record_id="true",
                   with_input_file_name_col="SRC", **SEGMENTS)
    options_jax = dict(options, record_extractor=(
        "{custom}.JaxCustomRdw5ByteExtractor"))
    if split:
        options["input_split_records"] = options_jax[
            "input_split_records"] = split
    _same(_write(tmp_path, "c.dat", data), options, pipelined=bool(split),
          jax_options=options_jax)
    assert custom_framing.CustomRdw5ByteExtractor.additional_info \
        == "info for the extractor"


@pytest.mark.parametrize("name", [
    "no_dots", "cobrix_tpu_torch.testing.nothing.Parser",
    "cobrix_tpu_torch.testing.custom_framing.Missing",
    "tests.test_torch_generic.JaxCustomRdw5ByteParser"])
def test_custom_header_parser_errors(tmp_path, name):
    """Unknown names, missing modules and classes, and a class written
    against the JAX package's base class are refused."""
    path = _write(tmp_path, "c.dat", gen.generate_custom_rdw(10, seed=1))
    with pytest.raises((ValueError, TypeError, ImportError)) as got:
        cobrix_tpu_torch.read_cobol(
            path, device="cpu", copybook_contents=gen.CUSTOM_RDW_COPYBOOK,
            is_record_sequence="true", record_header_parser=name)
    if name.startswith("tests."):
        assert got.type is TypeError or "could not be imported" in str(
            got.value)


# -- variable-size OCCURS --------------------------------------------------------

@pytest.mark.parametrize("split", [None, "9"], ids=["whole", "indexed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_variable_size_occurs(tmp_path, policy, split):
    """A trailing DEPENDING ON table: every record as long as its count
    says, framed by the variable-size OCCURS extractor and decoded on the
    static plan, the elements past the count null."""
    data = gen.generate_var_occurs(40, seed=12, max_count=25)
    options = dict(copybook_contents=gen.VAR_OCCURS_COPYBOOK,
                   variable_size_occurs="true", generate_record_id="true",
                   record_error_policy=policy)
    if split:
        options["input_split_records"] = split
    _same(_write(tmp_path, "v.dat", data), options, pipelined=bool(split))


MAPPED_OCCURS_COPYBOOK = """
       01  REC.
           05  KIND        PIC X(1).
           05  ITEMS       OCCURS 0 TO 3 TIMES DEPENDING ON KIND.
              10  ITEM     PIC X(2).
"""


@pytest.mark.parametrize("spelling", ["occurs_mappings", "occurs_mapping"])
def test_variable_size_occurs_with_occurs_mappings(tmp_path, spelling):
    data = b"".join(kind + b"AB" * count for kind, count in
                    [(b"A", 1), (b"C", 3), (b"B", 2), (b"A", 1), (b"C", 3)])
    options = dict(copybook_contents=MAPPED_OCCURS_COPYBOOK,
                   encoding="ascii", variable_size_occurs="true",
                   **{spelling: json.dumps({"ITEMS": {"A": 1, "B": 2,
                                                      "C": 3}})})
    got = _same(_write(tmp_path, "m.dat", data), options)
    assert len(got[1]) == 5


def test_variable_size_occurs_over_rdw(tmp_path):
    """With RDW headers the records are framed by their headers (no
    extractor), still on the generic reader."""
    body = gen.generate_var_occurs(20, seed=13, max_count=9)
    counts, pos, records = [], 0, []
    while pos < len(body):
        n = int.from_bytes(body[pos + 59:pos + 61], "big")
        size = gen.VAR_OCCURS_HEAD + 8 * n
        records.append(body[pos:pos + size])
        pos += size
    data = b"".join(b"\x00\x00" + len(r).to_bytes(2, "little") + r
                    for r in records)
    _same(_write(tmp_path, "vr.dat", data),
          dict(copybook_contents=gen.VAR_OCCURS_COPYBOOK,
               is_record_sequence="true", variable_size_occurs="true"))


DYNAMIC_OCCURS_COPYBOOK = """
       01  REC.
           05  CNT         PIC 9(1).
           05  ITEMS       OCCURS 0 TO 3 TIMES DEPENDING ON CNT.
              10  ITEM     PIC X(2).
           05  TRAILER     PIC X(3).
"""


def test_dynamic_occurs_layout_is_refused(tmp_path):
    """A DEPENDING ON table followed by another field shifts that field
    per record; the JAX package decodes such records on the host, row by
    row. The port, which refused them until it had that row walk, now
    reads them the same: the same rows, table and JSON lines."""
    path = _write(tmp_path, "d.dat", b"2AABBXYZ0QRS")
    options = dict(copybook_contents=DYNAMIC_OCCURS_COPYBOOK,
                   encoding="ascii", variable_size_occurs="true")
    got = _same(path, options)
    assert [row[0][2] for row in got[1]] == ["XYZ", "QRS"]


NESTED_OCCURS_COPYBOOK = """
       01  REC.
           05  CNT         PIC 9(1).
           05  GROUPS      OCCURS 0 TO 2 TIMES DEPENDING ON CNT.
              10  INNER    PIC 9(1).
              10  ITEMS    OCCURS 0 TO 3 TIMES DEPENDING ON INNER.
                 15  ITEM  PIC X(1).
"""


@pytest.mark.parametrize("split", [None, "2"], ids=["whole", "indexed"])
@pytest.mark.parametrize("layout", ["trailer", "nested"])
def test_dynamic_occurs_layouts(tmp_path, layout, split):
    """The row walk of the dynamic layouts: a table followed by a
    trailer, and a DEPENDING ON table nested in another; whole, split
    and pipelined."""
    if layout == "trailer":
        data = b"2AABBXYZ0QRS1CCTUV3DDEEFFWWW"
        copybook = DYNAMIC_OCCURS_COPYBOOK
    else:
        # counts 0; 1 of 2 items; 2 of (2, 0) items; 1 of 3 items
        data = b"0" + b"12AB" + b"22BC0" + b"13DEF"
        copybook = NESTED_OCCURS_COPYBOOK
    options = dict(copybook_contents=copybook, encoding="ascii",
                   variable_size_occurs="true", generate_record_id="true")
    if split:
        options["input_split_records"] = split
    got = _same(_write(tmp_path, "dl.dat", data), options,
                pipelined=bool(split))
    assert len(got[1]) == 4


# -- a shard of text that starts on an over-long line (ROADMAP C8) -------------

@pytest.mark.parametrize("workers", ["0", "2"], ids=["sequential",
                                                     "pipelined"])
@pytest.mark.parametrize("split", ["20", "10"])
@pytest.mark.parametrize("endings", ["crlf", "lf"])
def test_split_text_starts_after_the_previous_line_end(tmp_path, endings,
                                                       split, workers):
    """Line 20 is 15 bytes longer than a record, and a shard starts at
    it: the shard cuts it where the whole-file read does, after a CRLF
    line as after an LF one. The JAX package's split read cuts it a byte
    later after CRLF, so the port is held to its read without the
    index."""
    lines = gen.generate_text(40, seed=5).split(b"\n")
    if endings == "lf":
        lines = [line.rstrip(b"\r") for line in lines]
    line = lines[20]
    end = b"\r" if line.endswith(b"\r") else b""
    lines[20] = line[:len(line) - len(end)] + b"X" * 15 + end
    assert lines[19].endswith(b"\r") == (endings == "crlf")
    path = _write(tmp_path, "t.txt", b"\n".join(lines))
    options = dict(copybook_contents=gen.TEXT_COPYBOOK, is_text="true",
                   encoding="ascii")
    whole = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                  enable_indexes="false", **options)
    got = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                      input_split_records=split,
                                      pipeline_workers=workers, **options)
    assert got.to_rows() == whole.to_rows()
    assert got.to_arrow().equals(whole.to_arrow())


# -- the incremental indexer -----------------------------------------------------

@pytest.mark.parametrize("per,mb", [(7, None), (None, 1)])
def test_incremental_indexer_equals_the_generator(per, mb):
    from cobrix_tpu.reader.index import IncrementalIndexer as JaxIndexer
    from cobrix_tpu_torch.reader.header_parsers import RdwHeaderParser
    from cobrix_tpu_torch.reader.index import (IncrementalIndexer,
                                               sparse_index_generator)
    from cobrix_tpu_torch.reader.stream import MemoryStream

    data = gen.generate_exp3(80, seed=14)
    starts = faults.rdw_record_starts(data) + [len(data)]
    indexer, jax_indexer = IncrementalIndexer(per, mb), JaxIndexer(per, mb)
    for a, b in zip(starts, starts[1:]):
        indexer.add_record(b - a)
        jax_indexer.add_record(b - a)
    want = sparse_index_generator(
        0, MemoryStream(data), record_header_parser=RdwHeaderParser(),
        records_per_index_entry=per, size_per_index_entry_mb=mb)
    assert indexer.entries(0) == want
    assert [tuple(vars(e).values()) for e in jax_indexer.entries(0)] \
        == [tuple(vars(e).values()) for e in want]
    again = IncrementalIndexer.from_state(indexer.state_dict())
    assert again.entries(0) == want
