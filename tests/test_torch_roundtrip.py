"""The write half of the port (``cobrix_tpu_torch.encode``,
``testing.genspec``, ``testing.rtcheck``, ``CobolData.to_ebcdic``) on
the CPU, against the JAX package.

The first part is ``tests/test_roundtrip.py`` run through the port
(``device="cpu"``): encode→decode is value-identical over the canonical
domain (P1), decode→encode reproduces the file byte for byte (P2), raw
alias bytes reach a fixed point in one round (P3), over the named
grammar surface — fixed/RDW framing × DISPLAY/COMP/COMP-3/float × every
sign flavor × four code pages × OCCURS and DEPENDING ON — plus the
permissive corrupt-record loop; the random sweep runs under the `slow`
marker, as there.

The second part holds the port to the JAX package (``backend="numpy"``,
one thread) on the same seeds and bytes: `genspec` specs, options and
bodies, `encode_file` bytes, `encode_field` bytes or error messages
over a grid of every dtype kind, sign flavour, code page and
floating-point format, `BatchEncoder` matrices, and `to_ebcdic` bytes
of one file read by both packages, generated columns and all.
"""
import random
from decimal import Decimal

import numpy as np
import pytest

import cobrix_tpu
from cobrix_tpu import encode as jenc
from cobrix_tpu.copybook import copybook as jcb
from cobrix_tpu.copybook import datatypes as jdt
from cobrix_tpu.testing import genspec as jgenspec
from cobrix_tpu_torch import read_cobol
from cobrix_tpu_torch.copybook import copybook as tcb
from cobrix_tpu_torch.copybook import datatypes as tdt
from cobrix_tpu_torch.encode import (
    BatchEncoder,
    EncodeError,
    RecordEncoder,
    encode_field,
    encode_file,
)
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import corpus, rtcheck
from cobrix_tpu_torch.testing import genspec as tgenspec
from cobrix_tpu_torch.testing.genspec import safe_alphabet

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

CPU = {"device": "cpu"}


def _roundtrip(tmp_path, copybook, bodies, framing="fixed",
               encode_kw=None, read_kw=None, reencode_kw=None):
    """Assert P1 (value identity) and P2 (byte stability) through the
    port; return rows."""
    data = encode_file(copybook, bodies, framing=framing,
                       **(encode_kw or {}))
    path = str(tmp_path / "rt.dat")
    with open(path, "wb") as f:
        f.write(data)
    kw = dict(copybook_contents=copybook, **CPU)
    if framing == "rdw":
        kw["is_record_sequence"] = "true"
    kw.update(read_kw or {})
    out = read_cobol(path, **kw)
    rows = out.to_rows()
    assert [list(r) for r in rows] == [list(b) for b in bodies]
    assert out.to_ebcdic(framing=framing, **(reencode_kw or {})) == data
    return rows


SCALAR_COPYBOOK = """
       01  REC.
           05  NUM-DISP     PIC S9(5)V99.
           05  NUM-BIN      PIC S9(8)  COMP.
           05  NUM-BIN-LE   PIC 9(4)   COMP-9.
           05  NUM-BCD      PIC S9(7)V9(2) COMP-3.
           05  NUM-BCD-WIDE PIC S9(21) COMP-3.
           05  FLT-SINGLE   COMP-1.
           05  FLT-DOUBLE   COMP-2.
           05  NAME         PIC X(8).
"""

SCALAR_BODIES = [
    [(Decimal("-123.45"), -12345678, 9999, Decimal("98765.43"),
      -10 ** 20 - 7, 2.5, -1234.0625, "Ab.9-Z")],
    [(Decimal("0.00"), 0, 0, Decimal("0.00"), 0, 0.0, 0.0, "")],
    # None is canonical everywhere blank fill can express it — including
    # the implied-point DISPLAY decimal (blank decodes to null, not 0.00)
    [(None, 1, 1, None, None, 1.5, -0.25, "x")],
    [(Decimal("-0.07"), 2, 2, Decimal("0.01"), 5, 0.5, 2.0, "y")],
]


@pytest.mark.parametrize("framing", ["fixed", "rdw"])
@pytest.mark.parametrize("code_page",
                         ["common", "cp037", "cp500", "cp1047"])
def test_scalar_matrix(tmp_path, framing, code_page):
    """DISPLAY/COMP/COMP-9/COMP-3 (narrow + wide)/COMP-1/COMP-2/X
    across framings and code pages."""
    _roundtrip(
        tmp_path, SCALAR_COPYBOOK, SCALAR_BODIES, framing,
        encode_kw=dict(ebcdic_code_page=code_page,
                       floating_point_format=tdt.FloatingPointFormat
                       .IEEE754),
        read_kw=dict(ebcdic_code_page=code_page,
                     floating_point_format="ieee754"))


SIGN_COPYBOOK = """
       01  REC.
           05  TRAIL-OVER   PIC S9(4).
           05  LEAD-OVER    PIC S9(4) SIGN IS LEADING.
           05  LEAD-SEP     PIC S9(4) SIGN IS LEADING SEPARATE.
           05  TRAIL-SEP    PIC S9(4) SIGN IS TRAILING SEPARATE.
           05  EXPL-DOT     PIC S9(3).9(2).
           05  UNSIGNED     PIC 9(4).
"""

SIGN_BODIES = [
    [(-42, -42, -42, -42, Decimal("-1.25"), 42)],
    [(42, 42, 42, 42, Decimal("1.25"), 0)],
    [(0, 0, 0, 0, None, 9999)],
]


@pytest.mark.parametrize("framing", ["fixed", "rdw"])
def test_sign_variants(tmp_path, framing):
    _roundtrip(tmp_path, SIGN_COPYBOOK, SIGN_BODIES, framing)


OCCURS_COPYBOOK = """
       01  REC.
           05  ID      PIC 9(4) COMP.
           05  POINTS  PIC S9(3)V9 COMP-3 OCCURS 3 TIMES.
           05  PAIR    OCCURS 2 TIMES.
              10  TAG   PIC X(3).
              10  VAL   PIC 9(2).
"""

OCCURS_BODIES = [
    [(1, [Decimal("1.5"), Decimal("-2.5"), Decimal("0.0")],
      [("abc", 1), ("de", 22)])],
    [(2, [None, Decimal("99.9"), None], [("", 0), ("zz", 7)])],
]


def test_static_occurs(tmp_path):
    _roundtrip(tmp_path, OCCURS_COPYBOOK, OCCURS_BODIES)


ODO_COPYBOOK = """
       01  REC.
           05  ID      PIC 9(4) COMP.
           05  CNT     PIC 9(2).
           05  ITEM    PIC S9(5) COMP-3 OCCURS 0 TO 4 TIMES
               DEPENDING ON CNT.
           05  TAIL    PIC X(4).
"""

ODO_BODIES = [
    [(1, 3, [11, -22, 33], "aaaa")],
    [(2, 0, [], "bb")],
    [(3, 4, [1, 2, 3, 4], "")],
]


def test_depending_on_variable_records(tmp_path):
    _roundtrip(
        tmp_path, ODO_COPYBOOK, ODO_BODIES, "rdw",
        encode_kw=dict(variable_size_occurs=True),
        read_kw=dict(variable_size_occurs="true"),
        reencode_kw=dict(variable_size_occurs=True))


MULTISEG_BODIES = [
    [("C", "C000000001", ("Acme Ltd.", 12345678), None)],
    [("P", "C000000001", None, ("+0123456789", "Jane Roe"))],
    [("P", "C000000001", None, ("+0987654321", "Sam Poe"))],
    [("C", "C000000002", ("Globex", 999), None)],
]


def test_multiseg_redefines(tmp_path):
    """Segment-gated redefines: inactive branches are None both ways."""
    data = encode_file(
        corpus.MULTISEG_COPYBOOK, MULTISEG_BODIES, framing="rdw",
        segment_redefines=["STATIC-DETAILS", "CONTACTS"])
    path = str(tmp_path / "seg.dat")
    with open(path, "wb") as f:
        f.write(data)
    out = read_cobol(path, **corpus.multiseg_read_options(), **CPU)
    rows = out.to_rows()
    assert [list(r) for r in rows] == [list(b) for b in MULTISEG_BODIES]
    assert out.to_ebcdic(framing="rdw") == data


def test_permissive_corrupt_record_roundtrip(tmp_path):
    """Encoder-aware damage + permissive policy: the damaged field
    decodes to None, and decode→encode→decode is stable (the re-encoded
    file decodes to the same rows — corrupt nibbles normalize to blank
    fill, which still decodes to None)."""
    path = str(tmp_path / "txn.dat")
    corpus.write_fixed_corpus(path, 300, seed=5)
    data = open(path, "rb").read()
    bad, sites = corpus.corrupt_fixed_corpus(
        data, count=2, seed=9, kinds=("sign-nibble", "packed-digit"))
    with open(path, "wb") as f:
        f.write(bad)
    out = read_cobol(path, **corpus.fixed_read_options(),
                     record_error_policy="permissive", **CPU)
    rows = out.to_rows()
    for site in sites:
        assert rows[site["record"]][0][3] is None, site
    re_encoded = out.to_ebcdic(framing="fixed")
    path2 = str(tmp_path / "txn2.dat")
    with open(path2, "wb") as f:
        f.write(re_encoded)
    rows2 = read_cobol(path2, **corpus.fixed_read_options(),
                       record_error_policy="permissive", **CPU).to_rows()
    assert rows2 == rows


TXN_BODIES = [
    [(7, "ACC0000001", "USD", Decimal("-12345.67"),
      Decimal("999.99"), "A", 42)],
    [(8, "", "EUR", Decimal("0.00"), Decimal("-0.01"), "D", 0)],
]
TXN_COLUMNS = [
    [7, 8], ["ACC0000001", ""], ["USD", "EUR"],
    [-1234567, 0], [99999, -1], ["A", "D"], [42, 0],
]


def test_batch_encoder_matches_record_encoder():
    """The vectorized column path and the record-at-a-time walker must
    emit identical bytes for a static layout."""
    enc = RecordEncoder(corpus.TXN_COPYBOOK)
    batch = BatchEncoder(corpus.TXN_COPYBOOK)
    record_bytes = b"".join(enc.encode_record(b) for b in TXN_BODIES)
    assert batch.encode_fixed(TXN_COLUMNS, 2) == record_bytes


def test_encoder_refuses_out_of_domain():
    cb = tcb.parse_copybook("""
       01  REC.
           05  N  PIC 9(2).
           05  S  PIC X(2).
    """)
    fields = {st.name: st.dtype for st in cb.ast.walk_primitives()}
    n = fields["N"]
    s = fields["S"]
    with pytest.raises(EncodeError):
        encode_field(n, 100)   # 3 digits into PIC 9(2)
    with pytest.raises(EncodeError):
        encode_field(n, -1)    # negative into unsigned
    with pytest.raises(EncodeError):
        encode_field(s, "abc")  # 3 chars into X(2)


def test_safe_alphabet_round_trips_per_code_page():
    from cobrix_tpu_torch.encoding.codepages import (
        get_code_page_encode_table,
        get_code_page_table,
    )

    for cp in ("common", "cp037", "cp500", "cp1047"):
        table = get_code_page_table(cp)
        enc = get_code_page_encode_table(cp)
        for ch in safe_alphabet(cp):
            assert table[enc[ch]] == ch


def test_cp500_matches_stdlib_codec():
    """The cp500 table's printable region must agree with Python's own
    cp500 codec position by position (the control region follows the
    convention the cp037 tables established instead)."""
    from cobrix_tpu_torch.encoding.codepages import get_code_page_table

    table = get_code_page_table("cp500_extended")
    ours_037 = get_code_page_table("cp037_extended")
    for byte in range(0x40, 0x100):
        want = bytes([byte]).decode("cp500")
        # positions the cp037 table already diverges from stdlib cp037
        # on (deliberate reference-compat choices) carry over
        if ours_037[byte] == bytes([byte]).decode("cp037"):
            assert table[byte] == want, (hex(byte), table[byte], want)


def test_cp1047_bracket_rotation():
    """cp1047's signature cells (the z/OS Open Systems bracket layout)
    sit where IBM-1047 puts them, and everything else matches cp037."""
    from cobrix_tpu_torch.encoding.codepages import get_code_page_table

    t1047 = get_code_page_table("cp1047_extended")
    t037 = get_code_page_table("cp037_extended")
    rotated = {0x5F: "^", 0xAD: "[", 0xB0: "\xac", 0xBA: "\xdd",
               0xBB: "\xa8", 0xBD: "]"}
    for byte in range(256):
        want = rotated.get(byte, t037[byte])
        assert t1047[byte] == want, (hex(byte), t1047[byte], want)


def test_duplicate_glyph_encode_is_lowest_byte_wins():
    """Every glyph that several EBCDIC bytes decode to must encode to
    the LOWEST of those bytes on every builtin page — the deterministic
    inversion that makes decode→encode→decode byte-stable once the
    aliases canonicalize (rtcheck P3 covers the end-to-end surface)."""
    from cobrix_tpu_torch.encoding.codepages import (
        get_code_page_encode_table,
        get_code_page_table,
    )

    for cp in rtcheck.ALIAS_CODE_PAGES:
        table = get_code_page_table(cp)
        enc = get_code_page_encode_table(cp)
        first_byte = {}
        duplicated = set()
        for byte in range(256):
            ch = table[byte]
            if ch in first_byte:
                duplicated.add(ch)
            else:
                first_byte[ch] = byte
        assert duplicated, cp  # every builtin page carries alias glyphs
        for ch in duplicated:
            want = 0x40 if ch == " " else first_byte[ch]
            assert enc[ch] == want, (cp, ch, hex(enc[ch]))


def test_rtcheck_alias_matrix():
    """P3: raw alias bytes canonicalize in one decode→encode round on
    every builtin code page."""
    assert rtcheck.run_alias_matrix(seeds=(0,), device="cpu") == 0


def test_rtcheck_quick_harness():
    """The deterministic rtcheck matrix stays green on the plain
    versions (--sweep runs under the slow marker)."""
    assert rtcheck.run_quick(device="cpu") == 0


@pytest.mark.slow
def test_rtcheck_sweep():
    """≥100 random copybooks; failures would print shrunk repros."""
    assert rtcheck.run_sweep(120, base_seed=5000, device="cpu") == 0


def test_rtcheck_main_exits_zero(capsys):
    """`python -m cobrix_tpu_torch.testing.rtcheck --device cpu`."""
    assert rtcheck.main(["--device", "cpu"]) == 0
    assert "round-trip properties hold" in capsys.readouterr().out


# -- parity with the JAX package ------------------------------------------


def _options_view(opts):
    """encode/read options with the packages' enums by name."""
    return {k: (v.name if isinstance(v, (jdt.FloatingPointFormat,
                                         tdt.FloatingPointFormat)) else v)
            for k, v in opts.items()}


@pytest.mark.parametrize("seed", range(12))
def test_genspec_and_encode_file_match_jax(seed):
    """The quick matrix's draws: the same copybook text, options and
    bodies from one seed in both packages, and the same bytes from
    both packages' `encode_file` under both framings."""
    code_page = rtcheck.FUZZ_CODE_PAGES[seed % len(rtcheck.FUZZ_CODE_PAGES)]
    rng_t, rng_j = random.Random(1000 + seed), random.Random(1000 + seed)
    spec_t = tgenspec.CopybookSpec.random(rng_t, code_page=code_page)
    spec_j = jgenspec.CopybookSpec.random(rng_j, code_page=code_page)
    assert spec_t.copybook_text == spec_j.copybook_text
    bodies_t = [spec_t.random_body(rng_t) for _ in range(3)]
    bodies_j = [spec_j.random_body(rng_j) for _ in range(3)]
    assert bodies_t == bodies_j
    assert spec_t.trivial_body() == spec_j.trivial_body()
    assert rng_t.random() == rng_j.random()
    assert [s[1].copybook_text for s in rtcheck.quick_cases()][seed] \
        == spec_t.copybook_text
    for framing in ("fixed", "rdw"):
        assert spec_t.read_options(framing) == spec_j.read_options(framing)
        t_opts = spec_t.encode_options(framing)
        j_opts = spec_j.encode_options(framing)
        assert _options_view(t_opts) == _options_view(j_opts)
        if framing == "fixed" and spec_t.has_depending:
            continue  # variable-size records need RDW framing
        data_t = encode_file(spec_t.copybook_text, bodies_t, **t_opts)
        data_j = jenc.encode_file(spec_j.copybook_text, bodies_j, **j_opts)
        assert data_t == data_j


def test_shrinkers_match_jax():
    """`shrink_spec` and `shrink_body` take the same steps in both
    packages under the same failure predicate."""
    rng_t, rng_j = random.Random(77), random.Random(77)
    spec_t = tgenspec.CopybookSpec.random(rng_t, max_fields=10)
    spec_j = jgenspec.CopybookSpec.random(rng_j, max_fields=10)
    keep = spec_t.droppable_names()[-1]
    assert spec_j.droppable_names()[-1] == keep

    def still_has(spec):
        return keep in spec.copybook_text

    small_t = tgenspec.shrink_spec(spec_t, still_has)
    small_j = jgenspec.shrink_spec(spec_j, still_has)
    assert small_t.copybook_text == small_j.copybook_text
    body_t, body_j = spec_t.random_body(rng_t), spec_j.random_body(rng_j)

    def first_leaf_set(body):
        return repr(body).count("None") < 2

    assert tgenspec.shrink_body(spec_t, body_t, first_leaf_set) \
        == jgenspec.shrink_body(spec_j, body_j, first_leaf_set)


# every dtype kind and sign flavour the encoder takes; one copybook per
# data encoding
FIELD_GRID_COPYBOOK = """
       01  REC.
           05  D-INT      PIC 9(4).
           05  D-SINT     PIC S9(4).
           05  D-LEAD     PIC S9(4) SIGN IS LEADING.
           05  D-LSEP     PIC S9(4) SIGN IS LEADING SEPARATE.
           05  D-TSEP     PIC S9(4) SIGN IS TRAILING SEPARATE.
           05  D-VDEC     PIC S9(3)V99.
           05  D-UVDEC    PIC 9(3)V9.
           05  D-DOT      PIC S9(3).9(2).
           05  D-PPOS     PIC 9(3)PP.
           05  D-PNEG     PIC SPP9(3).
           05  D-WIDE     PIC S9(20).
           05  P-INT      PIC S9(5) COMP-3.
           05  P-UINT     PIC 9(5) COMP-3.
           05  P-DEC      PIC S9(5)V99 COMP-3.
           05  P-WIDE     PIC S9(25) COMP-3.
           05  P-PNEG     PIC SPP9(3) COMP-3.
           05  B-H        PIC S9(4) COMP.
           05  B-UH       PIC 9(4) COMP.
           05  B-F        PIC S9(9) COMP-4.
           05  B-UF       PIC 9(9) COMP-5.
           05  B-D        PIC S9(18) COMP.
           05  B-UD       PIC 9(18) COMP.
           05  B-LE       PIC S9(9) COMP-9.
           05  B-DEC      PIC S9(5)V99 COMP.
           05  B-PPOS     PIC 9(3)PP COMP.
           05  B-PNEG     PIC SPP9(3) COMP.
           05  F-SINGLE   COMP-1.
           05  F-DOUBLE   COMP-2.
           05  S-TEXT     PIC X(6).
"""

NUMBER_VALUES = [
    None, 0, 1, -1, 7, -42, 99, 100, 999, 1000, 9999, 10000, -10000,
    12345, -12345, 10 ** 9, -(10 ** 9), 2 ** 31, 2 ** 63, 10 ** 20,
    -(10 ** 24), Decimal("1.5"), Decimal("-0.07"), Decimal("123.45"),
    Decimal("-999.99"), Decimal("0.001"), Decimal("0.00123"),
    Decimal("12300"), Decimal("1.23E+5"), 2.5, -1234.0625, 0.1, 1e10,
    1e-80, 1e300, float("inf"), float("nan"), "17", "x", b"\x01",
]
TEXT_VALUES = [None, "", "A", "Hello", "héllo", "[]^|", "ÄÖü€",
               "abcdefg", "Ω", " pad "]


def _fields(cb_mod, text, **kw):
    return [st for st in cb_mod.parse_copybook(text, **kw)
            .ast.walk_primitives()]


def _outcome(fn):
    try:
        return ("bytes", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


def _grid_outcomes(fields_t, fields_j, values, kw_t, kw_j):
    for ft, fj in zip(fields_t, fields_j):
        assert ft.name == fj.name
        for v in values:
            got = _outcome(lambda: encode_field(ft.dtype, v, **kw_t))
            want = _outcome(lambda: jenc.encode_field(fj.dtype, v, **kw_j))
            assert got == want, (ft.name, v, got, want)


@pytest.mark.parametrize("fp", ["IBM", "IBM_LE", "IEEE754", "IEEE754_LE"])
def test_encode_field_numbers_match_jax(fp):
    """DISPLAY (every sign flavour, V, explicit dot, P scaling both
    ways, wide), COMP-3, COMP / COMP-4 / COMP-5 / COMP-9 (scaled too),
    COMP-1 / COMP-2 under each floating-point format: the same bytes,
    or the same error with the same message, for values in and out of
    each field's domain."""
    fields_t = _fields(tcb, FIELD_GRID_COPYBOOK)
    fields_j = _fields(jcb, FIELD_GRID_COPYBOOK)
    numeric = [i for i, f in enumerate(fields_t)
               if not isinstance(f.dtype, tdt.AlphaNumeric)]
    _grid_outcomes([fields_t[i] for i in numeric],
                   [fields_j[i] for i in numeric], NUMBER_VALUES,
                   dict(floating_point_format=tdt.FloatingPointFormat[fp]),
                   dict(floating_point_format=jdt.FloatingPointFormat[fp]))


def test_encode_field_ascii_numbers_match_jax():
    """The same numeric grid in an ASCII layout (no overpunch: a
    negative zoned number needs a spare leading digit)."""
    fields_t = _fields(tcb, FIELD_GRID_COPYBOOK,
                       data_encoding=tdt.Encoding.ASCII)
    fields_j = _fields(jcb, FIELD_GRID_COPYBOOK,
                       data_encoding=jdt.Encoding.ASCII)
    _grid_outcomes(fields_t, fields_j, NUMBER_VALUES + TEXT_VALUES,
                   {}, {})


@pytest.mark.parametrize("code_page", rtcheck.ALIAS_CODE_PAGES)
def test_encode_field_text_matches_jax(code_page):
    """PIC X on every builtin EBCDIC code page: the same bytes (the
    lowest-byte-wins inversion) or the same error for a glyph the page
    lacks, an over-long value or a non-string."""
    fields_t = _fields(tcb, FIELD_GRID_COPYBOOK)
    fields_j = _fields(jcb, FIELD_GRID_COPYBOOK)
    alphabet = "".join(chr(c) for c in range(32, 0x250))
    values = TEXT_VALUES + [alphabet[i:i + 6]
                            for i in range(0, len(alphabet), 6)]
    _grid_outcomes(fields_t[-1:], fields_j[-1:], values + [17],
                   dict(ebcdic_code_page=code_page),
                   dict(ebcdic_code_page=code_page))


@pytest.mark.parametrize("charset,utf16_be", [("us-ascii", True),
                                              ("cp1252", True),
                                              ("no-such", True),
                                              ("us-ascii", False)])
def test_encode_field_other_encodings_match_jax(charset, utf16_be):
    """ASCII text under a charset, UTF-16 (PIC N) in both byte orders,
    and the HEX and RAW debug fields."""
    text = """
       01  REC.
           05  A-TEXT   PIC X(6).
           05  N-TEXT   PIC N(4).
"""
    for enc_t, enc_j in ((tdt.Encoding.ASCII, jdt.Encoding.ASCII),
                         (tdt.Encoding.EBCDIC, jdt.Encoding.EBCDIC)):
        for dbg_t, dbg_j in ((tdt.DebugFieldsPolicy.HEX,
                              jdt.DebugFieldsPolicy.HEX),
                             (tdt.DebugFieldsPolicy.RAW,
                              jdt.DebugFieldsPolicy.RAW)):
            fields_t = _fields(tcb, text, data_encoding=enc_t,
                               debug_fields_policy=dbg_t)
            fields_j = _fields(jcb, text, data_encoding=enc_j,
                               debug_fields_policy=dbg_j)
            values = TEXT_VALUES + ["0a0B", "zz", b"\x00\xff", 5]
            _grid_outcomes(fields_t, fields_j, values,
                           dict(ascii_charset=charset,
                                is_utf16_big_endian=utf16_be),
                           dict(ascii_charset=charset,
                                is_utf16_big_endian=utf16_be))


STATIC_OCCURS_COPYBOOK = """
       01  REC.
           05  ID       PIC 9(6) COMP.
           05  POINTS   PIC S9(3)V9 COMP-3 OCCURS 3 TIMES.
           05  LEAD     PIC S9(5) SIGN IS LEADING.
           05  PAIR     OCCURS 2 TIMES.
              10  TAG   PIC X(3).
              10  VAL   PIC S9(4)V9 SIGN IS TRAILING SEPARATE.
           05  RATE     COMP-2.
           05  SMALL    COMP-1.
           05  LE       PIC S9(4) COMP-9.
"""


def _txn_columns(n, seed):
    rng = np.random.default_rng(seed)
    accounts = [f"ACC{int(i):07d}" for i in rng.integers(0, 10 ** 7, n)]
    return [
        rng.integers(0, 10 ** 9, n, dtype=np.int64),
        accounts,
        list(rng.choice(["USD", "EUR", "GBP", "", "Ω"][:4], n)),
        rng.integers(-(10 ** 11) + 1, 10 ** 11, n, dtype=np.int64),
        rng.integers(-(10 ** 9) + 1, 10 ** 9, n, dtype=np.int64),
        list(rng.choice(list("ACDPR"), n)),
        rng.integers(0, 10 ** 4, n, dtype=np.int64),
    ]


def test_batch_encoder_txn_matches_jax():
    """The TXN layout from the same numpy-drawn columns: the same
    record matrix from both packages' `BatchEncoder`, equal to the
    record walker's bytes."""
    n = 3000
    cols = _txn_columns(n, seed=11)
    got = BatchEncoder(corpus.TXN_COPYBOOK).encode_columns(cols, n)
    want = jenc.BatchEncoder(corpus.TXN_COPYBOOK).encode_columns(cols, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (n, corpus.TXN_RECORD_SIZE)


def test_batch_encoder_static_occurs_matches_jax():
    """A static OCCURS layout (arrays of COMP-3 and of groups, leading
    and separate signs, floats, COMP-9): the same matrix from both
    packages, under both float formats."""
    n = 500
    rng = np.random.default_rng(3)
    enc_t = BatchEncoder(STATIC_OCCURS_COPYBOOK)
    enc_j = jenc.BatchEncoder(STATIC_OCCURS_COPYBOOK)
    assert len(enc_t.slots) == len(enc_j.slots)
    cols = []
    for slot in enc_t.slots:
        d = slot.field.dtype
        if isinstance(d, tdt.AlphaNumeric):
            cols.append([f"T{int(i)}"[:3] for i in rng.integers(0, 99, n)])
        elif d.usage in (tdt.Usage.COMP1, tdt.Usage.COMP2):
            cols.append(rng.integers(-4000, 4000, n) / 16.0)
        else:
            lo = -999 if d.is_signed else 0
            cols.append(rng.integers(lo, 999, n, dtype=np.int64))
    for fp in ("IEEE754", "IBM"):
        got = BatchEncoder(STATIC_OCCURS_COPYBOOK,
                           floating_point_format=tdt.FloatingPointFormat[
                               fp]).encode_columns(cols, n)
        want = jenc.BatchEncoder(
            STATIC_OCCURS_COPYBOOK,
            floating_point_format=jdt.FloatingPointFormat[fp]
        ).encode_columns(cols, n)
        assert np.array_equal(got, want), fp


# -- to_ebcdic of one file read by both packages ---------------------------


def _both_reads(path, **opts):
    t = read_cobol(path, **CPU, **opts)
    j = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                              **opts)
    assert t.to_rows() == j.to_rows()
    return t, j


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def test_to_ebcdic_fixed_matches_jax(tmp_path):
    fp = dict(floating_point_format="ieee754")
    data = encode_file(SCALAR_COPYBOOK, SCALAR_BODIES * 5,
                       floating_point_format=tdt.FloatingPointFormat
                       .IEEE754)
    path = _write(tmp_path, "s.dat", data)
    t, j = _both_reads(path, copybook_contents=SCALAR_COPYBOOK, **fp)
    assert t.to_ebcdic() == j.to_ebcdic() == data
    out_t, out_j = str(tmp_path / "t.out"), str(tmp_path / "j.out")
    assert t.to_ebcdic(out_t) is None and j.to_ebcdic(out_j) is None
    assert open(out_t, "rb").read() == open(out_j, "rb").read() == data
    assert t.to_ebcdic(fill_byte=0) == j.to_ebcdic(fill_byte=0)
    with pytest.raises(ValueError, match="Unknown framing"):
        t.to_ebcdic(framing="vb")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rdw_big_endian=True),
    dict(rdw_adjustment=-2),
    dict(rdw_part_of_record_length=True),
    dict(truncate=False),
])
def test_to_ebcdic_rdw_matches_jax(tmp_path, kw):
    data = encode_file(SIGN_COPYBOOK, SIGN_BODIES * 7, framing="rdw")
    path = _write(tmp_path, "r.dat", data)
    t, j = _both_reads(path, copybook_contents=SIGN_COPYBOOK,
                       is_record_sequence="true")
    got = t.to_ebcdic(framing="rdw", **kw)
    assert got == j.to_ebcdic(framing="rdw", **kw)
    if not kw:
        assert got == data


def test_to_ebcdic_collapse_root_matches_jax(tmp_path):
    """COLLAPSE_ROOT rows are rewrapped into their root groups."""
    text = OCCURS_COPYBOOK + """
       01  REC2.
           05  EXTRA   PIC X(4).
"""
    bodies = [list(b) + [("w",)] for b in OCCURS_BODIES] * 3
    data = encode_file(text, bodies)
    path = _write(tmp_path, "c.dat", data)
    t, j = _both_reads(path, copybook_contents=text,
                       schema_retention_policy="collapse_root")
    assert t.to_ebcdic() == j.to_ebcdic() == data


def test_to_ebcdic_generated_columns_stripped_matches_jax(tmp_path):
    """Record ids, the input file name and two Seg_Id levels lead the
    rows; none of them is encoded."""
    data = encode_file(
        corpus.MULTISEG_COPYBOOK, MULTISEG_BODIES * 4, framing="rdw",
        segment_redefines=["STATIC-DETAILS", "CONTACTS"])
    path = _write(tmp_path, "seg.dat", data)
    opts = dict(corpus.multiseg_read_options(), generate_record_id="true",
                with_input_file_name_col="F_NAME", segment_id_level0="C",
                segment_id_level1="P", segment_id_prefix="T")
    t, j = _both_reads(path, **opts)
    assert len(t.to_rows()[0]) == 2 + 1 + 2 + 1  # ids, name, levels, root
    assert t.to_ebcdic(framing="rdw") == j.to_ebcdic(framing="rdw") == data
    for extra in ({"generate_record_id": "false"},
                  {"with_input_file_name_col": ""}):
        t, j = _both_reads(path, **dict(opts, **extra))
        assert t.to_ebcdic(framing="rdw") == j.to_ebcdic(framing="rdw")


def test_to_ebcdic_permissive_corrupt_column_matches_jax(tmp_path):
    """A permissive read with the corrupt-record column (trailing) and
    damaged COMP-3 fields: the same bytes from both packages."""
    path = str(tmp_path / "txn.dat")
    corpus.write_fixed_corpus(path, 400, seed=6)
    bad, _ = corpus.corrupt_fixed_corpus(
        open(path, "rb").read(), count=3, seed=4,
        kinds=("sign-nibble", "packed-digit"))
    path = _write(tmp_path, "bad.dat", bad)
    t, j = _both_reads(path, **corpus.fixed_read_options(),
                       record_error_policy="permissive",
                       corrupt_record_column="_bad")
    assert t.to_ebcdic() == j.to_ebcdic()
    assert len(t.to_ebcdic()) == len(bad)


def test_to_ebcdic_depending_on_matches_jax(tmp_path):
    data = encode_file(ODO_COPYBOOK, ODO_BODIES * 5, framing="rdw",
                       variable_size_occurs=True)
    path = _write(tmp_path, "odo.dat", data)
    t, j = _both_reads(path, copybook_contents=ODO_COPYBOOK,
                       is_record_sequence="true",
                       variable_size_occurs="true")
    for vso in (True, False):
        assert t.to_ebcdic(framing="rdw", variable_size_occurs=vso) \
            == j.to_ebcdic(framing="rdw", variable_size_occurs=vso)
    assert t.to_ebcdic(framing="rdw", variable_size_occurs=True) == data


def test_to_ebcdic_empty_file_matches_jax(tmp_path):
    path = _write(tmp_path, "empty.dat", b"")
    t, j = _both_reads(path, copybook_contents=SIGN_COPYBOOK)
    assert t.to_ebcdic() == j.to_ebcdic() == b""
    assert t.to_ebcdic(framing="rdw") == b""


def test_plan_fingerprint_matches_jax(tmp_path):
    """Set on every route, explain included, and equal to the JAX
    package's for the same copybook and options."""
    data = encode_file(SIGN_COPYBOOK, SIGN_BODIES)
    path = _write(tmp_path, "f.dat", data)
    prints = []
    for opts in (dict(copybook_contents=SIGN_COPYBOOK),
                 dict(copybook_contents=SIGN_COPYBOOK,
                      schema_retention_policy="collapse_root"),
                 dict(copybook_contents=SIGN_COPYBOOK,
                      ebcdic_code_page="cp037")):
        t, j = _both_reads(path, **opts)
        assert t.plan_fingerprint and t.plan_fingerprint \
            == j.plan_fingerprint
        prints.append(t.plan_fingerprint)
    # the retention policy shapes the schema, not the parse: the sink's
    # schema fingerprint tells those apart
    assert prints[0] == prints[1] != prints[2]
    report = read_cobol(path, copybook_contents=SIGN_COPYBOOK,
                        explain=True, **CPU)
    assert report.data.plan_fingerprint == prints[0]
