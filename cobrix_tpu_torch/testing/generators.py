"""EBCDIC test-data generators for the exp1, exp2 and exp3 profiles.

Port copy of the parts of ``cobrix_tpu.testing.generators`` that
``chip_smoke.py`` and the port's tests need: `EXP1_COPYBOOK`,
`generate_exp1`, `EXP2_COPYBOOK`, `generate_exp2`, `EXP3_COPYBOOK`,
`generate_exp3` and their helpers, unchanged. The other generators are
not carried over but `generate_custom_rdw` (records behind a custom
5-byte header), copied unchanged. `generate_ascii` (an ASCII
fixed-length layout) and `generate_fixed_segments` (a fixed-length
multisegment layout) are the port's own, for the record-shaping options;
so are the inputs of the generic per-record framings: `generate_text`
(text lines of `TEXT_COPYBOOK`), `LENGTH_FIELD_EXP3_COPYBOOK` (exp3 with
its RDW read as a record-length field) and `generate_var_occurs`
(variable-size OCCURS records of `VAR_OCCURS_COPYBOOK`), and
`generate_dynamic_occurs` (`DYNAMIC_OCCURS_COPYBOOK`: a DEPENDING ON
table followed by a trailer, read by the host row walk). The
hierarchical stream (`HIERARCHICAL_COPYBOOK`, `HIERARCHICAL_SEGMENT_MAP`,
`HIERARCHICAL_PARENT_MAP`, `generate_hierarchical`, the reference's
TestDataGen17Hierarchical) is copied unchanged, with
`encode_display_unsigned` and its value lists. `TRANSDATA_COPYBOOK` is
copied unchanged; `generate_transactions` makes its 45-byte records
(TestDataGen1Transactions: currencies, company names and ids, the
skewed AMOUNT) with one numpy draw a column, so its bytes are not the
JAX package's for the same seed.

Reimplements the behavior of the reference's example data generators
(TestDataGen4CompaniesWide for the exp3 multisegment-wide profile,
TestDataGen6TypeVariety-style fixed-length records for exp1;
GeneratorTools ASCII->EBCDIC encode helpers) with vectorized numpy so
benchmark-sized inputs (GBs) generate quickly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..encoding.codepages import get_code_page_table

# ASCII -> EBCDIC encode LUT: inverse of the "common" invariant decode table
# (unmappable characters encode as EBCDIC space 0x40)
_DECODE = get_code_page_table("common")
_ENCODE_LUT = np.full(128, 0x40, dtype=np.uint8)
for _ebcdic in range(255, -1, -1):
    _ch = _DECODE[_ebcdic]
    if ord(_ch) < 128:
        _ENCODE_LUT[ord(_ch)] = _ebcdic
_ENCODE_LUT[ord(" ")] = 0x40


def ebcdic_encode(text: str, length: Optional[int] = None,
                  pad: int = 0x00) -> bytes:
    """Encode ASCII text to EBCDIC, padded to `length` with `pad` bytes
    (the reference generators pad with NULs, GeneratorTools.putStringToArray)."""
    raw = np.frombuffer(text.encode("ascii", "replace"), dtype=np.uint8)
    out = _ENCODE_LUT[np.minimum(raw, 127)]
    if length is not None:
        padded = np.full(length, pad, dtype=np.uint8)
        padded[: min(len(out), length)] = out[:length]
        return padded.tobytes()
    return out.tobytes()


def encode_strings_column(values, width: int, pad: int = 0x00) -> np.ndarray:
    """[N] of str -> [N, width] EBCDIC uint8."""
    n = len(values)
    out = np.full((n, width), pad, dtype=np.uint8)
    for i, v in enumerate(values):
        enc = np.frombuffer(v.encode("ascii", "replace")[:width], dtype=np.uint8)
        out[i, : len(enc)] = _ENCODE_LUT[np.minimum(enc, 127)]
    return out


def encode_display_unsigned(values: np.ndarray, digits: int) -> np.ndarray:
    """[N] ints -> [N, digits] EBCDIC zoned (0xF0..0xF9)."""
    n = len(values)
    out = np.zeros((n, digits), dtype=np.uint8)
    v = values.astype(np.int64).copy()
    for pos in range(digits - 1, -1, -1):
        out[:, pos] = 0xF0 + (v % 10)
        v //= 10
    return out


def encode_comp3_unsigned(values: np.ndarray, digits: int) -> np.ndarray:
    """[N] ints -> [N, digits//2+1] packed BCD with 0xF sign nibble."""
    width = digits // 2 + 1
    n = len(values)
    nibble_count = width * 2 - 1
    nibbles = np.zeros((n, nibble_count), dtype=np.uint8)
    v = values.astype(np.int64).copy()
    for pos in range(nibble_count - 1, -1, -1):
        nibbles[:, pos] = v % 10
        v //= 10
    out = np.zeros((n, width), dtype=np.uint8)
    for b in range(width):
        high = nibbles[:, b * 2]
        low = nibbles[:, b * 2 + 1] if b * 2 + 1 < nibble_count \
            else np.full(n, 0x0F, dtype=np.uint8)
        out[:, b] = (high << 4) | low
    out[:, -1] = (nibbles[:, -1] << 4) | 0x0F
    return out


def encode_comp_be(values: np.ndarray, width: int) -> np.ndarray:
    """[N] ints -> [N, width] big-endian binary."""
    n = len(values)
    out = np.zeros((n, width), dtype=np.uint8)
    v = values.astype(np.int64).copy()
    for b in range(width - 1, -1, -1):
        out[:, b] = v & 0xFF
        v >>= 8
    return out


EXP2_COPYBOOK = """
        01  COMPANY-DETAILS.
            05  SEGMENT-ID        PIC X(5).
            05  COMPANY-ID        PIC X(10).
            05  STATIC-DETAILS.
               10  COMPANY-NAME      PIC X(15).
               10  ADDRESS           PIC X(25).
               10  TAXPAYER.
                  15  TAXPAYER-TYPE  PIC X(1).
                  15  TAXPAYER-STR   PIC X(8).
                  15  TAXPAYER-NUM  REDEFINES TAXPAYER-STR
                                     PIC 9(8) COMP.
            05  CONTACTS REDEFINES STATIC-DETAILS.
               10  PHONE-NUMBER      PIC X(17).
               10  CONTACT-PERSON    PIC X(28).
"""

EXP3_COPYBOOK = """
        01  COMPANY-DETAILS.
            05  SEGMENT-ID        PIC X(5).
            05  COMPANY-ID        PIC X(10).
            05  STATIC-DETAILS.
               10  COMPANY-NAME      PIC X(15).
               10  ADDRESS           PIC X(25).
               10  TAXPAYER.
                  15  TAXPAYER-TYPE  PIC X(1).
                  15  TAXPAYER-STR   PIC X(8).
                  15  TAXPAYER-NUM  REDEFINES TAXPAYER-STR
                                     PIC 9(8) COMP.
               10  STRATEGY.
                 15  STRATEGY-DETAIL OCCURS 2000.
                   25  NUM1 PIC 9(7) COMP.
                   25  NUM2 PIC 9(7) COMP-3.
            05  CONTACTS REDEFINES STATIC-DETAILS.
               10  PHONE-NUMBER      PIC X(17).
               10  CONTACT-PERSON    PIC X(28).
"""


# exp1: the 167-column fixed-length type-variety profile
# (TestDataGen6TypeVariety.scala:38-278 — the copybook is data/
# test6_copybook.cob; the generator's put-call sequence is lines 327-572).
# Each spec entry is one generator put call IN ORDER: (name, pic, kind,
# params). The copybook text is emitted from this same table, so the
# generator layout and the parsed schema cannot drift apart.
#
# kinds:
#   id      - int32 big-endian record counter (putIntToArray)
#   str     - EBCDIC string, NUL-padded (putStringToArray)
#   disp    - DISPLAY digits (encodeUncompressed); params: digits, signed,
#             sep ('lead'/'trail'/None = overpunch), lead (overpunch/sign
#             position), dot (explicit decimal byte index), neg (uses the
#             per-record isNegative flag)
#   bin     - big-endian two's complement (encodeBinSigned/Unsigned
#             precision buckets: <=4 digits 2B, <=9 4B, <=18 8B, else
#             ceil((log2(10)*digits+1)/8) bytes)
#   bcd     - packed decimal (encodeBcd); params: digits, signed encoder
#             (sign nibble C/D) vs unsigned (F), neg
#   float/double - IEEE754 BE of digits[:5].digits[5:7] / digits[:10].digits[10:14]
_D = "disp"


def _exp1_spec():
    nums = [1, 2, 3, 4, 5, 8, 9, 10, 11, 17, 18, 19, 20, 37]
    decs = [("99V9", 3), ("99V99", 4), ("9(3)V99", 5), ("9(4)V9(4)", 8),
            ("9(5)V9(4)", 9), ("9(5)V9(5)", 10), ("9(15)V99", 17),
            ("9(16)V99", 18), ("9(17)V99", 19), ("9(18)V9(10)", 28)]
    spec = [("ID", "9(7)  BINARY", "id", {})]
    spec.append(("STRING-VAL", "X(10)", "str", {}))
    for i, d in enumerate(nums):
        spec.append((f"NUM-STR-INT{i + 1:02d}", f"9({d})", _D,
                     dict(digits=d)))
    for i, d in enumerate(nums[1:]):
        spec.append((f"NUM-STR-SINT{i + 2:02d}", f"S9({d})", _D,
                     dict(digits=d, signed=True, neg=True)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-STR-DEC{i + 1:02d}", pic, _D, dict(digits=d)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-STR-SDEC{i + 1:02d}", "S" + pic, _D,
                     dict(digits=d, signed=True, neg=True)))
    # explicit decimal point ('.' literally in the data)
    for i, (pic, d, dot) in enumerate([("S9(3).99", 5, 3), ("S9(4).9(4)", 8, 4),
                                       ("S9(5).9(4)", 9, 5),
                                       ("S9(5).9(5)", 10, 5)]):
        spec.append((f"NUM-STR-EDEC{i + 3:02d}", pic, _D,
                     dict(digits=d, signed=True, neg=True, dot=dot)))
    usages = ["COMP", "COMP", "COMP-0", "COMP-4", "COMP-5"] + ["BINARY"] * 9
    for i, (d, u) in enumerate(zip(nums, usages)):
        spec.append((f"NUM-BIN-INT{i + 1:02d}", f"9({d}) {u}", "bin",
                     dict(digits=d)))
    for i, d in enumerate(nums):
        u = "COMP" if i < 5 else "BINARY"
        spec.append((f"NUM-SBIN-SINT{i + 1:02d}", f"S9({d}) {u}", "bin",
                     dict(digits=d, neg=True)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-BIN-DEC{i + 1:02d}", f"{pic} COMP", "bin",
                     dict(digits=d)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-SBIN-DEC{i + 1:02d}", f"S{pic} COMP", "bin",
                     dict(digits=d, neg=True)))
    for i, d in enumerate(nums):
        spec.append((f"NUM-BCD-INT{i + 1:02d}", f"9({d}) COMP-3", "bcd",
                     dict(digits=d)))
    for i, d in enumerate(nums):
        spec.append((f"NUM-BCD-SINT{i + 1:02d}", f"S9({d}) COMP-3", "bcd",
                     dict(digits=d, signed=True, neg=True)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-BCD-DEC{i + 1:02d}", f"{pic} COMP-3", "bcd",
                     dict(digits=d)))
    for i, (pic, d) in enumerate(decs):
        spec.append((f"NUM-BCD-SDEC{i + 1:02d}", f"S{pic} COMP-3", "bcd",
                     dict(digits=d, signed=True, neg=True)))
    spec += [
        ("NUM-SL-STR-INT01", "S9(9) SIGN IS LEADING SEPARATE", _D,
         dict(digits=9, signed=True, neg=True, sep="lead")),
        ("NUM-SL-STR-DEC01", "99V99 SIGN IS LEADING SEPARATE CHARACTER", _D,
         dict(digits=4, signed=True, neg=True, sep="lead")),
        ("NUM-ST-STR-INT01", "S9(9) SIGN IS TRAILING SEPARATE", _D,
         dict(digits=9, signed=True, neg=True, sep="trail")),
        ("NUM-ST-STR-DEC01", "99V99 SIGN TRAILING SEPARATE", _D,
         dict(digits=4, signed=True, neg=True, sep="trail")),
        ("NUM-SLI-STR-DEC01", "SV9(7) SIGN LEADING", _D,
         dict(digits=7, signed=True, neg=True, lead=True)),
        ("NUM-STI-STR-DEC01", "SV9(7) SIGN TRAILING", _D,
         dict(digits=7, signed=True, neg=True)),
        ("NUM-SLI-DEBUG", "X(7)", _D,
         dict(digits=7, signed=True, neg=True, lead=True)),
        ("NUM-STI-DEBUG", "X(7)", _D, dict(digits=7, signed=True, neg=True)),
        ("FLOAT-01", "COMP-1", "float", {}),
        ("DOUBLE-01", "COMP-2", "double", {}),
        ("COMMON-8-BIN", "9(8) BINARY", "bin", dict(digits=8)),
        ("COMMON-S3-BIN", "S9(3) BINARY", "bin", dict(digits=3)),
        ("COMMON-S94COMP", "S9(04) COMP", "bin", dict(digits=4)),
        ("COMMON-S8-BIN", "S9(8) BINARY", "bin", dict(digits=8)),
        ("COMMON-DDC97-BIN", "S9V9(7) BINARY", "bin", dict(digits=8)),
        ("COMMON-97COMP3", "9(07) COMP-3", "bcd", dict(digits=7)),
        ("COMMON-915COMP3", "9(15) COMP-3", "bcd", dict(digits=15)),
        ("COMMON-S95COMP3", "S9(5) COMP-3", "bcd",
         dict(digits=5, signed=True, neg=True)),
        ("COMMON-S999DCCOMP3", "S9(09)V99 COMP-3", "bcd",
         dict(digits=11, signed=True, neg=True)),
        ("COMMON-S913COMP3", "S9(13) COMP-3", "bcd",
         dict(digits=13, signed=True, neg=True)),
        ("COMMON-S913DCCOMP3", "S9(13)V99 COMP-3", "bcd",
         dict(digits=15, signed=True, neg=True)),
        ("COMMON-S911DCC2", "S9(11)V99 COMP-3", "bcd",
         dict(digits=13, signed=True, neg=True)),
        ("COMMON-S910DCC3", "S9(10)V999 COMP-3", "bcd",
         dict(digits=13, signed=True, neg=True)),
        ("COMMON-S03DDC", "SV9(5) COMP-3", "bcd",
         dict(digits=5, signed=True, neg=True)),
        # U03DDC/UPC5DDC/UPI5DDC use the SIGNED encoder with a positive
        # value: sign nibble 0xC, never 0xF (generator lines 542-546)
        ("COMMON-U03DDC", "V9(5) COMP-3", "bcd", dict(digits=5, signed=True)),
        ("COMMON-UPC5DDC", "PPP9(5) COMP-3", "bcd",
         dict(digits=5, signed=True)),
        ("COMMON-SPC5DDC", "SPP99999 COMP-3", "bcd",
         dict(digits=5, signed=True, neg=True)),
        ("COMMON-UPI5DDC", "9(5)PPP COMP-3", "bcd",
         dict(digits=5, signed=True)),
        ("COMMON-SPI5DDC", "S99999PPP COMP-3", "bcd",
         dict(digits=5, signed=True, neg=True)),
        ("COMMON-UPC5DISP", "SPPP9(5)", _D,
         dict(digits=5, signed=True, neg=True)),
        ("COMMON-UPI5DISP", "S9(5)PPP", _D,
         dict(digits=5, signed=True, neg=True)),
        ("COMMON-UPC1BIN", "SPPP9 COMP", "bin", dict(digits=1)),
        ("COMMON-UPI1BIN", "S9PPP COMP", "bin", dict(digits=1)),
        ("COMMON-UPC3BIN", "SPPP9(3) COMP", "bin", dict(digits=3)),
        ("COMMON-UPI3BIN", "S9(3)PPP COMP", "bin", dict(digits=3)),
        ("COMMON-UPC5BIN", "SPPP9(5) COMP", "bin", dict(digits=5)),
        ("COMMON-UPI5BIN", "S9(5)PPP COMP", "bin", dict(digits=5)),
        ("COMMON-UPC10BIN", "SPPP9(10) COMP", "bin", dict(digits=10)),
        ("COMMON-UPI10BIN", "S9(10)PPP COMP", "bin", dict(digits=10)),
        ("EX-NUM-INT01", "+9(8)", _D,
         dict(digits=8, signed=True, neg=True, sep="lead")),
        ("EX-NUM-INT02", "9(8)+", _D,
         dict(digits=8, signed=True, neg=True, sep="trail")),
        ("EX-NUM-INT03", "-9(8)", _D,
         dict(digits=8, signed=True, neg=True, sep="lead")),
        ("EX-NUM-INT04", "Z(8)-", _D,
         dict(digits=8, signed=True, neg=True, sep="trail")),
        ("EX-NUM-DEC01", "+9(6)V99", _D,
         dict(digits=8, signed=True, neg=True, sep="lead")),
        ("EX-NUM-DEC02", "Z(6)VZZ-", _D,
         dict(digits=8, signed=True, neg=True, sep="trail")),
        ("EX-NUM-DEC03", "9(6).99-", _D,
         dict(digits=8, signed=True, neg=True, sep="trail", dot=6)),
    ]
    return spec


EXP1_SPEC = _exp1_spec()


def _bin_width(digits: int) -> int:
    """encodeBinSigned/Unsigned byte width (GeneratorTools.scala:337-365 +
    strToBigArray:383-404) — matches BinaryUtils' IBM precision buckets."""
    import math
    if digits <= 4:
        return 2
    if digits <= 9:
        return 4
    if digits <= 18:
        return 8
    return math.ceil((math.log2(10.0) * digits + 1) / 8)


def _exp1_width(kind: str, p: dict) -> int:
    if kind == "id":
        return 4
    if kind == "str":
        return 10
    if kind == "disp":
        return (p["digits"] + (1 if p.get("sep") else 0)
                + (1 if p.get("dot") is not None else 0))
    if kind == "bin":
        return _bin_width(p["digits"])
    if kind == "bcd":
        return p["digits"] // 2 + 1
    return {"float": 4, "double": 8}[kind]


def _exp1_copybook() -> str:
    lines = ["        01  RECORD."]
    for name, pic, _, _ in EXP1_SPEC:
        clause = "" if pic.startswith("COMP-") else "PIC "
        # clause on a continuation line: cols 72+ are comment area and the
        # longest SIGN clauses would spill past it on a single line
        lines.append(f"          10  {name}")
        lines.append(f"              {clause}{pic}.")
    return "\n".join(lines) + "\n"


EXP1_COPYBOOK = _exp1_copybook()
EXP1_RECORD_SIZE = sum(_exp1_width(k, p) for _, _, k, p in EXP1_SPEC)

_COMPANIES = ["ABCD Ltd.", "ECRONO GmbH", "ZjkLPj Ltd.", "Eqartion Inc.",
              "Test Bank", "Pear GMBH.", "Beiereqweq.", "Joan Q & Z",
              "Robotrd Inc.", "Xingzhoug", "MapMot Inc.", "Dobry Pivivar",
              "Xingzhoug", "Hadlway Hotels"]
_FIRST = ["Jene", "Maya", "Starr", "Lynell", "Eliana", "Tyesha", "Beatrice",
          "Otelia", "Timika", "Wilbert", "Mindy", "Sunday"]
# the 30-name pool of TestDataGen6TypeVariety.scala:283-314
_EXP1_NAMES = _FIRST + ["Tyson", "Cliff", "Mabelle", "Verdie", "Sulema",
                        "Alona", "Suk", "Deandra", "Doretha", "Cassey",
                        "Janiece", "Deshawn", "Willis", "Carrie", "Gabriele",
                        "Inge", "Edyth", "Estelle"]
_LAST = ["Corle", "Mackinnon", "Mork", "Shapiro", "Boettcher", "Flatt",
         "Acuna", "Thorpe", "Riojas", "Lepe", "Maccarthy", "Filipski"]


def _rdw(length: int, big_endian: bool = False) -> bytes:
    if big_endian:
        return bytes([length >> 8, length & 0xFF, 0, 0])
    return bytes([0, 0, length & 0xFF, length >> 8])


def generate_exp2(num_records: int, seed: int = 100,
                  big_endian_rdw: bool = False) -> bytes:
    """RDW multisegment narrow profile (68/64-byte records, 'C'/'P' segments)."""
    return _generate_companies(num_records, seed, big_endian_rdw,
                               wide_detail_count=0)


def generate_exp3(num_records: int, seed: int = 100,
                  big_endian_rdw: bool = False) -> bytes:
    """RDW multisegment wide profile: segment 'C' records carry 2000
    (COMP + COMP-3) strategy elements (16068-byte records)."""
    return _generate_companies(num_records, seed, big_endian_rdw,
                               wide_detail_count=2000)


def _generate_companies(num_records: int, seed: int, big_endian_rdw: bool,
                        wide_detail_count: int) -> bytes:
    rng = np.random.default_rng(seed)
    chunks = []
    i = 0
    while i < num_records:
        company = _COMPANIES[rng.integers(0, len(_COMPANIES))]
        company_id = f"{rng.integers(10000, 99999)}{rng.integers(10000, 99999)}"
        payload = bytearray()
        payload += ebcdic_encode("C", 5)
        payload += ebcdic_encode(company_id, 10)
        payload += ebcdic_encode(company, 15)
        payload += ebcdic_encode(f"{rng.integers(1, 500)} Main Street", 25)
        taxpayer = int(rng.integers(10000000, 99999999))
        if rng.integers(0, 2) == 1:
            payload += ebcdic_encode("A", 1)
            payload += ebcdic_encode(str(taxpayer), 8)
        else:
            payload += ebcdic_encode("N", 1)
            payload += taxpayer.to_bytes(4, "big") + b"\x00\x00\x00\x00"
        if wide_detail_count:
            nums = rng.integers(0, 9999999, size=wide_detail_count)
            comp = encode_comp_be(nums, 4)
            comp3 = encode_comp3_unsigned(nums, 7)
            detail = np.concatenate([comp, comp3], axis=1)
            payload += detail.tobytes()
        chunks.append(_rdw(len(payload), big_endian_rdw) + bytes(payload))
        i += 1
        n_contacts = int(rng.integers(0, 5))
        for _ in range(n_contacts):
            if i >= num_records:
                break
            contact = bytearray()
            contact += ebcdic_encode("P", 5)
            contact += ebcdic_encode(company_id, 10)
            phone = (f"+({rng.integers(1, 921)}) {rng.integers(100, 999)} "
                     f"{rng.integers(10, 99)} {rng.integers(10, 99)}")
            contact += ebcdic_encode(phone, 17)
            person = (_FIRST[rng.integers(0, len(_FIRST))] + " "
                      + _LAST[rng.integers(0, len(_LAST))])
            contact += ebcdic_encode(person, 28)
            chunks.append(_rdw(len(contact), big_endian_rdw) + bytes(contact))
            i += 1
    return b"".join(chunks)


def encode_bcd_digits(digits: np.ndarray, sign_nibbles: np.ndarray
                      ) -> np.ndarray:
    """[n, d] digit values + [n] sign nibbles -> [n, d//2+1] packed BCD
    laid out as encodeBcd (GeneratorTools.scala:410-437): nibble stream =
    [0-pad if d even] + digits + sign, packed high-first."""
    n, d = digits.shape
    width = d // 2 + 1
    stream = np.zeros((n, width * 2), dtype=np.uint8)
    pad = 1 if d % 2 == 0 else 0
    stream[:, pad:pad + d] = digits
    stream[:, pad + d] = sign_nibbles
    return (stream[:, 0::2] << 4) | stream[:, 1::2]


_POW10 = 10 ** np.arange(18, dtype=np.int64)[::-1]


def _digits_to_int64(digits: np.ndarray) -> np.ndarray:
    d = digits.shape[1]
    return digits.astype(np.int64) @ _POW10[-d:]


def encode_bin_digits(digits: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """[n, d] digit values (+ neg mask) -> [n, w] big-endian two's
    complement, w per the encodeBinSigned/Unsigned precision buckets."""
    n, d = digits.shape
    w = _bin_width(d)
    out = np.zeros((n, w), dtype=np.uint8)
    if d <= 18:
        v = _digits_to_int64(digits)
        v = np.where(neg, -v, v)
        for b in range(w - 1, -1, -1):
            out[:, b] = (v & 0xFF).astype(np.uint8)
            v >>= 8
        return out
    # >18 digits: base-1e9 limbs, repeated divmod-256 to extract bytes
    # LSB-first (the vectorized equivalent of strToBigArray's BigInt path)
    n_limbs = -(-d // 9)
    limbs = np.zeros((n, n_limbs), dtype=np.int64)
    for j in range(n_limbs):
        hi = d - 9 * (n_limbs - j)
        chunk = digits[:, max(hi, 0):hi + 9]
        limbs[:, j] = _digits_to_int64(chunk)
    for b in range(w - 1, -1, -1):
        carry = np.zeros(n, dtype=np.int64)
        for j in range(n_limbs):
            cur = carry * 1_000_000_000 + limbs[:, j]
            limbs[:, j] = cur >> 8
            carry = cur & 0xFF
        out[:, b] = carry.astype(np.uint8)
    if neg.any():
        # two's complement of the magnitude: invert + ripple-add 1
        inv = 255 - out[neg]
        carry = np.ones(inv.shape[0], dtype=np.int64)
        for b in range(w - 1, -1, -1):
            s = inv[:, b].astype(np.int64) + carry
            inv[:, b] = (s & 0xFF).astype(np.uint8)
            carry = s >> 8
        out[neg] = inv
    return out


def _encode_exp1_disp(digits: np.ndarray, neg: np.ndarray, p: dict
                      ) -> np.ndarray:
    """DISPLAY plane of the exp1 generator (encodeUncompressed +
    putEncodedNumStrToArray placement, GeneratorTools.scala:245-332):
    overpunched sign unless sign-separate; optional literal '.' byte."""
    n, d = digits.shape
    body = 0xF0 + digits
    sep = p.get("sep")
    if p.get("signed") and not sep:
        pos = 0 if p.get("lead") else d - 1
        zone = np.where(neg, 0xD0, 0xC0).astype(np.uint8)
        body[:, pos] = zone + digits[:, pos]
    dot = p.get("dot")
    if dot is not None:
        body = np.concatenate(
            [body[:, :dot],
             np.full((n, 1), 0x4B, dtype=np.uint8),  # EBCDIC '.'
             body[:, dot:]], axis=1)
    if sep:
        sign_col = np.where(neg, 0x60, 0x4E).astype(  # EBCDIC '-' / '+'
            np.uint8)[:, None]
        order = [sign_col, body] if sep == "lead" else [body, sign_col]
        body = np.concatenate(order, axis=1)
    return body


def generate_exp1(num_records: int, seed: int = 100) -> np.ndarray:
    """Faithful exp1 fixed-length type-variety profile -> [N, 1493] uint8.

    Field-for-field port of the reference generator's record layout
    (TestDataGen6TypeVariety.scala:327-572 over data/test6_copybook.cob):
    each record draws one 56-digit number (7x 8-digit draws), a name from
    the 30-name list, and a sign flag; every numeric field encodes a
    digit-prefix of that number in its own representation. Vectorized so
    benchmark-sized batches (GBs) generate in seconds."""
    rng = np.random.default_rng(seed)
    n = num_records
    nums = rng.integers(10_000_000, 100_000_000, size=(n, 7))
    digits56 = np.zeros((n, 56), dtype=np.uint8)
    for j in range(7):
        v = nums[:, j].copy()
        for pos in range(7, -1, -1):
            digits56[:, j * 8 + pos] = v % 10
            v //= 10
    neg = rng.integers(0, 2, size=n).astype(bool)
    neg[0] = True  # the reference forces record 0 negative
    names = np.asarray(_EXP1_NAMES)[rng.integers(0, len(_EXP1_NAMES), n)]

    parts = []
    for name, _pic, kind, p in EXP1_SPEC:
        if kind == "id":
            ids = np.arange(1, n + 1, dtype=">i4")
            parts.append(ids.view(np.uint8).reshape(n, 4))
            continue
        if kind == "str":
            parts.append(encode_strings_column(list(names), 10, pad=0x00))
            continue
        if kind == "float":
            v = (_digits_to_int64(digits56[:, :7]) / 100.0)
            v = np.where(neg, -v, v).astype(">f4")
            parts.append(v.view(np.uint8).reshape(n, 4))
            continue
        if kind == "double":
            v = _digits_to_int64(digits56[:, :14]) / 10_000.0
            v = np.where(neg, -v, v).astype(">f8")
            parts.append(v.view(np.uint8).reshape(n, 8))
            continue
        d = p["digits"]
        fneg = neg if p.get("neg") else np.zeros(n, dtype=bool)
        pref = digits56[:, :d]
        if kind == "disp":
            parts.append(_encode_exp1_disp(pref, fneg, p))
        elif kind == "bin":
            parts.append(encode_bin_digits(pref, fneg))
        elif kind == "bcd":
            if p.get("signed"):
                sn = np.where(fneg, 0x0D, 0x0C).astype(np.uint8)
            else:
                sn = np.full(n, 0x0F, dtype=np.uint8)
            parts.append(encode_bcd_digits(pref, sn))
    out = np.concatenate(parts, axis=1)
    assert out.shape[1] == EXP1_RECORD_SIZE
    return out


# ---------------------------------------------------------------------------
# Remaining reference generator ports (examples-collection
# TestDataGen1/7/8/9/11/13a/13b/16/17; TestDataGen3CompaniesBigEndian is
# generate_exp2(big_endian_rdw=True)). Each reproduces the reference
# record layout byte for byte; the value pools come from CommonLists.
# ---------------------------------------------------------------------------


# -- fixed-length files for the record-shaping options ----------------------

def _digit_bytes(values: np.ndarray, width: int, zero: int) -> np.ndarray:
    """[n] non-negative ints -> [n, width] zero-padded decimal digit
    bytes, the digit 0 encoded as `zero` (0x30 ASCII, 0xF0 EBCDIC)."""
    out = np.empty((len(values), width), dtype=np.uint8)
    v = values.astype(np.int64).copy()
    for k in range(width - 1, -1, -1):
        out[:, k] = zero + v % 10
        v //= 10
    return out


def _letters(rng, n: int, width: int, lut=None) -> np.ndarray:
    """[n, width] random upper-case words padded with spaces at random
    lengths (ASCII, or through `lut` to EBCDIC)."""
    text = rng.integers(ord("A"), ord("Z") + 1, size=(n, width),
                        dtype=np.uint8)
    lengths = rng.integers(1, width + 1, size=n)
    text[np.arange(width)[None, :] >= lengths[:, None]] = ord(" ")
    return text if lut is None else lut[text]


def _comp3(rng_values: np.ndarray, digits: int,
           negative: np.ndarray) -> np.ndarray:
    """[n] magnitudes -> [n, digits//2+1] signed packed BCD (C/D)."""
    width = digits // 2 + 1
    nib = np.zeros((len(rng_values), width * 2), dtype=np.uint8)
    v = rng_values.astype(np.int64).copy()
    for k in range(width * 2 - 2, width * 2 - 2 - digits, -1):
        nib[:, k] = v % 10
        v //= 10
    nib[:, -1] = np.where(negative, 0xD, 0xC)
    return (nib[:, 0::2] << 4) | nib[:, 1::2]


# An ASCII fixed-length layout (encoding=ascii): signed DISPLAY with a
# sign character in the field and with separate leading and trailing
# signs, explicit decimal points, big-endian COMP, COMP-3 and strings;
# 82 bytes a record.
ASCII_COPYBOOK = """
       01  ASCII-RECORD.
           05  ID              PIC 9(8).
           05  NAME            PIC X(20).
           05  AMOUNT          PIC S9(7)V99.
           05  BALANCE         PIC S9(9)V99 SIGN LEADING SEPARATE.
           05  DELTA           PIC S9(5)V99 SIGN TRAILING SEPARATE.
           05  RATE            PIC 9(3).9(4).
           05  QTY             PIC S9(9) COMP.
           05  PRICE           PIC S9(11)V99 COMP-3.
           05  CODE            PIC X(6).
"""
ASCII_RECORD_SIZE = 82


def generate_ascii(num_records: int, seed: int = 100) -> np.ndarray:
    """[n, 82] uint8 records of `ASCII_COPYBOOK`, from `seed`."""
    rng = np.random.default_rng(seed)
    n = num_records
    neg = rng.integers(0, 2, size=(4, n)).astype(bool)
    cols = [_digit_bytes(np.arange(n) + 10 * seed, 8, 0x30),
            _letters(rng, n, 20)]
    # the sign as a leading character inside the field: '-', '+' or a
    # digit (unsigned)
    amount = _digit_bytes(rng.integers(0, 10 ** 9, size=n), 9, 0x30)
    lead = rng.integers(0, 3, size=n)
    amount[:, 0] = np.where(lead == 0, ord("-"),
                            np.where(lead == 1, ord("+"), amount[:, 0]))
    cols.append(amount)
    sign = np.where(neg[1], ord("-"), ord("+")).astype(np.uint8)[:, None]
    cols += [sign, _digit_bytes(rng.integers(0, 10 ** 11, size=n), 11, 0x30)]
    sign = np.where(neg[2], ord("-"), ord("+")).astype(np.uint8)[:, None]
    cols += [_digit_bytes(rng.integers(0, 10 ** 7, size=n), 7, 0x30), sign]
    rate = rng.integers(0, 10 ** 7, size=n)
    cols += [_digit_bytes(rate // 10 ** 4, 3, 0x30),
             np.full((n, 1), ord("."), dtype=np.uint8),
             _digit_bytes(rate % 10 ** 4, 4, 0x30)]
    qty = rng.integers(-(10 ** 9 - 1), 10 ** 9, size=n).astype(">i4")
    cols.append(qty.view(np.uint8).reshape(n, 4))
    cols.append(_comp3(rng.integers(0, 10 ** 13, size=n), 13, neg[3]))
    cols.append(_letters(rng, n, 6))
    return np.concatenate(cols, axis=1)


# An EBCDIC fixed-length multisegment layout (segment_field SEGMENT-ID,
# redefine map COMPANY => C, PERSON => P); 41 bytes a record.
FIXED_SEGMENTS_COPYBOOK = """
       01  SEG-RECORD.
           05  SEGMENT-ID      PIC X(1).
           05  COMPANY-ID      PIC X(10).
           05  COMPANY.
              10  NAME         PIC X(20).
              10  AMOUNT       PIC S9(9)V99 COMP-3.
              10  EMPLOYEES    PIC 9(6) COMP.
           05  PERSON REDEFINES COMPANY.
              10  FIRST-NAME   PIC X(12).
              10  AGE          PIC 9(3).
              10  SALARY       PIC S9(7)V99 COMP-3.
              10  FILLER       PIC X(10).
"""
FIXED_SEGMENTS_RECORD_SIZE = 41
FIXED_SEGMENTS_OPTIONS = {
    "segment_field": "SEGMENT-ID",
    "redefine-segment-id-map:0": "COMPANY => C",
    "redefine-segment-id-map:1": "PERSON => P"}


def generate_fixed_segments(num_records: int, seed: int = 100
                            ) -> np.ndarray:
    """[n, 41] uint8 EBCDIC records of `FIXED_SEGMENTS_COPYBOOK`: one
    company ('C') in four records, the rest its people ('P'), from
    `seed`."""
    rng = np.random.default_rng(seed)
    n = num_records
    is_c = rng.integers(0, 4, size=n) == 0
    out = np.zeros((n, FIXED_SEGMENTS_RECORD_SIZE), dtype=np.uint8)
    out[:, 0] = np.where(is_c, _ENCODE_LUT[ord("C")], _ENCODE_LUT[ord("P")])
    out[:, 1:11] = _digit_bytes(rng.integers(0, 10 ** 10, size=n), 10, 0xF0)
    company = np.concatenate([
        _letters(rng, n, 20, _ENCODE_LUT),
        _comp3(rng.integers(0, 10 ** 11, size=n), 11,
               rng.integers(0, 2, size=n).astype(bool)),
        rng.integers(0, 10 ** 6, size=n).astype(">u4").view(
            np.uint8).reshape(n, 4)], axis=1)
    person = np.concatenate([
        _letters(rng, n, 12, _ENCODE_LUT),
        _digit_bytes(rng.integers(0, 1000, size=n), 3, 0xF0),
        _comp3(rng.integers(0, 10 ** 9, size=n), 9,
               rng.integers(0, 2, size=n).astype(bool)),
        np.full((n, 10), 0x40, dtype=np.uint8)], axis=1)
    out[:, 11:41] = np.where(is_c[:, None], company, person[:, :30])
    return out


CUSTOM_RDW_COPYBOOK = EXP2_COPYBOOK


def generate_custom_rdw(num_records: int, seed: int = 100) -> bytes:
    """COMPANY-DETAILS records behind a CUSTOM 5-byte record header
    (TestDataGen11CustomRDW): byte 0 = validity flag, bytes 3-4 =
    little-endian payload length. Invalid records (flag 0, length 15)
    are interleaved and must be skipped by the custom header parser."""
    rng = np.random.default_rng(seed)
    chunks = []
    i = 0

    def header(valid: bool, length: int) -> bytes:
        return bytes([1 if valid else 0, 0, 0,
                      length & 0xFF, length >> 8])

    while i < num_records:
        company = _COMPANIES[rng.integers(0, len(_COMPANIES))]
        company_id = (f"{rng.integers(10000, 99999)}"
                      f"{rng.integers(10000, 99999)}")
        if rng.integers(0, 2) == 1:
            payload = bytearray()
            payload += ebcdic_encode("C", 5)
            payload += ebcdic_encode(company_id, 10)
            payload += ebcdic_encode(company, 15)
            payload += ebcdic_encode(f"{rng.integers(1, 500)} Main St", 25)
            taxpayer = int(rng.integers(10000000, 99999999))
            if rng.integers(0, 2) == 1:
                payload += ebcdic_encode("A", 1)
                payload += ebcdic_encode(str(taxpayer), 8)
            else:
                payload += ebcdic_encode("N", 1)
                payload += taxpayer.to_bytes(4, "big") + b"\x00" * 4
            chunks.append(header(True, 64) + bytes(payload))
            i += 1
            for _ in range(int(rng.integers(0, 5))):
                if i >= num_records:
                    break
                contact = bytearray()
                contact += ebcdic_encode("P", 5)
                contact += ebcdic_encode(company_id, 10)
                phone = (f"+({rng.integers(1, 921)}) "
                         f"{rng.integers(100, 999)} "
                         f"{rng.integers(10, 99)} {rng.integers(10, 99)}")
                contact += ebcdic_encode(phone, 17)
                person = (_FIRST[rng.integers(0, len(_FIRST))] + " "
                          + _LAST[rng.integers(0, len(_LAST))])
                contact += ebcdic_encode(person, 28)
                chunks.append(header(True, 60) + bytes(contact))
                i += 1
        else:
            chunks.append(header(False, 15) + b"\x00" * 15)
    return b"".join(chunks)


# -- inputs of the generic per-record framings -------------------------------

# the DISPLAY fields of `ASCII_COPYBOOK`, one record a text line
TEXT_COPYBOOK = """
       01  TEXT-RECORD.
           05  ID              PIC 9(8).
           05  NAME            PIC X(20).
           05  AMOUNT          PIC S9(7)V99.
           05  BALANCE         PIC S9(9)V99 SIGN LEADING SEPARATE.
           05  DELTA           PIC S9(5)V99 SIGN TRAILING SEPARATE.
           05  RATE            PIC 9(3).9(4).
           05  CODE            PIC X(6).
"""
TEXT_RECORD_SIZE = 71


def generate_text(num_records: int, seed: int = 100) -> bytes:
    """`num_records` ASCII lines of `TEXT_COPYBOOK` (the display columns
    of `generate_ascii`), trailing blanks cut, ended by LF or CRLF at
    random."""
    rng = np.random.default_rng(seed)
    rec = generate_ascii(num_records, seed=seed)
    cols = np.concatenate([rec[:, :65], rec[:, 76:82]], axis=1)
    assert cols.shape[1] == TEXT_RECORD_SIZE
    crlf = rng.integers(0, 2, size=num_records).astype(bool).tolist()
    return b"".join(line.rstrip(b" ") + (b"\r\n" if cr else b"\n")
                    for line, cr in zip((r.tobytes() for r in cols), crlf))


# exp3 with a big-endian RDW read through the copybook: the header's
# length is a record-length field (`record_length_field="RECORD-LENGTH"`,
# `rdw_adjustment=4`: the field counts the payload, the record is the
# header's 4 bytes longer) in front of exp3's fields
LENGTH_FIELD_EXP3_COPYBOOK = """
        01  COMPANY-DETAILS.
            05  RECORD-LENGTH     PIC 9(4) COMP.
            05  FILLER            PIC X(2).
            05  SEGMENT-ID        PIC X(5).
            05  COMPANY-ID        PIC X(10).
            05  STATIC-DETAILS.
               10  COMPANY-NAME      PIC X(15).
               10  ADDRESS           PIC X(25).
               10  TAXPAYER.
                  15  TAXPAYER-TYPE  PIC X(1).
                  15  TAXPAYER-STR   PIC X(8).
                  15  TAXPAYER-NUM  REDEFINES TAXPAYER-STR
                                     PIC 9(8) COMP.
               10  STRATEGY.
                 15  STRATEGY-DETAIL OCCURS 2000.
                   25  NUM1 PIC 9(7) COMP.
                   25  NUM2 PIC 9(7) COMP-3.
            05  CONTACTS REDEFINES STATIC-DETAILS.
               10  PHONE-NUMBER      PIC X(17).
               10  CONTACT-PERSON    PIC X(28).
"""

# exp3's wide segment with a variable-size strategy table: DETAIL-COUNT
# elements of (COMP, COMP-3), the table the record's last field, so every
# field keeps a static offset
VAR_OCCURS_COPYBOOK = """
        01  COMPANY-DETAILS.
            05  SEGMENT-ID        PIC X(5).
            05  COMPANY-ID        PIC X(10).
            05  COMPANY-NAME      PIC X(15).
            05  ADDRESS           PIC X(25).
            05  TAXPAYER-NUM      PIC 9(8) COMP.
            05  DETAIL-COUNT      PIC 9(4) COMP.
            05  STRATEGY-DETAIL OCCURS 1 TO 2000 TIMES
                                DEPENDING ON DETAIL-COUNT.
               10  NUM1 PIC 9(7) COMP.
               10  NUM2 PIC 9(7) COMP-3.
"""
VAR_OCCURS_HEAD = 61


def generate_var_occurs(num_records: int, seed: int = 100,
                        max_count: int = 2000) -> bytes:
    """`num_records` records of `VAR_OCCURS_COPYBOOK`, each with 1 to
    `max_count` strategy elements, laid end to end (no header: the
    variable-size OCCURS extractor frames them by their count)."""
    rng = np.random.default_rng(seed)
    n = num_records
    counts = rng.integers(1, max_count + 1, size=n)
    head = np.concatenate([
        encode_strings_column(["C"] * n, 5, pad=0x40),
        _digit_bytes(rng.integers(0, 10 ** 10, size=n), 10, 0xF0),
        _letters(rng, n, 15, _ENCODE_LUT),
        _letters(rng, n, 25, _ENCODE_LUT),
        encode_comp_be(rng.integers(0, 10 ** 8, size=n), 4),
        encode_comp_be(counts, 2)], axis=1)
    assert head.shape[1] == VAR_OCCURS_HEAD
    nums = rng.integers(0, 9999999, size=int(counts.sum()))
    detail = np.concatenate([encode_comp_be(nums, 4),
                             encode_comp3_unsigned(nums, 7)], axis=1)
    body = np.split(detail.reshape(-1), np.cumsum(counts * 8)[:-1])
    return b"".join(h.tobytes() + d.tobytes() for h, d in zip(head, body))


# -- the hierarchical (segment-children) stream -----------------------------

_DEPARTMENTS = ["Executive", "Finance", "Operations", "Development",
                "Sales", "Marketing", "Research", "Risk Management",
                "Production", "Logistics", "Transportation", "Planning",
                "Engineering", "Accounting", "Legal", "Compliance",
                "Creative"]
_ROLES = ["CEO", "CFO", "CTO", "COO", "VP of Sales", "VP of Operations",
          "VP of Marketing", "VP of Development", "VP of Legal",
          "VP of Accounting", "director", "managing director",
          "software developer", "software engineer", "big data engineer",
          "devops", "support", "project manager", "scrum master", "sales",
          "copyrightor", "accountant", "analytic", "legal", "assistant",
          "researcher", "specialist"]
_CONTRACT_STATES = ["Unsigned", "Signed", "Progress", "Rejected", "Done",
                    "Archived"]

HIERARCHICAL_COPYBOOK = """
     01  ENTITY.
         05  SEGMENT-ID           PIC 9(1).
         05  COMPANY.
            10  COMPANY-NAME      PIC X(20).
            10  ADDRESS           PIC X(30).
            10  TAXPAYER          PIC 9(9) BINARY.
         05  DEPT REDEFINES COMPANY.
            10  DEPT-NAME         PIC X(22).
            10  EXTENSION         PIC 9(6).
         05  EMPLOYEE REDEFINES COMPANY.
            10  FIRST-NAME        PIC X(16).
            10  LAST-NAME         PIC X(16).
            10  ROLE              PIC X(18).
            10  HOME-ADDRESS      PIC X(40).
            10  PHONE-NUM         PIC X(17).
         05  OFFICE REDEFINES COMPANY.
            10  ADDRESS           PIC X(30).
            10  FLOOR             PIC 9(3).
            10  ROOM-NUMBER       PIC 9(4).
         05  CUSTOMER REDEFINES COMPANY.
            10  CUSTOMER-NAME     PIC X(20).
            10  POSTAL-ADDRESS    PIC X(30).
            10  ZIP               PIC X(10).
         05  CONTACT REDEFINES COMPANY.
            10  FIRST-NAME        PIC X(16).
            10  LAST-NAME         PIC X(16).
            10  PHONE-NUM         PIC X(17).
         05  CONTRACT REDEFINES COMPANY.
            10  CONTRACT-NUMBER   PIC X(15).
            10  STATE             PIC X(8).
            10  DUE-DATE          PIC X(10).
            10  AMOUNT            PIC 9(10)V9(2) COMP-3.
"""

HIERARCHICAL_SEGMENT_MAP = {
    "1": "COMPANY", "2": "DEPT", "3": "EMPLOYEE", "4": "OFFICE",
    "5": "CUSTOMER", "6": "CONTACT", "7": "CONTRACT"}
HIERARCHICAL_PARENT_MAP = {
    "DEPT": "COMPANY", "EMPLOYEE": "DEPT", "OFFICE": "DEPT",
    "CUSTOMER": "COMPANY", "CONTACT": "CUSTOMER", "CONTRACT": "CUSTOMER"}


def generate_hierarchical(num_companies: int, seed: int = 100) -> bytes:
    """Little-endian-RDW hierarchical stream (TestDataGen17Hierarchical):
    company -> departments (employees, offices) + customers (contacts,
    contracts), segment ids 1-7."""
    rng = np.random.default_rng(seed)
    chunks = []

    def phone() -> str:
        return (f"+({rng.integers(1, 921)}) {rng.integers(100, 999)} "
                f"{rng.integers(10, 99)} {rng.integers(10, 99)}")

    def emit(seg: str, body: bytes) -> None:
        payload = ebcdic_encode(seg, 1) + body
        chunks.append(_rdw(len(payload)) + payload)

    def put_contract() -> None:
        amount_type = int(rng.integers(0, 4))
        if amount_type == 0:
            amount = int(rng.integers(0, 89999999)) + 10000
        elif amount_type == 1:
            amount = int(rng.integers(0, 99)) * 100 + 10000
        elif amount_type == 2:
            amount = int(rng.integers(0, 89999)) + 100000
        else:
            amount = int(rng.integers(0, 89999999)) + 10000000
        due = (f"{rng.integers(1990, 2020):04d}-"
               f"{rng.integers(1, 13):02d}-{rng.integers(1, 29):02d}")
        body = (ebcdic_encode(str(rng.integers(0, 1000000)), 15)
                + ebcdic_encode(
                    _CONTRACT_STATES[rng.integers(
                        0, len(_CONTRACT_STATES))], 8)
                + ebcdic_encode(due, 10)
                + encode_comp3_unsigned(
                    np.asarray([amount]), 12).tobytes())
        emit("7", body)

    def put_customer() -> None:
        body = (ebcdic_encode(
                    _COMPANIES[rng.integers(0, len(_COMPANIES))], 20)
                + ebcdic_encode(f"{rng.integers(1, 500)} Main Street", 30)
                + ebcdic_encode(
                    str(rng.integers(100000000, 999999999)), 10))
        emit("5", body)
        n_contacts, n_contracts = (int(rng.integers(0, 3)),
                                   int(rng.integers(0, 5)))
        for _ in range(n_contacts):
            body = (ebcdic_encode(
                        _EXP1_NAMES[rng.integers(0, len(_EXP1_NAMES))], 16)
                    + ebcdic_encode(
                        _LAST[rng.integers(0, len(_LAST))], 16)
                    + ebcdic_encode(phone(), 17))
            emit("6", body)
        for _ in range(n_contracts):
            put_contract()

    def put_department() -> None:
        body = (ebcdic_encode(
                    _DEPARTMENTS[rng.integers(0, len(_DEPARTMENTS))], 22)
                + encode_display_unsigned(
                    np.asarray([rng.integers(100000, 999999)]),
                    6).tobytes())
        emit("2", body)
        n_employees, n_offices = (int(rng.integers(0, 7)),
                                  int(rng.integers(0, 4)))
        for _ in range(n_employees):
            body = (ebcdic_encode(
                        _EXP1_NAMES[rng.integers(0, len(_EXP1_NAMES))], 16)
                    + ebcdic_encode(
                        _LAST[rng.integers(0, len(_LAST))], 16)
                    + ebcdic_encode(
                        _ROLES[rng.integers(0, len(_ROLES))], 18)
                    + ebcdic_encode(
                        f"{rng.integers(1, 500)} Main Street", 40)
                    + ebcdic_encode(phone(), 17))
            emit("3", body)
        for _ in range(n_offices):
            body = (ebcdic_encode(
                        f"{rng.integers(1, 500)} Main Street", 30)
                    + encode_display_unsigned(
                        np.asarray([rng.integers(0, 120)]), 3).tobytes()
                    + encode_display_unsigned(
                        np.asarray([rng.integers(0, 3000)]), 4).tobytes())
            emit("4", body)

    for _ in range(num_companies):
        body = (ebcdic_encode(
                    _COMPANIES[rng.integers(0, len(_COMPANIES))], 20)
                + ebcdic_encode(f"{rng.integers(1, 500)} Main Street", 30)
                + int(rng.integers(100000000, 999999999)).to_bytes(
                    4, "big"))
        emit("1", body)
        n_departments, n_customers = (int(rng.integers(0, 5)),
                                      int(rng.integers(0, 5)))
        for _ in range(n_departments):
            put_department()
        for _ in range(n_customers):
            put_customer()
    return b"".join(chunks)


# -- a variable-size OCCURS layout that shifts a later field ----------------

# a DEPENDING ON table followed by a trailer: the trailer's offset depends
# on the record's count, so no static columnar plan exists and the JAX
# package decodes such records on the host, row by row
DYNAMIC_OCCURS_COPYBOOK = """
        01  ORDER-RECORD.
            05  ORDER-ID          PIC X(8).
            05  CUSTOMER          PIC X(12).
            05  ITEM-COUNT        PIC 9(2) COMP.
            05  ITEMS OCCURS 1 TO 20 TIMES DEPENDING ON ITEM-COUNT.
               10  ITEM-ID        PIC 9(5) COMP-3.
               10  AMOUNT         PIC S9(7)V99 COMP-3.
            05  TRAILER           PIC X(6).
"""


def generate_dynamic_occurs(num_records: int, seed: int = 100,
                            max_count: int = 20) -> bytes:
    """`num_records` records of `DYNAMIC_OCCURS_COPYBOOK`, each with 1 to
    `max_count` items and the trailer after them, laid end to end (no
    header: the variable-size OCCURS extractor frames them by their
    count)."""
    rng = np.random.default_rng(seed)
    n = num_records
    counts = rng.integers(1, max_count + 1, size=n)
    head = np.concatenate([
        _digit_bytes(rng.integers(0, 10 ** 8, size=n), 8, 0xF0),
        _letters(rng, n, 12, _ENCODE_LUT),
        encode_comp_be(counts, 2)], axis=1)
    m = int(counts.sum())
    amounts = rng.integers(0, 10 ** 9, size=m)
    items = np.concatenate([
        encode_comp3_unsigned(rng.integers(0, 10 ** 5, size=m), 5),
        _comp3(amounts, 9, rng.random(m) < 0.3)], axis=1)
    body = np.split(items.reshape(-1), np.cumsum(counts * 8)[:-1])
    tail = _letters(rng, n, 6, _ENCODE_LUT)
    return b"".join(h.tobytes() + d.tobytes() + t.tobytes()
                    for h, d, t in zip(head, body, tail))


TRANSDATA_COPYBOOK = """
        01  TRANSDATA.
            05  CURRENCY          PIC X(3).
            05  SIGNATURE         PIC X(8).
            05  COMPANY-NAME      PIC X(15).
            05  COMPANY-ID        PIC X(10).
            05  WEALTH-QFY        PIC 9(1).
            05  AMOUNT            PIC S9(09)V99  BINARY.
"""
TRANSDATA_RECORD_SIZE = 45
_CURRENCIES = ["ZAR", "USD", "EUR", "GBP", "CAD", "CHF", "CZK", "ZWL"]


def _encoded(values, width: int) -> np.ndarray:
    """[len(values), width] EBCDIC bytes of ASCII strings, NUL-padded."""
    return np.stack([np.frombuffer(ebcdic_encode(v, width), dtype=np.uint8)
                     for v in values])


def generate_transactions(num_records: int, seed: int = 100) -> np.ndarray:
    """TRANSDATA fixed-length records (45 bytes each), flat uint8: a
    currency, a fixed signature, a company name and a 10-digit id, the
    wealth flag (37% '1') and AMOUNT in hundredths, 80% under 1,000,
    15% under 100,000, 5% under 10,000,000, cents only under 10,000
    (TestDataGen1Transactions.scala:68-79)."""
    rng = np.random.default_rng(seed)
    n = num_records
    out = np.zeros((n, TRANSDATA_RECORD_SIZE), dtype=np.uint8)
    out[:, 0:3] = _encoded(_CURRENCIES, 3)[
        rng.integers(0, len(_CURRENCIES), n)]
    out[:, 3:11] = _encoded(["S9276511"], 8)
    out[:, 11:26] = _encoded(_COMPANIES, 15)[
        rng.integers(0, len(_COMPANIES), n)]
    out[:, 26:36] = _digit_bytes(rng.integers(0, 10 ** 9, n), 10, 0xF0)
    out[:, 36] = np.where(rng.integers(0, 100, n) < 37, 0xF1, 0xF0)
    tp = rng.integers(0, 100, n)
    int_part = np.where(tp < 80, rng.integers(0, 1000, n),
                        np.where(tp < 95, rng.integers(0, 100000, n),
                                 rng.integers(0, 10000000, n)))
    frac = np.where(int_part < 10000, rng.integers(0, 100, n), 0)
    amount = (int_part * 100 + frac).astype(">i8")
    out[:, 37:45] = amount.view(np.uint8).reshape(n, 8)
    return out.reshape(-1)
