"""Scalar field encoders — the exact inverses of `ops.scalar_decoders`.

Every encoder here is derived from the corresponding decoder's semantics
(the parity oracle pinned by the reference goldens), so that for any value
`v` a field type can represent, `decode_field(dtype, encode_field(dtype, v))
== v`, and re-encoding the decoded value reproduces the same bytes
(encode is deterministic — decode→encode→decode is a byte-stable fixed
point after one round).

Known inversion gaps:

* COMP-1 under `FloatingPointFormat.IBM`: the reference decoder masks the
  exponent with the *sign* mask (FloatingPointDecoders.scala:82, replicated
  verbatim in `decode_ibm_single`), so no nonzero standard-encoded IBM
  single decodes to its own value. `encode_field` writes TRUE IBM bits
  (correct for real mainframes); round-trip identity for COMP-1 holds only
  under the IEEE754/IEEE754_LE formats (or for 0.0).
* Values a type cannot represent (None in a binary/float field, digits
  beyond the PIC precision, characters outside the code page) raise
  `EncodeError` rather than guessing.

Closed former gaps, now invariants the fuzzer covers unpinned: blank
fill is the spelling of None for EVERY display numeric — integrals,
explicit-dot decimals, and implied-point V-decimals alike — and the
decoders return null (never 0.00) for digit-less content, so
encode(None)→decode round-trips. Duplicate-glyph code pages invert
deterministically lowest-byte-wins (space always canonicalizes to
0x40), pinned end to end by rtcheck's P3 alias matrix.
"""
from __future__ import annotations

import decimal as _decimal
import math
import struct
from typing import Optional

from ..copybook.datatypes import (
    AlphaNumeric,
    Decimal,
    EBCDIC_DOT,
    EBCDIC_MINUS,
    EBCDIC_PLUS,
    EBCDIC_SPACE,
    Encoding,
    FloatingPointFormat,
    Integral,
    SignPosition,
    Usage,
    binary_size_bytes,
)
from ..encoding.codepages import get_code_page_encode_table

PyDecimal = _decimal.Decimal


class EncodeError(ValueError):
    """A value the target COBOL type cannot represent byte-for-byte."""


# ---------------------------------------------------------------------------
# mantissa extraction: value -> (integer mantissa, digit count available)
# ---------------------------------------------------------------------------

def _as_decimal(value) -> PyDecimal:
    if isinstance(value, PyDecimal):
        return value
    if isinstance(value, int):
        return PyDecimal(value)
    if isinstance(value, float):
        # repr round-trip: the decoded value came from a decimal string
        return PyDecimal(repr(value))
    if isinstance(value, str):
        return PyDecimal(value)
    raise EncodeError(f"Cannot encode {type(value).__name__} as a number")


def _exact_int(d: PyDecimal, what: str) -> int:
    if d != d.to_integral_value():
        raise EncodeError(f"{what}: value {d} is not representable "
                          f"(non-integral mantissa)")
    return int(d)


def scaled_mantissa(dtype, value, ndigits: int) -> int:
    """Integer mantissa whose `ndigits`-digit rendering decodes back to
    `value` under (scale, scale_factor) — the inverse of
    `add_decimal_point`/`decode_bcd_string` scaling."""
    d = _as_decimal(value)
    if isinstance(dtype, Integral):
        return _exact_int(d, dtype.pic)
    scale, sf = dtype.scale, dtype.scale_factor
    if sf == 0:
        return _exact_int(d.scaleb(scale), dtype.pic)
    if sf > 0:
        return _exact_int(d.scaleb(-sf), dtype.pic)
    # scale factor < 0: decoded value is 0.<|sf| zeros><digits>
    return _exact_int(d.scaleb(-sf + ndigits), dtype.pic)


def _binary_mantissa(dtype, value) -> int:
    """Binary fields render the mantissa with no leading zeros, so a
    negative scale factor needs the digit count solved for."""
    d = _as_decimal(value)
    if isinstance(dtype, Integral):
        return _exact_int(d, dtype.pic)
    scale, sf = dtype.scale, dtype.scale_factor
    if sf == 0:
        return _exact_int(d.scaleb(scale), dtype.pic)
    if sf > 0:
        return _exact_int(d.scaleb(-sf), dtype.pic)
    if d == 0:
        return 0
    for nd in range(1, 40):
        m = d.scaleb(-sf + nd)
        if m == m.to_integral_value() and len(str(abs(int(m)))) == nd:
            return int(m)
    raise EncodeError(f"{dtype.pic}: {d} has no scale_factor={sf} "
                      f"binary mantissa")


# ---------------------------------------------------------------------------
# zoned (DISPLAY) numerics
# ---------------------------------------------------------------------------

def _overpunch_side(dtype) -> str:
    """'left'/'right' overpunch digit, or 'separate' — from the PIC the
    sign clause was folded into (pic.apply_sign prepends/appends the sign
    char; a plain S picture overpunches the TRAILING digit, the COBOL
    default)."""
    if dtype.is_sign_separate:
        return "separate"
    pic = dtype.pic or ""
    if pic[:1] in "+-":
        return "left"
    return "right"


def encode_display_number(dtype, value, ascii_mode: bool = False) -> bytes:
    """Inverse of decode_ebcdic_number/decode_ascii_number (+ the
    add_decimal_point scaling applied by decode_field)."""
    size = binary_size_bytes(dtype)
    if value is None:
        return (b" " if ascii_mode else bytes([EBCDIC_SPACE])) * size
    precision = dtype.precision
    explicit_dot = isinstance(dtype, Decimal) and dtype.explicit_decimal
    m = scaled_mantissa(dtype, value, precision)
    if not dtype.is_signed and m < 0:
        raise EncodeError(f"{dtype.pic}: negative value in unsigned field")
    digits = str(abs(m))
    if len(digits) > precision:
        raise EncodeError(f"{dtype.pic}: {value} needs {len(digits)} digits, "
                          f"PIC has {precision}")
    digits = digits.zfill(precision)
    if explicit_dot:
        scale = dtype.scale
        digits = digits[:precision - scale] + "." + digits[precision - scale:]

    if ascii_mode:
        return _ascii_display(dtype, m, digits, size)
    return _ebcdic_display(dtype, m, digits, size)


def _ebcdic_display(dtype, m: int, digits: str, size: int) -> bytes:
    body = bytearray()
    for ch in digits:
        body.append(EBCDIC_DOT if ch == "." else 0xF0 + ord(ch) - 0x30)
    if not dtype.is_signed:
        out = bytes(body)
    else:
        side = _overpunch_side(dtype)
        if side == "separate":
            sign_byte = EBCDIC_MINUS if m < 0 else EBCDIC_PLUS
            if dtype.sign_position is SignPosition.LEFT:
                out = bytes([sign_byte]) + bytes(body)
            else:
                out = bytes(body) + bytes([sign_byte])
        else:
            zone = 0xD0 if m < 0 else 0xC0
            idx = 0 if side == "left" else len(body) - 1
            # overpunch lands on a digit byte, never the explicit dot
            if body[idx] == EBCDIC_DOT:
                raise EncodeError(f"{dtype.pic}: sign overpunch on the "
                                  f"decimal point")
            body[idx] = zone + (body[idx] - 0xF0)
            out = bytes(body)
    if len(out) != size:
        raise EncodeError(f"{dtype.pic}: encoded {len(out)} bytes, "
                          f"field is {size}")
    return out


def _ascii_display(dtype, m: int, digits: str, size: int) -> bytes:
    if not dtype.is_signed:
        out = digits.encode("ascii")
    elif dtype.is_sign_separate:
        sign = "-" if m < 0 else "+"
        if dtype.sign_position is SignPosition.LEFT:
            out = (sign + digits).encode("ascii")
        else:
            out = (digits + sign).encode("ascii")
    elif m < 0:
        # no ASCII overpunch exists: the sign char must displace the
        # leading (zero-filled) digit to keep the field width
        if digits[0] != "0":
            raise EncodeError(f"{dtype.pic}: negative ASCII DISPLAY needs "
                              f"a spare leading digit for the '-'")
        out = ("-" + digits[1:]).encode("ascii")
    else:
        out = digits.encode("ascii")
    if len(out) != size:
        raise EncodeError(f"{dtype.pic}: encoded {len(out)} bytes, "
                          f"field is {size}")
    return out


# ---------------------------------------------------------------------------
# packed BCD (COMP-3)
# ---------------------------------------------------------------------------

def encode_bcd(dtype, value) -> bytes:
    """Inverse of decode_bcd_integral / decode_bcd_string."""
    size = binary_size_bytes(dtype)
    if value is None:
        # 0x40 fill: every decoder rejects the 0x0 terminal sign nibble
        return bytes([EBCDIC_SPACE]) * size
    nslots = size * 2 - 1
    m = scaled_mantissa(dtype, value, nslots)
    if not dtype.is_signed and m < 0:
        raise EncodeError(f"{dtype.pic}: negative value in unsigned field")
    digits = str(abs(m))
    if len(digits) > nslots:
        raise EncodeError(f"{dtype.pic}: {value} needs {len(digits)} BCD "
                          f"digits, field holds {nslots}")
    digits = digits.zfill(nslots)
    sign_nibble = 0x0D if m < 0 else (0x0C if dtype.is_signed else 0x0F)
    nibbles = [ord(c) - 0x30 for c in digits] + [sign_nibble]
    return bytes((nibbles[i] << 4) | nibbles[i + 1]
                 for i in range(0, len(nibbles), 2))


# ---------------------------------------------------------------------------
# binary (COMP/COMP-4/COMP-5/COMP-9)
# ---------------------------------------------------------------------------

def encode_binary(dtype, value) -> bytes:
    size = binary_size_bytes(dtype)
    if value is None:
        raise EncodeError(f"{dtype.pic}: a binary field cannot encode None")
    big_endian = dtype.usage is not Usage.COMP9
    m = _binary_mantissa(dtype, value)
    signed = dtype.is_signed
    if not signed and m < 0:
        raise EncodeError(f"{dtype.pic}: negative value in unsigned field")
    try:
        out = m.to_bytes(size, "big" if big_endian else "little",
                         signed=signed)
    except OverflowError:
        raise EncodeError(f"{dtype.pic}: {value} overflows {size}-byte "
                          f"binary") from None
    if not signed and size in (4, 8) and m > (1 << (size * 8 - 1)) - 1:
        # the reference decoder returns None for these (unsigned
        # negative-overflow guard) — refuse to write undecodable bytes
        raise EncodeError(f"{dtype.pic}: {value} is in the unsigned "
                          f"overflow range the decoder rejects")
    return out


# ---------------------------------------------------------------------------
# floating point
# ---------------------------------------------------------------------------

def encode_ieee754_single(value: float, big_endian: bool = True) -> bytes:
    return struct.pack(">f" if big_endian else "<f", value)


def encode_ieee754_double(value: float, big_endian: bool = True) -> bytes:
    return struct.pack(">d" if big_endian else "<d", value)


def _encode_ibm_hex(value: float, frac_bits: int, width: int) -> bytes:
    """True IBM hexadecimal float: sign bit, excess-64 base-16 exponent,
    `frac_bits`-bit fraction in [1/16, 1)."""
    if value == 0.0:
        return b"\x00" * width
    sign = 0x80 if value < 0 else 0x00
    mant, e2 = math.frexp(abs(value))        # abs(value) = mant * 2**e2
    e16 = math.ceil(e2 / 4)
    frac = mant * 2.0 ** (e2 - 4 * e16)      # in [1/16, 1)
    f_int = int(round(frac * (1 << frac_bits)))
    if f_int >= (1 << frac_bits):            # rounding carried a hex digit
        f_int >>= 4
        e16 += 1
    exponent = 64 + e16
    if not 0 <= exponent <= 127:
        raise EncodeError(f"{value} overflows the IBM hexfloat exponent")
    return bytes([sign | exponent]) + f_int.to_bytes(width - 1, "big")


def encode_ibm_single(value: float) -> bytes:
    return _encode_ibm_hex(value, 24, 4)


def encode_ibm_double(value: float) -> bytes:
    return _encode_ibm_hex(value, 56, 8)


def _encode_float(dtype, value, fmt: FloatingPointFormat) -> bytes:
    if value is None:
        raise EncodeError(f"{dtype.pic}: a float field cannot encode None")
    v = float(value)
    single = dtype.usage is Usage.COMP1
    if fmt is FloatingPointFormat.IBM:
        return encode_ibm_single(v) if single else encode_ibm_double(v)
    if fmt is FloatingPointFormat.IBM_LE:
        raw = encode_ibm_single(v) if single else encode_ibm_double(v)
        return raw[::-1]
    big = fmt is FloatingPointFormat.IEEE754
    return (encode_ieee754_single(v, big) if single
            else encode_ieee754_double(v, big))


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def encode_string(dtype: AlphaNumeric, value, *,
                  ebcdic_code_page: str = "common",
                  ascii_charset: str = "us-ascii",
                  is_utf16_big_endian: bool = True) -> bytes:
    enc = dtype.enc or Encoding.EBCDIC
    length = dtype.length
    if enc is Encoding.RAW:
        data = bytes(value or b"")
        pad = b"\x00"
    elif enc is Encoding.HEX:
        data = bytes.fromhex(value or "")
        pad = b"\x00"
    elif enc is Encoding.EBCDIC:
        table = get_code_page_encode_table(ebcdic_code_page)
        out = bytearray()
        for ch in (value or ""):
            b = table.get(ch)
            if b is None:
                raise EncodeError(
                    f"char {ch!r} has no EBCDIC byte in code page "
                    f"'{ebcdic_code_page}'")
            out.append(b)
        data, pad = bytes(out), bytes([EBCDIC_SPACE])
    elif enc is Encoding.ASCII:
        charset = ("ascii" if ascii_charset.lower().replace("_", "-")
                   in ("us-ascii", "ascii") else ascii_charset)
        try:
            data = (value or "").encode(charset)
        except (UnicodeEncodeError, LookupError) as e:
            raise EncodeError(str(e)) from e
        pad = b" "
    elif enc is Encoding.UTF16:
        codec = "utf-16-be" if is_utf16_big_endian else "utf-16-le"
        data = (value or "").encode(codec)
        pad = " ".encode(codec)
    else:
        raise EncodeError(f"Unknown encoding {enc}")
    if len(data) > length:
        raise EncodeError(f"{value!r} is {len(data)} bytes, PIC holds "
                          f"{length}")
    npad, rem = divmod(length - len(data), len(pad))
    return data + pad * npad + pad[:rem]


# ---------------------------------------------------------------------------
# dispatcher (inverse of decode_field)
# ---------------------------------------------------------------------------

def encode_field(dtype, value, *,
                 ebcdic_code_page: str = "common",
                 ascii_charset: str = "us-ascii",
                 is_utf16_big_endian: bool = True,
                 floating_point_format: FloatingPointFormat =
                 FloatingPointFormat.IBM) -> bytes:
    """Encode one field value to exactly `binary_size_bytes(dtype)` bytes
    such that `decode_field` recovers the value (see module docstring for
    the named gaps)."""
    if isinstance(dtype, AlphaNumeric):
        return encode_string(dtype, value,
                             ebcdic_code_page=ebcdic_code_page,
                             ascii_charset=ascii_charset,
                             is_utf16_big_endian=is_utf16_big_endian)
    if not isinstance(dtype, (Integral, Decimal)):
        raise TypeError(f"Unknown COBOL type {dtype!r}")
    usage = dtype.usage
    if usage is None:
        ascii_mode = (dtype.enc or Encoding.EBCDIC) is not Encoding.EBCDIC
        return encode_display_number(dtype, value, ascii_mode=ascii_mode)
    if usage in (Usage.COMP1, Usage.COMP2):
        return _encode_float(dtype, value, floating_point_format)
    if usage is Usage.COMP3:
        return encode_bcd(dtype, value)
    if usage in (Usage.COMP4, Usage.COMP5, Usage.COMP9):
        return encode_binary(dtype, value)
    raise EncodeError(f"Unknown usage {usage}")
