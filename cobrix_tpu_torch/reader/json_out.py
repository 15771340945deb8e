"""Row -> JSON-lines rendering compatible with Spark's `df.toJSON`.

Used to verify byte-for-byte parity against the reference golden files
(data/testN_expected/testN.txt which were produced by Spark toJSON):
null fields omitted, decimals printed at the declared scale, floats with
Java shortest-round-trip formatting, binary as base64.

Port copy of ``cobrix_tpu.reader.json_out``, unchanged.
"""
from __future__ import annotations

import base64
import decimal as _decimal
import json
import re
import math
import struct
from typing import Iterable, List, Sequence

from .schema import ArrayType, Field, SimpleType, StructType

PyDecimal = _decimal.Decimal


def _java_double_str(v: float) -> str:
    """Java Double.toString semantics: decimal notation for 1e-3 <= |v| < 1e7,
    otherwise scientific 'dE+/-x'; always with a fractional part."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    if v == 0:
        return "-0.0" if math.copysign(1.0, v) < 0 else "0.0"
    a = abs(v)
    s = repr(v)  # shortest round-trip
    if 1e-3 <= a < 1e7:
        if "e" in s or "E" in s:
            s = f"{v:.17g}"
            # strip to shortest that round-trips
            for prec in range(1, 18):
                cand = f"{v:.{prec}g}"
                if float(cand) == v:
                    s = cand
                    break
        if "." not in s:
            s += ".0"
        return s
    # scientific
    mantissa, _, exp = s.partition("e")
    if not exp:
        # python chose decimal notation; convert exactly via the digit string
        # (float division by 10**e would double-round near mantissa 10.0)
        sign, digits, dexp = PyDecimal(s).as_tuple()
        e = dexp + len(digits) - 1
        dig = "".join(map(str, digits)).rstrip("0") or "0"
        m_str = ("-" if sign else "") + dig[0] + \
            ("." + dig[1:] if len(dig) > 1 else ".0")
        return f"{m_str}E{e}"
    if "." not in mantissa:
        mantissa += ".0"
    e = int(exp)
    return f"{mantissa}E{e}"


def _java_float_str(v: float) -> str:
    """Java Float.toString: shortest decimal that round-trips at float32."""
    f32 = struct.unpack(">f", struct.pack(">f", v))[0]
    if f32 != f32:
        return "NaN"
    if f32 in (float("inf"), float("-inf")):
        return "Infinity" if f32 > 0 else "-Infinity"
    if f32 == 0:
        return "-0.0" if math.copysign(1.0, f32) < 0 else "0.0"
    for prec in range(1, 10):
        cand = f"{f32:.{prec}g}"
        if struct.unpack(">f", struct.pack(">f", float(cand)))[0] == f32:
            break
    else:
        cand = repr(f32)
    a = abs(f32)
    if 1e-3 <= a < 1e7:
        if "e" in cand or "E" in cand:
            e = int(cand.lower().partition("e")[2])
            m = cand.lower().partition("e")[0]
            val = PyDecimal(m).scaleb(e)
            cand = format(val.normalize(), "f")
        if "." not in cand:
            cand += ".0"
        return cand
    mantissa, _, exp = cand.lower().partition("e")
    if not exp:
        sign, digits, dexp = PyDecimal(cand).as_tuple()
        e = dexp + len(digits) - 1
        dig = "".join(map(str, digits)).rstrip("0") or "0"
        mantissa = ("-" if sign else "") + dig[0] + \
            ("." + dig[1:] if len(dig) > 1 else "")
        exp = str(e)
    if "." not in mantissa:
        mantissa += ".0"
    return f"{mantissa}E{int(exp)}"


class _RawNum:
    """Marker so json.dumps emits a preformatted numeric literal."""

    def __init__(self, text: str):
        self.text = text


def _render_value(value, dtype):
    """Convert a decoded value to a JSON-compatible object (cast semantics of
    Spark: decimal overflow -> null)."""
    if value is None:
        return None
    if isinstance(dtype, StructType):
        return _render_struct(value, dtype)
    if isinstance(dtype, ArrayType):
        return [_render_value(v, dtype.element) for v in value]
    name = dtype.name if isinstance(dtype, SimpleType) else None
    if name == "string":
        if isinstance(value, bytes):
            return value.decode("latin-1")
        return str(value)
    if name == "binary":
        return base64.b64encode(value if isinstance(value, bytes)
                                else bytes(value)).decode("ascii")
    if name in ("integer", "long"):
        try:
            return int(value)
        except (TypeError, ValueError):
            return None
    if name == "float":
        return _RawNum(_java_float_str(float(value)))
    if name == "double":
        return _RawNum(_java_double_str(float(value)))
    if name and name.startswith("decimal("):
        p, s = name[8:-1].split(",")
        p, s = int(p), int(s)
        try:
            d = PyDecimal(value)
        except (TypeError, ValueError, _decimal.InvalidOperation):
            return None
        try:
            # the default 28-digit context breaks COBOL's 38-digit range
            with _decimal.localcontext() as ctx:
                ctx.prec = 60
                q = d.quantize(PyDecimal(1).scaleb(-s),
                               rounding=_decimal.ROUND_HALF_UP)
        except _decimal.InvalidOperation:
            return None
        _, digits, exp = q.as_tuple()
        # overflow check: number of integral digits must fit precision -
        # scale (zero for pure fractions like 0.3050393 in decimal(7,7))
        int_digits = max(len(digits) + exp, 0)
        if int_digits > p - s:
            return None
        return _RawNum(format(q, "f"))
    raise TypeError(f"Cannot render {value!r} as {dtype!r}")


def _render_struct(values: Sequence[object], schema: StructType) -> dict:
    out = {}
    for field, value in zip(schema.fields, values):
        rendered = _render_value(value, field.dtype)
        if rendered is not None:
            out[field.name] = rendered
    return out


_STR_ESCAPES = {'"': '\\"', "\\": "\\\\", "\n": "\\n", "\r": "\\r",
                "\t": "\\t", "\b": "\\b", "\f": "\\f"}
_NEEDS_ESCAPE = re.compile(r'[\x00-\x1f"\\]')


def _escape_char(m) -> str:
    ch = m.group(0)
    esc = _STR_ESCAPES.get(ch)
    return esc if esc is not None else "\\u%04X" % ord(ch)


def _json_str(s: str) -> str:
    """Jackson-style string escaping: control chars as uppercase \\u00XX
    (Python's json emits lowercase hex, which breaks byte-for-byte golden
    parity on non-printable data). Unescaped strings — the vast majority —
    take the no-copy fast path."""
    if _NEEDS_ESCAPE.search(s) is None:
        return f'"{s}"'
    return '"' + _NEEDS_ESCAPE.sub(_escape_char, s) + '"'


def _dump(obj) -> str:
    if isinstance(obj, _RawNum):
        return obj.text
    if isinstance(obj, dict):
        return "{" + ",".join(f"{_json_str(k)}:{_dump(v)}"
                              for k, v in obj.items()) + "}"
    if isinstance(obj, list):
        return "[" + ",".join(_dump(v) for v in obj) + "]"
    if isinstance(obj, str):
        return _json_str(obj)
    return json.dumps(obj, ensure_ascii=False)


def row_to_json(row: Sequence[object], schema: StructType) -> str:
    return _dump(_render_struct(row, schema))


def rows_to_json(rows: Iterable[Sequence[object]], schema: StructType) -> List[str]:
    return [row_to_json(r, schema) for r in rows]
