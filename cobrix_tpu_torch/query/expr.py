"""Typed filter-expression AST with a string grammar and a JSON wire
form.

The AST is deliberately tiny — field refs, literals, the six
comparisons, AND/OR/NOT, ``isin`` and a segment-id match — because
everything in it must be *pushable*: each node knows how to evaluate
against decoded Arrow arrays (pushdown.py) and how to render as a
pyarrow compute expression (the dataset scan surface). Anything a
caller cannot say here they can still do post-hoc on the Arrow table.

Three interchangeable spellings, all accepted by the ``filter=``
option:

* builder:   ``col("SEGMENT_ID") == "C"``, ``col("AMOUNT") > 100``,
             ``col("ID").isin([1, 2]) & ~(col("NAME") == "X")``,
             ``segment_is("C", "P")``
* grammar:   ``SEGMENT_ID == 'C' and (AMOUNT > 100 or ID in (1, 2))``
             (``str(expr)`` round-trips through ``parse_filter``)
* JSON wire: ``{"op": "and", "args": [...]}`` — what
             ``ReaderParameters.filter`` carries, what resume-token and
             chunk-plan fingerprints hash, and what crosses the serve
             'R' frame unchanged.

Null semantics are SQL/Kleene (pyarrow's): a comparison against a null
value is null, AND/OR propagate three-valued logic, and a row whose
final predicate is null is DROPPED — identical to post-hoc
``table.filter(...)``, which parity tests pin.

Port copy of ``cobrix_tpu.query.expr``, unchanged: the canonical
strings and the wire JSON are the JAX package's, byte for byte, since
filters cross process and package boundaries in that form.
"""
from __future__ import annotations

import json
import re
from typing import Iterable, List, Optional, Sequence, Tuple, Union

_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_OP_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "==": "==", "!=": "!="}

LiteralValue = Union[str, int, float, bool, None]


class Expr:
    """Base filter-expression node."""

    def fields(self) -> List[str]:
        """Referenced field names, in first-appearance order, deduped."""
        out: List[str] = []
        self._collect_fields(out)
        seen = set()
        uniq = []
        for name in out:
            key = name.upper()
            if key not in seen:
                seen.add(key)
                uniq.append(name)
        return uniq

    def _collect_fields(self, out: List[str]) -> None:
        raise NotImplementedError

    def to_wire(self) -> dict:
        raise NotImplementedError

    def canonical(self) -> str:
        """Deterministic wire JSON — what fingerprints hash and what
        ``ReaderParameters.filter`` stores."""
        return json.dumps(self.to_wire(), sort_keys=True,
                          separators=(",", ":"))

    # -- combinators -------------------------------------------------------

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __bool__(self):
        raise TypeError(
            "filter expressions are combined with & | ~ (bitwise), not "
            "'and'/'or'/'not' — Python cannot overload the keywords")

    def __repr__(self) -> str:
        return f"<query.Expr {self}>"

    def to_pyarrow(self):
        """The equivalent ``pyarrow.compute`` dataset expression."""
        raise NotImplementedError


class Field(Expr):
    """A field reference — only meaningful inside a comparison."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        name = str(name).strip()
        if not _NAME_RE.fullmatch(name):
            raise ValueError(f"invalid field name in filter: {name!r}")
        self.name = name

    # comparisons build Comparison nodes
    def __eq__(self, other):  # type: ignore[override]
        return Comparison("==", self.name, other)

    def __ne__(self, other):  # type: ignore[override]
        return Comparison("!=", self.name, other)

    def __lt__(self, other):
        return Comparison("<", self.name, other)

    def __le__(self, other):
        return Comparison("<=", self.name, other)

    def __gt__(self, other):
        return Comparison(">", self.name, other)

    def __ge__(self, other):
        return Comparison(">=", self.name, other)

    def __hash__(self):
        return hash(("field", self.name))

    def isin(self, values: Iterable[LiteralValue]) -> "IsIn":
        return IsIn(self.name, values)

    def _collect_fields(self, out: List[str]) -> None:
        out.append(self.name)

    def __str__(self) -> str:
        return self.name


class Literal(Expr):
    __slots__ = ("value",)

    def __init__(self, value: LiteralValue):
        _check_literal(value)
        self.value = value

    def _collect_fields(self, out: List[str]) -> None:
        pass

    def __str__(self) -> str:
        return _render_literal(self.value)


def _check_literal(value) -> None:
    if value is not None and not isinstance(value, (str, bool, int,
                                                    float)):
        # Decimal literals arrive as str/int/float; keeping the wire
        # form JSON-native keeps every surface (serve frames, tickets,
        # fingerprints) trivially serializable
        raise TypeError(
            f"unsupported filter literal {value!r} (type "
            f"{type(value).__name__}); use str/int/float/bool/None")


def _render_literal(v) -> str:
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    return repr(v)


class Comparison(Expr):
    """``field <op> literal`` (op in ==, !=, <, <=, >, >=)."""

    __slots__ = ("op", "field", "value")

    def __init__(self, op: str, field: str, value: LiteralValue):
        if op not in _CMP_OPS:
            raise ValueError(f"unknown comparison operator {op!r}")
        _check_literal(value)
        if value is None and op not in ("==", "!="):
            raise ValueError(
                "null literals only support == / != (is-null tests)")
        self.op = op
        self.field = Field(field).name
        self.value = value

    def _collect_fields(self, out: List[str]) -> None:
        out.append(self.field)

    def to_wire(self) -> dict:
        return {"op": self.op, "field": self.field, "value": self.value}

    def __str__(self) -> str:
        return f"{self.field} {self.op} {_render_literal(self.value)}"

    def to_pyarrow(self):
        import pyarrow.compute as pc

        f = pc.field(self.field)
        if self.value is None:
            return f.is_null() if self.op == "==" else ~f.is_null()
        return {"==": f.__eq__, "!=": f.__ne__, "<": f.__lt__,
                "<=": f.__le__, ">": f.__gt__,
                ">=": f.__ge__}[self.op](self.value)


class IsIn(Expr):
    """``field in (v1, v2, ...)``."""

    __slots__ = ("field", "values")

    def __init__(self, field: str, values: Iterable[LiteralValue]):
        vals = tuple(values)
        if not vals:
            raise ValueError("isin needs at least one value")
        for v in vals:
            _check_literal(v)
            if v is None:
                raise ValueError("isin values cannot be null")
        self.field = Field(field).name
        self.values = vals

    def _collect_fields(self, out: List[str]) -> None:
        out.append(self.field)

    def to_wire(self) -> dict:
        return {"op": "in", "field": self.field,
                "values": list(self.values)}

    def __str__(self) -> str:
        inner = ", ".join(_render_literal(v) for v in self.values)
        return f"{self.field} in ({inner})"

    def to_pyarrow(self):
        import pyarrow.compute as pc

        return pc.field(self.field).isin(list(self.values))


class SegmentIs(Expr):
    """Match the configured multisegment id field against one or more
    segment ids — the predicate that pushes ALL the way down to raw
    record bytes in the chunk scan (depth 2), before any decode."""

    __slots__ = ("values",)

    def __init__(self, values: Iterable[str]):
        vals = tuple(str(v) for v in values)
        if not vals:
            raise ValueError("segment() needs at least one segment id")
        self.values = vals

    def _collect_fields(self, out: List[str]) -> None:
        pass  # resolved against the multisegment config at bind time

    def to_wire(self) -> dict:
        return {"op": "segment", "values": list(self.values)}

    def __str__(self) -> str:
        inner = ", ".join(_render_literal(v) for v in self.values)
        return f"segment({inner})"

    def to_pyarrow(self):
        raise TypeError(
            "segment() has no pyarrow equivalent (it names the "
            "multisegment id field implicitly); use a comparison on "
            "the segment id field instead")


def _flatten(cls, args: Sequence[Expr]) -> List[Expr]:
    out: List[Expr] = []
    for a in args:
        if isinstance(a, cls):
            out.extend(a.args)
        else:
            out.append(_as_expr(a))
    return out


class And(Expr):
    __slots__ = ("args",)

    def __init__(self, *args: Expr):
        self.args = tuple(_flatten(And, args))
        if len(self.args) < 2:
            raise ValueError("and needs at least two operands")

    def _collect_fields(self, out: List[str]) -> None:
        for a in self.args:
            a._collect_fields(out)

    def to_wire(self) -> dict:
        return {"op": "and", "args": [a.to_wire() for a in self.args]}

    def __str__(self) -> str:
        return "(" + " and ".join(str(a) for a in self.args) + ")"

    def to_pyarrow(self):
        out = self.args[0].to_pyarrow()
        for a in self.args[1:]:
            out = out & a.to_pyarrow()
        return out


class Or(Expr):
    __slots__ = ("args",)

    def __init__(self, *args: Expr):
        self.args = tuple(_flatten(Or, args))
        if len(self.args) < 2:
            raise ValueError("or needs at least two operands")

    def _collect_fields(self, out: List[str]) -> None:
        for a in self.args:
            a._collect_fields(out)

    def to_wire(self) -> dict:
        return {"op": "or", "args": [a.to_wire() for a in self.args]}

    def __str__(self) -> str:
        return "(" + " or ".join(str(a) for a in self.args) + ")"

    def to_pyarrow(self):
        out = self.args[0].to_pyarrow()
        for a in self.args[1:]:
            out = out | a.to_pyarrow()
        return out


class Not(Expr):
    __slots__ = ("arg",)

    def __init__(self, arg: Expr):
        self.arg = _as_expr(arg)

    def _collect_fields(self, out: List[str]) -> None:
        self.arg._collect_fields(out)

    def to_wire(self) -> dict:
        return {"op": "not", "arg": self.arg.to_wire()}

    def __str__(self) -> str:
        return f"not ({self.arg})"

    def to_pyarrow(self):
        return ~self.arg.to_pyarrow()


def _as_expr(x) -> Expr:
    if isinstance(x, Expr):
        if isinstance(x, (Field, Literal)):
            raise TypeError(
                f"{x!r} is not a predicate by itself; compare it "
                "(e.g. col('A') == 1)")
        return x
    raise TypeError(f"expected a filter expression, got {type(x).__name__}")


# -- builders ---------------------------------------------------------------

def col(name: str) -> Field:
    """A field reference: ``col("AMOUNT") > 100``."""
    return Field(name)


def lit(value: LiteralValue) -> Literal:
    return Literal(value)


def segment_is(*values: str) -> SegmentIs:
    """Segment-id match against the configured ``segment_field``."""
    return SegmentIs(values)


# -- wire form --------------------------------------------------------------

def from_wire(obj) -> Expr:
    """JSON wire dict (or its json.dumps string) -> Expr."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    if not isinstance(obj, dict):
        raise ValueError(f"filter wire form must be an object, got "
                         f"{type(obj).__name__}")
    op = obj.get("op")
    try:
        if op in _CMP_OPS:
            # "value": null is an explicit is-null test; an ABSENT key
            # is a malformed object — silently reading it as null would
            # turn a client's dropped key into wrong rows
            if "value" not in obj:
                raise KeyError("value")
            return Comparison(op, obj["field"], obj["value"])
        if op == "in":
            return IsIn(obj["field"], obj["values"])
        if op == "segment":
            return SegmentIs(obj["values"])
        if op == "and":
            return And(*[from_wire(a) for a in obj["args"]])
        if op == "or":
            return Or(*[from_wire(a) for a in obj["args"]])
        if op == "not":
            return Not(from_wire(obj["arg"]))
    except KeyError as exc:
        # structurally incomplete wire JSON (e.g. a buggy serve client)
        # must surface as the option error it is, not a bare KeyError
        raise ValueError(
            f"filter wire object for op {op!r} is missing key "
            f"{exc.args[0]!r}") from exc
    raise ValueError(f"unknown filter op {op!r}")


# -- string grammar ---------------------------------------------------------

_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_\-:.]*")

_TOKEN_RE = re.compile(r"""
    \s*(
        (?P<op><=|>=|==|!=|=|<>|<|>)
      | (?P<lparen>\()
      | (?P<rparen>\))
      | (?P<comma>,)
      | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
      | (?P<name>[A-Za-z_][A-Za-z0-9_\-:.]*)
      | (?P<punct>[{}\[\]])
    )""", re.VERBOSE)

_KEYWORDS = {"and", "or", "not", "in", "true", "false", "null",
             "segment", "is_in", "invert"}


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                if text[pos:].strip():
                    raise ValueError(
                        f"cannot tokenize filter at: {text[pos:]!r}")
                break
            pos = m.end()
            for kind in ("op", "lparen", "rparen", "comma", "str",
                         "num", "name", "punct"):
                v = m.group(kind)
                if v is not None:
                    self.toks.append((kind, v))
                    break
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of filter expression")
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.peek()
        if t is None or t[0] != kind:
            return False
        if value is not None and t[1].lower() != value:
            return False
        self.i += 1
        return True

    def expect(self, kind: str, value: Optional[str] = None) -> str:
        t = self.peek()
        if t is None or t[0] != kind or (
                value is not None and t[1].lower() != value):
            raise ValueError(
                f"expected {value or kind} at "
                f"{' '.join(v for _, v in self.toks[self.i:self.i + 4])!r}")
        self.i += 1
        return t[1]


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


def _parse_value(toks: _Tokens) -> LiteralValue:
    kind, v = toks.next()
    if kind == "str":
        return _unquote(v)
    if kind == "num":
        return float(v) if ("." in v or "e" in v.lower()) else int(v)
    if kind == "name":
        low = v.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        if low == "null":
            return None
        # a bare name here is ambiguous — most likely a FIELD reference
        # (e.g. the repr of a pyarrow field-to-field comparison), and
        # silently reading it as the string literal would return wrong
        # rows; rejecting it makes the dataset scanner take its
        # documented post-hoc fallback instead
        raise ValueError(
            f"expected a literal, got bare name {v!r} (quote string "
            "literals; field-to-field comparisons are not supported)")
    raise ValueError(f"expected a literal, got {v!r}")


def _parse_value_list(toks: _Tokens) -> List[LiteralValue]:
    toks.expect("lparen")
    values = [_parse_value(toks)]
    while toks.accept("comma"):
        values.append(_parse_value(toks))
    toks.expect("rparen")
    return values


def _parse_primary(toks: _Tokens) -> Expr:
    if toks.accept("name", "not") or toks.accept("name", "invert"):
        # `invert(...)`: pyarrow's repr spelling of ~
        return Not(_parse_primary(toks))
    if toks.accept("name", "segment"):
        return SegmentIs(str(v) for v in _parse_value_list(toks))
    t = toks.peek()
    if t is not None and t[0] == "name" and t[1].lower() == "is_in":
        # pyarrow repr: is_in(FIELD, {value_set=type:[v1, v2], ...})
        return _parse_pyarrow_is_in(toks)
    if toks.accept("lparen"):
        e = _parse_or(toks)
        toks.expect("rparen")
        return e
    kind, name = toks.next()
    if kind != "name" or name.lower() in _KEYWORDS:
        raise ValueError(f"expected a field name, got {name!r}")
    t = toks.peek()
    if t is not None and t[0] == "name" and t[1].lower() == "in":
        toks.next()
        return IsIn(name, _parse_value_list(toks))
    op = toks.expect("op")
    op = {"=": "==", "<>": "!="}.get(op, op)
    return Comparison(op, name, _parse_value(toks))


def _parse_pyarrow_is_in(toks: _Tokens) -> Expr:
    """``is_in(FIELD, {value_set=<type>:[v, ...], ...})`` — the repr of
    ``pc.field(F).isin([...])``, so pyarrow expressions round-trip
    through their string form into the pushdown pipeline."""
    toks.expect("name", "is_in")
    toks.expect("lparen")
    field = toks.expect("name")
    # everything between the comma and the matching ')' is the options
    # struct; pull the [...] value list out of the raw token stream
    depth = 1
    values: List[LiteralValue] = []
    saw_list = False
    while True:
        t = toks.next()
        if t[0] == "lparen":
            depth += 1
        elif t[0] == "rparen":
            depth -= 1
            if depth == 0:
                break
        elif t[0] in ("str", "num") and saw_list:
            values.append(
                _unquote(t[1]) if t[0] == "str"
                else (float(t[1]) if "." in t[1] or "e" in t[1].lower()
                      else int(t[1])))
        elif t[0] == "name" and t[1] == "value_set":
            saw_list = True
        elif t[0] == "name" and t[1] == "null_matching_behavior":
            saw_list = False
    if not values:
        raise ValueError("is_in(...) with an empty or unparseable "
                         "value_set")
    return IsIn(field, values)


def _parse_and(toks: _Tokens) -> Expr:
    args = [_parse_primary(toks)]
    while toks.accept("name", "and"):
        args.append(_parse_primary(toks))
    return args[0] if len(args) == 1 else And(*args)


def _parse_or(toks: _Tokens) -> Expr:
    args = [_parse_and(toks)]
    while toks.accept("name", "or"):
        args.append(_parse_and(toks))
    return args[0] if len(args) == 1 else Or(*args)


def parse_filter(text: str) -> Expr:
    """Parse the string grammar (or the JSON wire form) into an Expr.

    Grammar: ``FIELD op literal`` with ``== != < <= > >= = <>``,
    ``FIELD in (v1, v2)``, ``segment('C', 'P')``, ``and``/``or``/
    ``not``, parentheses. String literals quote with ``'`` or ``"``.
    The repr of a pyarrow compute expression over the same operators
    parses too (``(A == "x") and invert(B < 5)``, ``is_in(A, {...})``),
    which is how the dataset scanner lowers pyarrow filters.
    """
    text = text.strip()
    if not text:
        raise ValueError("empty filter expression")
    if text.startswith("{"):
        return from_wire(text)
    toks = _Tokens(text)
    e = _parse_or(toks)
    if toks.peek() is not None:
        rest = " ".join(v for _, v in toks.toks[toks.i:])
        raise ValueError(f"trailing tokens in filter: {rest!r}")
    return e


def normalize_filter(value) -> Optional[str]:
    """Any accepted filter spelling -> the canonical wire JSON string
    (None/'' -> None). The single normalization point: the option
    parser calls this, so ``ReaderParameters.filter`` always holds one
    deterministic form and resume-token/plan fingerprints never see
    two spellings of the same predicate."""
    if value is None:
        return None
    if isinstance(value, Expr):
        return value.canonical()
    text = str(value).strip()
    if not text:
        return None
    return parse_filter(text).canonical()
