"""Random copybook + typed-value generator for round-trip fuzzing.

Port copy of ``cobrix_tpu.testing.genspec``: one seed gives the same
copybook text, options and bodies in both packages. The round-trip
property checker (`testing.rtcheck`) needs three things this module
provides:

* `CopybookSpec.random(rng, ...)` — a random copybook drawn from the
  grammar surface the encode/decode pair supports: DISPLAY numerics in
  every sign flavor (trailing/leading overpunch, leading/trailing
  SEPARATE), implied (V) and explicit (.) decimal points, COMP-3 packed
  (narrow and >18-digit wide), COMP/COMP-9 binaries, IEEE COMP-1/COMP-2,
  PIC X strings, FILLERs, nested groups, static OCCURS, and OCCURS
  DEPENDING ON with a preceding count field;
* `spec.random_body(rng)` — a typed record body in the exact shape
  `CobolData.to_rows()` produces (groups are tuples over non-filler
  children, arrays are lists), drawn from each field's *canonical value
  domain* — the set of values `v` for which decode(encode(v)) == v holds
  by contract (e.g. strings without edge whitespace, floats on a 2^-4
  grid, None only where blank-fill decodes back to None);
* shrinkers — `shrink_spec` / `shrink_body` reduce a failing (copybook,
  record) pair to a minimal reproduction by dropping fields and
  trivializing leaf values while the failure persists.

The one remaining round-trip gap is *excluded from generation* and
documented in `encode.fields`: IBM-format COMP-1 (the
reader's sign-mask-as-exponent quirk means nonzero singles never
round-trip — the fuzzer pins floating_point_format=ieee754). Blank
implied-point DISPLAY decimals now decode to None (so None is in every
DISPLAY decimal's canonical domain), and duplicate-glyph code pages
encode deterministically lowest-byte-wins (raw alias bytes reach one
canonical fixed point after a single decode→encode round — P3 in
`testing.rtcheck` covers that surface).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field as _dc_field, replace
from decimal import Decimal as _Dec
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

# DISPLAY sign flavors: rendered suffix clause, or None = plain S
# (trailing overpunch).
_SIGN_CLAUSES = (None, "SIGN IS LEADING", "SIGN IS LEADING SEPARATE",
                 "SIGN IS TRAILING SEPARATE")


def safe_alphabet(code_page: str = "common") -> str:
    """Characters that survive encode→decode on `code_page` and are
    never touched by the default BOTH trimming policy."""
    from ..encoding.codepages import (get_code_page_encode_table,
                                      get_code_page_table)

    table = get_code_page_table(code_page)
    enc = get_code_page_encode_table(code_page)
    out = []
    for ch in ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "abcdefghijklmnopqrstuvwxyz"
               "0123456789-./,:+*=%&?!"):
        b = enc.get(ch)
        if b is not None and table[b] == ch:
            out.append(ch)
    return "".join(out)


@dataclass
class FieldSpec:
    """One copybook statement (primitive or group) plus its value
    domain. `kind` is one of: display_int, display_dec, comp3_int,
    comp3_dec, binary, float, string, group."""
    name: str
    kind: str
    digits: int = 0            # integer digits (numerics)
    scale: int = 0             # fractional digits (decimals)
    signed: bool = True
    sign_clause: Optional[str] = None   # DISPLAY only
    explicit_dot: bool = False          # DISPLAY decimals only
    usage: Optional[str] = None  # COMP / COMP-9 / COMP-3 / COMP-1 / COMP-2
    length: int = 0            # strings
    is_filler: bool = False
    children: List["FieldSpec"] = _dc_field(default_factory=list)
    occurs: Optional[int] = None        # static OCCURS count
    occurs_min: int = 0                 # ODO lower bound
    depending_on: Optional[str] = None  # ODO: name of the count field
    counts_for: Optional[str] = None    # this field is the dependee of...
    allow_none: bool = False

    # -- rendering --------------------------------------------------------

    def pic(self) -> Optional[str]:
        if self.kind == "group":
            return None
        if self.kind == "string":
            return f"X({self.length})"
        if self.kind == "float":
            return None  # COMP-1/COMP-2 carry no PIC
        s = "S" if self.signed else ""
        p = f"{s}9({self.digits})"
        if self.scale:
            p += ("." if self.explicit_dot else "V") + f"9({self.scale})"
        return p

    def clauses(self) -> str:
        parts = []
        pic = self.pic()
        if pic is not None:
            parts.append(f"PIC {pic}")
        if self.usage:
            parts.append(self.usage)
        if self.sign_clause:
            parts.append(self.sign_clause)
        if self.depending_on:
            parts.append(f"OCCURS {self.occurs_min} TO "
                         f"{self.occurs} TIMES DEPENDING ON "
                         f"{self.depending_on}")
        elif self.occurs:
            parts.append(f"OCCURS {self.occurs} TIMES")
        return " ".join(parts)

    def render(self, lines: List[str], level: int) -> None:
        name = "FILLER" if self.is_filler else self.name
        head = f"           {level:02d}  {name}"
        clauses = self.clauses()
        # fixed-format area B ends at column 72: wrap long clause lists
        # onto continuation lines (the statement runs to the period)
        for word in clauses.split():
            if len(head) + 1 + len(word) > 71:
                lines.append(head)
                head = " " * 15 + word
            else:
                head += ("  " if head.endswith(name) else " ") + word
        lines.append(head + ".")
        for child in self.children:
            child.render(lines, level + 5)

    # -- values -----------------------------------------------------------

    def trivial_value(self):
        """The simplest canonical value (shrink target)."""
        if self.kind == "group":
            return tuple(c.trivial_value() for c in self.children
                         if not c.is_filler)
        if self.kind == "string":
            return ""
        if self.kind == "float":
            return 0.0
        if self.kind in ("display_dec", "comp3_dec"):
            return _Dec(0).scaleb(-self.scale)
        return 0

    def random_value(self, rng: random.Random, alphabet: str):
        if self.allow_none and rng.random() < 0.12:
            return None
        if self.kind == "string":
            n = rng.randint(0, self.length)
            return "".join(rng.choice(alphabet) for _ in range(n))
        if self.kind == "float":
            # exact on the float32 grid AND in IBM hexfloat range
            bound = 2 ** 20 if self.usage == "COMP-1" else 2 ** 40
            return rng.randint(-bound, bound) / 16.0
        if self.kind == "binary":
            from ..copybook.datatypes import (Integral, Usage,
                                              binary_size_bytes)

            nbytes = binary_size_bytes(Integral(
                pic=f"9({self.digits})", precision=self.digits,
                usage=(Usage.COMP9 if self.usage == "COMP-9"
                       else Usage.COMP4)))
            if self.signed:
                cap = min(10 ** self.digits - 1,
                          2 ** (8 * nbytes - 1) - 1)
                return rng.randint(-cap, cap)
            # 4/8-byte unsigned values past the signed max decode to
            # None (reader guard) — stay under it
            cap = min(10 ** self.digits - 1, 2 ** (8 * nbytes - 1) - 1)
            return rng.randint(0, cap)
        lo = -(10 ** self.digits - 1) if self.signed else 0
        hi = 10 ** self.digits - 1
        if self.kind in ("display_int", "comp3_int"):
            return rng.randint(lo, hi)
        if self.kind in ("display_dec", "comp3_dec"):
            m = rng.randint(lo * 10 ** self.scale, hi * 10 ** self.scale)
            return _Dec(m).scaleb(-self.scale)
        raise ValueError(f"no value domain for kind {self.kind!r}")


def _rand_primitive(rng: random.Random, name: str,
                    allow_float: bool) -> FieldSpec:
    kinds = ["display_int", "display_dec", "comp3_int", "comp3_dec",
             "binary", "string", "string"]
    if allow_float:
        kinds.append("float")
    kind = rng.choice(kinds)
    f = FieldSpec(name=name, kind=kind)
    if kind == "string":
        f.length = rng.randint(1, 12)
    elif kind == "float":
        f.usage = rng.choice(["COMP-1", "COMP-2"])
    elif kind == "binary":
        f.digits = rng.choice([2, 4, 6, 9, 12, 18])
        f.signed = rng.random() < 0.7
        f.usage = rng.choice(["COMP", "COMP-9"])
    elif kind in ("comp3_int", "comp3_dec"):
        f.usage = "COMP-3"
        f.digits = rng.choice([1, 3, 7, 11, 17, 21])  # incl. wide plane
        f.signed = rng.random() < 0.7
        if kind == "comp3_dec":
            f.scale = rng.randint(1, 4)
            f.digits = max(1, f.digits - f.scale)
        f.allow_none = rng.random() < 0.5
    else:  # display
        f.digits = rng.randint(1, 12)
        f.signed = rng.random() < 0.7
        if f.signed:
            f.sign_clause = rng.choice(_SIGN_CLAUSES)
        if kind == "display_dec":
            f.scale = rng.randint(1, 4)
            f.explicit_dot = rng.random() < 0.4
            # blank fill decodes back to None for implied-point AND
            # explicit-point decimals alike, so None is canonical on both
            f.allow_none = rng.random() < 0.5
        else:
            f.allow_none = rng.random() < 0.5
    return f


@dataclass
class CopybookSpec:
    """A generated copybook: root `01 REC` group over `fields`."""
    fields: List[FieldSpec]
    code_page: str = "common"
    record_name: str = "REC"

    # -- introspection -----------------------------------------------------

    def walk(self) -> Iterator[FieldSpec]:
        def rec(fs):
            for f in fs:
                yield f
                yield from rec(f.children)
        yield from rec(self.fields)

    @property
    def has_depending(self) -> bool:
        return any(f.depending_on for f in self.walk())

    @property
    def has_float(self) -> bool:
        return any(f.kind == "float" for f in self.walk())

    # -- rendering ---------------------------------------------------------

    @property
    def copybook_text(self) -> str:
        lines = [f"       01  {self.record_name}."]
        for f in self.fields:
            f.render(lines, 5)
        return "\n".join(lines) + "\n"

    def read_options(self, framing: str = "fixed") -> Dict[str, str]:
        """read_cobol options matching this spec + framing."""
        opts: Dict[str, str] = {"copybook_contents": self.copybook_text}
        if framing == "rdw":
            opts["is_record_sequence"] = "true"
        if self.has_depending:
            opts["variable_size_occurs"] = "true"
        if self.has_float:
            opts["floating_point_format"] = "ieee754"
        if self.code_page != "common":
            opts["ebcdic_code_page"] = self.code_page
        return opts

    def encode_options(self, framing: str = "fixed") -> Dict[str, object]:
        """encode_file keyword options matching `read_options`."""
        from ..copybook.datatypes import FloatingPointFormat

        opts: Dict[str, object] = {"framing": framing}
        if self.has_depending:
            opts["variable_size_occurs"] = True
        if self.has_float:
            opts["floating_point_format"] = FloatingPointFormat.IEEE754
        if self.code_page != "common":
            opts["ebcdic_code_page"] = self.code_page
        return opts

    # -- random construction ----------------------------------------------

    @classmethod
    def random(cls, rng: random.Random, *, max_fields: int = 8,
               allow_groups: bool = True, allow_occurs: bool = True,
               allow_depending: bool = True, allow_float: bool = True,
               code_page: str = "common") -> "CopybookSpec":
        seq = [0]

        def next_name(prefix: str = "F") -> str:
            seq[0] += 1
            return f"{prefix}{seq[0]:02d}"

        def make_fields(n: int, depth: int) -> List[FieldSpec]:
            out: List[FieldSpec] = []
            while len(out) < n:
                roll = rng.random()
                if allow_groups and depth < 2 and roll < 0.18:
                    grp = FieldSpec(name=next_name("G"), kind="group")
                    grp.children = make_fields(rng.randint(1, 3),
                                               depth + 1)
                    if all(c.is_filler for c in grp.children):
                        # an all-filler group is itself a filler and
                        # vanishes from row tuples — keep one live field
                        grp.children.append(
                            _rand_primitive(rng, next_name(), False))
                    if allow_occurs and rng.random() < 0.3:
                        grp.occurs = rng.randint(2, 4)
                    out.append(grp)
                elif roll < 0.24:
                    filler = _rand_primitive(rng, "FILLER", False)
                    if filler.kind == "float":
                        filler.kind, filler.length = "string", 3
                    filler.is_filler = True
                    filler.allow_none = False
                    out.append(filler)
                elif allow_depending and roll < 0.34:
                    arr = _rand_primitive(rng, next_name("A"), False)
                    if arr.kind == "float":
                        arr.kind, arr.length = "string", 4
                    arr.allow_none = False  # absent items are the Nones
                    arr.occurs = rng.randint(2, 5)
                    arr.occurs_min = rng.randint(0, 1)
                    cnt = FieldSpec(name=next_name("C"),
                                    kind="display_int", digits=2,
                                    signed=False, counts_for=arr.name)
                    arr.depending_on = cnt.name
                    out.extend([cnt, arr])
                else:
                    prim = _rand_primitive(rng, next_name(), allow_float)
                    if (allow_occurs and rng.random() < 0.15
                            and prim.kind != "float"):
                        prim.occurs = rng.randint(2, 4)
                        prim.allow_none = False
                    out.append(prim)
            return out

        return cls(fields=make_fields(rng.randint(1, max_fields), 0),
                   code_page=code_page)

    # -- bodies ------------------------------------------------------------

    def _choose_counts(self, rng: Optional[random.Random]
                       ) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for f in self.walk():
            if f.depending_on:
                counts[f.name] = (f.occurs_min if rng is None
                                  else rng.randint(f.occurs_min, f.occurs))
        return counts

    def _build_body(self, fields: Sequence[FieldSpec],
                    counts: Dict[str, int],
                    leaf: Callable[[FieldSpec], object]) -> tuple:
        out = []
        for f in fields:
            if f.is_filler:
                continue
            if f.counts_for is not None:
                out.append(counts.get(f.counts_for, 0))
                continue
            if f.kind == "group":
                one = (lambda g=f: self._build_body(g.children, counts,
                                                    leaf))
            else:
                one = (lambda g=f: leaf(g))
            if f.depending_on:
                out.append([one() for _ in range(counts[f.name])])
            elif f.occurs:
                out.append([one() for _ in range(f.occurs)])
            else:
                out.append(one())
        return tuple(out)

    def random_body(self, rng: random.Random) -> list:
        """One record body in to_rows() shape: [root_group_tuple]."""
        alphabet = safe_alphabet(self.code_page)
        counts = self._choose_counts(rng)
        return [self._build_body(self.fields, counts,
                                 lambda f: f.random_value(rng, alphabet))]

    def trivial_body(self) -> list:
        counts = self._choose_counts(None)
        return [self._build_body(self.fields, counts,
                                 lambda f: f.trivial_value())]

    # -- shrinking ---------------------------------------------------------

    def without(self, name: str) -> "CopybookSpec":
        """Spec minus the named field (an ODO array's count field and an
        ODO count field's array are removed together)."""
        partner = {name}
        for f in self.walk():
            if f.name == name and f.depending_on:
                partner.add(f.depending_on)
            if f.name == name and f.counts_for:
                partner.add(f.counts_for)
            if f.counts_for in partner:
                partner.add(f.name)
            if f.depending_on in partner:
                partner.add(f.name)

        def prune(fs: List[FieldSpec]) -> List[FieldSpec]:
            out = []
            for f in fs:
                if f.name in partner and not f.is_filler:
                    continue
                if f.kind == "group":
                    f = replace(f, children=prune(f.children))
                    if not f.children:
                        continue
                out.append(f)
            return out

        return replace(self, fields=prune(self.fields))

    def droppable_names(self) -> List[str]:
        return [f.name for f in self.walk() if not f.is_filler]


def shrink_spec(spec: CopybookSpec,
                still_fails: Callable[[CopybookSpec], bool],
                max_rounds: int = 20) -> CopybookSpec:
    """Greedy field-removal shrink: drop any field whose removal keeps
    the failure reproducing, until a fixpoint."""
    for _ in range(max_rounds):
        shrunk = False
        for name in spec.droppable_names():
            candidate = spec.without(name)
            if not candidate.fields:
                continue
            try:
                if still_fails(candidate):
                    spec = candidate
                    shrunk = True
                    break
            except Exception:
                continue  # candidate itself broken — keep shrinking
        if not shrunk:
            return spec
    return spec


def _leaf_paths(fields: Sequence[FieldSpec], body: tuple,
                prefix: Tuple[int, ...] = ()) -> List[Tuple[Tuple[int, ...],
                                                            FieldSpec]]:
    out = []
    i = 0
    for f in fields:
        if f.is_filler:
            continue
        val = body[i]
        here = prefix + (i,)
        if f.depending_on or f.occurs:
            for k, item in enumerate(val):
                if f.kind == "group":
                    out.extend(_leaf_paths(f.children, item,
                                           here + (k,)))
                else:
                    out.append((here + (k,), f))
        elif f.kind == "group":
            out.extend(_leaf_paths(f.children, val, here))
        elif f.counts_for is None:
            out.append((here, f))
        i += 1
    return out


def _set_path(body, path: Tuple[int, ...], value):
    if not path:
        return value
    seq = list(body)
    seq[path[0]] = _set_path(seq[path[0]], path[1:], value)
    return tuple(seq) if isinstance(body, tuple) else seq


def shrink_body(spec: CopybookSpec, body: list,
                still_fails: Callable[[list], bool]) -> list:
    """Greedy leaf-trivialization shrink of one record body."""
    root = body[0]
    changed = True
    while changed:
        changed = False
        for path, f in _leaf_paths(spec.fields, root):
            trivial = f.trivial_value()
            current = root
            for idx in path:
                current = current[idx]
            if current == trivial:
                continue
            candidate = _set_path(root, path, trivial)
            try:
                if still_fails([candidate]):
                    root = candidate
                    changed = True
            except Exception:
                continue
    return [root]
