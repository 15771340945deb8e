"""Prometheus text-exposition parser, validator, and renderer.

The fleet plane federates replicas by scraping their `/metrics` text
and merging series numerically (fleet/federate.py). That only works if
the exposition is *parseable by contract*, so this module is both the
consumer and the lint:

* `parse_text` — text -> ordered `{family_name: Family}` with typed
  samples (labels fully unescaped). Histogram child samples
  (``_bucket``/``_sum``/``_count``) attach to their declared family.
* `render` — families -> exposition text, the exact inverse:
  ``parse_text(render(parse_text(t)))`` equals ``parse_text(t)``
  (the round-trip the tests pin — a federated exposition must itself
  be scrapeable by the next aggregation layer).
* `validate_text` — structural lint run against our own
  `prometheus_text()` output in unit tests: HELP/TYPE exactly once per
  family and before its samples, families contiguous, label names and
  escaping legal, histogram buckets cumulative with ``+Inf`` equal to
  ``_count``, no duplicate series. Federation correctness depends on
  parseable output, so it is linted at the source.

Pure stdlib, no prometheus_client: the container pins dependencies,
and the subset of format 0.0.4 the scan plane emits is small enough to
own (the same reasoning as obs/metrics.py itself).

Port copy of ``cobrix_tpu.obs.promparse``, unchanged.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_KINDS = ("counter", "gauge", "histogram", "summary", "untyped")

Labels = Tuple[Tuple[str, str], ...]


@dataclass
class Sample:
    """One series sample: the full sample name (may carry a histogram
    suffix), its sorted label pairs, and the value."""

    name: str
    labels: Labels
    value: float


@dataclass
class Family:
    """One metric family: the TYPE/HELP pair plus every sample that
    belongs to it (for histograms that includes the ``_bucket`` /
    ``_sum`` / ``_count`` children)."""

    name: str
    kind: str = "untyped"
    help: str = ""
    samples: List[Sample] = field(default_factory=list)

    def value(self, labels: Labels = (), suffix: str = "") -> Optional[float]:
        want = self.name + suffix
        for s in self.samples:
            if s.name == want and s.labels == labels:
                return s.value
        return None


class PromParseError(ValueError):
    """A line the parser refused; carries the 1-based line number."""

    def __init__(self, lineno: int, detail: str):
        super().__init__(f"line {lineno}: {detail}")
        self.lineno = lineno
        self.detail = detail


def _unescape_label(raw: str, lineno: int) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(raw):
            raise PromParseError(lineno, "dangling backslash in label")
        nxt = raw[i + 1]
        if nxt == "\\":
            out.append("\\")
        elif nxt == '"':
            out.append('"')
        elif nxt == "n":
            out.append("\n")
        else:
            raise PromParseError(
                lineno, f"illegal label escape '\\{nxt}'")
        i += 2
    return "".join(out)


def escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _parse_labels(raw: str, lineno: int) -> Labels:
    """``a="x",b="y"`` -> sorted pairs; escapes resolved."""
    pairs: List[Tuple[str, str]] = []
    i = 0
    n = len(raw)
    while i < n:
        eq = raw.find("=", i)
        if eq < 0:
            raise PromParseError(lineno, f"label without '=': {raw[i:]!r}")
        name = raw[i:eq].strip()
        if not _LABEL_NAME_RE.match(name):
            raise PromParseError(lineno, f"illegal label name {name!r}")
        j = eq + 1
        if j >= n or raw[j] != '"':
            raise PromParseError(lineno, f"label {name} value not quoted")
        j += 1
        start = j
        while j < n:
            if raw[j] == "\\":
                j += 2
                continue
            if raw[j] == '"':
                break
            j += 1
        if j >= n:
            raise PromParseError(lineno, f"unterminated value for {name}")
        pairs.append((name, _unescape_label(raw[start:j], lineno)))
        j += 1
        if j < n:
            if raw[j] != ",":
                raise PromParseError(
                    lineno, f"expected ',' between labels at {raw[j:]!r}")
            j += 1
        i = j
    return tuple(sorted(pairs))


def _parse_value(raw: str, lineno: int) -> float:
    raw = raw.strip()
    low = raw.lower()
    if low in ("+inf", "inf"):
        return float("inf")
    if low == "-inf":
        return float("-inf")
    if low == "nan":
        return float("nan")
    try:
        return float(raw)
    except ValueError:
        raise PromParseError(lineno, f"unparseable value {raw!r}")


_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(sample_name: str,
               families: Dict[str, Family]) -> Optional[str]:
    """The declared family a sample belongs to: exact name, or the
    histogram/summary base when the suffixed form matches a declared
    histogram family."""
    if sample_name in families:
        return sample_name
    for suffix in _HIST_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            fam = families.get(base)
            if fam is not None and fam.kind in ("histogram", "summary"):
                return base
    return None


def parse_text(text: str) -> "Dict[str, Family]":
    """Exposition text -> insertion-ordered ``{name: Family}``.
    Raises PromParseError on malformed lines (use `validate_text` for
    a non-raising lint with the full issue list)."""
    families: Dict[str, Family] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue  # plain comment
            name = parts[2]
            if not _NAME_RE.match(name):
                raise PromParseError(lineno, f"illegal metric name {name!r}")
            fam = families.setdefault(name, Family(name))
            if parts[1] == "TYPE":
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in _KINDS:
                    raise PromParseError(
                        lineno, f"unknown TYPE {kind!r} for {name}")
                fam.kind = kind
            else:
                fam.help = parts[3] if len(parts) > 3 else ""
            continue
        # sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)"
                     r"(\s+-?\d+)?$", line)
        if not m:
            raise PromParseError(lineno, f"unparseable sample {line!r}")
        sname, _braced, rawlabels, rawvalue, _ts = m.groups()
        labels = _parse_labels(rawlabels, lineno) if rawlabels else ()
        value = _parse_value(rawvalue, lineno)
        base = _family_of(sname, families)
        if base is None:
            # undeclared family (no TYPE line): own it as untyped
            base = sname
            families.setdefault(base, Family(base))
        families[base].samples.append(Sample(sname, labels, value))
    return families


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_sample(s: Sample) -> str:
    if s.labels:
        inner = ",".join(f'{k}="{escape_label(v)}"' for k, v in s.labels)
        return f"{s.name}{{{inner}}} {_fmt_value(s.value)}"
    return f"{s.name} {_fmt_value(s.value)}"


def render(families: "Dict[str, Family]") -> str:
    """Families -> exposition text (HELP then TYPE then samples, the
    shape `MetricsRegistry.exposition` itself emits)."""
    lines: List[str] = []
    for fam in families.values():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        if fam.kind != "untyped" or fam.help:
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        lines.extend(render_sample(s) for s in fam.samples)
    return "\n".join(lines) + "\n"


# -- histogram helpers (the ONE owner of le-bound semantics) ----------------

def le_bound(raw: str) -> float:
    """A ``le`` label value as its numeric bucket bound (``+Inf``/
    ``inf`` -> math inf). Raises ValueError on garbage — callers decide
    whether that is a lint issue or a hard error."""
    if raw in ("+Inf", "inf", "Inf"):
        return float("inf")
    return float(raw)


def fold_histogram(family: Family, acc: Optional[dict] = None) -> dict:
    """Fold one histogram family's samples (ALL label sets collapsed)
    into ``{"buckets": {bound: cumulative}, "count": n, "sum": s}``,
    accumulating into ``acc`` when given — the shared primitive behind
    cluster-wide and per-replica quantile math (fleet/signals,
    tools/fleetview). Unparseable ``le`` values are skipped here;
    `validate_text` is where they become reported issues."""
    acc = acc if acc is not None else {"buckets": {}, "count": 0.0,
                                       "sum": 0.0}
    for s in family.samples:
        if s.name == family.name + "_bucket":
            le = dict(s.labels).get("le")
            if le is None:
                continue
            try:
                bound = le_bound(le)
            except ValueError:
                continue
            acc["buckets"][bound] = acc["buckets"].get(bound, 0.0) \
                + s.value
        elif s.name == family.name + "_count":
            acc["count"] += s.value
        elif s.name == family.name + "_sum":
            acc["sum"] += s.value
    return acc


# -- the validator ----------------------------------------------------------

def _histogram_issues(fam: Family) -> List[str]:
    """Bucket cumulativity + _sum/_count coherence per label set."""
    issues: List[str] = []
    by_series: Dict[Labels, List[Tuple[float, float]]] = {}
    counts: Dict[Labels, float] = {}
    sums: Dict[Labels, bool] = {}
    for s in fam.samples:
        if s.name == fam.name + "_bucket":
            le = dict(s.labels).get("le")
            if le is None:
                issues.append(f"{fam.name}: _bucket sample without le")
                continue
            key = tuple(p for p in s.labels if p[0] != "le")
            try:
                bound = le_bound(le)
            except ValueError:
                issues.append(f"{fam.name}: unparseable le={le!r}")
                continue
            by_series.setdefault(key, []).append((bound, s.value))
        elif s.name == fam.name + "_count":
            counts[s.labels] = s.value
        elif s.name == fam.name + "_sum":
            sums[s.labels] = True
    for key, buckets in by_series.items():
        buckets.sort(key=lambda b: b[0])
        prev = None
        for bound, cum in buckets:
            if prev is not None and cum < prev:
                issues.append(
                    f"{fam.name}{dict(key) or ''}: bucket counts not "
                    f"cumulative at le={bound}")
                break
            prev = cum
        if not buckets or buckets[-1][0] != float("inf"):
            issues.append(f"{fam.name}{dict(key) or ''}: missing "
                          "+Inf bucket")
            continue
        count = counts.get(key)
        if count is None:
            issues.append(f"{fam.name}{dict(key) or ''}: missing _count")
        elif buckets[-1][1] != count:
            issues.append(
                f"{fam.name}{dict(key) or ''}: +Inf bucket "
                f"({buckets[-1][1]:g}) disagrees with _count ({count:g})")
        if key not in sums:
            issues.append(f"{fam.name}{dict(key) or ''}: missing _sum")
    return issues


def validate_text(text: str) -> List[str]:
    """Structural lint; [] means the exposition is clean. Collects
    every issue instead of stopping at the first — the point is a CI
    assertion message that names all the problems at once."""
    issues: List[str] = []
    seen_help: Dict[str, int] = {}
    seen_type: Dict[str, int] = {}
    type_of: Dict[str, str] = {}
    sampled: Dict[str, bool] = {}
    closed: set = set()  # families whose sample block ended
    last_family: Optional[str] = None
    series_seen: set = set()

    def family_for(sname: str) -> str:
        if sname in type_of:
            return sname
        for suffix in _HIST_SUFFIXES:
            if sname.endswith(suffix):
                base = sname[: -len(suffix)]
                if type_of.get(base) in ("histogram", "summary"):
                    return base
        return sname

    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue
            kind, name = parts[1], parts[2]
            book = seen_help if kind == "HELP" else seen_type
            if name in book:
                issues.append(
                    f"line {lineno}: {kind} for {name} declared twice "
                    f"(first at line {book[name]})")
            book[name] = lineno
            if kind == "TYPE":
                if sampled.get(name):
                    issues.append(
                        f"line {lineno}: TYPE for {name} after its "
                        "samples")
                type_of[name] = (parts[3].strip()
                                 if len(parts) > 3 else "")
                if type_of[name] not in _KINDS:
                    issues.append(f"line {lineno}: unknown TYPE "
                                  f"{type_of[name]!r} for {name}")
            continue
        try:
            fams = parse_text(line)
        except PromParseError as exc:
            issues.append(f"line {lineno}: {exc.detail}")
            continue
        for fam in fams.values():
            for s in fam.samples:
                base = family_for(s.name)
                sampled[base] = True
                if base in closed:
                    issues.append(
                        f"line {lineno}: samples of {base} are not "
                        "contiguous")
                if last_family is not None and last_family != base:
                    closed.add(last_family)
                last_family = base
                key = (s.name, s.labels)
                if key in series_seen:
                    issues.append(
                        f"line {lineno}: duplicate series "
                        f"{render_sample(s).split(' ')[0]}")
                series_seen.add(key)
    # histogram coherence runs on the parsed view (needs whole families)
    try:
        families = parse_text(text)
    except PromParseError:
        return issues  # already reported line-wise above
    for fam in families.values():
        if fam.kind == "histogram":
            issues.extend(_histogram_issues(fam))
    return issues
