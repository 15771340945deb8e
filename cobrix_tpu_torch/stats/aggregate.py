"""Aggregates answered from statistics alone — when provably exact.

``dataset().aggregate()`` and ``count_rows()`` call in here first
(``use_stats=true``, no filter): if EVERY input file has a warm
profile under the read's exact configuration, ``count`` is the sum of
profiled record counts, ``min``/``max`` fold the per-chunk zone maps,
and ``sum`` folds the per-chunk exact sums (int/decimal kinds only —
float sums are order-dependent, never answered from stats). Anything
short of proof — a missing profile, a NaN-tainted chunk, an unknown
field, an inexact kind — returns None and the caller decodes, so a
stats answer is always byte-identical to the decoded one.

Port copy of ``cobrix_tpu.stats.aggregate``; the eligibility check
takes no backend. `parse_specs` lives here, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .profile import FileProfile

_UNPROVABLE = object()


def parse_specs(aggs: Sequence[str]) -> List[Tuple[str, Optional[str]]]:
    """``["count", "min:FIELD", ...]`` -> ``[(fn, field|None), ...]``
    (validated; the one spelling both the stats and decode paths
    share)."""
    out: List[Tuple[str, Optional[str]]] = []
    for spec in aggs:
        fn, sep, field = str(spec).partition(":")
        fn = fn.strip().lower()
        field = field.strip()
        if fn == "count" and not field:
            out.append(("count", None))
            continue
        if fn in ("min", "max", "sum") and sep and field:
            out.append((fn, field))
            continue
        raise ValueError(
            f"unsupported aggregate spec {spec!r} (use 'count', "
            f"'min:FIELD', 'max:FIELD', or 'sum:FIELD')")
    if not out:
        raise ValueError("aggregate() needs at least one spec")
    return out


def resolve_leaf(copybook, name: str) -> Optional[str]:
    """The profile key for an aggregate field reference (the same
    copybook resolution the filter binder uses), or None."""
    from ..copybook.ast import Group

    try:
        st = copybook.get_field_by_name(name)
    except (KeyError, ValueError):
        return None
    return None if isinstance(st, Group) else st.name


def load_all_profiles(files, copybook_contents,
                      params) -> Optional[List[FileProfile]]:
    """One profile per input file under this exact configuration — or
    None when ANY file lacks one (partial coverage cannot answer a
    whole-read aggregate)."""
    from ..plan.cache import parse_fingerprint
    from ..reader.stream import normalize_local
    from .collect import bump_overhead, profiling_eligibility
    from .store import StatsStore, local_fingerprint, \
        stats_config_fingerprint

    bump_overhead()
    if profiling_eligibility(files, params) is not None:
        return None
    try:
        store = StatsStore(params.cache_dir)
    except OSError:
        return None
    config_fp = stats_config_fingerprint(
        parse_fingerprint(copybook_contents, params), params)
    profiles: List[FileProfile] = []
    for path in files:
        local = normalize_local(path)
        fingerprint = local_fingerprint(local)
        if fingerprint is None:
            return None
        profile = store.load(local, fingerprint, config_fp)
        if profile is None:
            return None
        profiles.append(profile)
    return profiles


def _fold_min_max(profiles: List[FileProfile], leaf: str, fn: str):
    best = None
    non_null = 0
    for profile in profiles:
        if leaf not in profile.field_kinds:
            return _UNPROVABLE
        for chunk in profile.chunks:
            fs = chunk.fields.get(leaf)
            if fs is None:
                return _UNPROVABLE
            present = chunk.records - fs.null_count
            if present <= 0:
                continue
            if fs.min is None:
                return _UNPROVABLE  # NaN taint / unknown zone map
            non_null += present
            value = fs.min if fn == "min" else fs.max
            if best is None:
                best = value
            else:
                best = min(best, value) if fn == "min" \
                    else max(best, value)
    return best if non_null else None  # SQL NULL over no values


def _fold_sum(profiles: List[FileProfile], leaf: str):
    total = None
    non_null = 0
    for profile in profiles:
        kind = profile.field_kinds.get(leaf)
        if kind not in ("int", "decimal"):
            return _UNPROVABLE  # float sums are not exactly foldable
        for chunk in profile.chunks:
            fs = chunk.fields.get(leaf)
            if fs is None or fs.sum is None:
                return _UNPROVABLE
            non_null += chunk.records - fs.null_count
            total = fs.sum if total is None else total + fs.sum
    return total if non_null else None


def aggregates_from_profiles(profiles: List[FileProfile], copybook,
                             specs: Sequence[Tuple[str, Optional[str]]]
                             ) -> Optional[Dict[str, object]]:
    """Every requested aggregate from statistics alone, keyed by its
    original spec spelling — or None when any one is unprovable (all
    or nothing: mixing stats and decode answers in one call would make
    the provenance unauditable)."""
    out: Dict[str, object] = {}
    for fn, field in specs:
        if fn == "count":
            out["count"] = sum(p.total_records for p in profiles)
            continue
        leaf = resolve_leaf(copybook, field)
        if leaf is None:
            return None
        value = (_fold_sum(profiles, leaf) if fn == "sum"
                 else _fold_min_max(profiles, leaf, fn))
        if value is _UNPROVABLE:
            return None
        out[f"{fn}:{field}"] = value
    return out
