"""Fingerprint-keyed compile caches: copybook parse, field plan, LUT.

Every read used to re-derive the whole decode program from scratch —
copybook text -> AST -> FieldPlan -> kernel groups (-> jit trace on the
jax backend) — even when the same copybook scans the same layout a
thousand times a day, and the chunked pipeline executor (cobrix_tpu.engine)
multiplies that by the per-chunk decoder lookups. This module memoizes the
three derivation layers:

* parse cache  — copybook text + parse-relevant reader options
                 -> the SAME `Copybook` object. Deduplicating the object
                 (not just the work) is what makes the downstream caches
                 sound: FieldPlan column specs hold AST statement
                 references and row assembly resolves them by identity,
                 so a plan is only reusable alongside the copybook it was
                 compiled from.
* plan cache   — (copybook, active segment, select) -> compiled FieldPlan.
                 Hits return a fresh clone (cheap spec copies, same
                 statement references): callers like the device byte
                 projection rewrite column offsets in place
                 (parallel/query.py), which must never corrupt the cached
                 pristine plan.
* LUT cache    — code-page name -> the [256] uint16 transcode table,
                 returned read-only and shared.

Per-copybook decoder caches (jit program reuse) ride on the parse cache:
`decoder_cache_for` attaches the cache dict to the Copybook object, so
two reads that hit the parse cache share compiled decoders too.

All caches are process-global, lock-protected, and bounded. Hit/miss
counters are surfaced per read through `ReadMetrics.as_dict()["plan_cache"]`.

Port copy of ``cobrix_tpu.plan.cache``. The decoder cache is keyed by
the device in place of the backend (reader/columnar.py
``decoder_for_segment``). `absorb_scope`, which folds forked multihost
workers' counts home, waits for ROADMAP A7. `parse_fingerprint` digests
a configuration for the persisted sparse-index key (io/index_store.py).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .compiler import ColumnGroup, FieldPlan, compile_plan

_lock = threading.Lock()
_PARSE_LRU: "OrderedDict[str, object]" = OrderedDict()
_PLAN_LRU: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (copybook, plan)
_LUT_CACHE: Dict[str, np.ndarray] = {}

_PARSE_CAP = 16
_PLAN_CAP = 64

_STAT_KEYS = (
    "parse_hits", "parse_misses",
    "plan_hits", "plan_misses",
    "lut_hits", "lut_misses",
    "decoder_hits", "decoder_misses",
)

_stats = dict.fromkeys(_STAT_KEYS, 0)

# per-read counter scopes, installed per THREAD: every thread working
# for one read (the caller, the shard pool, the pipeline stage threads)
# activates the read's scope, so concurrent read_cobol calls attribute
# their own lookups exactly instead of polluting each other through a
# process-global delta (the documented cross-read contamination the old
# ReadMetrics baseline snapshot carried)
_scope_tls = threading.local()


class CacheStatsScope:
    """One read's cache-event counters. Mutated only under `_lock`
    (every stat bump already holds it), so one scope object is safely
    shared by all of the read's threads."""

    __slots__ = ("stats",)

    def __init__(self):
        self.stats = dict.fromkeys(_STAT_KEYS, 0)


def activate_scope(scope: Optional[CacheStatsScope]):
    """Install `scope` as this thread's counter sink; returns the
    previous scope for `deactivate_scope`."""
    prev = getattr(_scope_tls, "scope", None)
    _scope_tls.scope = scope
    return prev


def deactivate_scope(prev) -> None:
    _scope_tls.scope = prev


def _bump(key: str) -> None:
    """Count one cache event globally and into the active per-read
    scope. Caller must hold `_lock`."""
    _stats[key] += 1
    scope = getattr(_scope_tls, "scope", None)
    if scope is not None:
        scope.stats[key] += 1


def note_decoder(hit: bool) -> None:
    """Record a per-copybook decoder cache lookup (columnar.
    decoder_for_segment) — a hit means the plan, kernel groups, and any
    jit program were all reused without touching the caches below."""
    with _lock:
        _bump("decoder_hits" if hit else "decoder_misses")


def cache_stats() -> Dict[str, int]:
    """Snapshot of the global hit/miss counters."""
    with _lock:
        return dict(_stats)


def clear_caches() -> None:
    """Drop every cached artifact (tests / code-page re-registration)."""
    with _lock:
        _PARSE_LRU.clear()
        _PLAN_LRU.clear()
        _LUT_CACHE.clear()


def invalidate_code_page(name: str) -> None:
    """Drop everything derived from one code page (re-registration hook):
    the LUT, and every parse-cached Copybook bound to it — each carries
    an attached decoder cache whose decoders hold the OLD table's LUT, so
    evicting only the LUT would keep serving stale decodes."""
    with _lock:
        _LUT_CACHE.pop(name, None)
        stale = [k for k, cb in _PARSE_LRU.items()
                 if getattr(cb, "ebcdic_code_page", None) == name]
        for k in stale:
            cb = _PARSE_LRU.pop(k)
            # the plan LRU holds strong refs keyed by copybook identity;
            # drop those entries so the object (and its decoder cache,
            # attached as an attribute) can actually die
            for pk in [pk for pk, (pcb, _) in _PLAN_LRU.items()
                       if pcb is cb]:
                _PLAN_LRU.pop(pk, None)


# ---------------------------------------------------------------------------
# copybook parse cache
# ---------------------------------------------------------------------------

def _parse_key(contents: Tuple[str, ...], params) -> str:
    """Deterministic fingerprint of the copybook text plus every option
    that feeds parse_copybook. repr() of enums/dataclasses is stable
    within a process, which is the cache's lifetime."""
    seg = params.multisegment
    return repr((
        contents,
        params.data_encoding,
        params.drop_group_fillers,
        params.drop_value_fillers,
        tuple(sorted(set((seg.segment_id_redefine_map or {}).values())))
        if seg else (),
        tuple(sorted((seg.field_parent_map or {}).items())) if seg else (),
        params.string_trimming_policy,
        params.comment_policy,
        params.ebcdic_code_page,
        params.ebcdic_code_page_class,
        params.ascii_charset,
        params.is_utf16_big_endian,
        params.floating_point_format,
        tuple(params.non_terminals),
        tuple(sorted((k, tuple(sorted(v.items())))
                     for k, v in (params.occurs_mappings or {}).items())),
        params.debug_fields_policy,
    ))


def parse_fingerprint(copybook_contents, params) -> str:
    """Stable hex digest of (copybook text, parse-relevant options) —
    the copybook component of the persisted sparse-index key
    (cobrix_tpu_torch.io.index_store): two runs, or two processes, configured
    identically fingerprint identically."""
    import hashlib

    contents_list = ([copybook_contents]
                     if isinstance(copybook_contents, str)
                     else list(copybook_contents))
    key = _parse_key(tuple(contents_list), params)
    return hashlib.sha256(key.encode("utf-8", "replace")).hexdigest()


def copybook_for_params(copybook_contents, params):
    """Parse (or fetch) the Copybook for one reader configuration.

    Shared by FixedLenReader and VarLenReader so both hit the same cache.
    Returns the SAME Copybook object for identical (text, options) —
    parse output is never mutated after construction, and sharing the
    object is what keys the plan/decoder caches downstream.
    """
    from ..copybook.copybook import merge_copybooks, parse_copybook
    from ..encoding.codepages import resolve_code_page

    contents_list = ([copybook_contents]
                     if isinstance(copybook_contents, str)
                     else list(copybook_contents))
    key = _parse_key(tuple(contents_list), params)
    with _lock:
        cached = _PARSE_LRU.get(key)
        if cached is not None:
            _PARSE_LRU.move_to_end(key)
            _bump("parse_hits")
            return cached
        _bump("parse_misses")

    seg = params.multisegment
    copybooks = [
        parse_copybook(
            c,
            data_encoding=params.data_encoding,
            drop_group_fillers=params.drop_group_fillers,
            drop_value_fillers=params.drop_value_fillers,
            segment_redefines=sorted(set(
                (seg.segment_id_redefine_map or {}).values())) if seg else (),
            field_parent_map=dict(seg.field_parent_map) if seg else None,
            string_trimming_policy=params.string_trimming_policy,
            comment_policy=params.comment_policy,
            ebcdic_code_page=resolve_code_page(
                params.ebcdic_code_page, params.ebcdic_code_page_class),
            ascii_charset=params.ascii_charset,
            is_utf16_big_endian=params.is_utf16_big_endian,
            floating_point_format=params.floating_point_format,
            non_terminals=params.non_terminals,
            occurs_mappings=params.occurs_mappings,
            debug_fields_policy=params.debug_fields_policy,
        ) for c in contents_list]
    copybook = (copybooks[0] if len(copybooks) == 1
                else merge_copybooks(copybooks))
    with _lock:
        # a racing parse of the same key: first writer wins, so every
        # caller ends up holding the same object
        winner = _PARSE_LRU.setdefault(key, copybook)
        while len(_PARSE_LRU) > _PARSE_CAP:
            _PARSE_LRU.popitem(last=False)
    return winner


def decoder_cache_for(copybook) -> dict:
    """The per-copybook decoder cache dict (active|backend|select ->
    ColumnarDecoder). Attached to the Copybook object so reads that share
    a parse-cached copybook also share compiled decoders (and their jit
    programs)."""
    cache = getattr(copybook, "_decoder_cache", None)
    if cache is None:
        with _lock:
            cache = getattr(copybook, "_decoder_cache", None)
            if cache is None:
                cache = {}
                copybook._decoder_cache = cache
    return cache


# ---------------------------------------------------------------------------
# field-plan cache
# ---------------------------------------------------------------------------

def _clone_plan(plan: FieldPlan) -> FieldPlan:
    """Fresh FieldPlan with copied ColumnSpecs (same statement/dtype
    references). Consumers may rewrite spec offsets in place; clones keep
    the cached original pristine."""
    columns = [replace(c) for c in plan.columns]
    group_map: Dict[tuple, ColumnGroup] = {}
    for c in columns:
        key = (c.codec, c.width)
        if key not in group_map:
            group_map[key] = ColumnGroup(codec=c.codec, width=c.width)
        group_map[key].columns.append(c)
    return FieldPlan(
        record_size=plan.record_size,
        columns=columns,
        groups=list(group_map.values()),
        trimming=plan.trimming,
        ebcdic_code_page=plan.ebcdic_code_page,
        ascii_charset=plan.ascii_charset,
        is_utf16_big_endian=plan.is_utf16_big_endian,
        floating_point_format=plan.floating_point_format,
    )


def cached_compile_plan(copybook, active_segment: Optional[str] = None,
                        select: Optional[Sequence[str]] = None) -> FieldPlan:
    """compile_plan with a bounded identity-keyed LRU. The key holds a
    strong reference to the copybook, so an id() can never be recycled
    into a false hit while the entry lives; with the parse cache deduping
    copybooks by fingerprint, repeated scans key to the same object."""
    key = (id(copybook),
           active_segment.upper() if active_segment else None,
           tuple(select) if select else None)
    with _lock:
        entry = _PLAN_LRU.get(key)
        if entry is not None and entry[0] is copybook:
            _PLAN_LRU.move_to_end(key)
            _bump("plan_hits")
            return _clone_plan(entry[1])
        _bump("plan_misses")
    plan = compile_plan(copybook, active_segment, select=select)
    with _lock:
        _PLAN_LRU[key] = (copybook, plan)
        while len(_PLAN_LRU) > _PLAN_CAP:
            _PLAN_LRU.popitem(last=False)
    return _clone_plan(plan)


# ---------------------------------------------------------------------------
# code-page LUT cache
# ---------------------------------------------------------------------------

def cached_code_page_lut(name: str) -> np.ndarray:
    """Shared read-only [256] uint16 transcode LUT for one code page."""
    with _lock:
        lut = _LUT_CACHE.get(name)
        if lut is not None:
            _bump("lut_hits")
            return lut
        _bump("lut_misses")
    from ..encoding.codepages import code_page_lut_u16

    lut = code_page_lut_u16(name)
    lut.flags.writeable = False  # shared: accidental writes must fail loud
    with _lock:
        lut = _LUT_CACHE.setdefault(name, lut)
    return lut
