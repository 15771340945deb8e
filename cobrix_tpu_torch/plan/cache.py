"""Fingerprint-keyed compile caches: field plan and code-page LUT.

* plan cache — (copybook, active segment, select) -> compiled FieldPlan.
               Hits return a fresh clone (cheap spec copies, same
               statement references), so a caller that rewrites column
               offsets never corrupts the cached pristine plan.
* LUT cache  — code-page name -> the [256] uint16 transcode table,
               returned read-only and shared.

Both caches are process-global, lock-protected and bounded.

`copybook_for_params` parses the copybook of one reader configuration,
with the redefine map's segment redefines marked at parse time.

Port copy of ``cobrix_tpu.plan.cache``, reduced to `cached_compile_plan`,
`cached_code_page_lut`, `invalidate_code_page` and `copybook_for_params`:
the port has no parse cache (a read parses its copybook once and keeps
its decoders per reader), no per-read stats scopes and no hit/miss
counters, so the plan cache alone holds copybook references here.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import replace
from typing import Dict, Optional, Sequence

import numpy as np

from .compiler import ColumnGroup, FieldPlan, compile_plan

_lock = threading.Lock()
_PLAN_LRU: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (copybook, plan)
_LUT_CACHE: Dict[str, np.ndarray] = {}

_PLAN_CAP = 64


def invalidate_code_page(name: str) -> None:
    """Drop everything derived from one code page (re-registration hook):
    the LUT, and every cached plan of a copybook bound to it."""
    with _lock:
        _LUT_CACHE.pop(name, None)
        for pk in [pk for pk, (cb, _) in _PLAN_LRU.items()
                   if getattr(cb, "ebcdic_code_page", None) == name]:
            _PLAN_LRU.pop(pk, None)


def copybook_for_params(copybook_contents, params):
    """Parse the Copybook (merged when several texts are given) for one
    reader configuration: its data encoding, comment bounds, filler
    dropping, non-terminals, debug fields, trimming, code page (a custom
    code-page class loaded and registered on first use), ASCII charset,
    UTF-16 byte order and float format, its OCCURS mappings, the
    segment redefines of its redefine map marked at parse time, and the
    parent of each child segment (`segment-children`). Each call parses
    anew, so the plan cache, keyed by the Copybook's identity, never
    serves one configuration's plan to another: a hierarchical and a
    flat read of one copybook text get different plans, which the JAX
    package's parse cache ensures by keying on the parent map."""
    from ..copybook.copybook import merge_copybooks, parse_copybook
    from ..encoding.codepages import resolve_code_page

    contents_list = ([copybook_contents]
                     if isinstance(copybook_contents, str)
                     else list(copybook_contents))
    seg = params.multisegment
    redefines = (sorted(set(seg.segment_id_redefine_map.values()))
                 if seg else ())
    copybooks = [
        parse_copybook(
            c,
            data_encoding=params.data_encoding,
            drop_group_fillers=params.drop_group_fillers,
            drop_value_fillers=params.drop_value_fillers,
            segment_redefines=redefines,
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
    return (copybooks[0] if len(copybooks) == 1
            else merge_copybooks(copybooks))

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
    into a false hit while the entry lives."""
    key = (id(copybook),
           active_segment.upper() if active_segment else None,
           tuple(select) if select else None)
    with _lock:
        entry = _PLAN_LRU.get(key)
        if entry is not None and entry[0] is copybook:
            _PLAN_LRU.move_to_end(key)
            return _clone_plan(entry[1])
    plan = compile_plan(copybook, active_segment, select=select)
    with _lock:
        _PLAN_LRU[key] = (copybook, plan)
        while len(_PLAN_LRU) > _PLAN_CAP:
            _PLAN_LRU.popitem(last=False)
    return _clone_plan(plan)


def cached_code_page_lut(name: str) -> np.ndarray:
    """Shared read-only [256] uint16 transcode LUT for one code page."""
    with _lock:
        lut = _LUT_CACHE.get(name)
        if lut is not None:
            return lut
    from ..encoding.codepages import code_page_lut_u16

    lut = code_page_lut_u16(name)
    lut.flags.writeable = False  # shared: accidental writes must fail loud
    with _lock:
        lut = _LUT_CACHE.setdefault(name, lut)
    return lut
