"""Columnar Arrow assembly for hierarchical (IMS-style) reads.

Port copy of ``cobrix_tpu.reader.hierarchical_arrow``, unchanged but for
where its leaves come from. The reference assembles hierarchical rows
one root at a time — buffer a root record plus its children, then walk
the AST per record (VarLenHierarchicalIterator.scala:43-162,
extractHierarchicalRecord, RecordExtractors.scala:211). The row path
(``VarLenReader._read_rows_hierarchical_columnar``) mirrors that walk;
THIS module is its vectorized twin for Arrow output: the parent/child
nesting is a pure function of the per-record segment types, so
child-to-parent assignment, list offsets, and every leaf column come
from array ops over the one decode-once batch — no Python rows at any
point. In the port that batch's values were decoded on the card (the
pack kernel and one fused launch per batch), and its leaves are built
there too, at the struct's positions (``ArrowBatchBuilder
.leaf_strings_at`` / ``leaf_numeric_at``: a row table a request), in
the builder's one assembly: the walk below returns thunks, the builder
assembles, then the thunks make the arrays. The JAX package transcodes
strings from the raw file image with its native library there.

Child-attachment rule (matches extract_children's forward scan): a child
record attaches to the nearest PRECEDING occurrence of any segment type
in its ancestor chain, and is kept only when that occurrence is of its
direct parent's type (the oracle's scan from the parent breaks when any
ancestor id reappears). That type-level formulation equals the oracle's
sid-level one except when a NON-ROOT parent type is reachable from
multiple segment ids (the oracle then scans PAST sibling occurrences with
a different id, double-attaching their children) — such shapes bail to
the row path. Record_Id parity: each assembled root row is stamped with
the id of the record that TRIGGERS its flush — the next root, or one past
the last record at end of stream. `assembly_stats` counts each columnar
assembly and each bail, by reason.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..copybook.ast import Group, Primitive
from ..copybook.datatypes import SchemaRetentionPolicy
from .arrow_out import _once, _pa


# columnar-vs-row-path assembly counters (observability: the bail rate is
# a BENCH metric — a silent fall-back to the Python row path would read
# as "columnar" while costing 5-10x)
ASSEMBLY_STATS = {"columnar": 0, "bail_multi_sid_parent": 0,
                  "bail_odo_cross_segment": 0, "bail_schema_shape": 0}
_STATS_LOCK = threading.Lock()  # bridge handler threads assemble concurrently


def _count(key: str) -> None:
    with _STATS_LOCK:
        ASSEMBLY_STATS[key] += 1


def assembly_stats(reset: bool = False) -> Dict[str, int]:
    """Snapshot (optionally reset) the columnar/bail counters."""
    with _STATS_LOCK:
        out = dict(ASSEMBLY_STATS)
        if reset:
            for k in ASSEMBLY_STATS:
                ASSEMBLY_STATS[k] = 0
    return out


def _depending_crosses_segment(copybook) -> bool:
    """True when an OCCURS DEPENDING ON array inside a segment redefine
    names a dependee that is not declared inside that SAME redefine.

    The row oracle (extract_hierarchical_record, mirroring reference
    RecordExtractors.scala:211-385) registers dependees while walking the
    ROOT record's full AST — prefix fields and every overlay are decoded
    from the root's bytes — and a child record's subtree walk only
    re-registers dependees declared inside the child's own group. So for
    an in-redefine array, a dependee outside that redefine resolves to the
    ROOT record's value, while the columnar build would re-read the
    current record's own bytes at the dependee's offset — bail. Arrays in
    the shared area only materialize at root positions, where both paths
    read the root record's own bytes — safe for any dependee placement.
    A dependee name declared in multiple regions is ambiguous — bail."""
    # keys upper-cased: the oracle binds DEPENDING ON case-insensitively
    # (mark_dependee_fields matches on .upper(), pipeline.py)
    regions: Dict[str, set] = {}

    def collect(g: Group, region: Optional[str]) -> None:
        for st in g.children:
            r = (st.name if isinstance(st, Group) and st.is_segment_redefine
                 else region)
            regions.setdefault(st.name.upper(), set()).add(r)
            if isinstance(st, Group):
                collect(st, r)

    for root in copybook.ast.children:
        if isinstance(root, Group):
            collect(root, None)

    def crosses(g: Group, region: Optional[str]) -> bool:
        for st in g.children:
            r = (st.name if isinstance(st, Group) and st.is_segment_redefine
                 else region)
            if st.is_array and st.depending_on is not None and r is not None:
                if regions.get(st.depending_on.upper()) != {r}:
                    return True
            if isinstance(st, Group) and crosses(st, r):
                return True
        return False

    return any(crosses(root, None) for root in copybook.ast.children
               if isinstance(root, Group))


def hierarchical_table(batch, segment_names,
                       copybook, output_schema,
                       sid_map: Dict[str, Group],
                       parent_child_map: Dict[str, list],
                       root_names: set,
                       file_id: int, start_record_id: int,
                       input_file_name: str = ""):
    """pyarrow Table for a hierarchical read, straight from a decode-once
    `DecodedBatch` over all framed records. `segment_names`: per-record
    redefine group names — either a plain sequence ("" / None for
    unmapped ids) or the dictionary-coded pair (uniq_names, codes
    ndarray) straight from SegmentIds. Returns None when the shape needs
    the row path."""
    from .arrow_out import ArrowBatchBuilder, arrow_schema

    pa = _pa()
    n = batch.n_records

    # non-root parent types fed by multiple segment ids diverge from the
    # oracle's sid-level break rule (see module docstring)
    sids_per_name: Dict[str, int] = {}
    for _sid, g in sid_map.items():
        sids_per_name[g.name] = sids_per_name.get(g.name, 0) + 1
    for name, count in sids_per_name.items():
        if count > 1 and name not in root_names and name in parent_child_map:
            _count("bail_multi_sid_parent")
            return None

    # DEPENDING ON arrays whose dependee lives in a different visibility
    # region (shared area vs a segment redefine overlay): bail to the row
    # path, which owns the oracle's cross-record dependee semantics
    if _depending_crosses_segment(copybook):
        _count("bail_odo_cross_segment")
        return None

    # integer-coded segment names: every membership test below runs on an
    # int32 code vector (object-dtype string compares/np.isin dominated
    # the assembly at scale). Callers pass the dictionary-coded form
    # (uniq_names, codes) straight from SegmentIds; a plain sequence is
    # coded here for direct/test use.
    if (isinstance(segment_names, tuple) and len(segment_names) == 2
            and isinstance(segment_names[1], np.ndarray)):
        uniq_names, codes = segment_names
        uniq_names = ["" if not s else s for s in uniq_names]
    else:
        uniq_names, seen = [], {}
        codes = np.empty(len(segment_names), dtype=np.int32)
        for i, s in enumerate(segment_names):
            s = s or ""
            j = seen.get(s)
            if j is None:
                j = seen[s] = len(uniq_names)
                uniq_names.append(s)
            codes[i] = j
    codes = np.asarray(codes, dtype=np.int32)
    name_codes: Dict[str, list] = {}
    for j, nm in enumerate(uniq_names):
        name_codes.setdefault(nm, []).append(j)

    def mask_of(names_iter) -> np.ndarray:
        ids = [j for nm in names_iter for j in name_codes.get(nm, ())]
        if not ids:
            return np.zeros(len(codes), dtype=bool)
        # id lists are tiny (distinct sids per name): OR of equality
        # compares beats np.isin's sort machinery
        mask = codes == ids[0]
        for j in ids[1:]:
            mask |= codes == j
        return mask

    parent_of = {}
    for parent, children in parent_child_map.items():
        for ch in children:
            parent_of[ch.name] = parent

    def ancestors(name: str) -> List[str]:
        out = []
        cur = parent_of.get(name)
        while cur is not None:
            out.append(cur)
            cur = parent_of.get(cur)
        return out

    positions_of = {name: np.nonzero(mask_of([name]))[0]
                    for name in {g.name for g in sid_map.values()}}
    root_pos_list = [positions_of.get(name, np.zeros(0, dtype=np.int64))
                     for name in root_names]
    roots = (np.sort(np.concatenate(root_pos_list)) if root_pos_list
             else np.zeros(0, dtype=np.int64))
    if roots.size == 0:
        return arrow_schema(output_schema.schema).empty_table()

    # per-redefine visibility masks: leaf columns of a segment build only
    # their own rows (hidden rows skip truncation fixups and string work;
    # their values are garbage by design and are never gathered)
    seg_masks = {g.name.upper(): mask_of([g.name])
                 for g in sid_map.values()}
    builder = ArrowBatchBuilder(batch, active=None,
                                redefine_masks=seg_masks)
    full_cache: Dict[int, object] = {}

    def full_array(st):
        """Thunk of the full-length array of a non-redefine statement,
        cached (a child type under two parents shares one build)."""
        build = full_cache.get(id(st))
        if build is None:
            build = full_cache[id(st)] = _once(
                builder._statement_array(st, ()))
        return build

    # child segments in the SCHEMA's order: global segment-redefine
    # declaration order filtered by parent (reader/schema.py _parse_group)
    all_redefines = copybook.get_all_segment_redefines()

    def child_segments_of(group: Group) -> List[Group]:
        return [seg for seg in all_redefines
                if seg.parent_segment is not None
                and seg.parent_segment.name.upper() == group.name.upper()]

    def assign_children(child: Group, parent_positions: np.ndarray):
        """(kept child positions in order, int32 list offsets aligned to
        parent_positions)."""
        ch_pos = positions_of.get(child.name, np.zeros(0, dtype=np.int64))
        anc_names = set(ancestors(child.name))
        anc_pos = np.nonzero(mask_of(anc_names))[0]
        if ch_pos.size and anc_pos.size:
            idx = np.searchsorted(anc_pos, ch_pos, side="left") - 1
            has_anc = idx >= 0
            owner = np.where(has_anc, anc_pos[np.maximum(idx, 0)], -1)
            # keep only children whose nearest ancestor occurrence is an
            # occurrence of the DIRECT parent
            is_parent_row = np.zeros(len(codes) + 1, dtype=bool)
            is_parent_row[parent_positions] = True
            keep = has_anc & is_parent_row[owner]
            ch_kept = ch_pos[keep]
            owner = owner[keep]
        else:
            ch_kept = np.zeros(0, dtype=np.int64)
            owner = ch_kept
        # children arrive in position order, owners non-decreasing
        starts = np.searchsorted(owner, parent_positions, side="left")
        offsets = np.empty(len(parent_positions) + 1, dtype=np.int32)
        offsets[:-1] = starts
        offsets[-1] = len(owner)
        return ch_kept, offsets

    def expand_offsets(offsets_own: np.ndarray, owned: np.ndarray
                       ) -> np.ndarray:
        """Re-align list offsets computed over the owned subset to the
        full positions vector (non-owned rows become empty lists)."""
        m = len(owned)
        ranks = np.cumsum(owned) - 1  # index into owned rows
        offsets = np.empty(m + 1, dtype=np.int32)
        start_owned = offsets_own[np.clip(ranks, 0, None)]
        end_owned = offsets_own[np.clip(ranks + 1, 0, len(offsets_own) - 1)]
        offsets[:-1] = np.where(owned, start_owned,
                                np.where(ranks >= 0, end_owned, 0))
        offsets[-1] = offsets_own[-1]
        return offsets

    def segment_struct(group: Group, positions: np.ndarray,
                       null_mask: Optional[np.ndarray] = None):
        """Thunk of the StructArray of `group` at `positions` (child
        segments nested as list<struct> fields, schema order).
        `null_mask`: True where the struct itself is null (rows of
        positions owned by a sibling redefine — their decoded bytes are
        garbage by design)."""
        arrays, field_names = [], []
        owned = None if null_mask is None else ~null_mask
        positions = positions.astype(np.int64, copy=False)
        # this struct's string leaves, requested at its positions
        built_at = builder.leaf_strings_at(
            [c for c in group.children
             if isinstance(c, Primitive) and not c.is_filler
             and not c.is_array], positions)
        for child in group.children:
            if child.is_filler:
                continue
            if isinstance(child, Group) and child.parent_segment is not None:
                continue  # nested below in schema order
            if isinstance(child, Group) and child.is_segment_redefine:
                # a segment redefine nested below this group (the root
                # case: the AST root holds the root redefines)
                child_owned = mask_of([child.name])[positions]
                sub_mask = (None if bool(child_owned.all())
                            else ~child_owned)
                arrays.append(segment_struct(child, positions, sub_mask))
                field_names.append(child.name)
                continue
            field_names.append(child.name)
            arr = None
            if isinstance(child, Primitive) and not child.is_array:
                # string/numeric leaves build straight at `positions`
                # (a row table on the device) — no full-length build, no
                # take
                arr = built_at.get(id(child))
                if arr is None:
                    arr = builder.leaf_numeric_at(child, positions)
            if arr is None:
                full = full_array(child)

                def arr(full=full, positions=positions):
                    return full().take(pa.array(positions))
            arrays.append(arr)
        for seg in child_segments_of(group):
            par_pos = positions if owned is None else positions[owned]
            ch_pos, offs_own = assign_children(seg, par_pos)
            offsets = (offs_own if owned is None
                       else expand_offsets(offs_own, owned))
            field_names.append(seg.name)
            child = segment_struct(seg, ch_pos)
            arrays.append(lambda offsets=offsets, child=child:
                          pa.ListArray.from_arrays(pa.array(offsets),
                                                   child()))
        if not arrays:
            return lambda: pa.nulls(len(positions), type=pa.struct([]))
        return lambda: pa.StructArray.from_arrays(
            [a() for a in arrays], names=field_names,
            mask=None if null_mask is None else pa.array(null_mask))

    cols: List[object] = []
    n_roots = len(roots)
    if output_schema.generate_record_id:
        cols.append(pa.array(np.full(n_roots, file_id, dtype=np.int32)))
        # flush-trigger ids: the next root's record index, or one past the
        # last record at end of stream
        triggers = np.empty(n_roots, dtype=np.int64)
        triggers[:-1] = start_record_id + roots[1:]
        triggers[-1] = start_record_id + n
        cols.append(pa.array(triggers))
        if output_schema.input_file_name_field:
            cols.append(pa.array([input_file_name] * n_roots,
                                 type=pa.string()))
    elif output_schema.input_file_name_field:
        cols.append(pa.array([input_file_name] * n_roots, type=pa.string()))

    structs = [segment_struct(root, roots) for root in copybook.ast.children
               if isinstance(root, Group)]
    builder.assemble()
    for build in structs:
        struct = build()
        if output_schema.policy is SchemaRetentionPolicy.COLLAPSE_ROOT:
            for f in struct.type:
                cols.append(struct.field(f.name))
        else:
            cols.append(struct)

    if getattr(output_schema, "corrupt_record_field", ""):
        # hierarchical assemblies carry no per-row corruption attribution;
        # the debug column is declared but all-null here (the ledger on
        # CobolData.diagnostics still records every incident)
        cols.append(pa.nulls(n_roots, pa.string()))

    target = arrow_schema(output_schema.schema)
    if len(cols) != len(target):
        _count("bail_schema_shape")
        return None  # shape mismatch: the row path owns it
    arrays = [c.cast(target.field(i).type)
              if c.type != target.field(i).type else c
              for i, c in enumerate(cols)]
    _count("columnar")
    return pa.Table.from_arrays(arrays, schema=target)
