"""Vectorized Arrow output: decoded planes -> pyarrow Table.

Port copy of ``cobrix_tpu.reader.arrow_out``, so that the tables are the
JAX package's. Where the JAX package builds its buffers with its native
decode->Arrow assembly (``_asm_descriptor``, ``_asm_call``,
``_build_native_scalars``, ``_native_flat_values``, the native string
buffers, ``decimal128_batch`` and ``pack_validity``), the port builds
them on the device from the batch's decoded planes
(``ops.arrow_assemble``): `ArrowBatchBuilder` walks the output schema
and requests every leaf it can build there (a `Request` a column: the
int32 / int64 / float32 / float64 values, the 128-bit decimals with a
static, per-row or digit-count shift, the UTF-8 strings of the
code-point planes under the trim policy, one record-major flat array of
every slot of an OCCURS leaf: slot s of record i at i*S+s), then one
assembly builds them all and every array wraps its buffers in the one
host copy of the assembly's output. Schema types follow the output
StructType (spark-cobol schema/CobolSchema.scala:77-173):
Decimal->decimal128(p,s), Integral->int32/int64 by precision bucket,
COMP-1/2->float32/float64, RAW->binary, OCCURS->list (list offsets from
the DEPENDING ON counts, on the host). Whatever the device route cannot
express (host-fallback codecs, truncated variable-length tails, custom
charsets, UTF-16/HEX/RAW, wide integers, per-value exponents of other
codecs, a narrow decimal's shift outside 0..18, and a column the
assembly marks bad: a decimal out of its exact window, a string with a
surrogate code point or past 2^31 - 1 bytes) is built from the column's
Python value list: the same values and nulls as the rows.

One change from the JAX package: a decimal value that does not fit its
declared precision and scale on that value-list route, which only a
malformed record gives (a binary field holds more digits than its PIC
declares), is null in the table, as Spark makes a decimal overflow
null; the JAX package's ``to_arrow`` raises ArrowInvalid on such a
record (ROADMAP C5).

A decode-once batch (every record of a hierarchical read decoded at the
full plan) carries per-redefine row masks (`redefine_masks`): a segment
redefine's struct is null on the rows of other segments, whose decoded
values are garbage by design and are never read (the assembly makes
them null and zero, or blank strings, without reading them; OCCURS
planes are built for the visible rows only: `_compact_visibility`).
`leaf_strings_at` and `leaf_numeric_at` request a leaf at given record
positions (a row table), where the JAX package transcodes strings from
the raw file image with its native library. `rows_to_table` builds the
table of a row-backed result (the host row walk), with the value-list
route's decimal rule above.

Per-field cost attribution (``obs.fieldcost``) charges the assemble
plane once a batch, around its card assembly (`_Leaves.run`), and per
column on the value-list route, into the accumulator the batch captured
at decode time (a sequential read's tables are built after
``read_cobol`` returned).

Left out: the grouped and limb decimal builds of the JAX package's
numpy backend (``_decimal_group_array``, ``_decimal128_native``) and
``const_string_col``.
"""
from __future__ import annotations

import decimal
from typing import List, Optional, Sequence

import numpy as np

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.datatypes import SchemaRetentionPolicy, TrimPolicy
from ..obs import fieldcost
from ..ops import arrow_assemble as asm
from ..plan.compiler import Codec
from .columnar import (
    _FLOAT_CODECS,
    _STRING_CODECS,
    _dyn_scale,
    _resolve_occurs,
    DecodedBatch,
    fixed_point_exponent,
)
from .schema import (
    ArrayType,
    Field,
    SimpleType,
    StructType,
    primitive_data_type,
)


def _pa():
    import pyarrow as pa
    return pa


def warm_pyarrow() -> None:
    """Run pyarrow's lazy pandas import on the calling thread: pyarrow
    imports pandas at its first masked ``pa.array`` call. The pipelined
    read calls this before its threads start, so that the first call is
    never one thread's while another thread uses pyarrow: the JAX
    package's parallel assembly makes several first calls at once, and
    the process may then segfault in a later ``pa.array`` (ROADMAP C4).
    After the first call this costs a few microseconds."""
    pa = _pa()
    pa.array(np.zeros(1, dtype=np.int64), mask=np.ones(1, dtype=bool))


def to_arrow_type(t):
    """Our schema type -> pyarrow type (decimal(p,s) strings included)."""
    pa = _pa()
    if isinstance(t, SimpleType):
        name = t.name
        if name == "string":
            return pa.string()
        if name == "integer":
            return pa.int32()
        if name == "long":
            return pa.int64()
        if name == "float":
            return pa.float32()
        if name == "double":
            return pa.float64()
        if name == "binary":
            return pa.binary()
        if name.startswith("decimal("):
            p, s = name[8:-1].split(",")
            return pa.decimal128(int(p), int(s))
        raise TypeError(f"Unknown simple type {name}")
    if isinstance(t, StructType):
        return pa.struct([(f.name, to_arrow_type(f.dtype)) for f in t.fields])
    if isinstance(t, ArrayType):
        return pa.list_(to_arrow_type(t.element))
    raise TypeError(t)


def arrow_schema(struct: StructType):
    # memoized on the StructType instance: per-chunk pipeline assembly
    # calls this once per chunk
    cached = getattr(struct, "_pa_schema", None)
    if cached is not None:
        return cached
    pa = _pa()
    schema = pa.schema([(f.name, to_arrow_type(f.dtype))
                        for f in struct.fields])
    try:
        struct._pa_schema = schema
    except AttributeError:  # slotted/frozen struct types stay uncached
        pass
    return schema


_FIT_CTX = decimal.Context(prec=100)


def _fits_decimal(value: "decimal.Decimal", pa_type) -> bool:
    """Whether `value` is exact at the type's scale and within its
    precision. Only a malformed record's field gives a value that is
    not (a binary field holds more digits than its PIC declares)."""
    q = value.quantize(decimal.Decimal(1).scaleb(-pa_type.scale),
                       context=_FIT_CTX)
    return q == value and (q.is_zero()
                           or q.adjusted() < pa_type.precision - pa_type.scale)


# the assembly's trim modes: Java String.trim strips everything <= ' ' on
# both sides, left/right trim strip " \t" (scalar_decoders._trim parity)
_TRIM_MODES = {TrimPolicy.NONE: asm.TRIM_NONE, TrimPolicy.BOTH: asm.TRIM_BOTH,
               TrimPolicy.LEFT: asm.TRIM_LEFT, TrimPolicy.RIGHT: asm.TRIM_RIGHT}


def _once(build):
    """A thunk that builds its array at the first call only."""
    box = []

    def get():
        if not box:
            box.append(build())
        return box[0]
    return get


class _Leaves:
    """The leaf arrays of one batch that the device assembly builds
    (``ops.arrow_assemble``): requested while the builder walks the
    schema, built in one assembly, read back as Arrow arrays over the
    one host copy of its output buffer (``pa.py_buffer``: no copy)."""

    def __init__(self, batch: DecodedBatch):
        self.batch = batch
        self.requests: List[asm.Request] = []
        self.types: list = []
        # each request's column (its cost name, width and kernel label)
        self.specs: list = []
        self.result: Optional[asm.Result] = None

    def add(self, request: "asm.Request", pa_type, spec) -> int:
        if self.result is not None:
            raise RuntimeError("a leaf was requested after the assembly ran")
        self.requests.append(request)
        self.types.append(pa_type)
        self.specs.append(spec)
        return len(self.requests) - 1

    def run(self) -> None:
        if self.result is None and self.requests:
            # field-cost attribution: one assemble-plane region over the
            # plan and the card assembly, which ends in its own
            # synchronize, split across the requested columns by bytes
            fc = self.batch.field_costs
            tok = fc.begin() if fc is not None else None
            plan = asm.build_plan(self.requests, self.batch.host_buffer,
                                  self.batch.decoder.device)
            self.result = asm.assemble(plan)
            if tok is not None:
                self._charge(fc, tok)

    def _charge(self, fc, tok) -> None:
        n = max(1, self.batch.n_records)
        cost_name = self.batch.decoder.plan.cost_name
        fc.commit_weighted(
            tok,
            [((cost_name(spec),),
              spec.width * max(1, r.length // n), r.length * spec.width,
              f"{spec.codec.value}/w{spec.width}")
             for r, spec in zip(self.requests, self.specs)],
            fieldcost.PLANE_ASSEMBLE, self.batch.n_records)

    def array(self, i: int):
        """Request i's array, or None when the assembly marked it bad."""
        pa = _pa()
        res, r, t = self.result, self.requests[i], self.types[i]
        if res.bad(i):
            return None
        if r.is_string:
            return pa.Array.from_buffers(
                pa.string(), r.length,
                [None, pa.py_buffer(res.values(i)),
                 pa.py_buffer(res.data(i))])
        nulls = res.null_count(i)
        vbuf = None if nulls == 0 else pa.py_buffer(res.bitmap(i))
        return pa.Array.from_buffers(t, r.length,
                                     [vbuf, pa.py_buffer(res.values(i))],
                                     null_count=nulls)


def _no_fallback():
    raise RuntimeError("the device assembly marked an integer, float or "
                       "flat OCCURS array bad, which it never does")


class ArrowBatchBuilder:
    """Builds Arrow arrays for one DecodedBatch — either a single active
    segment (`active`; None for records of no redefine: a segment
    redefine other than `active` is a null struct), or a decode-once
    whole-plan batch where `redefine_masks` gates each segment redefine
    per row via the struct validity bitmap (inactive rows' decoded bytes
    are garbage, but a null parent struct masks its children by Arrow
    semantics).

    The walk returns thunks: every leaf the device assembly builds is
    requested while the schema is walked, `assemble` builds them all at
    once, and calling a thunk then makes its array (`build` does the
    three for one statement)."""

    def __init__(self, batch: DecodedBatch, active: Optional[str],
                 redefine_masks: Optional[dict] = None):
        self.batch = batch
        self.decoder = batch.decoder
        self.active = active
        self.redefine_masks = redefine_masks
        self.n = batch.n_records
        self.leaves = _Leaves(batch)

    def assemble(self) -> None:
        """Build every requested leaf (one assembly on the batch's
        device); the walk's thunks may be called after this."""
        self.leaves.run()

    def _requested(self, request: "asm.Request", pa_type, fallback, spec):
        """Thunk of `request`'s assembled array (of column `spec`, or of
        the OCCURS field whose first slot it is), or of `fallback()` (the
        value-list route) where the assembly marks it bad."""
        if request.length == 0:
            pa = _pa()
            return lambda: pa.array([], type=pa_type)
        i = self.leaves.add(request, pa_type, spec)

        def build():
            arr = self.leaves.array(i)
            return arr if arr is not None else fallback()
        return build

    # -- leaves ------------------------------------------------------------

    def _number_kind(self, spec, out: dict, pa_type) -> Optional[tuple]:
        """(source kind, output kind, decimal mode, shift, precision
        bound) of a number column on the device route, or None for the
        value-list route: wide integers, float codecs of another width,
        per-value exponents of other codecs, and a narrow decimal whose
        static shift leaves 0..18 (as ``_asm_descriptor`` decides in the
        JAX package, with the port's narrow rule)."""
        pa = _pa()
        wide = "values_hi" in out
        dtype = np.asarray(out["values"]).dtype
        int_src = {np.dtype(np.int32): asm.SRC_I32,
                   np.dtype(np.int64): asm.SRC_I64}.get(dtype)
        if not wide and spec.codec in _FLOAT_CODECS:
            src = asm.SRC_F32 if dtype == np.float32 else asm.SRC_F64
            if pa.types.is_float32(pa_type):
                return src, asm.OUT_F32, asm.DEC_NONE, 0, 0
            if pa.types.is_float64(pa_type):
                return src, asm.OUT_F64, asm.DEC_NONE, 0, 0
            return None
        if not wide and pa.types.is_integer(pa_type):
            if int_src is None or not (pa.types.is_int32(pa_type)
                                       or pa.types.is_int64(pa_type)):
                return None
            out_kind = (asm.OUT_I32 if pa.types.is_int32(pa_type)
                        else asm.OUT_I64)
            return int_src, out_kind, asm.DEC_NONE, 0, 0
        if not pa.types.is_decimal(pa_type):
            return None
        src = asm.SRC_WIDE if wide else int_src
        if src is None:
            return None
        p = spec.params
        if p.explicit_decimal or _dyn_scale(spec):
            if spec.codec is Codec.BINARY and p.scale_factor < 0:
                # binary PIC P: |sf| + the value's digit count
                # (columnar._binary_dyn_dots), counted on the card
                mode, shift = asm.DEC_DIGITS, pa_type.scale + p.scale_factor
            elif "dot_scale" in out and np.asarray(
                    out["dot_scale"]).dtype == np.int32:
                mode, shift = asm.DEC_DOTS, pa_type.scale
            else:
                return None
        else:
            mode = asm.DEC_STATIC
            shift = pa_type.scale + fixed_point_exponent(spec)
        if mode == asm.DEC_STATIC and not wide \
                and pa_type.precision <= 18 and not 0 <= shift <= 18:
            return None
        # every decimal is bounded by its declared precision: a value
        # out of it (a malformed record's binary field holding more
        # digits than its PIC) takes the value list, which makes it null
        # (ROADMAP C5), so that every array is valid Arrow and a Parquet
        # export stores what the table holds
        return src, asm.OUT_DEC, mode, shift, pa_type.precision

    @staticmethod
    def _number_planes(out: dict, kind: tuple) -> dict:
        planes = {"values": out["values"], "valid": out["valid"]}
        if kind[0] == asm.SRC_WIDE:
            planes["hi"] = out["values_hi"]
            planes["neg"] = out["negative"]
        if kind[2] == asm.DEC_DOTS:
            planes["dots"] = out["dot_scale"]
        return planes

    def _number_request(self, kind: tuple, outs: Sequence[dict],
                        length: int, rows=None, mask=None):
        src, out_kind, mode, shift, maxd = kind
        return asm.Request(length, [self._number_planes(o, kind)
                                    for o in outs], src, out_kind, mode,
                           shift, maxd, rows=rows, mask=mask)

    def _string_request(self, spec, mat: np.ndarray, rows=None, mask=None):
        return asm.Request(
            self.n if rows is None else len(rows), [{"values": mat}],
            asm.SRC_CP16 if mat.dtype == np.uint16 else asm.SRC_CP8,
            asm.OUT_UTF8, rows=rows, mask=mask, width=mat.shape[1],
            trim=_TRIM_MODES[self.decoder.plan.trimming])

    def leaf_strings_at(self, sts, positions: np.ndarray) -> dict:
        """String-leaf thunks built AT `positions` from the batch's
        code-point planes, for every eligible statement of one struct.
        Returns {id(st): thunk} for the leaves it could build; callers
        fall back to the full-length build + take for the rest
        (UTF-16 / HEX / RAW / custom charsets, truncated rows). Rows
        hidden by a redefine mask are blank: the null parent struct
        hides them."""
        pa = _pa()
        out = {}
        for st in sts:
            col = self.decoder.slot_map.get((id(st), ()))
            if col is None:
                continue
            spec = self.decoder.plan.columns[col]
            if spec.codec not in _STRING_CODECS \
                    or not self.batch._vectorizable_string(spec):
                continue
            lengths = self.batch.lengths
            if lengths is not None and bool(
                    (lengths[positions] < spec.offset + spec.width).any()):
                continue  # truncated tails keep the scalar-owned path
            mat = self.batch.column_arrays(col)["bytes"]
            if mat.ndim != 2 or mat.shape[1] == 0:
                continue
            relevant = self._relevant_of(spec)

            def fallback(col=col, relevant=relevant):
                return self._python_fallback(
                    col, pa.string(), relevant).take(pa.array(positions))
            out[id(st)] = self._requested(
                self._string_request(spec, mat, rows=positions,
                                     mask=relevant), pa.string(), fallback,
                spec)
        return out

    def leaf_numeric_at(self, st: Primitive, positions: np.ndarray):
        """Thunk of an integer/float leaf built AT `positions` (the row
        table of its request) instead of a full-length array + take.
        None -> caller uses the full path (decimals, wide planes,
        truncation, host fallback)."""
        pa = _pa()
        col = self.decoder.slot_map.get((id(st), ()))
        if col is None:
            return None
        spec = self.decoder.plan.columns[col]
        pa_type = to_arrow_type(primitive_data_type(st))
        if not (pa.types.is_integer(pa_type)
                or pa.types.is_floating(pa_type)):
            return None
        if spec.codec in _STRING_CODECS:
            return None
        lengths = self.batch.lengths
        if lengths is not None and bool(
                (lengths[positions] < spec.offset + spec.width).any()):
            return None  # truncated tails keep the scalar-owned path
        out = self.batch.column_arrays(col)
        if "values" not in out or "values_hi" in out:
            return None
        kind = self._number_kind(spec, out, pa_type)
        if kind is None:
            return None
        return self._requested(
            self._number_request(kind, [out], len(positions),
                                 rows=positions), pa_type, _no_fallback,
            spec)

    def _relevant_of(self, spec):
        """Row-visibility mask for a column of a decode-once batch (None =
        visible everywhere)."""
        if self.redefine_masks is not None and spec.segment:
            return self.redefine_masks.get(spec.segment.upper())
        return None

    def _python_fallback(self, col: int, pa_type, relevant=None):
        fc = self.batch.field_costs
        if fc is None:
            return self._python_fallback_impl(col, pa_type, relevant)
        tok = fc.begin()
        arr = self._python_fallback_impl(col, pa_type, relevant)
        # seconds only: the column's bytes were counted by its decode
        fc.commit(tok, (self.decoder.plan.cost_name(
            self.decoder.plan.columns[col]),), fieldcost.PLANE_ASSEMBLE,
            0, 0)
        return arr

    def _python_fallback_impl(self, col: int, pa_type, relevant=None):
        pa = _pa()
        # `relevant` (decode-once batches): rows hidden by a null parent
        # struct materialize as None and skip the truncation fixups
        values = self.batch.column_values(col, relevant=relevant)
        try:
            return pa.array(values, type=pa_type)
        except pa.ArrowInvalid:
            if not pa.types.is_decimal(pa_type):
                raise
        # a malformed record's decimal that does not fit the type: null
        return pa.array([v if v is None or _fits_decimal(v, pa_type)
                         else None for v in values], type=pa_type)

    def _leaf_array(self, st: Primitive, slot_path):
        pa = _pa()
        pa_type = to_arrow_type(primitive_data_type(st))
        col = self.decoder.slot_map.get((id(st), slot_path))
        if col is None:
            return lambda: pa.nulls(self.n, type=pa_type)
        spec = self.decoder.plan.columns[col]
        # rows where this column is visible: in a decode-once batch a
        # redefine-gated column only matters where its segment is active
        # (elsewhere the parent struct is null and the decoded bytes are
        # garbage by design): the assembly makes hidden rows null (blank
        # strings) without reading them
        relevant = self._relevant_of(spec)

        def fallback():
            return self._python_fallback(col, pa_type, relevant)
        lengths = self.batch.lengths
        if lengths is not None:
            trunc = lengths < spec.offset + spec.width
            if relevant is not None:
                trunc = trunc & relevant
            if bool(trunc.any()):
                # truncated variable-length tails: the scalar path owns
                # the partial-field rules
                return fallback
        out = self.batch.column_arrays(col)
        if "host" in out:
            return fallback
        if spec.codec in _STRING_CODECS:
            if not self.batch._vectorizable_string(spec):
                # UTF-16 / HEX / RAW / custom charsets: per-value host decode
                return fallback
            mat = out["bytes"]
            if mat.ndim != 2 or mat.shape[1] == 0:
                return lambda: pa.array([""] * self.n, type=pa_type)
            return self._requested(
                self._string_request(spec, mat, mask=relevant), pa_type,
                fallback, spec)
        kind = self._number_kind(spec, out, pa_type)
        if kind is None:
            return fallback
        return self._requested(
            self._number_request(kind, [out], self.n, mask=relevant),
            pa_type, fallback, spec)

    # -- arrays / groups ---------------------------------------------------

    def _occurs_counts(self, st: Statement) -> Optional[np.ndarray]:
        """Per-record element counts, or None when constant max size."""
        if st.depending_on is None:
            return None
        dep_col = self.decoder.dependee_columns.get(st.depending_on)
        if dep_col is None:
            return None
        values = self.batch.column_values(dep_col)
        if st.depending_on_handlers or any(
                not isinstance(v, (int, np.integer)) for v in values):
            return np.asarray([_resolve_occurs(st, v) for v in values],
                              dtype=np.int64)
        v = np.asarray(values, dtype=np.int64)
        return np.where((v >= st.array_min_size) & (v <= st.array_max_size),
                        v, st.array_max_size)

    def _flat_slot_values(self, st: Primitive, slot_path, max_size: int,
                          compact_rows=None):
        """Thunk of one record-major flat array covering every OCCURS slot
        of a numeric leaf (slot s of record i at i*S+s): one request of S
        slots. `compact_rows` (decode-once): build values for ONLY these
        rows — the caller verified hidden rows are nulled at an enclosing
        struct, where child buffers are invisible. Rows a redefine mask
        hides are otherwise null. None -> caller uses the per-slot
        path."""
        pa = _pa()
        pa_type = to_arrow_type(primitive_data_type(st))
        is_decimal = pa.types.is_decimal(pa_type)
        if not (pa.types.is_integer(pa_type) or pa.types.is_floating(pa_type)
                or is_decimal):
            return None
        cols = [self.decoder.slot_map.get((id(st), slot_path + (k,)))
                for k in range(max_size)]
        if any(c is None for c in cols):
            return None
        spec0 = self.decoder.plan.columns[cols[0]]
        if is_decimal and (spec0.params.explicit_decimal
                           or _dyn_scale(spec0)
                           or pa_type.precision > 18):
            return None  # per-value exponents and wide values stay per slot
        relevant = self._relevant_of(spec0)
        lengths = self.batch.lengths
        if lengths is not None:
            last = self.decoder.plan.columns[cols[-1]]
            trunc = lengths < last.offset + last.width
            if relevant is not None:
                trunc = trunc & relevant
            if bool(trunc.any()):
                return None  # truncated tails own the partial-field rules
        first = self.batch.column_arrays(cols[0])
        if "values" not in first or "values_hi" in first:
            return None
        kind = self._number_kind(spec0, first, pa_type)
        if kind is None:
            return None
        planes = self._slot_planes(cols, kind)
        if planes is None:
            outs = [self.batch.column_arrays(c) for c in cols]
            if any("values" not in o or "values_hi" in o for o in outs):
                return None
            planes = [self._number_planes(o, kind) for o in outs]
        n = self.n if compact_rows is None else len(compact_rows)
        src, out_kind, mode, shift, maxd = kind
        return self._requested(
            asm.Request(n * max_size, planes, src, out_kind, mode, shift,
                        maxd, rows=compact_rows,
                        mask=relevant if compact_rows is None else None),
            pa_type, _no_fallback, spec0)

    def _slot_planes(self, cols: Sequence[int], kind: tuple):
        """The planes of an OCCURS field's slots `cols` as one
        `asm.SlotPlanes` ([rows, S] views of its kernel group's planes)
        when they are evenly spaced columns of one group, as the fused
        decoder lays them out: the first, second and last slots' planes
        give and check the spacing, so the plan reads a few attributes a
        plane kind, not every slot's planes. None otherwise."""
        place = self.decoder.group_position
        if any(c not in place for c in cols):
            return None
        pos = np.fromiter((place[c][1] for c in cols), dtype=np.int64,
                          count=len(cols))
        if len({place[c][0] for c in cols}) != 1 or (len(pos) > 1 and (
                pos[1] <= pos[0] or np.any(np.diff(pos) != pos[1] - pos[0]))):
            return None
        ends = [self._number_planes(self.batch.column_arrays(c), kind)
                for c in (cols[0], cols[min(1, len(cols) - 1)], cols[-1])]
        arrays = {}
        for name, a in ends[0].items():
            a, b, z = (np.asarray(e.get(name)) for e in ends)
            addr = [x.__array_interface__["data"][0] for x in (a, b, z)]
            step = addr[1] - addr[0]
            if any(x.dtype != a.dtype or x.shape != a.shape
                   or x.strides != a.strides for x in (b, z)) \
                    or addr[2] != addr[0] + (len(cols) - 1) * step:
                return None
            arrays[name] = np.lib.stride_tricks.as_strided(
                a, shape=(a.shape[0], len(cols)),
                strides=(a.strides[0], step), writeable=False)
        return asm.SlotPlanes(arrays)

    def _flat_struct_values(self, group: Group, slot_path, max_size: int,
                            compact_rows=None):
        """Thunk of a record-major flat StructArray over all OCCURS slots
        of a group element whose fields are all numeric leaves (exp3's
        STRATEGY-DETAIL). None -> per-slot path."""
        pa = _pa()
        names, children = [], []
        for child in group.children:
            if child.is_filler:
                continue
            if isinstance(child, Group) or child.is_array:
                return None
            flat = self._flat_slot_values(child, slot_path, max_size,
                                          compact_rows=compact_rows)
            if flat is None:
                return None
            names.append(child.name)
            children.append(flat)
        if not children:
            return None
        return lambda: pa.StructArray.from_arrays([c() for c in children],
                                                  names=names)

    def _compact_visibility(self, st: Statement):
        """Row mask under which `st` (a decode-once OCCURS subtree) is
        visible, IF the hidden rows are guaranteed nulled at an enclosing
        segment-redefine struct: there, child buffers are logically
        invisible, so values need building only for the visible rows
        (exp3: the 2000-slot STRATEGY plane shrinks from every record to
        just the C records). None = no mask, or no null-struct
        guarantee — callers must then build positionally."""
        if self.redefine_masks is None:
            return None
        node, redef = st.parent, None
        while node is not None:
            if getattr(node, "is_segment_redefine", False):
                redef = node
                break
            node = node.parent
        # the redefine root only receives its struct null mask when it is
        # built as a row-level struct: itself not an array, and not
        # nested inside one (element structs are built unmasked)
        if redef is None or redef.is_array:
            return None
        p = redef.parent
        while p is not None:
            if p.is_array:
                return None
            p = p.parent
        mask = self.redefine_masks.get(redef.name.upper())
        if mask is None or bool(mask.all()):
            return None  # fully visible: the positional path IS compact
        return mask

    def _subtree_planned(self, st: Statement) -> bool:
        """True when any leaf under `st` has a compiled column. False
        means the projection pruned the whole subtree: its output is
        nulls, buildable without walking slots."""
        if id(st) in self.decoder.planned_statement_ids:
            return True
        if isinstance(st, Group):
            return any(self._subtree_planned(c) for c in st.children)
        return False

    def _flat_null_values(self, st: Statement, max_size: int):
        """Thunk of a record-major all-null values array for a pruned
        constant-size OCCURS subtree (primitive elements, or a group of
        primitive non-array children), shaped as the per-slot walk would
        build it (valid structs, null leaves). None -> caller takes the
        per-slot path."""
        pa = _pa()
        total = self.n * max_size
        if not isinstance(st, Group):
            t = to_arrow_type(primitive_data_type(st))
            return lambda: pa.nulls(total, type=t)
        names, types = [], []
        for child in st.children:
            if child.is_filler:
                continue
            if isinstance(child, Group) or child.is_array:
                return None
            names.append(child.name)
            types.append(to_arrow_type(primitive_data_type(child)))
        if not types:
            return None
        return lambda: pa.StructArray.from_arrays(
            [pa.nulls(total, type=t) for t in types], names=names)

    def _list_array(self, st: Statement, slot_path):
        pa = _pa()
        n, max_size = self.n, st.array_max_size
        counts = self._occurs_counts(st)
        if n and max_size and n * max_size < 2**31 - 1:
            # one flat record-major values array (slot s of record i at
            # i*S+s), then list offsets over it
            flat = None
            if not self._subtree_planned(st):
                flat = self._flat_null_values(st, max_size)
            if flat is None and counts is None:
                # decode-once + segment mask: values for visible rows
                # only; hidden rows get EMPTY lists, invisible under
                # their null redefine struct
                cmask = self._compact_visibility(st)
                if cmask is not None:
                    rows = np.nonzero(cmask)[0]
                    cflat = (self._flat_struct_values(
                                 st, slot_path, max_size, compact_rows=rows)
                             if isinstance(st, Group)
                             else self._flat_slot_values(
                                 st, slot_path, max_size, compact_rows=rows))
                    if cflat is not None:
                        offsets = np.zeros(n + 1, dtype=np.int32)
                        np.cumsum(np.where(cmask, max_size, 0),
                                  out=offsets[1:])
                        return lambda: pa.ListArray.from_arrays(
                            pa.array(offsets), cflat())
            if flat is None:
                flat = (self._flat_struct_values(st, slot_path, max_size)
                        if isinstance(st, Group)
                        else self._flat_slot_values(st, slot_path,
                                                    max_size))
            if flat is not None:
                if counts is None:
                    offsets = np.arange(n + 1, dtype=np.int32) * max_size
                    return lambda: pa.ListArray.from_arrays(
                        pa.array(offsets), flat())
                # DEPENDING ON: drop the unused tail slots with one
                # ascending-index gather over the record-major array
                mask = np.arange(max_size)[None, :] < counts[:, None]
                offsets = np.zeros(n + 1, dtype=np.int32)
                np.cumsum(counts, out=offsets[1:])
                if bool(mask.all()):
                    return lambda: pa.ListArray.from_arrays(
                        pa.array(offsets), flat())
                indices = (np.arange(n, dtype=np.int64)[:, None] * max_size
                           + np.arange(max_size, dtype=np.int64)[None, :]
                           )[mask]
                return lambda: pa.ListArray.from_arrays(
                    pa.array(offsets), flat().take(pa.array(indices)))
        elems = [self._statement_array(st, slot_path + (k,), as_element=True)
                 for k in range(max_size)]
        if n == 0 or max_size == 0:
            def empty():
                value_type = (elems[0]().type if elems else to_arrow_type(
                    self._element_schema_type(st)))
                return pa.ListArray.from_arrays(
                    pa.array(np.zeros(n + 1, dtype=np.int32)),
                    pa.nulls(0, type=value_type))
            return empty
        # element k of record i sits at position k*n + i of the concatenation
        idx = (np.arange(max_size)[None, :] * n
               + np.arange(n)[:, None])
        if counts is None:
            lengths = np.full(n, max_size, dtype=np.int64)
            indices = idx.ravel()
        else:
            mask = np.arange(max_size)[None, :] < counts[:, None]
            lengths = counts
            indices = idx[mask]
        offsets = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        return lambda: pa.ListArray.from_arrays(
            pa.array(offsets),
            pa.concat_arrays([e() for e in elems]).take(indices))

    def _element_schema_type(self, st: Statement):
        if isinstance(st, Group):
            return StructType(self._group_fields(st))
        return primitive_data_type(st)

    def _group_fields(self, group: Group) -> List[Field]:
        fields = []
        for child in group.children:
            if child.is_filler:
                continue
            if isinstance(child, Group):
                if child.parent_segment is not None:
                    continue
                t = self._element_schema_type(child)
                fields.append(Field(
                    child.name, ArrayType(t) if child.is_array else t))
            else:
                t = primitive_data_type(child)
                fields.append(Field(
                    child.name, ArrayType(t) if child.is_array else t))
        return fields

    def _struct_array(self, group: Group, slot_path, null_mask=None):
        pa = _pa()
        names, children = [], []
        for child in group.children:
            if child.is_filler:
                continue
            if isinstance(child, Group) and child.parent_segment is not None:
                continue  # hierarchical child segments never reach this path
            names.append(child.name)
            children.append(self._statement_array(child, slot_path))
        if not children:
            return lambda: pa.nulls(self.n, type=pa.struct([]))
        return lambda: pa.StructArray.from_arrays(
            [c() for c in children], names=names,
            mask=None if null_mask is None else pa.array(null_mask))

    def _statement_array(self, st: Statement, slot_path,
                         as_element: bool = False):
        """Thunk of `st`'s array (see the class docstring)."""
        pa = _pa()
        if st.is_array and not as_element:
            return self._list_array(st, slot_path)
        if isinstance(st, Group):
            if st.is_segment_redefine and not as_element:
                if self.redefine_masks is not None:
                    mask = self.redefine_masks.get(st.name.upper())
                    if mask is None or not mask.any():
                        t = to_arrow_type(StructType(self._group_fields(st)))
                        return lambda: pa.nulls(self.n, type=t)
                    return self._struct_array(st, slot_path,
                                              null_mask=~mask)
                if (self.active is None
                        or st.name.upper() != self.active.upper()):
                    t = to_arrow_type(StructType(self._group_fields(st)))
                    return lambda: pa.nulls(self.n, type=t)
            return self._struct_array(st, slot_path)
        return self._leaf_array(st, slot_path)

    # -- top level ---------------------------------------------------------

    def body_columns(self, policy: SchemaRetentionPolicy):
        """(name, array) pairs for the record body, matching
        CobolOutputSchema._create_schema ordering: the walk, one
        assembly, then the arrays."""
        out = self.request_body(policy)
        self.assemble()
        return [(name, build()) for name, build in out]

    def request_body(self, policy: SchemaRetentionPolicy):
        """The walk of `body_columns`: (name, thunk) pairs, every leaf the
        assembly builds requested in `leaves`."""
        out = []
        for root in self.decoder.copybook.ast.children:
            if not isinstance(root, Group):
                continue
            if policy is SchemaRetentionPolicy.COLLAPSE_ROOT:
                for child in root.children:
                    if child.is_filler:
                        continue
                    if isinstance(child, Group) and child.parent_segment is not None:
                        continue
                    out.append((child.name, self._statement_array(child, ())))
            else:
                out.append((root.name, self._statement_array(root, ())))
        return out


def segment_table(batch: DecodedBatch,
                  active: Optional[str],
                  output_schema,
                  file_id: int = 0,
                  record_ids: Optional[np.ndarray] = None,
                  seg_level_ids=None,
                  input_file_name: str = "",
                  corrupt_reasons: Optional[Sequence] = None):
    """One Arrow table for one decoded batch of a single active segment,
    with the generated columns the output schema asks for in front.
    `seg_level_ids`: a `SegLevelColumns` view of the batch's rows;
    `corrupt_reasons`: per-row values of the trailing corrupt-record
    debug column (None entries = clean; None = every row clean)."""
    pa = _pa()
    builder = ArrowBatchBuilder(batch, active)
    n = batch.n_records

    def seg_arrays():
        return [seg_level_ids.arrow_level(lvl) if seg_level_ids is not None
                else pa.nulls(n, type=pa.string())
                for lvl in range(output_schema.generate_seg_id_field_count)]

    def file_name_col():
        enc = input_file_name.encode("utf-8")
        offsets = np.arange(n + 1, dtype=np.int32) * len(enc)
        return pa.Array.from_buffers(
            pa.string(), n, [None, pa.py_buffer(offsets),
                             pa.py_buffer(enc * n)])

    # Generated columns in ROW order (extractors._apply_post_processing /
    # reference RecordExtractors.applyRecordPostProcessing): with record
    # ids the file name goes before the Seg_Id levels; without, after.
    # The declared schema prepends the file-name field before the Seg_Id
    # fields in BOTH cases (CobolSchema.scala:99-103) — the reference binds
    # Spark Rows positionally, so that (reference) misalignment is parity;
    # columns here are therefore labeled positionally, exactly like rows.
    cols: List[object] = []
    if output_schema.generate_record_id:
        cols.append(pa.array(np.full(n, file_id, dtype=np.int32)))
        rids = (np.asarray(record_ids, dtype=np.int64)
                if record_ids is not None else np.arange(n, dtype=np.int64))
        cols.append(pa.array(rids))
        if output_schema.input_file_name_field:
            cols.append(file_name_col())
        cols.extend(seg_arrays())
    else:
        cols.extend(seg_arrays())
        if output_schema.input_file_name_field:
            cols.append(file_name_col())
    cols.extend(arr for _, arr in builder.body_columns(output_schema.policy))
    if getattr(output_schema, "corrupt_record_field", ""):
        cols.append(pa.nulls(n, pa.string()) if corrupt_reasons is None
                    else pa.array(list(corrupt_reasons), type=pa.string()))
    target = arrow_schema(output_schema.schema)
    if len(cols) != len(target):
        raise ValueError(
            f"Arrow column count mismatch: built {len(cols)}, "
            f"schema {len(target)}")
    arrays = [c.cast(target.field(i).type)
              if c.type != target.field(i).type else c
              for i, c in enumerate(cols)]
    return pa.Table.from_arrays(arrays, schema=target)


def rows_to_table(rows: List[List[object]], struct: StructType):
    """A typed table from materialized Python rows (row-backed results:
    the host row walk, hierarchical rows). Same declared types as the
    vectorized routes, so both produce schema-identical tables; a
    decimal that does not fit its type is null, as on the value-list
    route (ROADMAP C5)."""
    pa = _pa()
    target = arrow_schema(struct)
    arrays = []
    for i, f in enumerate(struct.fields):
        col = [row[i] for row in rows]
        pa_type = target.field(i).type
        try:
            arr = pa.array(_normalize_objects(col, f.dtype), type=pa_type)
        except pa.ArrowInvalid:
            arr = pa.array(_normalize_objects(col, f.dtype, fit=True),
                           type=pa_type)
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, schema=target)


def _normalize_objects(values, dtype, fit: bool = False):
    """Tuples (group values) -> dicts keyed by field name so pa.array can
    build struct arrays from the nested row shape. `fit`: decimals that
    do not fit their declared type become None."""
    if isinstance(dtype, StructType):
        names = [f.name for f in dtype.fields]
        return [None if v is None else
                {nm: nv for nm, nv in zip(
                    names, (_normalize_objects([x], f.dtype, fit)[0]
                            for x, f in zip(v, dtype.fields)))}
                for v in values]
    if isinstance(dtype, ArrayType):
        return [None if v is None
                else _normalize_objects(list(v), dtype.element, fit)
                for v in values]
    if fit and isinstance(dtype, SimpleType) \
            and dtype.name.startswith("decimal("):
        pa_type = to_arrow_type(dtype)
        return [v if v is None or _fits_decimal(decimal.Decimal(v), pa_type)
                else None for v in values]
    return list(values)


def cached_table(holder, output_schema):
    """The table the pipelined read's assemble stage cached on `holder`
    (a DecodedBatch or FileResult) when it was built for this output
    schema, by identity or by an equal Arrow schema; else None."""
    table = holder._arrow_cache
    if table is not None and (
            holder._arrow_cache_schema is output_schema
            or table.schema.equals(arrow_schema(output_schema.schema))):
        return table
    return None
