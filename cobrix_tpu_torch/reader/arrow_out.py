"""Vectorized Arrow output: decoded host planes -> pyarrow Table.

Port copy of ``cobrix_tpu.reader.arrow_out`` on its numpy routes, so
that the tables are the JAX package's. Numeric columns become typed
arrays from the (values, valid) planes without touching Python objects;
Decimal columns of up to 18 digits are built as decimal128 buffers from
the int64 mantissas, shifted exactly in 128 bits as the native
``decimal128_batch`` does; strings come from the code-point planes
through one vectorized trim; OCCURS arrays become ListArrays over one
record-major flat values array, with offsets from the DEPENDING ON
counts. Schema types follow the output StructType
(spark-cobol schema/CobolSchema.scala:77-173): Decimal->decimal128(p,s),
Integral->int32/int64 by precision bucket, COMP-1/2->float32/float64,
RAW->binary, OCCURS->list. Whatever the vectorized routes cannot express
(host-fallback codecs, truncated variable-length tails, non-ASCII code
points, custom charsets, UTF-16/HEX/RAW, wider decimals and decimal
shifts outside 0..18) is built from the column's Python value list: the
same values and nulls as the rows.

One change from the JAX package: a decimal value that does not fit its
declared precision and scale on that value-list route, which only a
malformed record gives (a binary field holds more digits than its PIC
declares), is null in the table, as Spark makes a decimal overflow
null; the JAX package's ``to_arrow`` raises ArrowInvalid on such a
record (ROADMAP C5).

A decode-once batch (every record of a hierarchical read decoded at the
full plan) carries per-redefine row masks (`redefine_masks`): a segment
redefine's struct is null on the rows of other segments, whose decoded
values are garbage by design and are never read (strings blanked,
numbers invalid, OCCURS planes built for the visible rows only:
`_compact_visibility`). `leaf_strings_at` and `leaf_numeric_at` build a
leaf at given record positions from the batch's planes in numpy, where
the JAX package's transcodes strings from the raw file image with its
native library. `rows_to_table` builds the table of a row-backed result
(the host row walk), with the value-list route's decimal rule above.

Left out, because they need ``cobrix_tpu.native`` (the port builds the
same arrays on the routes above) or serve only the JAX package's host
backend and lazy decode: the fused decode->Arrow assembly
(``_asm_descriptor``, ``_asm_call``, ``_build_native_scalars``,
``_native_flat_values``), the grouped and limb decimal builds
(``_decimal_group_array``, ``_decimal128_native``), the native string
buffers, ``const_string_col`` and ``pack_validity``; and the per-field
cost attribution (``obs.fieldcost``).
"""
from __future__ import annotations

import decimal
from typing import List, Optional, Sequence

import numpy as np

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.datatypes import SchemaRetentionPolicy, TrimPolicy
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


def _validity_buffer(valid: np.ndarray):
    pa = _pa()
    # py_buffer holds a reference to the packed array: zero-copy
    return pa.py_buffer(np.packbits(valid, bitorder="little"))


_LOW32 = np.uint64(0xFFFFFFFF)
_U32 = np.uint64(32)
# 10**k as (high, low) uint64 limbs, k = 0..38
_POW10_HI = np.array([(10 ** k) >> 64 for k in range(39)], dtype=np.uint64)
_POW10_LO = np.array([(10 ** k) & (2 ** 64 - 1) for k in range(39)],
                     dtype=np.uint64)


def _mul64(a: np.ndarray, b: np.ndarray):
    """(high, low) uint64 limbs of the 128-bit products a * b."""
    a_lo, a_hi = a & _LOW32, a >> _U32
    b_lo, b_hi = b & _LOW32, b >> _U32
    ll, lh, hl = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo
    mid = (ll >> _U32) + (lh & _LOW32) + (hl & _LOW32)
    lo = (ll & _LOW32) | (mid << _U32)
    hi = a_hi * b_hi + (lh >> _U32) + (hl >> _U32) + (mid >> _U32)
    return hi, lo


def _decimal128_array(hi: np.ndarray, lo: np.ndarray, negative: np.ndarray,
                      shift, valid: np.ndarray, pa_type,
                      max_digits: int = 0):
    """decimal128 array of +-(hi * 2**64 + lo) * 10**shift (`shift` a
    scalar or one per value) as the unscaled values, exact in 128 bits
    as the JAX package's native ``decimal128_batch`` and
    ``decimal128_from_limbs`` make them. With `max_digits`, None when a
    valid value needs a shift outside 0..38, or outruns 128 bits or that
    many digits: the caller then takes the value-list route."""
    pa = _pa()
    n = len(lo)
    shift = np.broadcast_to(np.asarray(shift, dtype=np.int64), (n,))
    if max_digits and bool(((shift < 0) | (shift > 38))[valid].any()):
        return None
    k = np.clip(shift, 0, 38)
    b_hi, b_lo = _POW10_HI[k], _POW10_LO[k]
    # (hi, lo) * (b_hi, b_lo) mod 2**128, and whether it overflows
    zero = np.uint64(0)
    p1_hi, p1_lo = _mul64(lo, b_lo)
    p2_hi, p2_lo = _mul64(lo, b_hi) if b_hi.any() else (zero, zero)
    p3_hi, p3_lo = _mul64(hi, b_lo) if hi.any() else (zero, zero)
    s1 = p1_hi + p2_lo
    out_hi = s1 + p3_lo
    out_lo = p1_lo
    if max_digits:
        over = (((hi != 0) & (b_hi != 0)) | (p2_hi != 0) | (p3_hi != 0)
                | (s1 < p1_hi) | (out_hi < s1))
        bound = 10 ** max_digits
        m_hi, m_lo = np.uint64(bound >> 64), np.uint64(bound & (2**64 - 1))
        over |= (out_hi > m_hi) | ((out_hi == m_hi) & (out_lo >= m_lo))
        if bool(over[valid].any()):
            return None
    # two's complement of the 128-bit value where negative
    lo_neg = ~out_lo + np.uint64(1)
    hi_neg = ~out_hi + (lo_neg == 0).astype(np.uint64)
    le = np.empty((n, 2), dtype="<u8")
    le[:, 0] = np.where(negative, lo_neg, out_lo)
    le[:, 1] = np.where(negative, hi_neg, out_hi)
    vbuf = None if valid.all() else _validity_buffer(valid)
    return pa.Array.from_buffers(pa_type, n, [vbuf, pa.py_buffer(le)])


def _decimal128_from_mantissa(mantissa: np.ndarray, shift,
                              valid: np.ndarray, pa_type):
    """decimal128 array of `mantissa` (int64) * 10**`shift` (0..18):
    exact in 128 bits, unbounded by the precision, as the JAX package's
    native build of decimals of up to 18 digits."""
    if np.ndim(shift) == 0 and len(mantissa):
        scale = 10 ** int(shift)
        limit = (2 ** 63 - 1) // scale
        if -limit <= int(mantissa.min()) and int(mantissa.max()) <= limit:
            # the product fits int64: its sign-extended 128-bit form
            pa = _pa()
            le = np.empty((len(mantissa), 2), dtype="<i8")
            le[:, 0] = mantissa * scale
            le[:, 1] = le[:, 0] >> 63
            vbuf = None if valid.all() else _validity_buffer(valid)
            return pa.Array.from_buffers(pa_type, len(mantissa),
                                         [vbuf, pa.py_buffer(le)])
    # |INT64_MIN| wraps under int64 abs; its uint64 view is 2**63
    mag = np.abs(mantissa).view(np.uint64)
    return _decimal128_array(np.zeros_like(mag), mag, mantissa < 0, shift,
                             valid, pa_type)


def _static_decimal_shift(spec, pa_type) -> Optional[int]:
    """Mantissa power-of-ten shift for a fixed-exponent decimal column
    (None when out of the exact-int64 0..18 window)."""
    shift = pa_type.scale + fixed_point_exponent(spec)
    return shift if 0 <= shift <= 18 else None


def _numpy_dtype_for(pa_type):
    """pa numeric type -> the numpy dtype the planes cast to."""
    pa = _pa()
    if pa.types.is_floating(pa_type):
        return np.float32 if pa.types.is_float32(pa_type) else np.float64
    return np.int32 if pa.types.is_int32(pa_type) else np.int64


_FIT_CTX = decimal.Context(prec=100)


def _fits_decimal(value: "decimal.Decimal", pa_type) -> bool:
    """Whether `value` is exact at the type's scale and within its
    precision. Only a malformed record's field gives a value that is
    not (a binary field holds more digits than its PIC declares)."""
    q = value.quantize(decimal.Decimal(1).scaleb(-pa_type.scale),
                       context=_FIT_CTX)
    return q == value and (q.is_zero()
                           or q.adjusted() < pa_type.precision - pa_type.scale)


# Java String.trim strips everything <= ' ' on both sides; left/right trim
# strip " \t" (scalar_decoders._trim parity)
_JAVA_TRIM = "".join(map(chr, range(0x21)))
_LR_TRIM = " \t"


def _string_from_codepoints(mat: np.ndarray, trimming: TrimPolicy):
    """[n, w] code points (uint8 masked ASCII or uint16 LUT output) -> Arrow
    string array. Requires every code point <= 0x7F so UTF-8 bytes == code
    points (the caller falls back otherwise); the fixed-width matrix becomes
    one string buffer with uniform offsets, and trimming runs in Arrow's
    C++ kernels."""
    import pyarrow.compute as pc

    pa = _pa()
    n, w = mat.shape
    data = np.ascontiguousarray(mat.astype(np.uint8, copy=False))
    big = n * w > 2**31 - 8
    off_t, s_t = ("<i8", pa.large_string()) if big else ("<i4", pa.string())
    offsets = np.arange(n + 1, dtype=off_t) * w
    arr = pa.Array.from_buffers(
        s_t, n, [None, pa.py_buffer(offsets), pa.py_buffer(data)])
    if trimming is TrimPolicy.BOTH:
        arr = pc.utf8_trim(arr, characters=_JAVA_TRIM)
    elif trimming is TrimPolicy.LEFT:
        arr = pc.utf8_ltrim(arr, characters=_LR_TRIM)
    elif trimming is TrimPolicy.RIGHT:
        arr = pc.utf8_rtrim(arr, characters=_LR_TRIM)
    if big:
        arr = arr.cast(pa.string())
    return arr


class ArrowBatchBuilder:
    """Builds Arrow arrays for one DecodedBatch — either a single active
    segment (`active`; None for records of no redefine: a segment
    redefine other than `active` is a null struct), or a decode-once
    whole-plan batch where `redefine_masks` gates each segment redefine
    per row via the struct validity bitmap (inactive rows' decoded bytes
    are garbage, but a null parent struct masks its children by Arrow
    semantics)."""

    def __init__(self, batch: DecodedBatch, active: Optional[str],
                 redefine_masks: Optional[dict] = None):
        self.batch = batch
        self.decoder = batch.decoder
        self.active = active
        self.redefine_masks = redefine_masks
        self.n = batch.n_records

    # -- leaves ------------------------------------------------------------

    def leaf_strings_at(self, sts, positions: np.ndarray) -> dict:
        """String-leaf values built AT `positions` from the batch's
        code-point planes, for every eligible statement of one struct.
        Returns {id(st): pa.StringArray} for the leaves it could build;
        callers fall back to the full-length build + take for the rest
        (UTF-16 / HEX / RAW / custom charsets, non-ASCII code points,
        truncated rows). Rows hidden by a redefine mask are blanked: the
        null parent struct hides them."""
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
            mat = mat[positions]
            relevant = self._relevant_of(spec)
            if relevant is not None:
                hidden = ~relevant[positions]
                if hidden.any():
                    mat[hidden] = 0x20
            if mat.dtype == np.uint16 and bool((mat > 0x7F).any()):
                continue
            out[id(st)] = _string_from_codepoints(
                mat, self.decoder.plan.trimming)
        return out

    def leaf_numeric_at(self, st: Primitive, positions: np.ndarray):
        """Integer/float leaf values gathered AT `positions` — the numpy
        gather happens before the Arrow build instead of a full-length
        array + take. None -> caller uses the full path (decimals, wide
        planes, truncation, host fallback)."""
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
        values = np.asarray(out["values"])[positions]
        valid = np.asarray(out["valid"])[positions]
        return pa.array(
            values.astype(_numpy_dtype_for(pa_type), copy=False),
            mask=None if valid.all() else ~valid)

    def _relevant_of(self, spec):
        """Row-visibility mask for a column of a decode-once batch (None =
        visible everywhere)."""
        if self.redefine_masks is not None and spec.segment:
            return self.redefine_masks.get(spec.segment.upper())
        return None

    def _python_fallback(self, col: int, pa_type, relevant=None):
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
            return pa.nulls(self.n, type=pa_type)
        spec = self.decoder.plan.columns[col]
        # rows where this column is visible: in a decode-once batch a
        # redefine-gated column only matters where its segment is active
        # (elsewhere the parent struct is null and the decoded bytes are
        # garbage by design)
        relevant = self._relevant_of(spec)
        lengths = self.batch.lengths
        if lengths is not None:
            trunc = lengths < spec.offset + spec.width
            if relevant is not None:
                trunc = trunc & relevant
            if bool(trunc.any()):
                # truncated variable-length tails: the scalar path owns
                # the partial-field rules
                return self._python_fallback(col, pa_type, relevant)
        out = self.batch.column_arrays(col)
        if "host" in out:
            return self._python_fallback(col, pa_type, relevant)
        if spec.codec in _STRING_CODECS:
            return self._string_array(spec, out, pa_type, relevant)
        values = np.asarray(out["values"])
        valid = np.asarray(out["valid"])
        if relevant is not None:
            # hidden rows: invalid, so that their garbage neither forces
            # the value-list route nor reaches a buffer
            valid = valid & relevant
        if "values_hi" not in out and (spec.codec in _FLOAT_CODECS
                                       or pa.types.is_integer(pa_type)):
            return pa.array(
                values.astype(_numpy_dtype_for(pa_type), copy=False),
                mask=None if valid.all() else ~valid)
        if not pa.types.is_decimal(pa_type):
            return self._python_fallback(col, pa_type, relevant)
        if spec.params.explicit_decimal or _dyn_scale(spec):
            shift = pa_type.scale - np.asarray(out["dot_scale"],
                                               dtype=np.int64)
            if relevant is not None:
                shift = np.where(relevant, shift, 0)
        else:
            shift = pa_type.scale + fixed_point_exponent(spec)
        if "values_hi" in out or pa_type.precision > 18:
            # wide (uint128-limb) mantissas, and int64 ones of a wider
            # type: bounded by the declared precision, as the native
            # limb build is; a value out of it takes the value list
            if "values_hi" in out:
                hi = np.asarray(out["values_hi"]).view(np.uint64)
                lo = np.asarray(out["values"]).view(np.uint64)
                neg = np.asarray(out["negative"])
            else:
                v = values.astype(np.int64, copy=False)
                lo, neg = np.abs(v).view(np.uint64), v < 0
                hi = np.zeros_like(lo)
            arr = _decimal128_array(hi, lo, neg, shift, valid, pa_type,
                                    max_digits=pa_type.precision)
            return (arr if arr is not None
                    else self._python_fallback(col, pa_type, relevant))
        if np.any((shift < 0) | (shift > 18)):
            return self._python_fallback(col, pa_type, relevant)
        return _decimal128_from_mantissa(values.astype(np.int64, copy=False),
                                         shift, valid, pa_type)

    def _string_array(self, spec, out, pa_type, relevant=None):
        pa = _pa()
        if not self.batch._vectorizable_string(spec):
            # UTF-16 / HEX / RAW / custom charsets: per-value host decode
            return self._python_fallback(spec.index, pa_type, relevant)
        mat = out["bytes"]
        if mat.ndim != 2 or mat.shape[1] == 0:
            return pa.array([""] * self.n, type=pa_type)
        if relevant is not None and not relevant.all():
            # hidden rows' garbage code points must not poison the
            # column (their >0x7F values would truncate to invalid
            # UTF-8 below) — blank them; the null parent struct hides
            # whatever value they produce
            mat = mat.copy()
            mat[~relevant] = 0x20
        if mat.dtype == np.uint16 and bool((mat > 0x7F).any()):
            # non-ASCII code points need real UTF-8 encoding
            return self._python_fallback(spec.index, pa_type, relevant)
        return _string_from_codepoints(mat, self.decoder.plan.trimming)

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
        """One record-major flat array covering every OCCURS slot of a
        numeric leaf (slot s of record i at i*S+s), stacked from the
        slots' planes. `compact_rows` (decode-once): build values for
        ONLY these rows — the caller verified hidden rows are nulled at
        an enclosing struct, where child buffers are invisible. Rows a
        redefine mask hides are otherwise invalid. None -> caller uses
        the per-slot path."""
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
        outs = [self.batch.column_arrays(c) for c in cols]
        if any("values" not in o or "values_hi" in o for o in outs):
            return None
        if compact_rows is not None:
            vals = np.stack([o["values"][compact_rows] for o in outs], axis=1)
            valid = np.stack([o["valid"][compact_rows] for o in outs], axis=1)
        else:
            vals = np.stack([o["values"] for o in outs], axis=1)
            valid = np.stack([o["valid"] for o in outs], axis=1)
            if relevant is not None:
                valid &= relevant[:, None]
        flat = vals.reshape(-1)
        fvalid = valid.reshape(-1)
        if is_decimal:
            shift = _static_decimal_shift(spec0, pa_type)
            if shift is None:
                return None
            return _decimal128_from_mantissa(
                flat.astype(np.int64, copy=False), shift, fvalid, pa_type)
        return pa.array(
            flat.astype(_numpy_dtype_for(pa_type), copy=False),
            mask=None if fvalid.all() else ~fvalid)

    def _flat_struct_values(self, group: Group, slot_path, max_size: int,
                            compact_rows=None):
        """Record-major flat StructArray over all OCCURS slots of a group
        element whose fields are all numeric leaves (exp3's
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
        return pa.StructArray.from_arrays(children, names=names)

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
        """Record-major all-null values array for a pruned constant-size
        OCCURS subtree (primitive elements, or a group of primitive
        non-array children), shaped as the per-slot walk would build it
        (valid structs, null leaves). None -> caller takes the per-slot
        path."""
        pa = _pa()
        total = self.n * max_size
        if not isinstance(st, Group):
            return pa.nulls(total,
                            type=to_arrow_type(primitive_data_type(st)))
        names, children = [], []
        for child in st.children:
            if child.is_filler:
                continue
            if isinstance(child, Group) or child.is_array:
                return None
            names.append(child.name)
            children.append(pa.nulls(
                total, type=to_arrow_type(primitive_data_type(child))))
        if not children:
            return None
        return pa.StructArray.from_arrays(children, names=names)

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
                        return pa.ListArray.from_arrays(pa.array(offsets),
                                                        cflat)
            if flat is None:
                flat = (self._flat_struct_values(st, slot_path, max_size)
                        if isinstance(st, Group)
                        else self._flat_slot_values(st, slot_path,
                                                    max_size))
            if flat is not None:
                if counts is None:
                    offsets = np.arange(n + 1, dtype=np.int32) * max_size
                    return pa.ListArray.from_arrays(pa.array(offsets), flat)
                # DEPENDING ON: drop the unused tail slots with one
                # ascending-index gather over the record-major array
                mask = np.arange(max_size)[None, :] < counts[:, None]
                if bool(mask.all()):
                    values = flat
                else:
                    indices = (np.arange(n, dtype=np.int64)[:, None]
                               * max_size
                               + np.arange(max_size,
                                           dtype=np.int64)[None, :])[mask]
                    values = flat.take(pa.array(indices))
                offsets = np.zeros(n + 1, dtype=np.int32)
                np.cumsum(counts, out=offsets[1:])
                return pa.ListArray.from_arrays(pa.array(offsets), values)
        elems = [self._statement_array(st, slot_path + (k,), as_element=True)
                 for k in range(max_size)]
        if n == 0 or max_size == 0:
            value_type = (elems[0].type if elems
                          else to_arrow_type(self._element_schema_type(st)))
            return pa.ListArray.from_arrays(
                pa.array(np.zeros(n + 1, dtype=np.int32)),
                pa.nulls(0, type=value_type))
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
        values = pa.concat_arrays(elems).take(indices)
        offsets = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        return pa.ListArray.from_arrays(pa.array(offsets), values)

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
            return pa.nulls(self.n, type=pa.struct([]))
        return pa.StructArray.from_arrays(
            children, names=names,
            mask=None if null_mask is None else pa.array(null_mask))

    def _statement_array(self, st: Statement, slot_path,
                         as_element: bool = False):
        pa = _pa()
        if st.is_array and not as_element:
            return self._list_array(st, slot_path)
        if isinstance(st, Group):
            if st.is_segment_redefine and not as_element:
                if self.redefine_masks is not None:
                    mask = self.redefine_masks.get(st.name.upper())
                    if mask is None or not mask.any():
                        t = to_arrow_type(StructType(self._group_fields(st)))
                        return pa.nulls(self.n, type=t)
                    return self._struct_array(st, slot_path,
                                              null_mask=~mask)
                if (self.active is None
                        or st.name.upper() != self.active.upper()):
                    t = to_arrow_type(StructType(self._group_fields(st)))
                    return pa.nulls(self.n, type=t)
            return self._struct_array(st, slot_path)
        return self._leaf_array(st, slot_path)

    # -- top level ---------------------------------------------------------

    def body_columns(self, policy: SchemaRetentionPolicy):
        """(name, array) pairs for the record body, matching
        CobolOutputSchema._create_schema ordering."""
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
