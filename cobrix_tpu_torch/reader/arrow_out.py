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

Left out, because they need ``cobrix_tpu.native`` (the port builds the
same arrays on the routes above) or serve only the JAX package's host
backend and lazy decode: the fused decode->Arrow assembly
(``_asm_descriptor``, ``_asm_call``, ``_build_native_scalars``,
``_native_flat_values``), the raw-image ``leaf_strings_at`` and
``leaf_numeric_at``, the grouped and limb decimal builds
(``_decimal_group_array``, ``_decimal128_native``), the native string
buffers, ``const_string_col`` and ``pack_validity``; and the per-field
cost attribution (``obs.fieldcost``). Also left out: the decode-once
batches' redefine masks and the compact OCCURS route that rides them,
since the port decodes each active segment on its own and gives an
inactive redefine a null struct; and ``rows_to_table``, the route of
row-backed results, which no reader of the port gives.
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
    """Builds Arrow arrays for one DecodedBatch of a single active
    segment (`active`; None for records of no redefine): a segment
    redefine other than `active` is a null struct."""

    def __init__(self, batch: DecodedBatch, active: Optional[str]):
        self.batch = batch
        self.decoder = batch.decoder
        self.active = active
        self.n = batch.n_records

    # -- leaves ------------------------------------------------------------

    def _python_fallback(self, col: int, pa_type):
        pa = _pa()
        values = self.batch.column_values(col)
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
        lengths = self.batch.lengths
        if lengths is not None and bool(
                (lengths < spec.offset + spec.width).any()):
            # truncated variable-length tails: the scalar path owns the
            # partial-field rules
            return self._python_fallback(col, pa_type)
        out = self.batch.column_arrays(col)
        if "host" in out:
            return self._python_fallback(col, pa_type)
        if spec.codec in _STRING_CODECS:
            return self._string_array(spec, out, pa_type)
        values = np.asarray(out["values"])
        valid = np.asarray(out["valid"])
        if "values_hi" not in out and (spec.codec in _FLOAT_CODECS
                                       or pa.types.is_integer(pa_type)):
            return pa.array(
                values.astype(_numpy_dtype_for(pa_type), copy=False),
                mask=None if valid.all() else ~valid)
        if not pa.types.is_decimal(pa_type):
            return self._python_fallback(col, pa_type)
        if spec.params.explicit_decimal or _dyn_scale(spec):
            shift = pa_type.scale - np.asarray(out["dot_scale"],
                                               dtype=np.int64)
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
                    else self._python_fallback(col, pa_type))
        if np.any((shift < 0) | (shift > 18)):
            return self._python_fallback(col, pa_type)
        return _decimal128_from_mantissa(values.astype(np.int64, copy=False),
                                         shift, valid, pa_type)

    def _string_array(self, spec, out, pa_type):
        pa = _pa()
        if not self.batch._vectorizable_string(spec):
            # UTF-16 / HEX / RAW / custom charsets: per-value host decode
            return self._python_fallback(spec.index, pa_type)
        mat = out["bytes"]
        if mat.ndim != 2 or mat.shape[1] == 0:
            return pa.array([""] * self.n, type=pa_type)
        if mat.dtype == np.uint16 and bool((mat > 0x7F).any()):
            # non-ASCII code points need real UTF-8 encoding
            return self._python_fallback(spec.index, pa_type)
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

    def _flat_slot_values(self, st: Primitive, slot_path, max_size: int):
        """One record-major flat array covering every OCCURS slot of a
        numeric leaf (slot s of record i at i*S+s), stacked from the
        slots' planes. None -> caller uses the per-slot path."""
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
        lengths = self.batch.lengths
        if lengths is not None:
            last = self.decoder.plan.columns[cols[-1]]
            if bool((lengths < last.offset + last.width).any()):
                return None  # truncated tails own the partial-field rules
        outs = [self.batch.column_arrays(c) for c in cols]
        if any("values" not in o or "values_hi" in o for o in outs):
            return None
        vals = np.stack([o["values"] for o in outs], axis=1)
        valid = np.stack([o["valid"] for o in outs], axis=1)
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

    def _flat_struct_values(self, group: Group, slot_path, max_size: int):
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
            flat = self._flat_slot_values(child, slot_path, max_size)
            if flat is None:
                return None
            names.append(child.name)
            children.append(flat)
        if not children:
            return None
        return pa.StructArray.from_arrays(children, names=names)

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

    def _struct_array(self, group: Group, slot_path):
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
        return pa.StructArray.from_arrays(children, names=names)

    def _statement_array(self, st: Statement, slot_path,
                         as_element: bool = False):
        pa = _pa()
        if st.is_array and not as_element:
            return self._list_array(st, slot_path)
        if isinstance(st, Group):
            if st.is_segment_redefine and not as_element and (
                    self.active is None
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
