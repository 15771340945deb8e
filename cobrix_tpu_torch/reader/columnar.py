"""Columnar batch decoder on the device: [batch, record_len] uint8 -> columns.

Port of ``cobrix_tpu.reader.columnar`` carrying only the device path
(the JAX package's ``backend="pallas"``). A `FieldPlan` is bound to kernel
launches exactly as there: columns sharing (codec, width, kernel variant)
form one kernel group. Every group that ``_pallas_group_spec`` would fuse
goes through ONE launch of the fused CUDA kernel (``ops.fused_decode``);
string and float groups go through ``ops.batch_torch`` on the same device,
as ``_run_group_jax`` sends them through batch_jax; host-fallback columns
decode per value on the host. The outputs come back as the same host
planes, with the same dtypes, that the JAX package builds, and
`DecodedBatch` turns them into values and rows with the JAX package's code.

`decode_raw` is the packed route of the JAX package's ``decode_raw``
(``packed_fallback``, the route of its device backends): the records of a
file image already on the device are packed at the plan's extent by the
pack kernel (``ops.device_framing.pack_records``) and decoded there; the
packed matrix never comes to the host, so such a batch keeps on the host
only the rows its truncation and host-fallback columns read
(`DecodedBatch` ``host_rows``). `decoder_for_segment` builds a reader's
decoder per (active segment, device) once.

`decode_planes` is the counterpart of ``build_jax_decode_fn``: one
batch on the device in, each kernel group's outputs as device tensors
out, with nothing copied to the host; the device-resident query path
(``parallel.query``, ``parallel.sharded``) reduces them where they lie.
`_decode_device` runs it and then makes the batch's one copy back, so
the two launch the same work. A decoder takes a column projection
(`select`), as the JAX decoder does; `rebuild_groups` after a byte
projection rewrote the plan's offsets builds a new fused layout, with
its own device tables.

`DecodedBatch.concat` joins the batches of one file's records into one
batch (the hierarchical read assembles a file's records as one).
`DecodedBatch.to_arrow` builds a batch's table (``arrow_out
.segment_table``: its host buffer goes back to the device, where the
Arrow buffers are built, ``ops.arrow_assemble``), or returns the one the
pipelined read's assemble stage cached on it.

Left out of the port: the numpy and native backends, the lazy planes,
the in-place raw kernels and segment row masks of ``decode_raw``, the
native Arrow string buffers and their caches (``string_arrow_buffers``,
``_build_arrow_strings``, ``_group_masks``: the port's strings are
built on the device from the code-point planes) and the multi-device
``shard_map`` split (ROADMAP A7). Field-cost attribution
(``obs.fieldcost``) charges the decode plane once a batch, after its
one synchronize and its `collect_outputs` (`_commit_decode`), and per
column in `_decode_host_fallback`.
"""
from __future__ import annotations

import decimal as _decimal
import threading
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..copybook.ast import Group, Primitive, Statement
from ..copybook.copybook import Copybook
from ..copybook.datatypes import (
    Decimal,
    Integral,
    MAX_INTEGER_PRECISION,
    MAX_LONG_PRECISION,
    SchemaRetentionPolicy,
    Usage,
)
from ..device import resolve_device
from ..obs import fieldcost
from ..ops import batch_torch
from ..ops.device_framing import pack_records
from ..ops.fused_decode import (_PLANE_DTYPES, FusedLayout, StridedGroup,
                                fused_decode)
from ..profiling import annotate
from ..plan.cache import cached_code_page_lut, cached_compile_plan
from ..plan.compiler import Codec, ColumnSpec, FieldPlan
from .extractors import DecodeOptions

PyDecimal = _decimal.Decimal

_NUMERIC_CODECS = (Codec.BINARY, Codec.BCD, Codec.DISPLAY_NUM,
                   Codec.DISPLAY_NUM_ASCII)

# wide (uint128) mantissas carry up to 39 digits; the default 28-digit
# context would round them during scaleb
_WIDE_CTX = _decimal.Context(prec=60)


def _exact_scaleb(mantissa: int, e: int) -> "PyDecimal":
    if e == 0:
        return PyDecimal(mantissa)
    return PyDecimal(mantissa).scaleb(e, _WIDE_CTX)
_FLOAT_CODECS = (Codec.FLOAT_IBM, Codec.FLOAT_IEEE, Codec.DOUBLE_IBM,
                 Codec.DOUBLE_IEEE)
_STRING_CODECS = (Codec.EBCDIC_STRING, Codec.ASCII_STRING, Codec.UTF16_STRING,
                  Codec.HEX_STRING, Codec.RAW_BYTES)

# numpy view of each torch dtype a batch's outputs take on the host
_NP_DTYPES = {torch.uint8: np.uint8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float32: np.float32, torch.bool: np.bool_}
# byte alignment of each output in a batch's buffer
_OUT_ALIGN = 256


def _is_wide(spec: ColumnSpec) -> bool:
    """>18-digit fields decode through the uint128-limb kernels (the
    reference's BigDecimal plane: BCDNumberDecoders.decodeBigBCDNumber,
    decodeBinaryAribtraryPrecision, decodeEbcdicBigNumber). DISPLAY
    classifies by byte width, not PIC precision: every byte of the field
    could be a digit, and the oracle decodes whatever digits are there."""
    if spec.codec is Codec.BINARY:
        return spec.width > 8
    if spec.codec in (Codec.DISPLAY_NUM, Codec.DISPLAY_NUM_ASCII):
        return spec.width > MAX_LONG_PRECISION
    return spec.params.precision > MAX_LONG_PRECISION


def _variant_key(spec: ColumnSpec) -> tuple:
    p = spec.params
    if spec.codec is Codec.BINARY:
        return (p.signed, p.big_endian, spec.width <= 4, _is_wide(spec))
    if spec.codec is Codec.BCD:
        return (p.precision <= MAX_INTEGER_PRECISION, _is_wide(spec))
    if spec.codec in (Codec.DISPLAY_NUM, Codec.DISPLAY_NUM_ASCII):
        # only a NEGATIVE scale factor changes the kernel (the dyn_sf
        # digit-count plane); positive sf is applied per column at
        # materialization, so grouping on min(sf, 0) avoids splitting
        # otherwise-identical columns into separate kernel launches.
        # require_digits is unconditional: a digit-less DISPLAY field
        # (blank fill) decodes to null for integrals, explicit-point
        # AND implied-point decimals alike — the value the encoder's
        # blank fill for None round-trips back to
        return (p.signed, p.explicit_decimal, True,
                spec.width <= MAX_INTEGER_PRECISION,
                min(p.scale_factor, 0),
                _is_wide(spec))
    return ()


def _dyn_scale(spec: ColumnSpec) -> bool:
    """PIC P with a negative scale factor on a DISPLAY/BINARY field: the
    reference's exponent depends on the decoded digit count
    (addDecimalPoint, BinaryUtils.scala:208-211), so it rides the
    per-value dot_scale plane instead of a static exponent."""
    return (spec.params.scale_factor < 0
            and spec.codec is not Codec.BCD)


def _digit_count(values, xp=np):
    """Decimal digit count of |value| for int64 planes; array-module
    parameterized so the host path (numpy) and the traced DeviceAggregator
    program (jnp) share the exact 10^k boundary logic."""
    absv = xp.abs(values.astype(xp.int64))
    nd = xp.ones(absv.shape, dtype=xp.int32)
    for k in range(1, 19):
        nd = nd + (absv >= 10 ** k)
    # int64 min has no positive abs; it carries 19 decimal digits
    return xp.where(absv < 0, 19, nd)


def _digit_count_limbs(hi, lo, xp=np):
    """Same for uint128 magnitudes held as (hi, lo) uint64 limb planes."""
    hi = hi.astype(xp.uint64)
    lo = lo.astype(xp.uint64)
    nd = xp.ones(hi.shape, dtype=xp.int32)
    for k in range(1, 39):
        p = 10 ** k
        ph = xp.uint64(p >> 64)
        pl = xp.uint64(p & 0xFFFFFFFFFFFFFFFF)
        nd = nd + ((hi > ph) | ((hi == ph) & (lo >= pl)))
    return nd


def _binary_dyn_dots(values: np.ndarray, sf: int) -> np.ndarray:
    """dot_scale plane for a narrow binary PIC P column: |sf| + number of
    decimal digits in str(|value|)."""
    return _digit_count(values).astype(np.int64) - sf


def _wide_dyn_dots(hi: np.ndarray, lo: np.ndarray, sf: int) -> np.ndarray:
    """Same for a wide (uint128-limb magnitude) binary PIC P column."""
    return _digit_count_limbs(hi, lo).astype(np.int64) - sf


class _KernelGroup:
    def __init__(self, codec: Codec, width: int, variant: tuple,
                 columns: List[ColumnSpec], names: Tuple[str, ...]):
        self.codec = codec
        self.width = width
        self.variant = variant
        self.columns = columns
        self.offsets = np.array([c.offset for c in columns], dtype=np.int64)
        # cost-attribution identity: plan-resolved field names (OCCURS
        # slots repeat a name and merge into one cost row; names reused
        # across statements arrive path-qualified — FieldPlan.cost_name)
        # and the kernel-family label shown in the explain table
        self.names = names
        self.label = f"{codec.value}/w{width}"

    @property
    def wide(self) -> bool:
        """uint128-limb output layout (values_hi/values/negative planes)."""
        return (self.codec in _NUMERIC_CODECS and self.variant
                and self.variant[-1] is True)


def fixed_point_exponent(spec: ColumnSpec) -> int:
    """Constant power-of-ten exponent for a non-explicit-decimal fixed-point
    column: value = mantissa * 10**e. Shared by the row path and the Arrow
    columnar output (same branches as the reference's decimal placement,
    BCDNumberDecoders.scala:83-162 scale/scaleFactor rules). Negative
    scale factors on DISPLAY/BINARY are dynamic (see _dyn_scale) and never
    reach this path."""
    dt = spec.dtype
    sf = spec.params.scale_factor
    if isinstance(dt, Decimal) and dt.usage is Usage.COMP3:
        n_digits = spec.width * 2 - 1
        return sf if sf > 0 else sf - n_digits if sf < 0 else -spec.params.scale
    if sf > 0:
        # addDecimalPoint appends sf zeros and ignores the scale
        return sf
    return -spec.params.scale


def _resolve_occurs(st: Statement, dep_value) -> int:
    """DEPENDING ON value -> element count (clamp + string-handler rules,
    reference RecordExtractors.scala:68-80). Shared by the per-cell and
    compiled row-assembly paths."""
    max_size = st.array_max_size
    if dep_value is None:
        return max_size
    if isinstance(dep_value, str):
        dep_value = st.depending_on_handlers.get(dep_value, max_size)
    else:
        dep_value = int(dep_value)
    if st.array_min_size <= dep_value <= max_size:
        return dep_value
    return max_size


def fused_group_spec(g: _KernelGroup) -> Optional[StridedGroup]:
    """StridedGroup for the fused kernel, or None if the group stays on
    the batch_torch path (strings, floats, host fallback). The port of
    ``columnar._pallas_group_spec``: every numeric plane is fused."""
    if g.codec is Codec.BINARY:
        signed, big_endian, fits32, wide = g.variant
        out = "i32" if fits32 else "wide" if wide else "i64"
        return StridedGroup(g.offsets, g.width, "binary", out,
                            signed=signed, big_endian=big_endian)
    if g.codec is Codec.BCD:
        fits32, wide = g.variant
        out = "i32" if fits32 else "wide" if wide else "i64"
        return StridedGroup(g.offsets, g.width, "bcd", out)
    if g.codec in (Codec.DISPLAY_NUM, Codec.DISPLAY_NUM_ASCII):
        signed, allow_dot, require_digits, fits32, sf, wide = g.variant
        out = "i32" if fits32 else "wide" if wide else "i64"
        kind = ("display_ebcdic" if g.codec is Codec.DISPLAY_NUM
                else "display_ascii")
        return StridedGroup(
            g.offsets, g.width, kind, out, signed=signed,
            allow_dot=allow_dot, require_digits=require_digits,
            dyn_sf=min(sf, 0))
    return None


class DecodedBatch:
    """Decoded columns of one record batch (host planes)."""

    def __init__(self, decoder: "ColumnarDecoder",
                 data: Optional[np.ndarray],
                 outputs: Dict[int, dict],
                 lengths: Optional[np.ndarray] = None,
                 host_rows: Optional[Dict[int, np.ndarray]] = None,
                 n_records: Optional[int] = None,
                 host_buffer: Optional[torch.Tensor] = None,
                 groups: Optional[List[tuple]] = None):
        self.decoder = decoder
        # each kernel group's host outputs, the arrays `collect_outputs`
        # made the columns' planes of (`concat` joins them)
        self.groups = groups
        # the one host buffer the host planes are numpy views of: the one
        # the decode's copy back filled (pinned for a CUDA batch), or a
        # join's; the Arrow assembly copies it to the device whole (None:
        # the assembly stages the planes it reads)
        self.host_buffer = host_buffer
        # the host record matrix; None for a batch that crossed to the
        # device from a staging buffer or was packed there, whose
        # truncated rows (the only ones `value` reads bytes of) come to
        # the host in `host_rows`
        self.data = data
        self.host_rows = host_rows or {}
        self.n_records = (n_records if n_records is not None
                          else data.shape[0] if data is not None
                          else len(lengths))
        self._out = outputs  # col index -> {"values","valid","dot_scale","bytes"}
        self._str_cache: Dict[int, List[str]] = {}
        self._col_cache: Dict[int, list] = {}
        self._maker_cache: Dict[tuple, object] = {}
        # actual byte length of each record when shorter than the padded
        # row; columns past a record's end are null / truncated like
        # reference Primitive.decodeTypeValue (Primitive.scala:102)
        self.lengths = lengths
        # the table the pipelined read's assemble stage built, and the
        # output schema it was built for
        self._arrow_cache = None
        self._arrow_cache_schema = None
        # the read's cost accumulator, captured at DECODE time (the obs
        # context is active here) so the Arrow assembly of this batch
        # attributes to the right read even when it runs after
        # read_cobol returned (sequential to_arrow)
        self.field_costs = fieldcost.current()

    @classmethod
    def concat(cls, batches: Sequence["DecodedBatch"]) -> "DecodedBatch":
        """One batch over the records of `batches` (of one decoder), in
        order: each kernel group's host outputs concatenated into one
        host buffer (`host_buffer`), the columns' planes views of them,
        and the lengths;
        the host bytes of records cut short keyed by their position in
        the whole. The hierarchical read decodes a file's records in
        batches and assembles them as one."""
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        # each kernel group's outputs are joined, a copy each, into one
        # host buffer, in the memory order they came in (the fused
        # planes' columns stay contiguous); the columns' planes are views
        # of them, as after a decode. A join a column would be thousands
        # of copies, and threads joining shards side by side would queue
        # for the interpreter at each one
        n = sum(b.n_records for b in batches)
        layout, total = [], 0
        for gi, outs in enumerate(first.groups):
            for k, arr in enumerate(outs):
                shape = (n,) + arr.shape[1:]
                nbytes = int(np.prod(shape)) * arr.itemsize
                layout.append((gi, k, arr, shape, total, nbytes))
                total += -(-nbytes // _OUT_ALIGN) * _OUT_ALIGN
        buf = torch.empty(max(total, _OUT_ALIGN), dtype=torch.uint8)
        flat = buf.numpy()
        groups: List[list] = [[] for _ in first.groups]
        for gi, k, arr, shape, at, nbytes in layout:
            region = flat[at:at + nbytes].view(arr.dtype)
            if arr.ndim == 2 and not arr.flags.c_contiguous:
                view = region.reshape(shape[::-1]).T
            else:
                view = region.reshape(shape)
            np.concatenate([b.groups[gi][k][:b.n_records] for b in batches],
                           out=view)
            groups[gi].append(view)
        groups = [tuple(g) for g in groups]
        outputs = first.decoder.collect_outputs(groups, n)
        for col, planes in first._out.items():
            if "host" in planes:
                outputs[col] = {"host": [v for b in batches
                                         for v in b._out[col]["host"]]}
        host_rows: Dict[int, np.ndarray] = {}
        lengths = []
        base = 0
        for b in batches:
            if b.data is not None:
                raise ValueError("DecodedBatch.concat takes batches that "
                                 "keep no host record matrix")
            host_rows.update((base + i, row) for i, row in b.host_rows.items())
            lengths.append(b.lengths)
            base += b.n_records
        return cls(first.decoder, None, outputs,
                   lengths=np.concatenate(lengths), host_rows=host_rows,
                   n_records=base, host_buffer=buf, groups=groups)

    def column_arrays(self, col: int) -> dict:
        return self._out[col]

    def to_arrow(self, output_schema):
        """The batch's records (of no segment redefine) as a pyarrow
        Table, or the table the assemble stage cached for an equal
        schema."""
        from .arrow_out import cached_table, segment_table

        table = cached_table(self, output_schema)
        return (table if table is not None
                else segment_table(self, None, output_schema))

    def row(self, i: int,
            policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL
            ) -> List[object]:
        """Record `i` as `to_rows` builds it; the row maker turns each
        column into its value list once per batch."""
        return self._row_maker(None, policy)(i)

    def value(self, col: int, i: int):
        """Python value for column `col`, record `i` — same semantics as the
        scalar oracle (None for nulls)."""
        spec = self.decoder.plan.columns[col]
        out = self.column_arrays(col)
        if self.lengths is not None:
            length = int(self.lengths[i])
            if spec.codec in _STRING_CODECS:
                if spec.offset > length:
                    return None
                if spec.offset + spec.width > length:
                    # truncated varchar tail: decode the available bytes
                    row = (self.data[i] if self.data is not None
                           else self.host_rows[i])
                    chunk = row[spec.offset:length].tobytes()
                    return self.decoder.options.decode(spec.dtype, chunk)
            elif spec.offset + spec.width > length:
                return None
        if "host" in out:
            return out["host"][i]
        if spec.codec in _STRING_CODECS:
            return self._string_value(spec, out, i)
        if spec.codec in _FLOAT_CODECS:
            if not out["valid"][i]:
                return None
            return float(out["values"][i])
        # fixed-point
        if not out["valid"][i]:
            return None
        if "values_hi" in out:
            # wide (uint128-limb) mantissa; the oracle returns Decimal for
            # these even when integral (the reference's BigDecimal plane)
            mantissa = (int(out["values_hi"][i]) << 64) | int(out["values"][i])
            if out["negative"][i]:
                mantissa = -mantissa
            if spec.params.explicit_decimal or _dyn_scale(spec):
                return _exact_scaleb(mantissa, -int(out["dot_scale"][i]))
            return _exact_scaleb(mantissa, fixed_point_exponent(spec))
        mantissa = int(out["values"][i])
        dt = spec.dtype
        if isinstance(dt, Integral):
            return mantissa
        # Decimal; explicit '.' and PIC P exponents are per-value planes
        if spec.params.explicit_decimal or _dyn_scale(spec):
            scale = int(out["dot_scale"][i])
            return PyDecimal(mantissa).scaleb(-scale)
        return PyDecimal(mantissa).scaleb(fixed_point_exponent(spec))

    def _vectorizable_string(self, spec: ColumnSpec) -> bool:
        """EBCDIC columns always decode via the LUT code-point matrix;
        ASCII only when the charset is plain US-ASCII (a custom charset
        decodes per value through the scalar oracle)."""
        return spec.codec is Codec.EBCDIC_STRING or (
            spec.codec is Codec.ASCII_STRING
            and not self.decoder.non_standard_ascii_charset)

    def _string_value(self, spec: ColumnSpec, out: dict, i: int):
        if self._vectorizable_string(spec):
            # whole-column decode on first access: one C-level bytes->str
            # conversion + per-row slicing beats a per-value chr() join by
            # ~50x at narrow-record row counts
            cache = self._str_cache.get(spec.index)
            if cache is None:
                cache = self._decode_string_column(spec, out)
                self._str_cache[spec.index] = cache
            return cache[i]
        raw = out["bytes"][i]
        if spec.codec is Codec.RAW_BYTES:
            return bytes(raw.view(np.uint8))
        if spec.codec is Codec.HEX_STRING:
            return bytes(raw.view(np.uint8)).hex().upper()
        trimming = self.decoder.plan.trimming
        if spec.codec is Codec.ASCII_STRING:
            return self.decoder.options.decode(spec.dtype,
                                               bytes(raw.view(np.uint8)))
        # UTF16
        enc = ("utf-16-be" if self.decoder.plan.is_utf16_big_endian
               else "utf-16-le")
        s = bytes(raw.view(np.uint8)).decode(enc, errors="replace")
        from ..ops.scalar_decoders import _trim
        return _trim(s, trimming)

    def _decode_string_column(self, spec: ColumnSpec, out: dict,
                              relevant=None) -> List[str]:
        from ..ops.scalar_decoders import _trim

        arr = out["bytes"]
        n = arr.shape[0]
        w = arr.shape[1] if arr.ndim == 2 else 0
        trimming = self.decoder.plan.trimming
        if w == 0:
            return [""] * n
        if arr.dtype == np.uint16:  # EBCDIC LUT code points
            blob = np.ascontiguousarray(arr).tobytes()
            text = blob.decode("utf-16-le", errors="replace")
        else:  # masked ASCII bytes (always < 0x80)
            text = np.ascontiguousarray(arr).tobytes().decode("latin-1")
        if relevant is not None:
            # build only the rows the caller can see (hierarchical walks
            # read a redefine's columns solely on its own segment's rows)
            lst: List[Optional[str]] = [None] * n
            for i in np.nonzero(relevant)[0]:
                i = int(i)
                lst[i] = _trim(text[i * w:(i + 1) * w], trimming)
            return lst
        return [_trim(text[i * w:(i + 1) * w], trimming) for i in range(n)]

    def column_values(self, col: int, relevant=None) -> list:
        """Whole column as a Python value list (the vectorized form of
        `value` — same null/decimal semantics, one pass per column instead
        of one dynamic dispatch per cell). `relevant`: optional row mask —
        rows outside it skip the truncation fixups and may materialize as
        None (sparse masks take a per-row path; dense ones keep the
        vectorized conversion, so hidden rows may carry kernel values —
        hierarchical/decode-once callers never read them either way);
        masked results are not cached."""
        if relevant is None:
            lst = self._col_cache.get(col)
            if lst is not None:
                return lst
        spec = self.decoder.plan.columns[col]
        out = self.column_arrays(col)
        n = self.n_records
        if relevant is not None and "host" not in out \
                and not self._vectorizable_string(spec):
            k = int(np.count_nonzero(relevant))
            if k * 4 < n:
                # sparse segment: per-row scalar decode of just its rows
                # beats whole-column Python materialization
                lst = [None] * n
                for i in np.nonzero(relevant)[0]:
                    lst[int(i)] = self.value(col, int(i))
                return lst
        if "host" in out:
            lst = list(out["host"])
        elif self._vectorizable_string(spec):
            if relevant is not None:
                lst = self._decode_string_column(spec, out, relevant)
            else:
                cached = self._str_cache.get(spec.index)
                if cached is None:
                    cached = self._decode_string_column(spec, out)
                    self._str_cache[spec.index] = cached
                # copy only when the truncation fixup below may mutate it
                lst = list(cached) if self.lengths is not None else cached
        elif spec.codec in _STRING_CODECS:
            lst = [self._string_value(spec, out, i) for i in range(n)]
        elif spec.codec in _FLOAT_CODECS:
            vals = [float(v) for v in out["values"].tolist()]
            valid = out["valid"]
            if not valid.all():
                vb = valid.tolist()
                lst = [v if ok else None for v, ok in zip(vals, vb)]
            else:
                lst = vals
        elif "values_hi" in out:
            valid = out["valid"]
            all_ok = bool(valid.all())
            vb = None if all_ok else valid.tolist()
            his = out["values_hi"].tolist()
            los = out["values"].tolist()
            negs = out["negative"].tolist()
            if spec.params.explicit_decimal or _dyn_scale(spec):
                exps = out["dot_scale"].tolist()
                es = [-e for e in exps]
            else:
                es = [fixed_point_exponent(spec)] * n
            mk = (lambda h, l, ng, e:
                  _exact_scaleb(-((h << 64) | l) if ng else (h << 64) | l, e))
            if all_ok:
                lst = [mk(h, l, ng, e)
                       for h, l, ng, e in zip(his, los, negs, es)]
            else:
                lst = [mk(h, l, ng, e) if ok else None
                       for h, l, ng, e, ok in zip(his, los, negs, es, vb)]
        else:
            valid = out["valid"]
            mant = out["values"].tolist()
            dt = spec.dtype
            all_ok = bool(valid.all())
            vb = None if all_ok else valid.tolist()
            if isinstance(dt, Integral):
                lst = (mant if all_ok
                       else [v if ok else None for v, ok in zip(mant, vb)])
            elif spec.params.explicit_decimal or _dyn_scale(spec):
                dots = out["dot_scale"].tolist()
                if all_ok:
                    lst = [PyDecimal(v).scaleb(-d)
                           for v, d in zip(mant, dots)]
                else:
                    lst = [PyDecimal(v).scaleb(-d) if ok else None
                           for v, d, ok in zip(mant, dots, vb)]
            else:
                e = fixed_point_exponent(spec)
                if all_ok:
                    lst = [PyDecimal(v).scaleb(e) for v in mant]
                else:
                    lst = [PyDecimal(v).scaleb(e) if ok else None
                           for v, ok in zip(mant, vb)]
        if self.lengths is not None:
            # columns (partly) past a record's end: re-derive through the
            # scalar path, which owns the truncation rules (only for rows
            # the caller can see — OTHER segments' shorter records would
            # otherwise storm the per-value path)
            trunc = self.lengths < spec.offset + spec.width
            if relevant is not None:
                trunc = trunc & relevant
            for i in np.nonzero(trunc)[0]:
                lst[int(i)] = self.value(col, int(i))
        if relevant is None:
            self._col_cache[col] = lst
        return lst

    # -- row materialization ----------------------------------------------

    def to_rows(self,
                policy: SchemaRetentionPolicy = SchemaRetentionPolicy.KEEP_ORIGINAL,
                generate_record_id: bool = False,
                file_id: int = 0,
                first_record_id: int = 0,
                generate_input_file_field: bool = False,
                input_file_name: str = "",
                segment_level_ids: Optional[List[List[object]]] = None,
                active_segments: Optional[Sequence[Optional[str]]] = None,
                record_ids: Optional[Sequence[int]] = None,
                handler=None) -> List[List[object]]:
        """Assemble nested rows (same shape as reader.extractors.extract_record).
        `record_ids` overrides the sequential first_record_id+i numbering
        (used when a batch holds non-contiguous records, e.g. one segment
        of a multisegment file). `handler`: the RecordHandler seam — group
        records materialize through handler.create instead of tuples."""
        # one compiled maker per DISTINCT active segment; mixed-active
        # batches (decode-once) dispatch per row
        if active_segments is None or not len(active_segments):
            makers = {None: self._row_maker(None, policy, handler)}
            actives = None
        else:
            distinct = (set(active_segments.uniq)
                        if hasattr(active_segments, "uniq")
                        else set(active_segments))
            makers = {a: self._row_maker(a or None, policy, handler)
                      for a in distinct}
            actives = active_segments if len(makers) > 1 else None
            if actives is None:
                makers = {None: makers[next(iter(distinct))]}

        rows = []
        the_maker = makers.get(None)
        for i in range(self.n_records):
            maker = (the_maker if actives is None
                     else makers[actives[i]])
            body = maker(i)
            seg = list(segment_level_ids[i]) if segment_level_ids else []
            rid = (record_ids[i] if record_ids is not None
                   else first_record_id + i)
            if generate_record_id and generate_input_file_field:
                row = [file_id, rid, input_file_name] + seg + body
            elif generate_record_id:
                row = [file_id, rid] + seg + body
            elif generate_input_file_field:
                row = seg + [input_file_name] + body
            else:
                row = seg + body
            rows.append(row)
        return rows

    # -- compiled row assembly ---------------------------------------------

    def _row_maker(self, active: Optional[str],
                   policy: SchemaRetentionPolicy, handler=None):
        """Compile the nested-row assembly into closures over the column
        value lists: leaf access becomes list indexing instead of per-cell
        dynamic dispatch (the difference between ~30us and ~3us per row on
        narrow records). One maker per (active segment, policy, handler)
        per batch; group records materialize through handler.create when a
        RecordHandler is supplied (tuples otherwise)."""
        key = (active, policy, id(handler) if handler is not None else None)
        maker = self._maker_cache.get(key)
        if maker is not None:
            return maker

        def occurs_counts(st: Statement):
            """Per-record element counts for an array statement (None when
            the count is the constant max size)."""
            dep_col = (self.decoder.dependee_columns.get(st.depending_on)
                       if st.depending_on is not None else None)
            if dep_col is None:
                return None
            return [_resolve_occurs(st, v)
                    for v in self.column_values(dep_col)]

        def build_group(group: Group, slot_path: Tuple[int, ...]):
            makers = []
            for st in group.children:
                if st.is_array:
                    counts = occurs_counts(st)
                    if isinstance(st, Group):
                        elems = [build_group(st, slot_path + (k,))
                                 for k in range(st.array_max_size)]
                    else:
                        elems = [self._leaf_maker(st, slot_path + (k,))
                                 for k in range(st.array_max_size)]
                    if counts is None:
                        m = (lambda i, e=elems:
                             [mk(i) for mk in e])
                    else:
                        m = (lambda i, e=elems, c=counts:
                             [e[k](i) for k in range(c[i])])
                elif isinstance(st, Group):
                    if st.is_segment_redefine and (
                            active is None
                            or st.name.upper() != active.upper()):
                        m = lambda i: None
                    else:
                        m = build_group(st, slot_path)
                else:
                    m = self._leaf_maker(st, slot_path)
                if not st.is_filler:
                    makers.append(m)
            if handler is not None:
                return (lambda i, ms=tuple(makers), g=group:
                        handler.create([mk(i) for mk in ms], g))
            return lambda i, ms=tuple(makers): tuple([mk(i) for mk in ms])

        root_makers = [build_group(root, ())
                       for root in self.decoder.copybook.ast.children
                       if isinstance(root, Group)]
        if policy is SchemaRetentionPolicy.COLLAPSE_ROOT:
            def maker(i):
                body: List[object] = []
                for rm in root_makers:
                    rec = rm(i)
                    body.extend(handler.to_seq(rec) if handler is not None
                                else rec)
                return body
        else:
            def maker(i):
                return [rm(i) for rm in root_makers]
        self._maker_cache[key] = maker
        return maker

    def _leaf_maker(self, st: Primitive, slot_path: Tuple[int, ...]):
        col = self.decoder.slot_map.get((id(st), slot_path))
        if col is None:
            return lambda i: None
        values = self.column_values(col)
        return values.__getitem__


_DECODER_LOCK = threading.Lock()


def decoder_for_segment(cache: Dict[str, "ColumnarDecoder"],
                        copybook: Copybook, active: str, device,
                        select: Optional[Sequence[str]] = None
                        ) -> "ColumnarDecoder":
    """The decoder of one active segment on `device` with the column
    projection `select`, built once per `cache` (the copybook's
    ``plan.cache.decoder_cache_for`` dict) under a lock, since pipeline
    workers share a reader; each lookup counts as a decoder-cache hit or
    miss (``plan.cache.note_decoder``). Port of the JAX package's
    ``decoder_for_segment``, keyed by the device in place of the
    backend."""
    from ..plan.cache import note_decoder

    device = resolve_device(device)
    key = f"{active}|{device}|{','.join(select) if select else ''}"
    dec = cache.get(key)
    if dec is None:
        with _DECODER_LOCK:
            dec = cache.get(key)
            if dec is None:
                note_decoder(hit=False)
                dec = ColumnarDecoder(copybook,
                                      active_segment=active or None,
                                      select=select, device=device)
                cache[key] = dec
                return dec
    note_decoder(hit=True)
    return dec


class DevicePlanes(NamedTuple):
    """One batch's decoded outputs on the device (`decode_planes`).

    `groups[gi]` is kernel group gi's output tuple, dtype for dtype the
    tuple ``_run_group_jax`` gives in the JAX package, except that wide
    hi/lo limbs are int64 bit patterns (uint64 in the JAX package) and
    double outputs int64 bit patterns; host-fallback groups give ().
    `planes` are the fused kernel's three column-major planes
    ([rows, n]: a column's values are contiguous), None without fused
    groups. Every output, and the `extras` copied in, lies in one device
    `buffer`, at the byte `spans` of `entries` ((key, dtype, shape))."""
    groups: List[tuple]
    planes: Optional[Dict[str, torch.Tensor]]
    buffer: torch.Tensor
    entries: List[Tuple[object, torch.dtype, tuple]]
    spans: List[Tuple[int, int]]


class ColumnarDecoder:
    """Decodes [n, record_len] record batches on `device` (default: the
    CUDA device; ``device="cpu"`` runs the plain versions, for tests).
    `select`: the column projection of ``compile_plan`` (only the named
    fields, or the fields under a named group, and the DEPENDING ON
    dependees are decoded; every other leaf is None)."""

    def __init__(self, copybook: Copybook,
                 active_segment: Optional[str] = None,
                 select: Optional[Sequence[str]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.copybook = copybook
        self.select = tuple(select) if select else None
        self.plan: FieldPlan = cached_compile_plan(copybook, active_segment,
                                                   select=self.select)
        self.options = DecodeOptions.from_copybook(copybook)
        self.non_standard_ascii_charset = (
            copybook.ascii_charset.lower().replace("_", "-")
            not in ("us-ascii", "ascii"))
        self.lut = cached_code_page_lut(copybook.ebcdic_code_page)
        self.rebuild_groups()

    def rebuild_groups(self) -> None:
        """Build kernel groups, lookup maps and the fused kernel's layout
        from the plan columns: at construction, and again after a byte
        projection rewrote the columns' offsets (``parallel.query``). The
        layout is always a new `FusedLayout`, whose device tables are
        uploaded from its own descriptors: none of an earlier layout's
        is reused."""
        groups: Dict[tuple, List[ColumnSpec]] = {}
        for c in self.plan.columns:
            key = (c.codec, c.width) + _variant_key(c)
            groups.setdefault(key, []).append(c)
        self.kernel_groups = [
            _KernelGroup(key[0], key[1], key[2:], cols,
                         tuple(self.plan.cost_name(c) for c in cols))
            for key, cols in groups.items()]
        # each column's (kernel group, position in the group's planes):
        # the Arrow builder takes an OCCURS field's evenly spaced slots
        # from its group's planes as one [rows, S] view
        self.group_position: Dict[int, Tuple[int, int]] = {
            c.index: (gi, pos) for gi, g in enumerate(self.kernel_groups)
            for pos, c in enumerate(g.columns)}
        # lookup maps for row assembly
        self.slot_map: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        for c in self.plan.columns:
            self.slot_map.setdefault((id(c.statement), c.slot_path), c.index)
        self.dependee_columns: Dict[str, int] = {}
        for c in self.plan.columns:
            if c.statement is not None and c.statement.is_dependee:
                self.dependee_columns.setdefault(c.statement.name, c.index)
        # statements with at least one compiled column: the Arrow builder
        # emits a subtree the projection pruned as nulls at once
        self.planned_statement_ids = frozenset(
            id(c.statement) for c in self.plan.columns
            if c.statement is not None)
        # every numeric group rides ONE fused launch
        self.fused_indices: List[int] = []
        specs = []
        for gi, g in enumerate(self.kernel_groups):
            sg = fused_group_spec(g)
            if sg is not None:
                self.fused_indices.append(gi)
                specs.append(sg)
        self.fused = FusedLayout(specs) if specs else None
        # per-group gather indices of the batch_torch groups, on the
        # device (built here, read-only after: decode workers share them),
        # and the out table: each batch_torch output's (group, output,
        # dtype, per-record shape) in the batch's one output buffer, after
        # the fused planes
        self._gather_idx: Dict[int, torch.Tensor] = {}
        self._out_table: List[Tuple[int, int, torch.dtype, tuple]] = []
        fused = set(self.fused_indices)
        for gi, g in enumerate(self.kernel_groups):
            if gi not in fused and g.codec is not Codec.HOST_FALLBACK:
                idx = g.offsets[:, None] + np.arange(g.width)[None, :]
                self._gather_idx[gi] = torch.from_numpy(idx).to(self.device)
                self._out_table.extend(
                    (gi, k, dt, shape)
                    for k, (dt, shape) in enumerate(self._group_outs(g)))
        self._lut_dev = torch.from_numpy(
            self.lut.view(np.int16).copy()).to(self.device)

    def _group_outs(self, g: _KernelGroup) -> List[Tuple[torch.dtype, tuple]]:
        """dtype and per-record shape of each output `_run_group_torch`
        gives for group `g`."""
        count, width = len(g.columns), g.width
        if g.codec in (Codec.FLOAT_IBM, Codec.FLOAT_IEEE):
            return [(torch.float32, (count,)), (torch.bool, (count,))]
        if g.codec in (Codec.DOUBLE_IBM, Codec.DOUBLE_IEEE):
            return [(torch.int64, (count,)), (torch.bool, (count,))]
        if g.codec is Codec.EBCDIC_STRING:
            return [(torch.int16, (count, width))]
        return [(torch.uint8, (count, width))]

    # ------------------------------------------------------------------

    def decode(self, data, lengths: Optional[np.ndarray] = None) -> DecodedBatch:
        """data: bytes (length N*record_size) or a uint8 numpy array
        [N, record_len]. The batch moves to the device as one [N, extent]
        uint8 tensor. `lengths`: optional per-record actual byte counts
        for padded batches."""
        rs = self.plan.record_size
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, dtype=np.uint8)
            if len(arr) % rs != 0:
                raise ValueError(
                    f"Data size {len(arr)} is not divisible by the record size {rs}")
            arr = arr.reshape(-1, rs)
        else:
            arr = np.asarray(data, dtype=np.uint8)
            if arr.ndim != 2:
                raise ValueError("Expected a [batch, record_len] uint8 array")
            extent = self.plan.max_extent
            if arr.shape[1] < extent:
                # pad to the plan's byte extent; columns past a record's
                # true end are nulled via `lengths`
                padded = np.zeros((arr.shape[0], extent), dtype=np.uint8)
                padded[:, :arr.shape[1]] = arr
                arr = padded
        arr = np.ascontiguousarray(arr)
        with warnings.catch_warnings():
            # a read-only buffer (bytes, mmap) is only read here, never
            # written through the tensor
            warnings.filterwarnings("ignore", message=".*not writable.*")
            host = torch.from_numpy(arr)
        # the decode region opens before the batch's H2D (transfers
        # included, as the JAX package times its device decode)
        fc = fieldcost.current()
        tok = fc.begin() if fc is not None else None
        group_outs, _, buf = self._decode_device(host.to(self.device))
        outputs = self.collect_outputs(group_outs, arr.shape[0])
        self._commit_decode(fc, tok, arr.shape[0])
        self._decode_host_fallback(arr, outputs)
        return DecodedBatch(self, arr, outputs, lengths=lengths,
                            host_buffer=buf, groups=group_outs)

    def decode_tensor(self, data: torch.Tensor) -> DecodedBatch:
        """Decode a [n, record_len] uint8 record matrix that is already
        on the decoder's device (a staged chunk of the pipelined read).
        The batch keeps no host record matrix: the host-fallback columns'
        bytes come back in the batch's one copy to the host."""
        if data.device != self.device or data.dtype != torch.uint8 \
                or data.dim() != 2:
            raise ValueError(
                f"decode_tensor takes a [n, record_len] uint8 matrix on "
                f"{self.device}, not {tuple(data.shape)} {data.dtype} on "
                f"{data.device}")
        fc = fieldcost.current()
        tok = fc.begin() if fc is not None else None
        extent = self.plan.max_extent
        if data.shape[1] < extent:
            data = torch.nn.functional.pad(data, (0, extent - data.shape[1]))
        n = data.shape[0]
        end = self._fallback_end()
        extras = [data[:, :end]] if end else []
        group_outs, extra_host, buf = self._decode_device(
            data.contiguous(), extras)
        outputs = self.collect_outputs(group_outs, n)
        self._commit_decode(fc, tok, n)
        if end:
            self._decode_host_fallback(extra_host[0], outputs)
        return DecodedBatch(self, None, outputs, n_records=n,
                            host_buffer=buf, groups=group_outs)

    def decode_raw(self, image: torch.Tensor, rec_offsets, rec_lengths,
                   start_offset: int = 0, rows=None) -> DecodedBatch:
        """Decode framed records of a file image on the decoder's device:
        the pack kernel gathers them, from `start_offset` into each
        record, into a zero-padded [n, extent] matrix at the plan's byte
        extent, which is decoded where it lies; columns past a record's
        end are nulled through the lengths, as the JAX package's packed
        route does. `rec_offsets` / `rec_lengths`: int64 payload offsets
        into `image` and record lengths, as tensors on the device or
        host arrays; `rows` (host positions), when given, picks the
        records to decode among them."""
        if image.device != self.device:
            raise ValueError(f"decode_raw: image on {image.device}, decoder "
                             f"on {self.device}")

        def on_device(x):
            return torch.as_tensor(x, dtype=torch.int64).to(self.device)

        # the decode region opens before the batch's first transfer or
        # launch (the gather of its records' offsets, or its pack)
        fc = fieldcost.current()
        tok = fc.begin() if fc is not None else None
        if rows is not None:
            rows = np.asarray(rows, dtype=np.int64)
            rec_offsets, rec_lengths = (
                x[torch.from_numpy(rows).to(x.device)]
                if isinstance(x, torch.Tensor) else np.asarray(x)[rows]
                for x in (rec_offsets, rec_lengths))
        host_lengths = (rec_lengths.cpu().numpy()
                        if isinstance(rec_lengths, torch.Tensor)
                        else np.asarray(rec_lengths, dtype=np.int64))
        extent = self.plan.max_extent
        lengths = np.minimum(host_lengths - start_offset, extent)
        with annotate("cobrix.pack", self.device):
            packed = pack_records(image, on_device(rec_offsets),
                                  on_device(rec_lengths), extent,
                                  start_offset)
        n = packed.shape[0]
        # `value` reads the bytes of a record that ends before the plan's
        # extent (a string cut by the record's end): only those rows, up
        # to the longest of their lengths, come to the host, in the same
        # copy as the planes; so do the host-fallback columns' bytes
        extras = []
        short = np.nonzero(lengths < extent)[0]
        if len(short):
            keep = int(max(lengths[short].max(), 0))
            extras.append(packed[torch.from_numpy(short).to(self.device),
                                 :keep])
        end = self._fallback_end()
        if end:
            extras.append(packed[:, :end])
        group_outs, extra_host, buf = self._decode_device(packed, extras)
        outputs = self.collect_outputs(group_outs, n)
        self._commit_decode(fc, tok, n)
        host_rows = dict(zip(short.tolist(), extra_host[0])) \
            if len(short) else {}
        if end:
            self._decode_host_fallback(extra_host[-1], outputs)
        return DecodedBatch(self, None, outputs, lengths=lengths,
                            host_rows=host_rows, host_buffer=buf,
                            groups=group_outs)

    def _fallback_end(self) -> int:
        """Bytes of a row the host-fallback columns read (0: none)."""
        return max((c.offset + c.width for g in self.kernel_groups
                    if g.codec is Codec.HOST_FALLBACK for c in g.columns),
                   default=0)

    def decode_planes(self, data: torch.Tensor,
                      extras: Sequence[torch.Tensor] = ()) -> DevicePlanes:
        """Decode a [n, extent] uint8 record matrix on the decoder's
        device into device tensors, with no copy to the host: one fused
        kernel launch for every numeric group, ``batch_torch`` for the
        strings and floats, each output written into one device buffer
        laid out by a per-plan table (the JAX package's
        ``build_jax_decode_fn``). `extras` (tensors on the device) are
        copied into the same buffer, for `_decode_device`'s one copy
        back."""
        n = data.shape[0]
        with annotate("cobrix.decode", self.device):
            group_outs = {gi: self._run_group_torch(
                self.kernel_groups[gi], data[:, idx])
                for gi, idx in self._gather_idx.items()}
            entries: List[Tuple[object, torch.dtype, tuple]] = []
            if self.fused is not None:
                entries += [(p, dt, (self.fused.rows[p], n))
                            for p, dt in _PLANE_DTYPES.items()]
            entries += [((gi, k), dt, (n,) + shape)
                        for gi, k, dt, shape in self._out_table]
            entries += [(("extra", k), t.dtype, tuple(t.shape))
                        for k, t in enumerate(extras)]
            spans, total = [], 0
            for _, dt, shape in entries:
                nbytes = int(np.prod(shape)) * dt.itemsize
                spans.append((total, total + nbytes))
                total += -(-nbytes // _OUT_ALIGN) * _OUT_ALIGN
            buf = torch.empty(total, dtype=torch.uint8, device=data.device)
            views = {key: buf[a:b].view(dt).view(shape)
                     for (key, dt, shape), (a, b) in zip(entries, spans)}
            planes = None
            outs: List[tuple] = [()] * len(self.kernel_groups)
            if self.fused is not None:
                planes = {p: views[p] for p in _PLANE_DTYPES}
                fused_decode(data, self.fused, out=planes)
                for gi, res in zip(self.fused_indices,
                                   self.fused.split(planes)):
                    outs[gi] = res
            for gi, k, dt, shape in self._out_table:
                out = group_outs[gi][k]
                if out.dtype != dt or tuple(out.shape) != (n,) + shape:
                    raise RuntimeError(
                        f"group {gi} output {k}: {out.dtype} "
                        f"{tuple(out.shape)}, the out table says {dt} "
                        f"{(n,) + shape}")
                views[(gi, k)].copy_(out)
                outs[gi] = outs[gi] + (views[(gi, k)],)
            for k, t in enumerate(extras):
                views[("extra", k)].copy_(t)
        return DevicePlanes(outs, planes, buf, entries, spans)

    def _decode_device(self, data: torch.Tensor,
                       extras: Sequence[torch.Tensor] = ()
                       ) -> Tuple[List[tuple], List[np.ndarray],
                                  torch.Tensor]:
        """Per-kernel-group host outputs of one batch, the host copies
        of `extras` and the host buffer they are views of:
        `decode_planes`, then ONE copy of its buffer to the host (see the
        module docstring)."""
        dp = self.decode_planes(data, extras)
        buf, entries, spans = dp.buffer, dp.entries, dp.spans
        with annotate("cobrix.d2h", self.device):
            if buf.device.type == "cpu" or buf.numel() == 0:
                host = buf.cpu()
            else:
                host = torch.empty(buf.numel(), dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(buf, non_blocking=True)
                torch.cuda.current_stream(buf.device).synchronize()
        host_np = host.numpy()
        planes = {key: host_np[a:b].view(_NP_DTYPES[dt]).reshape(shape)
                  for (key, dt, shape), (a, b) in zip(entries, spans)}
        outs: List[Optional[tuple]] = [()] * len(self.kernel_groups)
        if self.fused is not None:
            for gi, res in zip(self.fused_indices, self.fused.split(
                    {p: planes[p] for p in _PLANE_DTYPES})):
                outs[gi] = res
        for gi, k, _, _ in self._out_table:
            outs[gi] = outs[gi] + (planes[(gi, k)],)
        return (outs, [planes[("extra", k)] for k in range(len(extras))],
                host)

    def _commit_decode(self, fc, tok, n: int) -> None:
        """Field-cost attribution (``obs.fieldcost``): commit one batch's
        decode region. The region opens before the batch's first
        transfer or launch and closes here, after the synchronize that
        ends `_decode_device`'s copy back and after `collect_outputs`,
        as the JAX package's closes after its device decode's
        ``collect_outputs``: it holds the device work and not only its
        launches. Its wall splits across the kernel groups by bytes
        touched, as the JAX package splits its jitted device decode.
        Off (`tok` None), nothing is timed and nothing is synchronized
        beyond the copy's own synchronize."""
        if tok is None:
            return
        fc.commit_weighted(
            tok,
            [(g.names, g.width, n * g.width, g.label)
             for g in self.kernel_groups
             if g.codec is not Codec.HOST_FALLBACK and g.names],
            fieldcost.PLANE_DECODE, n)

    def collect_outputs(self, group_outs, n: int) -> Dict[int, dict]:
        """Per-group host outputs -> per-column host planes, with the JAX
        package's dtypes (int16 code points viewed as uint16, double bit
        patterns as float64)."""
        outputs: Dict[int, dict] = {}
        for g, out in zip(self.kernel_groups, group_outs):
            if g.codec is Codec.HOST_FALLBACK:
                continue
            if g.codec in _STRING_CODECS:
                chars = out[0][:n]
                if chars.dtype == np.int16:
                    chars = chars.view(np.uint16)
                for pos, c in enumerate(g.columns):
                    outputs[c.index] = {"bytes": chars[:, pos]}
            elif g.wide:
                arrs = [o[:n] for o in out]
                self._store_wide(g, outputs, *arrs)
            elif g.codec in (Codec.DISPLAY_NUM, Codec.DISPLAY_NUM_ASCII):
                values, valid, dots = (o[:n] for o in out)
                self._store_numeric(g, outputs, values, valid, dots)
            else:
                values, valid = (o[:n] for o in out)
                if g.codec in (Codec.DOUBLE_IBM, Codec.DOUBLE_IEEE):
                    # the device returns IEEE754 bit patterns
                    values = values.view(np.float64)
                self._store_numeric(g, outputs, values, valid)
        return outputs

    def _run_group_torch(self, g: _KernelGroup, slab: torch.Tensor) -> tuple:
        """A non-fused group through batch_torch (`_run_group_jax`'s
        string and float branches; numeric groups take the fused kernel)."""
        if g.codec is Codec.FLOAT_IBM:
            s = slab if g.columns[0].params.big_endian else slab.flip(-1)
            return batch_torch.decode_ibm_float32(s)
        if g.codec is Codec.DOUBLE_IBM:
            s = slab if g.columns[0].params.big_endian else slab.flip(-1)
            return batch_torch.decode_ibm_float64(s)
        if g.codec is Codec.FLOAT_IEEE:
            return batch_torch.decode_ieee_float(
                slab, g.columns[0].params.big_endian, double=False)
        if g.codec is Codec.DOUBLE_IEEE:
            return batch_torch.decode_ieee_float(
                slab, g.columns[0].params.big_endian, double=True)
        if g.codec is Codec.EBCDIC_STRING:
            return (batch_torch.transcode_ebcdic(slab, self._lut_dev),)
        if g.codec is Codec.ASCII_STRING and not self.non_standard_ascii_charset:
            return (batch_torch.mask_ascii(slab),)
        return (slab,)

    def _store_numeric(self, g: _KernelGroup, outputs: Dict[int, dict],
                       values, valid, dot_scale=None) -> None:
        values = np.asarray(values)
        valid = np.asarray(valid)
        dots = None if dot_scale is None else np.asarray(dot_scale)
        for pos, c in enumerate(g.columns):
            out = {"values": values[:, pos], "valid": valid[:, pos]}
            if dots is not None:
                out["dot_scale"] = dots[:, pos]
            elif c.params.scale_factor < 0 and g.codec is Codec.BINARY:
                # binary PIC P: exponent = |sf| + decimal digit count of the
                # value (addDecimalPoint over str(value)); the kernels have
                # no digit-count plane for binary, so derive it here
                out["dot_scale"] = _binary_dyn_dots(
                    values[:, pos], c.params.scale_factor)
            outputs[c.index] = out

    def _store_wide(self, g: _KernelGroup, outputs: Dict[int, dict],
                    hi, lo, negative, valid, dot_scale=None) -> None:
        """uint128-limb layout: magnitude = (values_hi << 64) | values,
        sign in `negative` (the columnar form of the BigDecimal plane)."""
        hi = np.asarray(hi)
        lo = np.asarray(lo)
        negative = np.asarray(negative)
        valid = np.asarray(valid)
        dots = None if dot_scale is None else np.asarray(dot_scale)
        for pos, c in enumerate(g.columns):
            out = {"values": lo[:, pos], "values_hi": hi[:, pos],
                   "negative": negative[:, pos], "valid": valid[:, pos]}
            if dots is not None:
                out["dot_scale"] = dots[:, pos]
            elif c.params.scale_factor < 0 and g.codec is Codec.BINARY:
                out["dot_scale"] = _wide_dyn_dots(
                    hi[:, pos], lo[:, pos], c.params.scale_factor)
            outputs[c.index] = out

    # -- host fallback -----------------------------------------------------

    def _decode_host_fallback(self, arr: np.ndarray,
                              outputs: Dict[int, dict]) -> None:
        fc = fieldcost.current()
        n = arr.shape[0]
        for g in self.kernel_groups:
            if g.codec is not Codec.HOST_FALLBACK:
                continue
            for c in g.columns:
                tok = fc.begin() if fc is not None else None
                values = []
                for i in range(n):
                    chunk = arr[i, c.offset: c.offset + c.width].tobytes()
                    values.append(self.options.decode(c.dtype, chunk))
                outputs[c.index] = {"host": values}
                if tok is not None:
                    fc.commit(tok, (self.plan.cost_name(c),),
                              fieldcost.PLANE_DECODE, n * c.width, n,
                              "host")
