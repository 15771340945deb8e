"""Masked, scaled per-field aggregates over decoded planes: the CUDA
kernel's wrapper, its plain version and the float groups' reduction.

Replaces the reduction body of ``cobrix_tpu.parallel.query
.DeviceAggregator._build`` (the XLA ``agg`` program after the decode).
The kernel is ``csrc/aggregate.cu``; its note says what it computes and
what bounds it.

* `AggregateSpec` is the static table of one query: a row per fused
  column a field owns (its plane rows, kind, scale and field id, sorted
  by kind, scale mode and field), the kernel's plan over them (classes
  of one kind and mode, runs of one field in a class, each column's
  bytes a row), uploaded once per device, and the float groups' slots.
* `new_stats(n_fields, device)` makes the outputs: one device buffer
  holding per field a float64 sum, an int32 count, and min and max as
  order-preserving int64 keys of the double (`order_key`), so that a
  query's whole result comes back in one copy (`read_stats`);
  `AggregateSpec.new_stats(device)` copies the same buffer from one
  uploaded with the query's tables (one copy on the card, not four
  fills).
* `aggregate(planes, spec, n, stats)` adds the fused columns' statistics
  to `stats`: a CUDA plane launches the kernel (a launch for each class
  and one to combine, counted once in ``aggregate.launches``), a
  CPU plane runs `aggregate_plain`, the same arithmetic in torch ops;
  nothing else is taken. `n` (the live rows) is a host int or a 0-d
  int32 tensor on the planes' device, which the kernel reads there: no
  host round trip.
* `aggregate_floats(groups, spec, n, stats)` reduces the float and
  double groups (``batch_torch`` outputs, never fused in either package)
  with torch ops on any device; double bit patterns are viewed as
  float64. NaNs propagate as in the JAX program.

Powers of ten: the JAX program multiplies by ``10.0 ** e`` computed in
Python for a constant exponent, and by ``jnp.power(10.0, -k)`` for the
DISPLAY dot plane and the PIC P digit counts. Here ``10.0 ** -k`` for
0 <= k < `POW10_SIZE` is one table computed in Python, indexed by the
kernel and by the plain version alike, so both give the same double.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ._build import count_launch

POW10_SIZE = 256
_POW10 = np.array([10.0 ** -k for k in range(POW10_SIZE)], dtype=np.float64)

# csrc/aggregate.cu descriptor fields and codes
_DESC_FIELDS = 9
(_D_VALUE, _D_LO, _D_NEG, _D_VALID, _D_DOTS, _D_KIND, _D_MODE, _D_SF,
 _D_FIELD) = range(_DESC_FIELDS)
KIND_I32, KIND_I64, KIND_WIDE = 0, 1, 2
MODE_NONE, MODE_CONST, MODE_DOTS, MODE_DIGITS = 0, 1, 2, 3

_INT64_MIN, _INT64_MAX = -2 ** 63, 2 ** 63 - 1
_FLIP = 0x7FFFFFFFFFFFFFFF
# keys of NaN: a NaN min (max) takes the smallest (largest) key, which
# reads back as NaN, as the JAX program's jnp.minimum propagates it
NAN_MIN_KEY, NAN_MAX_KEY = _INT64_MIN, _INT64_MAX

# csrc/aggregate.cu plan tables: a class is the columns of one kind and
# scale mode (their bytes a row `weight`, the row bytes of all of them,
# their runs); a run is a class's columns of one field (its row bytes
# before it in the class, its field, its class)
_CLASS_FIELDS = 6
(_C_KIND, _C_MODE, _C_WEIGHT, _C_ROW_BYTES, _C_RUN0,
 _C_RUN1) = range(_CLASS_FIELDS)
_RUN_FIELDS = 5
_R_COL0, _R_COL1, _R_START, _R_FIELD, _R_CLASS = range(_RUN_FIELDS)
# bytes the kernel reads a row for a value of each kind (a wide value:
# its hi and lo limbs and its sign), beside the valid flag and, in
# MODE_DOTS, the dot count
VALUE_BYTES = {KIND_I32: 4, KIND_I64: 8, KIND_WIDE: 17}
# the kernel's rows a work unit, and the bytes of a block's partial
UNIT_ROWS = 16
PARTIAL_BYTES = 32


class AggregateColumn(NamedTuple):
    """One fused column of a field: its rows in the planes (`value` in
    the i32 plane for KIND_I32, in the i64 plane otherwise; `lo` and
    `neg` for KIND_WIDE; `dots` in the i32 plane or -1; `valid` in the
    bool plane), the scale `mode` with its constant `factor` (MODE_CONST)
    or its scale factor `sf` (MODE_DIGITS: 10 ** -(digits - sf)), and the
    output slot `field`."""
    value: int
    lo: int
    neg: int
    valid: int
    dots: int
    kind: int
    mode: int
    sf: int
    field: int
    factor: float


class FloatSlot(NamedTuple):
    """The positions of one float or double group that a field owns."""
    group: int
    positions: Tuple[int, ...]
    double: bool
    field: int


def row_weight(kind: int, mode: int) -> int:
    """Bytes the kernel reads a row of a column: value, valid flag and,
    in MODE_DOTS, the dot count."""
    return VALUE_BYTES[kind] + 1 + (4 if mode == MODE_DOTS else 0)


class AggregateSpec:
    """The fused columns of a query, sorted by kind, scale mode and field
    (stable), the kernel's plan over them and the float slots;
    `n_fields` output slots.

    The plan: `classes` (a row per (kind, mode) present), `runs` (a row
    per stretch of one field in a class) and, for the combine, each
    output field's runs in class order (`field_runs` from
    `field_ptr[i]` to `field_ptr[i + 1]`)."""

    def __init__(self, columns: Sequence[AggregateColumn],
                 floats: Sequence[FloatSlot], n_fields: int):
        cols = sorted(columns, key=lambda c: (c.kind, c.mode, c.field))
        self.n_fields = n_fields
        self.floats = list(floats)
        self.desc = np.asarray([c[:_DESC_FIELDS] for c in cols],
                               dtype=np.int32).reshape(-1, _DESC_FIELDS)
        self.factor = np.asarray([c.factor for c in cols], dtype=np.float64)
        classes: List[List[int]] = []
        runs: List[List[int]] = []
        for i, c in enumerate(cols):
            if not classes or (classes[-1][_C_KIND],
                               classes[-1][_C_MODE]) != (c.kind, c.mode):
                classes.append([c.kind, c.mode, row_weight(c.kind, c.mode),
                                0, len(runs), len(runs)])
            cls = classes[-1]
            if cls[_C_RUN1] > cls[_C_RUN0] and runs[-1][_R_FIELD] == c.field:
                runs[-1][_R_COL1] = i + 1
            else:
                runs.append([i, i + 1, cls[_C_ROW_BYTES], c.field,
                             len(classes) - 1])
                cls[_C_RUN1] += 1
            cls[_C_ROW_BYTES] += cls[_C_WEIGHT]
        self.classes = np.asarray(classes, dtype=np.int64).reshape(
            -1, _CLASS_FIELDS)
        self.runs = np.asarray(runs, dtype=np.int64).reshape(-1, _RUN_FIELDS)
        order = np.argsort(self.runs[:, _R_FIELD], kind="stable")
        self.field_runs = order.astype(np.int64)
        fields = self.runs[order, _R_FIELD]
        starts = np.flatnonzero(np.r_[True, fields[1:] != fields[:-1]]) \
            if len(fields) else np.zeros(0, dtype=np.int64)
        self.field_ptr = np.r_[starts, len(fields)].astype(np.int64)
        self.row_bytes = int(self.classes[:, _C_ROW_BYTES].sum())
        self._tables: Dict[str, tuple] = {}
        self._plans: Dict[str, tuple] = {}
        self._fresh: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def n_cols(self) -> int:
        return self.desc.shape[0]

    def tables_on(self, device: torch.device) -> tuple:
        """(descriptors, factors, powers of ten) on `device` and the float
        slots' field ids and positions (device tensors, by slot); the
        kernel's plan tables (`plan_on`) with them. All are uploaded once
        under a lock with a blocking copy."""
        key = str(device)
        with self._lock:
            t = self._tables.get(key)
            if t is None:
                t = (torch.from_numpy(self.desc.copy()).to(device),
                     torch.from_numpy(self.factor.copy()).to(device),
                     torch.from_numpy(_POW10.copy()).to(device),
                     [(torch.tensor(s.positions, dtype=torch.int64,
                                    device=device),
                       torch.tensor([s.field], dtype=torch.int64,
                                    device=device)) for s in self.floats])
                self._tables[key] = t
                self._plans[key] = tuple(
                    torch.from_numpy(a.copy()).to(device)
                    for a in (self.classes, self.runs, self.field_ptr,
                              self.field_runs))
                self._fresh[key] = new_stats(self.n_fields, "cpu").buffer \
                    .to(device)
        return t

    def new_stats(self, device: torch.device) -> Stats:
        """Fresh outputs for the query on `device`: one device copy of
        the `new_stats` buffer uploaded with the tables (`tables_on`), in
        place of four fills."""
        self.tables_on(device)
        return _stats_of(self._fresh[str(device)].clone(), self.n_fields)

    def plan_on(self, device: torch.device) -> tuple:
        """(classes, runs, field_ptr, field_runs) int64 tables on `device`
        (`tables_on`)."""
        self.tables_on(device)
        return self._plans[str(device)]


class Stats(NamedTuple):
    """A query's outputs on the device: views of one `buffer`."""
    buffer: torch.Tensor
    sums: torch.Tensor    # float64 [F]
    mins: torch.Tensor    # int64 keys [F]
    maxs: torch.Tensor    # int64 keys [F]
    counts: torch.Tensor  # int32 [F]


def order_key_of(x: float) -> int:
    """The int64 key of a Python float (signed order = float order)."""
    b = int(np.float64(x).view(np.int64))
    return b if b >= 0 else b ^ _FLIP


KEY_POS_INF = order_key_of(float("inf"))
KEY_NEG_INF = order_key_of(float("-inf"))


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys of a float64 tensor, as the kernel makes them."""
    b = x.view(torch.int64)
    return torch.where(b >= 0, b, b ^ _FLIP)


def key_values(keys: np.ndarray) -> np.ndarray:
    """float64 values of int64 keys (numpy, on the host)."""
    keys = np.asarray(keys, dtype=np.int64)
    return np.where(keys >= 0, keys, keys ^ _FLIP).view(np.float64)


def _stats_of(buf: torch.Tensor, f: int) -> Stats:
    """The `Stats` views of a 28 * f byte buffer."""
    return Stats(buf, buf[:8 * f].view(torch.float64),
                 buf[8 * f:16 * f].view(torch.int64),
                 buf[16 * f:24 * f].view(torch.int64),
                 buf[24 * f:].view(torch.int32))


def new_stats(n_fields: int, device) -> Stats:
    """Zero sums and counts, +inf and -inf keys, in one buffer."""
    stats = _stats_of(torch.empty(28 * n_fields, dtype=torch.uint8,
                                  device=device), n_fields)
    stats.sums.zero_()
    stats.counts.zero_()
    stats.mins.fill_(KEY_POS_INF)
    stats.maxs.fill_(KEY_NEG_INF)
    return stats


def read_stats(host: np.ndarray, n_fields: int):
    """(sums, counts, mins, maxs) numpy arrays from a host copy of a
    `Stats` buffer."""
    f = n_fields
    return (host[:8 * f].view(np.float64), host[24 * f:].view(np.int32),
            key_values(host[8 * f:16 * f].view(np.int64)),
            key_values(host[16 * f:24 * f].view(np.int64)))


def _live(n, rows: int, device) -> torch.Tensor:
    return torch.arange(rows, device=device, dtype=torch.int64) < n


def _pow10_neg(k: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """10 ** -k for an int64 tensor: the table inside it, torch.pow
    outside (the kernel's pow there)."""
    inside = (k >= 0) & (k < POW10_SIZE)
    return torch.where(inside, table[k.clamp(0, POW10_SIZE - 1)],
                       torch.pow(10.0, -k.double()))


def digit_count(values: torch.Tensor) -> torch.Tensor:
    """Decimal digits of |value| for an integer tensor (int64 min: 19):
    ``columnar._digit_count`` in torch."""
    absv = values.to(torch.int64).abs()
    nd = torch.ones(absv.shape, dtype=torch.int64, device=absv.device)
    for k in range(1, 19):
        nd = nd + (absv >= 10 ** k).to(torch.int64)
    return torch.where(absv < 0, torch.full_like(nd, 19), nd)


def _flip(x: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns with the sign bit flipped: signed order of the
    result is the unsigned order of the patterns."""
    return x ^ _INT64_MIN


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def digit_count_limbs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Decimal digits of the uint128 magnitude held as int64 bit patterns
    (hi, lo): ``columnar._digit_count_limbs`` in torch."""
    h, l = _flip(hi), _flip(lo)
    nd = torch.ones(hi.shape, dtype=torch.int64, device=hi.device)
    for k in range(1, 39):
        p = 10 ** k
        ph = _signed(p >> 64) ^ _INT64_MIN
        pl = _signed(p & 0xFFFFFFFFFFFFFFFF) ^ _INT64_MIN
        nd = nd + ((h > ph) | ((h == ph) & (l >= pl))).to(torch.int64)
    return nd


def unsigned_to_double(x: torch.Tensor) -> torch.Tensor:
    """float64 of int64 bit patterns read as uint64, rounded once to
    nearest (``__ull2double_rn``): the two 32-bit halves are exact in a
    double, and so is the high half times 2**32; the one sum rounds."""
    return (((x >> 32) & 0xFFFFFFFF).double() * 4294967296.0
            + (x & 0xFFFFFFFF).double())


def _column_values(planes: Dict[str, torch.Tensor], d: torch.Tensor,
                   kind: int, mode: int, factor: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """[c, N] float64 values of the columns `d`, all of one kind and
    scale mode."""
    digits = None
    if kind == KIND_WIDE:
        hi = planes["i64"][d[:, _D_VALUE]]
        lo = planes["i64"][d[:, _D_LO]]
        mag = unsigned_to_double(hi) * 18446744073709551616.0 \
            + unsigned_to_double(lo)
        v = torch.where(planes["bool"][d[:, _D_NEG]], -mag, mag)
        if mode == MODE_DIGITS:
            digits = digit_count_limbs(hi, lo)
    else:
        x = planes["i32" if kind == KIND_I32 else "i64"][d[:, _D_VALUE]]
        v = x.double()
        if mode == MODE_DIGITS:
            digits = digit_count(x)
    if mode == MODE_CONST:
        v = v * factor[:, None]
    elif mode == MODE_DOTS:
        dots = planes["i32"][d[:, _D_DOTS]].to(torch.int64)
        v = v * _pow10_neg(dots, table)
    elif mode == MODE_DIGITS:
        sf = d[:, _D_SF].to(torch.int64)[:, None]
        v = v * _pow10_neg(digits - sf, table)
    return v


def aggregate_plain(planes: Dict[str, torch.Tensor], spec: AggregateSpec,
                    n, stats: Stats) -> Stats:
    """The kernel's function in torch ops on the planes' device: each
    column's values, masked to valid rows below `n`, reduced to a sum,
    count and min and max keys, and combined into `stats` by field."""
    if spec.n_cols == 0:
        return stats
    device = planes["bool"].device
    desc, factor, table, _ = spec.tables_on(device)
    N = planes["bool"].shape[1]
    live = _live(n, N, device)
    host = spec.desc
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i in range(spec.n_cols):
        buckets.setdefault((int(host[i, _D_KIND]), int(host[i, _D_MODE])),
                           []).append(i)
    for (kind, mode), rows in buckets.items():
        idx = torch.tensor(rows, dtype=torch.int64, device=device)
        d = desc[idx].to(torch.int64)
        v = _column_values(planes, d, kind, mode, factor[idx], table)
        ok = planes["bool"][d[:, _D_VALID]] & live[None, :]
        keys = order_key(v)
        field = d[:, _D_FIELD]
        stats.sums.index_add_(0, field, torch.where(ok, v, 0.0).sum(1))
        stats.counts.index_add_(0, field, ok.sum(1, dtype=torch.int32))
        stats.mins.scatter_reduce_(0, field, torch.where(
            ok, keys, _INT64_MAX).amin(1), "amin")
        stats.maxs.scatter_reduce_(0, field, torch.where(
            ok, keys, _INT64_MIN).amax(1), "amax")
    return stats


def aggregate_floats(groups: Sequence[tuple], spec: AggregateSpec, n,
                     stats: Stats) -> Stats:
    """The float and double slots of `spec` over the groups' outputs
    ((values, valid) of each, [N, count]) into `stats`, with the JAX
    program's masking: sum and min and max over valid live values (NaN
    propagating)."""
    if not spec.floats:
        return stats
    device = stats.buffer.device
    _, _, _, slots = spec.tables_on(device)
    live = None
    for slot, (pos, field) in zip(spec.floats, slots):
        values, valid = groups[slot.group][:2]
        if live is None:
            live = _live(n, values.shape[0], device)
        values = values[:, pos]
        v = (values.view(torch.float64) if slot.double
             else values.double())
        ok = valid[:, pos] & live[:, None]
        inf = float("inf")
        lo = torch.where(ok, v, inf).amin()
        hi = torch.where(ok, v, -inf).amax()
        stats.sums.index_add_(0, field, torch.where(ok, v, 0.0).sum()[None])
        stats.counts.index_add_(0, field, ok.sum(dtype=torch.int32)[None])
        stats.mins.scatter_reduce_(0, field, torch.where(
            lo.isnan(), NAN_MIN_KEY, order_key(lo))[None], "amin")
        stats.maxs.scatter_reduce_(0, field, torch.where(
            hi.isnan(), NAN_MAX_KEY, order_key(hi))[None], "amax")
    return stats


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """The C entries with their argument types (ctypes would otherwise
    pass every Python int as a 32-bit int and cut the pointers)."""
    from ._build import load

    lib = load("aggregate")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.cobrix_aggregate.argtypes = [
        p, p, p, i64, p, p, p, i32, p, p, i32, p, p, p, i32, p, i64, p, p, p,
        p, p, p, p]
    lib.cobrix_aggregate.restype = ctypes.c_int
    lib.cobrix_aggregate_grids.argtypes = [p]
    lib.cobrix_aggregate_grids.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def class_grids(device: torch.device) -> np.ndarray:
    """The kernel's grid of each (kind, mode) class on `device` (at
    kind * 4 + mode): as many blocks as fit on every SM at once."""
    grids = np.zeros(12, dtype=np.int32)
    with torch.cuda.device(device):
        rc = _lib().cobrix_aggregate_grids(grids.ctypes.data)
    if rc != 0 or (grids <= 0).any():
        raise RuntimeError(f"aggregate kernel: occupancy query failed "
                           f"(CUDA error {rc}, grids {grids.tolist()})")
    return grids


def aggregate(planes: Dict[str, torch.Tensor], spec: AggregateSpec, n,
              stats: Stats) -> Stats:
    """Add the fused columns' sum, count, min and max over the valid rows
    below `n` to `stats`, by field. `planes` are the fused kernel's
    contiguous [rows, N] int32, int64 and bool planes on one device; `n`
    a host int or a 0-d int32 tensor there. A CUDA plane launches the
    kernel on the current stream, a CPU plane runs `aggregate_plain`."""
    for p, dt in (("i32", torch.int32), ("i64", torch.int64),
                  ("bool", torch.bool)):
        t = planes[p]
        if t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"aggregate: plane {p!r} must be a contiguous "
                             f"[rows, N] {dt} tensor")
    device = planes["bool"].device
    N = planes["bool"].shape[1]
    if any(planes[p].device != device or planes[p].shape[1] != N
           for p in ("i32", "i64")) or stats.buffer.device != device:
        raise ValueError("aggregate: planes and stats on one device, "
                         "with one row length")
    n_dev = None
    if isinstance(n, torch.Tensor):
        if n.dim() != 0 or n.dtype != torch.int32 or n.device != device:
            raise ValueError(f"aggregate: n is a host int or a 0-d int32 "
                             f"tensor on {device}")
        n_dev = n
    if device.type == "cpu":
        return aggregate_plain(planes, spec, n, stats)
    if device.type != "cuda":
        raise ValueError(f"aggregate runs on cuda or cpu, not {device}")
    if spec.n_cols == 0 or N == 0:
        return stats
    desc, factor, table, _ = spec.tables_on(device)
    classes, runs, field_ptr, field_runs = spec.plan_on(device)
    grids = class_grids(device)
    grid = grids[spec.classes[:, _C_KIND] * 4 + spec.classes[:, _C_MODE]]
    if spec.row_bytes * -(-N // UNIT_ROWS) * int(grid.max()) >= 1 << 62:
        raise ValueError(f"aggregate: {spec.n_cols} columns x {N} rows is "
                         f"past the kernel's 64-bit work split")
    slots = int((grid - 1).sum()) + spec.runs.shape[0]
    partials = torch.empty(slots * PARTIAL_BYTES, dtype=torch.uint8,
                           device=device)
    with torch.cuda.device(device):
        rc = _lib().cobrix_aggregate(
            planes["i32"].data_ptr(), planes["i64"].data_ptr(),
            planes["bool"].data_ptr(), N, desc.data_ptr(), factor.data_ptr(),
            table.data_ptr(), POW10_SIZE, classes.data_ptr(),
            spec.classes.ctypes.data, spec.classes.shape[0],
            runs.data_ptr(), field_ptr.data_ptr(), field_runs.data_ptr(),
            len(spec.field_ptr) - 1,
            n_dev.data_ptr() if n_dev is not None else None,
            0 if n_dev is not None else int(n), grids.ctypes.data,
            partials.data_ptr(), stats.sums.data_ptr(),
            stats.counts.data_ptr(), stats.mins.data_ptr(),
            stats.maxs.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {rc}")
    count_launch(aggregate)
    return stats


aggregate.launches = 0
