"""Masked, scaled per-field aggregates over decoded planes: the CUDA
kernel's wrapper, its plain version and the float groups' reduction.

Replaces the reduction body of ``cobrix_tpu.parallel.query
.DeviceAggregator._build`` (the XLA ``agg`` program after the decode).
The kernel is ``csrc/aggregate.cu``; its note says what it computes and
what bounds it.

* `AggregateSpec` is the static table of one query: a row per fused
  column a field owns (its plane rows, kind, scale and field id, sorted
  by field), uploaded once per device, and the float groups' slots.
* `new_stats(n_fields, device)` makes the outputs: one device buffer
  holding per field a float64 sum, an int32 count, and min and max as
  order-preserving int64 keys of the double (`order_key`), so that a
  query's whole result comes back in one copy (`read_stats`).
* `aggregate(planes, spec, n, stats)` adds the fused columns' statistics
  to `stats`: a CUDA plane launches the kernel (counted in
  ``aggregate.launches``), a CPU plane runs `aggregate_plain`, the same
  arithmetic in torch ops; nothing else is taken. `n` (the live rows)
  is a host int or a 0-d int32 tensor on the planes' device, which the
  kernel reads there: no host round trip.
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

# the kernel's blocks: a tile of columns x a chunk of rows, about
# BLOCK_VALUES values each
BLOCK_VALUES = 16384
_BLOCK_ROWS_STEP = 256


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


class AggregateSpec:
    """The fused columns of a query, sorted by field (stable), and its
    float slots; `n_fields` output slots."""

    def __init__(self, columns: Sequence[AggregateColumn],
                 floats: Sequence[FloatSlot], n_fields: int):
        cols = sorted(columns, key=lambda c: c.field)
        self.n_fields = n_fields
        self.floats = list(floats)
        self.desc = np.asarray([c[:_DESC_FIELDS] for c in cols],
                               dtype=np.int32).reshape(-1, _DESC_FIELDS)
        self.factor = np.asarray([c.factor for c in cols], dtype=np.float64)
        self._tables: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    @property
    def n_cols(self) -> int:
        return self.desc.shape[0]

    def tables_on(self, device: torch.device) -> tuple:
        """(descriptors, factors, powers of ten) on `device`, uploaded
        once under a lock with a blocking copy, and the float slots'
        field ids and positions (device tensors, by slot)."""
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
        return t


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


def new_stats(n_fields: int, device) -> Stats:
    """Zero sums and counts, +inf and -inf keys, in one buffer."""
    f = n_fields
    buf = torch.empty(28 * f, dtype=torch.uint8, device=device)
    sums = buf[:8 * f].view(torch.float64)
    mins = buf[8 * f:16 * f].view(torch.int64)
    maxs = buf[16 * f:24 * f].view(torch.int64)
    counts = buf[24 * f:].view(torch.int32)
    sums.zero_()
    counts.zero_()
    mins.fill_(KEY_POS_INF)
    maxs.fill_(KEY_NEG_INF)
    return Stats(buf, sums, mins, maxs, counts)


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

def plan_blocks(N: int, n_cols: int) -> Tuple[int, int]:
    """(columns a block, rows a block): a chunk of rows a multiple of
    256 up to BLOCK_VALUES, and as many columns as keep a block near
    BLOCK_VALUES values."""
    rows = min(-(-max(N, 1) // _BLOCK_ROWS_STEP) * _BLOCK_ROWS_STEP,
               BLOCK_VALUES)
    return max(1, min(64, BLOCK_VALUES // rows, n_cols)), rows


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry with its argument types (ctypes would otherwise pass
    every Python int as a 32-bit int and cut the pointers)."""
    from ._build import load

    fn = load("aggregate").cobrix_aggregate
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, p, p, i64, p, i32, p, i64, p, p, p, p, i32,
                   i64, p]
    fn.restype = ctypes.c_int
    return fn


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
    cols, rows = plan_blocks(N, spec.n_cols)
    with torch.cuda.device(device):
        rc = _kernel()(
            planes["i32"].data_ptr(), planes["i64"].data_ptr(),
            planes["bool"].data_ptr(), N, desc.data_ptr(), factor.data_ptr(),
            spec.n_cols, table.data_ptr(), POW10_SIZE,
            n_dev.data_ptr() if n_dev is not None else None,
            0 if n_dev is not None else int(n), stats.sums.data_ptr(),
            stats.counts.data_ptr(), stats.mins.data_ptr(),
            stats.maxs.data_ptr(), cols, rows,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error {rc}")
    count_launch(aggregate)
    return stats


aggregate.launches = 0
