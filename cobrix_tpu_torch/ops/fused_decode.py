"""The fused numeric decode: CUDA kernel wrapper, plain version, layout.

Replaces ``cobrix_tpu/ops/pallas_tpu.py::_fused_kernel`` (with its
launcher ``build_fused_decode`` and XLA-side ``_assemble_group``): one
launch decodes every binary, packed-BCD and zoned-DISPLAY group of a
record batch. The kernel is ``csrc/fused_decode.cu``; its note says what
bounds it and how its tiles, windows and ring answer that.

* `StridedGroup` is the static spec of one fused group, with the plain
  attributes of ``pallas_tpu.StridedGroup``.
* `FusedLayout` flattens a list of groups into per-column descriptors
  and places every group output in one of three column-major planes:
  ``"i32"`` (int32), ``"i64"`` (int64) and ``"bool"``. `split` turns the
  planes back into each group's tuple, dtype for dtype the tuple
  ``columnar._run_group_jax`` returns in the JAX package: int32 or int64
  values, bool valid, uint64 hi/lo (int64 bit patterns on the card,
  viewed as uint64 on the host), bool negative, int32 dots.
* `plan_windows` cuts a layout's columns, sorted by offset, into byte
  windows of the row that the kernel stages in shared memory a record
  tile at a time; the layout keeps the descriptor table reordered by
  window and the window table, uploaded once per device.
* `fused_decode(data, layout)` launches the kernel for a CUDA tensor and
  counts the launch in ``fused_decode.launches``; for a CPU tensor it runs
  `fused_decode_plain`, counted in ``fused_decode_plain.launches``. Any
  other input raises: there is no fallback.
* `fused_decode_plain(data, groups)` gathers each group's byte slab and
  calls ``ops.batch_torch``, the route of the JAX ``"jax"`` backend. The
  tests hold it against the Pallas kernel; ``chip_smoke.py`` holds the
  CUDA kernel against it on the card.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import batch_torch
from ._build import count_launch

KINDS = ("binary", "bcd", "display_ebcdic", "display_ascii")
OUTS = ("i32", "i64", "wide")

# widest field each (kind, out) bucket takes: the buckets the plan
# compiler's variant keys make (columnar._variant_key), within which the
# kernel's integer arithmetic and the plain version's agree bit for bit
_MAX_WIDTH = {("binary", "i32"): 4, ("binary", "i64"): 8,
              ("binary", "wide"): 16, ("display", "i32"): 9,
              ("display", "i64"): 18}
_MIN_WIDTH = {("binary", "i64"): 5, ("binary", "wide"): 9}

# csrc/fused_decode.cu descriptor fields
_DESC_FIELDS = 12
_F_SIGNED, _F_BIG_ENDIAN, _F_ALLOW_DOT, _F_REQUIRE_DIGITS = 1, 2, 4, 8

_PLANE_DTYPES = {"i32": torch.int32, "i64": torch.int64, "bool": torch.bool}

# csrc/fused_decode.cu staging: a block stages TILE_RECORDS records x one
# window of the row per stage, in a ring of two stages; the planner keeps
# each stage within STAGE_BYTES so that two blocks fit on an SM
TILE_RECORDS = 32
STAGE_BYTES = 48 * 1024
# window table fields: lo, span, pitch, first column, end column
_WIN_FIELDS = 5


class StridedGroup:
    """Static decode spec for one fused kernel group: the field byte
    offsets of its columns, the field width, the kind ("binary", "bcd",
    "display_ebcdic" or "display_ascii"), the value plane ``out`` ("i32",
    "i64" or "wide": the uint128 BigDecimal plane) and the kind's flags."""

    def __init__(self, offsets: Sequence[int], width: int, kind: str,
                 out: str = "i32", signed: bool = False,
                 big_endian: bool = True, allow_dot: bool = False,
                 require_digits: bool = True, dyn_sf: int = 0):
        self.offsets = [int(o) for o in offsets]
        self.count = len(self.offsets)
        self.width = int(width)
        self.kind = kind
        self.out = out
        self.signed = bool(signed)
        self.big_endian = bool(big_endian)
        self.allow_dot = bool(allow_dot)
        self.require_digits = bool(require_digits)
        self.dyn_sf = int(dyn_sf)
        self._check()

    @classmethod
    def from_dict(cls, d: dict) -> "StridedGroup":
        """From the plain attributes of ``pallas_tpu.StridedGroup``:
        offsets, width, kind, out, signed, big_endian, allow_dot,
        require_digits and dyn_sf."""
        return cls(**d)

    def _check(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fused group kind {self.kind!r}")
        if self.out not in OUTS:
            raise ValueError(f"unknown fused group out {self.out!r}")
        if not self.offsets or min(self.offsets) < 0:
            raise ValueError("a fused group needs non-negative offsets")
        family = "display" if self.is_display else self.kind
        hi = _MAX_WIDTH.get((family, self.out), 1 << 16)
        lo = _MIN_WIDTH.get((family, self.out), 1)
        if not lo <= self.width <= hi:
            raise ValueError(
                f"{self.kind} group with out={self.out!r} takes widths "
                f"{lo}..{hi}, not {self.width}")

    @property
    def end(self) -> int:
        return max(self.offsets) + self.width

    @property
    def is_display(self) -> bool:
        return self.kind.startswith("display")

    def out_planes(self) -> List[str]:
        """Plane of each tuple element, in `_run_group_jax` order."""
        if self.out == "wide":
            planes = ["i64", "i64", "bool", "bool"]   # hi, lo, neg, valid
        else:
            planes = [self.out, "bool"]               # values, valid
        return planes + (["i32"] if self.is_display else [])  # dots


def staged_pitch(span: int) -> int:
    """Bytes between two staged records of a window `span` bytes wide.

    A record's window bytes land at their 16-byte phase in the row (the
    copies move aligned 16-byte chunks), so the span needs room for 15
    more bytes. The chunk count is made odd: then 8 records at one window
    position lie in 8 different 16-byte bank slots, whatever the row
    pitch (at a pitch that is a multiple of 128 they would share one)."""
    chunks = -(-(span + 15) // 16)
    return 16 * (chunks | 1)


class WindowPlan(NamedTuple):
    order: np.ndarray    # descriptor rows in window order (sorted by offset)
    windows: np.ndarray  # [n_windows, 5] int32: lo, span, pitch, begin, end


def plan_windows(offsets: Sequence[int],
                 widths: Sequence[int]) -> WindowPlan:
    """Cut the columns, sorted by offset, into windows [lo, lo + span) of
    the row that never split a field and whose staged tile (TILE_RECORDS
    records at `staged_pitch(span)`) fits STAGE_BYTES. The cut is greedy:
    a window takes the next column while its span still fits, and a
    column that does not starts the next window at its own offset.
    Columns ``order[begin:end]`` lie in a window. A field too wide for the
    budget gets a window of its own; the kernel's launch then asks for
    the shared memory it needs, or is refused."""
    offsets = np.asarray(offsets, dtype=np.int64)
    ends = offsets + np.asarray(widths, dtype=np.int64)
    order = np.argsort(offsets, kind="stable")
    windows = []
    lo = hi = begin = None
    for k, c in enumerate(order):
        start, end = int(offsets[c]), int(ends[c])
        if lo is not None and (TILE_RECORDS * staged_pitch(max(hi, end) - lo)
                               <= STAGE_BYTES):
            hi = max(hi, end)
            continue
        if lo is not None:
            windows.append((lo, hi - lo, staged_pitch(hi - lo), begin, k))
        lo, hi, begin = start, end, k
    if lo is not None:
        windows.append((lo, hi - lo, staged_pitch(hi - lo), begin,
                        len(order)))
    return WindowPlan(order, np.asarray(windows, dtype=np.int32).reshape(
        -1, _WIN_FIELDS))


class FusedLayout:
    """Where every group's outputs live in the three planes, the
    per-column descriptor table (`desc`, in group order) and the kernel's
    tables: `plan` cuts the columns into windows, and the kernel reads
    `desc[plan.order]` with `plan.windows`."""

    def __init__(self, groups: Sequence[StridedGroup]):
        self.groups = list(groups)
        rows = {"i32": 0, "i64": 0, "bool": 0}
        self.slots: List[List[tuple]] = []
        for g in self.groups:
            slots = []
            for plane in g.out_planes():
                slots.append((plane, rows[plane]))
                rows[plane] += g.count
            self.slots.append(slots)
        self.rows = rows
        self.desc = self._descriptors()
        self.plan = plan_windows(self.desc[:, 0], self.desc[:, 3])
        self._tables_on: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._tables_lock = threading.Lock()

    def _descriptors(self) -> np.ndarray:
        out = []
        for g, slots in zip(self.groups, self.slots):
            flags = ((_F_SIGNED if g.signed else 0)
                     | (_F_BIG_ENDIAN if g.big_endian else 0)
                     | (_F_ALLOW_DOT if g.allow_dot else 0)
                     | (_F_REQUIRE_DIGITS if g.require_digits else 0))
            starts = [start for _, start in slots]
            if g.out == "wide":
                value, lo, neg, valid = starts[:4]
            else:
                (value, valid), lo, neg = starts[:2], -1, -1
            dots = starts[-1] if g.is_display else -1
            for pos, off in enumerate(g.offsets):
                at = lambda s: s + pos if s >= 0 else -1  # noqa: E731
                out.append([off, KINDS.index(g.kind), OUTS.index(g.out),
                            g.width, flags, g.dyn_sf, at(value), at(lo),
                            at(neg), at(valid), at(dots), 0])
        return np.asarray(out, dtype=np.int32).reshape(-1, _DESC_FIELDS)

    @property
    def n_cols(self) -> int:
        return self.desc.shape[0]

    @property
    def max_pitch(self) -> int:
        return int(self.plan.windows[:, 2].max())

    def tables_on(self, device: torch.device) -> tuple:
        """(descriptors in window order, window table) on `device`,
        uploaded once and cached. The upload is a blocking copy made
        under a lock, so decode workers on other streams never race it
        or read the tables before they have landed."""
        key = str(device)
        with self._tables_lock:
            t = self._tables_on.get(key)
            if t is None:
                desc = np.ascontiguousarray(self.desc[self.plan.order])
                t = (torch.from_numpy(desc).to(device),
                     torch.from_numpy(self.plan.windows).to(device))
                self._tables_on[key] = t
        return t

    def empty_planes(self, n: int, device) -> Dict[str, torch.Tensor]:
        return {p: torch.empty((self.rows[p], n), dtype=dt, device=device)
                for p, dt in _PLANE_DTYPES.items()}

    def split(self, planes: dict) -> List[tuple]:
        """Planes (torch on any device, or numpy on the host) -> each
        group's output tuple of [n, count] views. On numpy planes the wide
        hi/lo bit patterns come back viewed as uint64, the JAX package's
        host dtype."""
        res = []
        for g, slots in zip(self.groups, self.slots):
            outs = []
            for k, (plane, start) in enumerate(slots):
                rows = planes[plane][start:start + g.count]
                if isinstance(rows, np.ndarray):
                    if g.out == "wide" and k < 2:
                        rows = rows.view(np.uint64)
                    outs.append(rows.T)
                else:
                    outs.append(rows.t())
            res.append(tuple(outs))
        return res

    def bytes_per_record(self) -> tuple:
        """(field bytes read, output bytes written) per record: the least
        traffic of one decode, for the memory bound."""
        size = {"i32": 4, "i64": 8, "bool": 1}
        read = sum(g.width * g.count for g in self.groups)
        written = sum(size[p] * n for p, n in self.rows.items())
        return read, written


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _slab(data: torch.Tensor, g: StridedGroup) -> torch.Tensor:
    idx = (torch.tensor(g.offsets, dtype=torch.int64, device=data.device)
           [:, None] + torch.arange(g.width, device=data.device)[None, :])
    return data[:, idx]


def decode_group_plain(slab: torch.Tensor, g: StridedGroup) -> tuple:
    """One group's [n, count, width] byte slab through batch_torch, as
    ``columnar._run_group_jax`` sends it through batch_jax."""
    out_dtype = torch.int32 if g.out == "i32" else torch.int64
    if g.kind == "binary":
        if g.out == "wide":
            return batch_torch.decode_binary_wide(slab, g.signed,
                                                  g.big_endian)
        return batch_torch.decode_binary(slab, g.signed, g.big_endian,
                                         out_dtype)
    if g.kind == "bcd":
        if g.out == "wide":
            return batch_torch.decode_bcd_wide(slab)
        return batch_torch.decode_bcd(slab, out_dtype)
    ascii_mode = g.kind == "display_ascii"
    if g.out == "wide":
        fn = (batch_torch.decode_display_ascii_wide if ascii_mode
              else batch_torch.decode_display_ebcdic_wide)
        return fn(slab, g.signed, g.allow_dot, g.require_digits, g.dyn_sf)
    fn = (batch_torch.decode_display_ascii if ascii_mode
          else batch_torch.decode_display_ebcdic)
    values, valid, dots = fn(slab, g.signed, g.allow_dot, g.require_digits,
                             out_dtype, g.dyn_sf)
    # batch_jax (and so batch_torch) sums DISPLAY mantissas into int64;
    # the fused kernel writes the i32 bucket as int32, as the Pallas
    # kernel does. Exact: an i32 field holds at most 9 digits.
    return values.to(out_dtype), valid, dots


def fused_decode_plain(data: torch.Tensor,
                       groups: Sequence[StridedGroup]) -> List[tuple]:
    """Plain PyTorch version of the fused kernel on any device: each
    group's tuple, as the kernel's planes give them after `split`. Bytes
    past the end of a row read as 0, as in the kernel."""
    groups = list(groups)
    need = max([g.end for g in groups], default=0)
    if need > data.shape[1]:
        data = torch.nn.functional.pad(data, (0, need - data.shape[1]))
    return [tuple(decode_group_plain(_slab(data, g), g)) for g in groups]


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry, loaded and given its argument types once (ctypes
    would otherwise pass every Python int as a 32-bit int and cut the
    pointers)."""
    from ._build import load

    fn = load("fused_decode").cobrix_fused_decode
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, p, i32, i32, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def fused_decode(data: torch.Tensor, layout: FusedLayout,
                 out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Decode every group of `layout` over a [n, row_len] uint8 record
    matrix into the three planes (see `FusedLayout.split`). A CUDA tensor
    launches the kernel on the current stream; a CPU tensor takes the
    plain version. `out`: the planes to write, contiguous [rows, n]
    tensors of the plane dtypes on the data's device (the decoder's one
    output buffer); new ones when None."""
    if not isinstance(data, torch.Tensor):
        raise TypeError("fused_decode takes a torch.Tensor")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(
            f"fused_decode takes a [n, row_len] uint8 matrix, not "
            f"{tuple(data.shape)} {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("fused_decode takes a contiguous record matrix")
    n, row_len = data.shape
    if out is None:
        planes = layout.empty_planes(n, data.device)
    else:
        planes = out
        for p, dt in _PLANE_DTYPES.items():
            t = planes[p]
            if (t.dtype != dt or tuple(t.shape) != (layout.rows[p], n)
                    or t.device != data.device or not t.is_contiguous()):
                raise ValueError(
                    f"fused_decode: out plane {p!r} must be a contiguous "
                    f"{dt} [{layout.rows[p]}, {n}] tensor on {data.device}")
    if data.device.type == "cpu":
        for (g, slots), outs in zip(zip(layout.groups, layout.slots),
                                    fused_decode_plain(data, layout.groups)):
            for (plane, start), arr in zip(slots, outs):
                planes[plane][start:start + g.count] = arr.t()
        count_launch(fused_decode_plain)
        return planes
    if data.device.type != "cuda":
        raise ValueError(f"fused_decode runs on cuda or cpu, not "
                         f"{data.device}")
    desc, windows = layout.tables_on(data.device)
    kernel = _kernel()
    with torch.cuda.device(data.device):  # ctypes launches on the current device
        rc = kernel(data.data_ptr(), n, row_len, desc.data_ptr(),
                    windows.data_ptr(), windows.shape[0], layout.max_pitch,
                    planes["i32"].data_ptr(),
                    planes["i64"].data_ptr(), planes["bool"].data_ptr(),
                    torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(fused_decode)
    return planes


fused_decode.launches = 0
# the wrapper's plain route (a CPU tensor), counted as the kernel's
# launches are, so that CPU tests can assert a path's launches
fused_decode_plain.launches = 0
