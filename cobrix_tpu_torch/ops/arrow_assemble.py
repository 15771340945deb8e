"""Arrow buffers of one decoded batch, built on the device: the CUDA
kernels' wrappers, their plain version and the descriptor table.

Replaces host C++ of the JAX package (no TPU kernel): the Arrow legs of
``native.assemble_cols_arrow`` (``cobrix_tpu/native/columnar.cpp:518``),
``pack_validity`` (``:740``), ``transcode_string_cols_arrow``
(``cobrix_tpu/native/framing.cpp:600``), ``decimal128_from_limbs``
(``:973``) and ``decimal128_batch`` (``:1034``). The kernels are
``csrc/arrow_assemble.cu``; its note says what they compute and what
bounds them.

* `Request` names one output array: its planes (numpy views of a
  batch's host planes: a list of S per-slot dicts, or a `SlotPlanes`
  whose every plane kind is one [rows, S] array, as the fused decoder's
  column-major group planes hold an OCCURS field's slots), the source
  and output kinds, the decimal mode, shift and precision bound, an
  optional row table (build the array at those rows) and visibility mask
  (a hidden row is null and zero, a hidden string blank), or the string
  width and trim.
* `build_plan(requests, host_buffer, device)` lays the requests out: each
  plane kind's slots as a base and a step (the bytes from one slot's
  plane to the next) in the batch's one host buffer (`host_buffer`, the
  pinned buffer ``ColumnarDecoder._decode_device`` filled), or, when a
  plane lies outside it or a request's slots are not evenly spaced there
  (a joined batch, ``DecodedBatch.concat``), in a staging buffer of only
  the planes the requests read, each kind's slots one after the other;
  the descriptor, work, row and mask tables in one aux buffer; the output
  buffer's layout: four int64 counters a request (null count, bad, data
  start, total) and the grand total, each array's values and validity
  words or int32 offsets, then the string data. A `SlotPlanes` request
  costs a few numpy attributes a plane kind, whatever S is.
* `assemble(plan)` runs the three steps on the plan's device and returns
  the used part of the output buffer on the host: a CUDA plan copies the
  source buffer to the card in one copy (and the aux tables in one
  more), launches the kernels on the current stream, reads the grand
  total, and copies every Arrow buffer back in one copy into a pinned
  buffer; a CPU plan runs the plain version in place.
* The steps `scalars`, `str_lengths` (the strings' lengths and the scan
  of their tiles' sums, one launch) and `str_copy` take CUDA tensors to
  their kernel, counted in the wrapper's ``launches``, and CPU tensors
  to the plain version, the same arithmetic in torch ops; nothing else
  is taken. `Result` reads the counters and the buffers back.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._build import count_launch

# csrc/arrow_assemble.cu descriptor fields, plane kinds and counters
D_NF = 27
(D_LEN, D_SLOTS, D_ROWS, D_MASK, D_SRC, D_RSTRIDE, D_OUT, D_DEC, D_SHIFT,
 D_MAXD, D_VALUES, D_BITMAP, D_WIDTH, D_TRIM, D_RT, D_SC, D_RTILES) = range(17)
D_BASE, D_STEP = 17, 22   # + plane kind: slot 0's byte offset, slot step
P_NF = 5
P_VALUES, P_VALID, P_HI, P_NEG, P_DOTS = range(P_NF)
C_NF = 4
C_NULLS, C_BAD, C_START, C_TOTAL = range(C_NF)
# the string lengths kernel's look-back status word: the flag in bits
# 62-63, the array's OR-ed bad bit in bit 61, the value in bits 0-60
STATUS_FLAG_SHIFT = 62
STATUS_AGGREGATE, STATUS_INCLUSIVE = 1, 2
STATUS_BAD = 1 << 61
STATUS_VALUE_MASK = STATUS_BAD - 1
STR_LOOK_ROUND = 128   # status words a round of its look-back loads

SRC_I32, SRC_I64, SRC_F32, SRC_F64, SRC_WIDE, SRC_CP8, SRC_CP16 = range(7)
OUT_I32, OUT_I64, OUT_F32, OUT_F64, OUT_DEC, OUT_UTF8 = range(6)
DEC_NONE, DEC_STATIC, DEC_DOTS, DEC_DIGITS = range(4)
TRIM_NONE, TRIM_BOTH, TRIM_LEFT, TRIM_RIGHT = range(4)

OUT_ITEMSIZE = {OUT_I32: 4, OUT_I64: 8, OUT_F32: 4, OUT_F64: 8, OUT_DEC: 16}
TILE = 256          # strings a string tile (threads a block)
SCALAR_ROWS = 2048  # rows a scalar tile at most
SCALAR_ELEMS = 4096  # elements a scalar tile at most
SCALAR_CAP = 4128   # staged slots of a scalar tile, SC x (RT + 1)
STR_CP_BYTES = 16384   # staged code-point bytes of a string tile
STR_OUT_BYTES = 24576  # staged UTF-8 bytes of a string tile
_ALIGN = 256        # byte alignment of every buffer in src, aux and out
_INT32_MAX = 2 ** 31 - 1

# 10^k as (high, low) int64 bit patterns, k = 0..38
_POW10_HI = np.array([(10 ** k) >> 64 for k in range(39)],
                     dtype=np.uint64).view(np.int64)
_POW10_LO = np.array([(10 ** k) & (2 ** 64 - 1) for k in range(39)],
                     dtype=np.uint64).view(np.int64)


def _up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def scalar_tile(slots: int) -> Tuple[int, int]:
    """(rows, slots) of one `arrow_scalars` tile of an array of `slots`
    slots: 2,048 rows of a one-slot array, whole rows of up to 64 slots,
    else 128 rows x 32 slots (a slot's 128 rows are 512 or 1,024 bytes of
    values: whole sectors). Two runs of 32 slots of one tile are at least
    33 elements apart, so they never share a validity word."""
    if slots == 1:
        return SCALAR_ROWS, 1
    if slots <= 64:
        return SCALAR_ROWS // slots, slots
    return 128, 32


class SlotPlanes:
    """The planes of an array's S slots, each kind one [rows, S] numpy
    array whose strides are the row stride and the step from one slot's
    plane to the next (a slice of a fused group's column-major planes).
    It reads as the list of per-slot dicts it stands for."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = arrays
        self.slots = next(iter(arrays.values())).shape[1]

    def __len__(self) -> int:
        return self.slots

    def __getitem__(self, s: int) -> Dict[str, np.ndarray]:
        if not -self.slots <= s < self.slots:
            raise IndexError(s)
        return {k: a[:, s] for k, a in self.arrays.items()}


@dataclass
class Request:
    """One output array of `length` elements. `planes`: slot s's host
    planes by name ("values", "valid", "hi", "neg", "dots"; strings:
    "values", the [n, width] code points), a list of per-slot dicts or a
    `SlotPlanes`, numpy arrays over the batch's rows; element j is slot
    j % S of row j // S, or of `rows[j // S]`."""

    length: int
    planes: Union[List[Dict[str, np.ndarray]], SlotPlanes]
    src_kind: int
    out_kind: int
    dec_mode: int = DEC_NONE
    shift: int = 0
    maxd: int = 0
    rows: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    width: int = 0
    trim: int = TRIM_NONE

    @property
    def is_string(self) -> bool:
        return self.out_kind == OUT_UTF8


_PLANE = {"values": P_VALUES, "valid": P_VALID, "hi": P_HI, "neg": P_NEG,
          "dots": P_DOTS}


@dataclass
class Plan:
    """The laid-out requests of one assembly (see the module docstring).
    `src` is the host buffer the planes lie in; `aux` the tables."""

    requests: List[Request]
    src: torch.Tensor
    aux: np.ndarray
    desc: np.ndarray
    num_ids: np.ndarray
    num_work: np.ndarray   # (request, tile) int32 a scalar block
    str_ids: np.ndarray
    str_starts: np.ndarray
    aux_off: Dict[str, int]
    data_off: int          # out bytes before the string data
    out_bytes: int         # data_off + the strings' worst case
    grand_slot: int        # int64 index of the grand total in out
    device: torch.device
    staged: bool = False

    @property
    def num_tiles(self) -> int:
        return len(self.num_work)

    @property
    def str_tiles(self) -> int:
        return int(self.str_starts[-1])


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def _kinds(r: Request) -> Dict[str, Union[np.ndarray, List[np.ndarray]]]:
    """Each plane kind of `r`: its [rows, S] array, or its S per-slot
    arrays ([rows], or [rows, width] code points)."""
    if isinstance(r.planes, SlotPlanes):
        return r.planes.arrays
    return {name: [slot[name] for slot in r.planes] for name in r.planes[0]}


def _placed(arrs, lo: int, size: int):
    """(base, step, row stride or None for one row) of a plane kind's
    slots in the buffer [lo, lo + size), or None where the kernels cannot
    read them there: outside it, misaligned, a slot step or row stride
    that is not a whole number of elements, slots not evenly spaced, or a
    string row whose code points are not contiguous."""
    if isinstance(arrs, np.ndarray):
        a, n, slots = arrs, arrs.shape[0], arrs.shape[1]
        item, (rs, st) = a.itemsize, a.strides
        st = st if slots > 1 else 0
        at = [_addr(a) - lo]
    else:
        a, n, slots = arrs[0], arrs[0].shape[0], len(arrs)
        item, rs = a.itemsize, a.strides[0]
        if a.ndim == 2 and a.shape[1] > 1 and a.strides[1] != item:
            return None
        at = [_addr(x) - lo for x in arrs]
        if any(x.strides[0] != rs for x in arrs):
            return None
        st = at[1] - at[0] if slots > 1 else 0
        if slots > 2 and np.any(np.diff(np.asarray(at)) != st):
            return None
    rs = rs if n > 1 else 0
    row_bytes = (a.shape[1] - 1) * item if a.ndim == 2 and not \
        isinstance(arrs, np.ndarray) else 0
    span = (max(n - 1, 0) * rs + (slots - 1) * st + row_bytes + item
            if n else 0)
    if (at[0] < 0 or at[0] + span > size or at[0] % item or rs % item
            or st % item or rs < 0 or st < 0):
        return None
    return at[0], st, (rs // item if n > 1 else None)


def _layout_in(r: Request, lo: int, size: int):
    """(rstride, {kind: (base, step)}) of `r` in the buffer, or None."""
    kinds, rstride = {}, None
    for name, arrs in _kinds(r).items():
        got = _placed(arrs, lo, size)
        if got is None:
            return None
        base, step, rs = got
        if rs is not None and rstride not in (None, rs):
            return None
        rstride = rs if rs is not None else rstride
        kinds[name] = (base, step)
    if rstride is None:
        rstride = r.width if r.is_string else 1
    return rstride, kinds


def _staged_layout(requests: Sequence[Request], device: torch.device):
    """A staging buffer holding each request's planes, each kind's slots
    one after the other (row stride 1, or the width for strings), and
    each request's (rstride, {kind: (base, step)})."""
    total, spots = 0, []
    for r in requests:
        kinds = {}
        for name, arrs in _kinds(r).items():
            if isinstance(arrs, np.ndarray):
                one, slots = arrs[:, 0], arrs.shape[1]
            else:
                one, slots = arrs[0], len(arrs)
            kinds[name] = (total, one.nbytes, arrs, one)
            total += _up(one.nbytes * slots)
        spots.append(kinds)
    src = _pinned_empty(max(total, _ALIGN), device)
    flat = src.numpy()
    layouts = []
    for r, kinds in zip(requests, spots):
        placed = {}
        for name, (at, step, arrs, one) in kinds.items():
            slots = len(arrs) if isinstance(arrs, list) else arrs.shape[1]
            view = flat[at:at + step * slots].view(one.dtype).reshape(
                (slots,) + one.shape)
            if isinstance(arrs, np.ndarray):
                view[...] = arrs.T
            else:
                for s, a in enumerate(arrs):
                    view[s] = a
            placed[name] = (at, step)
        layouts.append((r.width if r.is_string else 1, placed))
    return src, layouts


def _pinned_empty(nbytes: int, device: torch.device) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def _work(ids: Sequence[int], blocks: Sequence[int]) -> np.ndarray:
    """(request, tile of the request) int32 pairs, request by request."""
    blocks = np.asarray(blocks, dtype=np.int64)
    starts = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum(blocks, out=starts[1:])
    work = np.empty((int(starts[-1]), 2), dtype=np.int32)
    work[:, 0] = np.repeat(np.asarray(ids, dtype=np.int64), blocks)
    work[:, 1] = np.arange(int(starts[-1])) - np.repeat(starts[:-1], blocks)
    return work


def build_plan(requests: Sequence[Request],
               host_buffer: Optional[torch.Tensor],
               device: torch.device) -> Plan:
    """Lay out `requests` over the planes of one batch (see the module
    docstring). `host_buffer`: the batch's host buffer (a 1-D uint8 CPU
    tensor, pinned for a CUDA batch) its planes are views of, or None."""
    requests = list(requests)
    layouts = None
    if host_buffer is not None and host_buffer.numel() % 8 == 0:
        lo, size = host_buffer.data_ptr(), host_buffer.numel()
        layouts = [_layout_in(r, lo, size) for r in requests]
        if any(x is None for x in layouts):
            layouts = None
    staged = layouts is None
    if staged:
        src, layouts = _staged_layout(requests, device)
    else:
        src = host_buffer

    # aux: descriptors, work tables, rows, masks
    k = len(requests)
    num = [i for i, r in enumerate(requests) if not r.is_string]
    strs = [i for i, r in enumerate(requests) if r.is_string]
    str_starts = np.zeros(len(strs) + 1, dtype=np.int64)
    np.cumsum([-(-requests[i].length // TILE) for i in strs],
              out=str_starts[1:])
    parts: List[Tuple[str, np.ndarray]] = []
    aux_off: Dict[str, int] = {}
    cursor = 0

    def put(name: str, arr: np.ndarray) -> int:
        nonlocal cursor
        at = cursor
        aux_off[name] = at
        parts.append((name, np.ascontiguousarray(arr).view(np.uint8)
                      .reshape(-1)))
        cursor = _up(at + arr.nbytes, 8)
        return at

    desc = np.zeros((k, D_NF), dtype=np.int64)
    desc[:, D_BASE:D_BASE + P_NF] = -1
    put("desc", desc)
    shared: Dict[int, int] = {}
    blocks = []
    # out: counters, then each array's fixed buffers
    out_cursor = _up((C_NF * k + 1) * 8)
    worst = 0
    for i, r in enumerate(requests):
        rstride, kinds = layouts[i]
        d = desc[i]
        slots = len(r.planes)
        d[D_LEN] = r.length
        d[D_SLOTS] = slots
        d[D_RSTRIDE] = rstride
        for name, (base, step) in kinds.items():
            d[D_BASE + _PLANE[name]] = base
            d[D_STEP + _PLANE[name]] = step
        d[D_ROWS] = d[D_MASK] = -1
        for field_, arr, dt in ((D_ROWS, r.rows, np.int64),
                                (D_MASK, r.mask, np.uint8)):
            if arr is None:
                continue
            at = shared.get(id(arr))
            if at is None:
                at = shared[id(arr)] = put(f"t{len(shared)}",
                                           np.asarray(arr).astype(
                                               dt, copy=False))
            d[field_] = at
        d[D_SRC] = r.src_kind
        d[D_OUT] = r.out_kind
        d[D_DEC] = r.dec_mode
        d[D_SHIFT] = r.shift
        d[D_MAXD] = r.maxd
        d[D_WIDTH] = r.width
        d[D_TRIM] = r.trim
        d[D_VALUES] = out_cursor
        if r.is_string:
            d[D_BITMAP] = -1
            out_cursor = _up(out_cursor + 4 * (r.length + 1))
            worst += r.length * r.width * (3 if r.src_kind == SRC_CP16
                                           else 1)
            continue
        if r.length % slots:
            raise ValueError(f"arrow_assemble: an array of {r.length} "
                             f"elements over {slots} slots")
        rows = r.length // slots
        if rows >= 2 ** 31:
            raise ValueError(f"arrow_assemble: {rows} rows (the kernels "
                             f"take fewer than 2^31)")
        d[D_RT], d[D_SC] = scalar_tile(slots)
        d[D_RTILES] = -(-rows // d[D_RT])
        blocks.append(int(d[D_RTILES]) * -(-slots // int(d[D_SC])))
        out_cursor = _up(out_cursor + OUT_ITEMSIZE[r.out_kind] * r.length)
        d[D_BITMAP] = out_cursor
        out_cursor = _up(out_cursor + 4 * -(-r.length // 32))
    num_work = _work(num, blocks)
    put("num_work", num_work)
    put("str_ids", np.asarray(strs, dtype=np.int64))
    put("str_work", _work(strs, np.diff(str_starts)))
    aux = np.zeros(max(cursor, 8), dtype=np.uint8)
    for name, arr in parts:
        at = aux_off[name]
        aux[at:at + arr.nbytes] = arr if name != "desc" else \
            desc.view(np.uint8).reshape(-1)
    return Plan(requests, src, aux, desc, np.asarray(num, dtype=np.int64),
                num_work, np.asarray(strs, dtype=np.int64), str_starts,
                aux_off, out_cursor, out_cursor + worst, C_NF * k, device,
                staged=bool(staged))


# ---------------------------------------------------------------------------
# the host side: upload, launch, one copy back
# ---------------------------------------------------------------------------

def new_state(plan: Plan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(out, tile_sums, scratch) for one assembly on `device`: the output
    buffer with its counters and fixed buffers zeroed, the string tiles'
    bases, and the string lengths kernel's own zeroed scratch (a
    look-back status word a tile, then the tile ticket and the count of
    finished tiles, two int32 in one word; the plain version leaves it
    alone)."""
    out = torch.empty(max(plan.out_bytes, 8), dtype=torch.uint8,
                      device=device)
    out[:plan.data_off].zero_()
    tile_sums = torch.zeros(max(plan.str_tiles, 1), dtype=torch.int64,
                            device=device)
    scratch = torch.zeros(plan.str_tiles + 1, dtype=torch.int64,
                          device=device)
    return out, tile_sums, scratch


def upload(plan: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source and aux buffers on the plan's device: one copy each
    from pinned memory on the current stream (the CPU: themselves)."""
    device = plan.device
    aux = torch.from_numpy(plan.aux)
    if device.type == "cpu":
        return plan.src, aux
    pinned = torch.empty(aux.numel(), dtype=torch.uint8, pin_memory=True)
    pinned.copy_(aux)
    return (plan.src.to(device, non_blocking=True),
            pinned.to(device, non_blocking=True))


def run_steps(plan: Plan, src: torch.Tensor, aux: torch.Tensor,
              state: Tuple[torch.Tensor, ...], plain: bool = False) -> int:
    """The three steps over `state` (`new_state`); returns the bytes of
    `out` in use (the fixed part and the string data). `plain` runs the
    plain version on any device (the card check holds the kernels to
    it there)."""
    out, tile_sums, scratch = state
    steps = ((scalars_plain, str_lengths_and_offsets_plain, str_copy_plain)
             if plain else (scalars, str_lengths, str_copy))
    if plan.num_tiles:
        steps[0](src, aux, plan, out)
    if not plan.str_tiles:
        return plan.data_off
    steps[1](src, aux, plan, out, tile_sums, scratch)
    steps[2](src, aux, plan, out, tile_sums)
    # the copy does not read the grand total: the host waits once, here
    grand = int(out[8 * plan.grand_slot:8 * plan.grand_slot + 8]
                .view(torch.int64).item())
    return plan.data_off + grand


def assemble(plan: Plan) -> "Result":
    """Every array of `plan`, built on its device; the used part of the
    output buffer comes back in one copy (a pinned host buffer)."""
    src, aux = upload(plan)
    state = new_state(plan, plan.device)
    used = run_steps(plan, src, aux, state)
    out = state[0][:used]
    if plan.device.type == "cpu":
        return Result(plan, out.numpy())
    host = torch.empty(used, dtype=torch.uint8, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(plan.device).synchronize()
    return Result(plan, host.numpy())


class Result:
    """The host copy of an assembly's output buffer, read per request."""

    def __init__(self, plan: Plan, host: np.ndarray):
        self.plan = plan
        self.host = host
        k = len(plan.requests)
        self.counters = host[:8 * C_NF * k].view(np.int64).reshape(k, C_NF)

    def bad(self, i: int) -> bool:
        return bool(self.counters[i, C_BAD])

    def null_count(self, i: int) -> int:
        return int(self.counters[i, C_NULLS])

    def values(self, i: int) -> np.ndarray:
        """Request i's value bytes (numbers) or int32 offsets (strings)."""
        r, d = self.plan.requests[i], self.plan.desc[i]
        n = (4 * (r.length + 1) if r.is_string
             else OUT_ITEMSIZE[r.out_kind] * r.length)
        return self.host[d[D_VALUES]:d[D_VALUES] + n]

    def bitmap(self, i: int) -> np.ndarray:
        r, d = self.plan.requests[i], self.plan.desc[i]
        return self.host[d[D_BITMAP]:d[D_BITMAP] + -(-r.length // 8)]

    def data(self, i: int) -> np.ndarray:
        at = self.plan.data_off + int(self.counters[i, C_START])
        return self.host[at:at + int(self.counters[i, C_TOTAL])]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """The C entries, loaded and given their argument types once (ctypes
    would otherwise pass every Python int as a 32-bit int and cut the
    pointers)."""
    from ._build import load

    lib = load("arrow_assemble")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cobrix_arrow_scalars.argtypes = [p, i64, p, p, p, i64, p, p]
    lib.cobrix_arrow_str_lengths.argtypes = [p, i64, p, p, p, p, i64, i64,
                                             p, p, p, i64, p]
    lib.cobrix_arrow_str_copy.argtypes = [p, i64, p, p, p, i64, p, p, i64,
                                          p]
    for fn in (lib.cobrix_arrow_scalars, lib.cobrix_arrow_str_lengths,
               lib.cobrix_arrow_str_copy):
        fn.restype = ctypes.c_int
    return lib


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"arrow_assemble: tensors on {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"arrow_assemble runs on cuda or cpu, not {device}")
    return device


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_lib(), f"cobrix_arrow_{name}")
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"arrow_assemble {name} kernel launch failed: "
                           f"CUDA error {rc}")


def _tables(aux: torch.Tensor, plan: Plan, *names: str) -> tuple:
    base = aux.data_ptr()
    return tuple(base + plan.aux_off[n] for n in ("desc",) + names)


def _aligned(*tensors: torch.Tensor) -> None:
    """The kernels read the source and write the output buffer in
    aligned 16-byte words."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("arrow_assemble: a source or output buffer "
                             "that is not 16-byte aligned")


def scalars(src: torch.Tensor, aux: torch.Tensor, plan: Plan,
            out: torch.Tensor) -> None:
    """Step 1: every number array's values, validity words, null count
    and bad flag. `out`'s counters and validity words start zeroed
    (`new_state`): a word two tiles share is OR-ed in."""
    if _device_of(src, aux, out).type == "cpu":
        return scalars_plain(src, aux, plan, out)
    _aligned(src, out)
    desc, work = _tables(aux, plan, "num_work")
    _launch("scalars", out.device, src.data_ptr(), src.numel(),
            aux.data_ptr(), desc, work, plan.num_tiles, out.data_ptr())
    count_launch(scalars)


def str_lengths(src: torch.Tensor, aux: torch.Tensor, plan: Plan,
                out: torch.Tensor, tile_sums: torch.Tensor,
                scratch: torch.Tensor) -> None:
    """Step 2, one launch: each string's UTF-8 length at offsets[j + 1],
    offsets[0] = 0, the bad flag of a surrogate; each tile's exclusive
    base within its array in `tile_sums`, each array's total (0 and bad
    past 2^31 - 1), data starts in request order and the grand total.
    `scratch` (`new_state`) starts zeroed and is the kernel's own."""
    if _device_of(src, aux, out, tile_sums, scratch).type == "cpu":
        return str_lengths_and_offsets_plain(src, aux, plan, out, tile_sums,
                                             scratch)
    _aligned(src)
    desc, work, ids = _tables(aux, plan, "str_work", "str_ids")
    _launch("str_lengths", out.device, src.data_ptr(), src.numel(),
            aux.data_ptr(), desc, work, ids, len(plan.str_ids),
            plan.str_tiles, out.data_ptr(), tile_sums.data_ptr(),
            scratch.data_ptr(), plan.grand_slot)
    count_launch(str_lengths)


def str_copy(src: torch.Tensor, aux: torch.Tensor, plan: Plan,
             out: torch.Tensor, tile_sums: torch.Tensor) -> None:
    """Step 3: the int32 offsets and the UTF-8 bytes of every string
    array not marked bad."""
    if _device_of(src, aux, out, tile_sums).type == "cpu":
        return str_copy_plain(src, aux, plan, out, tile_sums)
    _aligned(src, out)
    desc, work = _tables(aux, plan, "str_work")
    _launch("str_copy", out.device, src.data_ptr(), src.numel(),
            aux.data_ptr(), desc, work, plan.str_tiles, out.data_ptr(),
            tile_sums.data_ptr(), plan.data_off)
    count_launch(str_copy)


for _fn in (scalars, str_lengths, str_copy):
    _fn.launches = 0
KERNELS = {"arrow_scalars": scalars, "arrow_str_lengths": str_lengths,
           "arrow_str_copy": str_copy}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MIN64 = -2 ** 63


def _ult(a, b):
    """a < b for int64 tensors read as uint64."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def _mul64(a, b):
    """(high, low) of the 128-bit products of uint64 bit patterns."""
    a_lo, a_hi = a & _M32, (a >> 32) & _M32
    b_lo, b_hi = b & _M32, (b >> 32) & _M32
    ll, lh, hl = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo
    mid = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    hi = (a_hi * b_hi + ((lh >> 32) & _M32) + ((hl >> 32) & _M32)
          + ((mid >> 32) & _M32))
    return hi, lo


def _ge128(a_hi, a_lo, b_hi, b_lo):
    return _ult(b_hi, a_hi) | ((a_hi == b_hi) & ~_ult(a_lo, b_lo))


def _pow10(k, device):
    k = k.clamp(0, 38)
    return (torch.from_numpy(_POW10_HI).to(device)[k],
            torch.from_numpy(_POW10_LO).to(device)[k])


def _mul_pow10(m_hi, m_lo, k):
    p_hi, p_lo = _pow10(k, m_lo.device)
    p1_hi, p1_lo = _mul64(m_lo, p_lo)
    p2_hi, p2_lo = _mul64(m_lo, p_hi)
    p3_hi, p3_lo = _mul64(m_hi, p_lo)
    s1 = p1_hi + p2_lo
    hi = s1 + p3_lo
    over = (((m_hi != 0) & (p_hi != 0)) | (p2_hi != 0) | (p3_hi != 0)
            | _ult(s1, p1_hi) | _ult(hi, s1))
    return hi, p1_lo, over


def _digit_count(m_hi, m_lo):
    nd = torch.ones(m_lo.shape, dtype=torch.int64, device=m_lo.device)
    for k in range(1, 39):
        nd += _ge128(m_hi, m_lo, int(_POW10_HI[k]), int(_POW10_LO[k])
                     ).to(torch.int64)
    return nd


def _as_i64(x):
    return torch.as_tensor(x, dtype=torch.int64)


class _Views:
    """Typed views of a uint8 buffer (its length a multiple of 8)."""

    def __init__(self, buf: torch.Tensor):
        self.u8 = buf
        n = buf.numel() // 8 * 8
        self.i16 = buf[:n].view(torch.int16)
        self.i32 = buf[:n].view(torch.int32)
        self.i64 = buf[:n].view(torch.int64)


def _aux_i64(aux: torch.Tensor, at: int, n: int) -> torch.Tensor:
    return aux[at:at + 8 * n].view(torch.int64)


def _elements(aux: torch.Tensor, d) -> tuple:
    """(rows, visible, slot index) of every element of a request."""
    L, S = int(d[D_LEN]), int(d[D_SLOTS])
    j = torch.arange(L, dtype=torch.int64, device=aux.device)
    k, s = j // S, j % S
    rows = _aux_i64(aux, int(d[D_ROWS]), -(-L // S))[k] if d[D_ROWS] >= 0 \
        else k
    if d[D_MASK] >= 0:
        visible = aux[int(d[D_MASK]):][rows] != 0
    else:
        visible = torch.ones(L, dtype=torch.bool, device=aux.device)
    return rows, visible, s


def _plane_at(d, p: int, rows, s, size: int, vis):
    """Byte offsets of plane kind p's elements at (rows, slots s); a
    hidden row reads offset 0 of the buffer (its value is unused)."""
    return torch.where(vis, int(d[D_BASE + p]) + s * int(d[D_STEP + p])
                       + rows * int(d[D_RSTRIDE]) * size, 0)


def scalars_plain(src, aux, plan: Plan, out) -> None:
    sv, ov = _Views(src), _Views(out)
    counters = ov.i64
    for i in plan.num_ids.tolist():
        d = plan.desc[i]
        L = int(d[D_LEN])
        rows, vis, s = _elements(aux, d)
        at = lambda p, size: _plane_at(d, p, rows, s, size, vis)  # noqa: E731
        valid = vis & (sv.u8[at(P_VALID, 1)] != 0)
        kind = int(d[D_SRC])
        iv = torch.zeros(L, dtype=torch.int64, device=src.device)
        m_hi = torch.zeros_like(iv)
        neg = torch.zeros_like(valid)
        if kind in (SRC_I32, SRC_F32):
            iv = sv.i32[at(P_VALUES, 4) // 4].to(torch.int64)
        elif kind in (SRC_I64, SRC_F64, SRC_WIDE):
            iv = sv.i64[at(P_VALUES, 8) // 8]
        if kind == SRC_WIDE:
            m_hi = sv.i64[at(P_HI, 8) // 8]
            neg = sv.u8[at(P_NEG, 1)] != 0
            m_lo = iv
        else:
            neg = iv < 0
            m_lo = torch.where(neg, -iv, iv)   # -INT64_MIN wraps to 2**63
        okind = int(d[D_OUT])
        item = OUT_ITEMSIZE[okind]
        base = int(d[D_VALUES])
        region = out[base:base + item * L]
        bad = torch.zeros((), dtype=torch.bool, device=src.device)
        if okind in (OUT_I32, OUT_I64):
            vals = torch.where(valid, iv, 0)
            region.view(torch.int32 if okind == OUT_I32 else torch.int64
                        ).copy_(vals.to(torch.int32) if okind == OUT_I32
                                else vals)
        elif okind == OUT_F32:
            bits = iv.to(torch.int32) if kind == SRC_F32 else \
                iv.view(torch.float64).to(torch.float32).view(torch.int32)
            region.view(torch.int32).copy_(torch.where(valid, bits, 0))
        elif okind == OUT_F64:
            bits = iv if kind == SRC_F64 else iv.to(torch.int32).view(
                torch.float32).to(torch.float64).view(torch.int64)
            region.view(torch.int64).copy_(torch.where(valid, bits, 0))
        else:
            shift = torch.full_like(iv, int(d[D_SHIFT]))
            if d[D_DEC] == DEC_DOTS:
                shift = shift - sv.i32[at(P_DOTS, 4) // 4].to(torch.int64)
            elif d[D_DEC] == DEC_DIGITS:
                shift = shift - _digit_count(m_hi, m_lo)
            out_of = (shift < 0) | (shift > (18 if d[D_MAXD] == 0 else 38))
            hi, lo, over = _mul_pow10(m_hi, m_lo, shift)
            if d[D_MAXD] == 0:
                bad = (vis & out_of).any()
                fail = out_of
            else:
                maxd = int(d[D_MAXD])
                fail = out_of | over | _ge128(
                    hi, lo, int(_POW10_HI[maxd]), int(_POW10_LO[maxd]))
                bad = (valid & fail).any()
            keep = valid & ~fail
            hi, lo = torch.where(keep, hi, 0), torch.where(keep, lo, 0)
            n_lo = ~lo + 1
            n_hi = ~hi + (n_lo == 0).to(torch.int64)
            negate = neg & valid
            lo = torch.where(negate, n_lo, lo)
            hi = torch.where(negate, n_hi, hi)
            region.view(torch.int64).view(L, 2).copy_(
                torch.stack([lo, hi], dim=1))
        words = -(-L // 32)
        bits = torch.zeros(words * 32, dtype=torch.int64, device=src.device)
        bits[:L] = valid.to(torch.int64)
        packed = (bits.view(words, 32) << torch.arange(
            32, device=src.device)).sum(1)
        bm = int(d[D_BITMAP])
        out[bm:bm + 4 * words].view(torch.int32).copy_(packed.to(torch.int32))
        counters[C_NF * i + C_NULLS] += L - int(valid.sum())
        if bool(bad):
            counters[C_NF * i + C_BAD] = 1


def _string_values(src, aux, d):
    """(code points [L, w] int64 with hidden rows blank, kept mask)."""
    L, w = int(d[D_LEN]), int(d[D_WIDTH])
    rows, vis, s = _elements(aux, d)
    wide = d[D_SRC] == SRC_CP16
    cs = 2 if wide else 1
    start = _plane_at(d, P_VALUES, rows, s, cs, vis)
    idx = start[:, None] + cs * torch.arange(w, device=src.device)[None, :]
    if wide:
        cps = _Views(src).i16[idx // 2].to(torch.int64) & 0xFFFF
    else:
        cps = src[idx].to(torch.int64)
    cps = torch.where(vis[:, None], cps, 0x20)
    mode = int(d[D_TRIM])
    pos = torch.arange(w, device=src.device)[None, :].expand(L, w)
    keep = torch.ones((L, w), dtype=torch.bool, device=src.device)
    if mode != TRIM_NONE:
        trims = cps <= 0x20 if mode == TRIM_BOTH else (cps == 0x20) | (
            cps == 0x09)
        solid = ~trims
        big = torch.full_like(pos, w)
        first = torch.where(solid, pos, big).min(1).values
        last = torch.where(solid, pos, -1).max(1).values
        if mode in (TRIM_BOTH, TRIM_LEFT):
            keep &= pos >= first[:, None]
        if mode in (TRIM_BOTH, TRIM_RIGHT):
            keep &= pos <= last[:, None]
    return cps, keep


def _utf8_len(cps):
    return torch.where(cps < 0x80, 1, torch.where(cps < 0x800, 2, 3))


def str_lengths_plain(src, aux, plan: Plan, out, tile_sums) -> None:
    counters = _Views(out).i64
    for m, i in enumerate(plan.str_ids.tolist()):
        d = plan.desc[i]
        L = int(d[D_LEN])
        cps, keep = _string_values(src, aux, d)
        lens = (_utf8_len(cps) * keep).sum(1)
        base = int(d[D_VALUES])
        offs = out[base:base + 4 * (L + 1)].view(torch.int32)
        offs[1:] = lens.to(torch.int32)
        if L:
            offs[0] = 0
        t0, t1 = int(plan.str_starts[m]), int(plan.str_starts[m + 1])
        padded = torch.zeros((t1 - t0) * TILE, dtype=torch.int64,
                             device=src.device)
        padded[:L] = lens
        tile_sums[t0:t1] = padded.view(-1, TILE).sum(1)
        if bool((keep & (cps >= 0xD800) & (cps <= 0xDFFF)).any()):
            counters[C_NF * i + C_BAD] = 1


def str_offsets_plain(plan: Plan, out, tile_sums) -> None:
    counters = _Views(out).i64
    start = 0
    for m, i in enumerate(plan.str_ids.tolist()):
        t0, t1 = int(plan.str_starts[m]), int(plan.str_starts[m + 1])
        sums = tile_sums[t0:t1].clone()
        tile_sums[t0:t1] = torch.cumsum(sums, 0) - sums
        total = int(sums.sum())
        if total > _INT32_MAX:
            counters[C_NF * i + C_BAD] = 1
        if counters[C_NF * i + C_BAD]:
            total = 0
        counters[C_NF * i + C_TOTAL] = total
        counters[C_NF * i + C_START] = start
        start += total
    counters[plan.grand_slot] = start


def str_lengths_and_offsets_plain(src, aux, plan: Plan, out, tile_sums,
                                  scratch=None) -> None:
    """The plain version of `str_lengths`' one launch: the lengths, then
    the scan of the tile sums; the kernel's scratch is not used."""
    str_lengths_plain(src, aux, plan, out, tile_sums)
    str_offsets_plain(plan, out, tile_sums)


def str_copy_plain(src, aux, plan: Plan, out, tile_sums) -> None:
    counters = _Views(out).i64
    for i in plan.str_ids.tolist():
        if counters[C_NF * i + C_BAD]:
            continue
        d = plan.desc[i]
        L = int(d[D_LEN])
        cps, keep = _string_values(src, aux, d)
        ul = _utf8_len(cps)
        lens = (ul * keep).sum(1)
        base = int(d[D_VALUES])
        out[base + 4:base + 4 * (L + 1)].view(torch.int32).copy_(
            torch.cumsum(lens, 0).to(torch.int32))
        b0 = torch.where(cps < 0x80, cps, torch.where(
            cps < 0x800, 0xC0 | (cps >> 6), 0xE0 | (cps >> 12)))
        b1 = torch.where(cps < 0x800, 0x80 | (cps & 0x3F),
                         0x80 | ((cps >> 6) & 0x3F))
        b2 = 0x80 | (cps & 0x3F)
        data = torch.stack([b0, b1, b2], dim=2)
        take = keep[:, :, None] & (torch.arange(
            3, device=src.device)[None, None, :] < ul[:, :, None])
        data = data[take].to(torch.uint8)
        at = plan.data_off + int(counters[C_NF * i + C_START])
        out[at:at + data.numel()] = data
