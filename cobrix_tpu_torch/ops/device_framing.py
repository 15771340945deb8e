"""RDW framing and record packing on the device: kernel wrappers and
plain versions.

Port of ``cobrix_tpu.ops.device_framing`` (``_scan_body`` /
``rdw_scan_device`` and ``pack_records_device``). The kernels are
``csrc/rdw_framing.cu``; its note says what bounds them. Unlike the JAX
device scan, which stops quietly at the first invalid link, the scan has
the semantics of the host walk the JAX reader frames with
(``native.rdw_scan``, ``native.pack_records``): the last length clamped
to the window's end, and a zero or oversized header reported at the
position the sequential walk reaches. The file's header, footer and
windows, and the JAX package's `FramingError`, are the reader's
(``reader.var_len_reader.frame_windows``).

* `scan_window(image, start, last_window, big_endian, adjustment, tile)`
  frames one window of a file image from a start position: payload
  offsets and lengths (window-relative int64 tensors on the image's
  device) and the window's status. A window that is not the last keeps
  only the records that end inside it and says where the next window
  starts. A CUDA tensor launches the kernel's passes (`ScanPasses`, over
  tiles of `tile` positions; counted in ``scan_window.launches``), a CPU
  tensor runs `scan_window_plain`; nothing else is taken.
* `pack_records(image, offsets, lengths, extent, start_offset)` gathers
  the zero-padded [n, extent] record matrix (``pack_records.launches``)
  by the tiles of `plan_pack_tiles`; `pack_records_plain` is the
  ``pack_records_device`` expression in torch with the host pack's
  clamps.

* `scan_capped(image, min_len, cap, ...)` frames a whole image with the
  same kernels in their capped mode: only the records whose header
  length is at least `min_len`, the first `cap` of them, into [cap]
  offsets and lengths, and their count, min(total, cap), left on the
  device as a 0-d int32 tensor; nothing is read back
  (`scan_capped_plain` on the CPU). Its launches count in
  ``scan_window.launches``: they are the scan kernel's.
* `build_wide_pipeline(extent, cap, min_len, ...)` (the JAX package's)
  composes it with `pack_records` and, for a byte projection
  (`columns`), a torch column gather of the packed matrix: a file image
  on the card in, the packed [cap, width] matrix and the live count out,
  with no host round trip. `rdw_scan_device` and `pack_records_device`
  keep the JAX signatures over `scan_window` and `pack_records`; like
  the JAX scan, they stop quietly at a zero or invalid header, keeping
  the records before it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import count_launch

# the host walk's cap on one record (native MAX_RDW_RECORD_SIZE)
MAX_RDW_RECORD_SIZE = 100 * 1024 * 1024

# scan status codes (csrc/rdw_framing.cu ScanStatus)
DONE, CARRY, ZERO, TOO_BIG = 0, 1, -1, -2


class WindowStatus(NamedTuple):
    """How a window's chain ended: `code` DONE (it reached the window's
    end), CARRY (it stopped at a record that continues past a window that
    is not the last: the next window starts at `position`), ZERO or
    TOO_BIG (a malformed header at `position`); `length` is the header's
    length there (adjustment included) for CARRY and the errors."""
    code: int
    position: int
    length: int


def _steps(n: int) -> int:
    """Doubling steps that reach every hop count below n + 1."""
    return max(1, math.ceil(math.log2(n + 1)))


def _check_image(image: torch.Tensor, what: str) -> None:
    if not isinstance(image, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor image")
    if image.dtype != torch.uint8 or image.dim() != 1:
        raise ValueError(f"{what} takes a 1-D uint8 image, not "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError(f"{what} takes a contiguous image")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {image.device}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _header_lengths(image: torch.Tensor, big_endian: bool,
                    adjustment: int) -> torch.Tensor:
    """int64 length of the header that would start at each position
    (bytes past the image read 0)."""
    b = torch.nn.functional.pad(image, (0, 4)).to(torch.int64)
    n = image.numel()
    if big_endian:
        ln = b[1:n + 1] + 256 * b[0:n]
    else:
        ln = b[2:n + 2] + 256 * b[3:n + 3]
    return ln + adjustment


def scan_window_plain(image: torch.Tensor, start: int, last_window: bool,
                      big_endian: bool = False, adjustment: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, WindowStatus]:
    """The kernel's pointer doubling in torch ops (``_scan_body``): links,
    then reachability by `scatter_reduce` (amax) through the doubled
    links, on the image's device."""
    L = image.numel()
    dev = image.device
    pos = torch.arange(L, device=dev, dtype=torch.int64)
    ln = _header_lengths(image, big_endian, adjustment)
    valid = ((pos + 4 <= L) & (ln > 0) & (ln <= MAX_RDW_RECORD_SIZE)
             & (last_window | (pos + 4 + ln <= L)))
    link = torch.where(valid, torch.clamp(pos + 4 + ln, max=L),
                       torch.full_like(pos, L))
    jump = torch.cat([link, torch.tensor([L], device=dev)])
    reached = torch.zeros(L + 1, dtype=torch.uint8, device=dev)
    reached[start] = 1
    for _ in range(_steps(L)):
        reached = reached.scatter_reduce(0, jump, reached, "amax")
        jump = jump[jump]
    hit = torch.nonzero(reached[:L]).flatten()
    starts = hit[valid[hit]]
    offsets = starts + 4
    lengths = torch.minimum(ln[starts], L - offsets)
    code, at, length = DONE, L, 0
    if hit.numel():
        q = int(hit[-1])
        if not bool(valid[q]):
            at = q
            if q + 4 <= L:
                length = int(ln[q])
                code = (ZERO if length <= 0 else TOO_BIG
                        if length > MAX_RDW_RECORD_SIZE else CARRY)
            else:
                code = DONE if last_window else CARRY
    return offsets, lengths, WindowStatus(code, at, length)


def pack_records_plain(image: torch.Tensor, offsets: torch.Tensor,
                       lengths: torch.Tensor, extent: int,
                       start_offset: int = 0) -> torch.Tensor:
    """``pack_records_device`` in torch, with ``native.pack_records``'s
    clamps: a negative or past-the-end offset or a length that is not
    positive gives a zero row, and a record never reads past the image."""
    size = image.numel()
    offs = offsets.to(torch.int64) + start_offset
    lens = torch.clamp(lengths.to(torch.int64) - start_offset, max=extent)
    dead = (offs < 0) | (lens <= 0) | (offs >= size)
    lens = torch.where(dead, torch.zeros_like(lens),
                       torch.minimum(lens, size - offs))
    cols = torch.arange(extent, device=image.device, dtype=torch.int64)
    idx = torch.clamp(offs[:, None] + cols[None, :], 0, max(size - 1, 0))
    gathered = (image[idx] if size else
                torch.zeros(idx.shape, dtype=torch.uint8,
                            device=image.device))
    return torch.where(cols[None, :] < lens[:, None], gathered,
                       torch.zeros((), dtype=torch.uint8,
                                   device=image.device))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# The scan's tile: window positions one block of pass 1 takes, a power of
# two from MIN_SCAN_TILE to MAX_SCAN_TILE (tile-local links are 16-bit).
SCAN_TILE = 65536
MIN_SCAN_TILE, MAX_SCAN_TILE = 8, 65536

# The pack's plan: output bytes a tile aims at, the most output bytes a
# chunk (one stage of the ring) holds, and shared bytes a stage may take.
PACK_THREADS = 256
PACK_TILE_BYTES = 8 * 1024
PACK_CHUNK_BYTES = 8 * 1024
PACK_STAGE_BYTES = 64 * 1024
PACK_SLOT_BYTES = 24  # a staged row's copy plan (rdw_framing.cu Slot)


class PackPlan(NamedTuple):
    """How the pack kernel cuts an [n, extent] output (csrc/rdw_framing.cu
    ``pack_tiles``): `tiles` blocks of `rows` rows, rows * extent a
    multiple of 16; each walks its tile in chunks of `chunk_words` 16-byte
    output words (a multiple of `threads`), staging the at most `slots`
    rows a chunk touches, `slot_words` words each, `lanes` threads a row."""
    rows: int
    tiles: int
    chunk_words: int
    threads: int
    slots: int
    slot_words: int
    lanes: int

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a block: two ring stages of staged words and
        row plans."""
        return 2 * self.slots * (16 * self.slot_words + PACK_SLOT_BYTES)


@functools.lru_cache(maxsize=256)
def plan_pack_tiles(n: int, extent: int) -> PackPlan:
    """The pack kernel's tiles for n > 0 rows of extent > 0 bytes."""
    rows_per_word = 16 // math.gcd(extent, 16)
    rows = rows_per_word * max(1, PACK_TILE_BYTES
                               // (rows_per_word * extent))
    chunk = PACK_CHUNK_BYTES // 16
    while True:
        slots = min(rows, (16 * chunk - 2) // extent + 2)
        slot_words = (min(extent, 16 * chunk) + 30) // 16
        if (slots * (16 * slot_words + PACK_SLOT_BYTES) <= PACK_STAGE_BYTES
                or chunk == 32):
            break
        chunk //= 2
    return PackPlan(rows=rows, tiles=-(-n // rows), chunk_words=chunk,
                    threads=min(PACK_THREADS, chunk), slots=slots,
                    slot_words=slot_words,
                    lanes=min(32, 1 << (slot_words - 1).bit_length()))


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of rdw_framing.cu, with their argument types (ctypes
    would otherwise cut every pointer to 32 bits)."""
    from ._build import load

    lib = load("rdw_framing")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    window = [p, i64, i32, i32, i32, i32]  # image, L, tile_log2, be, adj, last
    fns = {
        "exits": (lib.cobrix_rdw_exits, window + [p, p, p]),
        "chain": (lib.cobrix_rdw_chain,
                  [p, i64, i64, i32, i32, i32, i32, p, p, p, p]),
        "count": (lib.cobrix_rdw_count, window + [p, p, p, i64, i64, p, p]),
        "records": (lib.cobrix_rdw_records,
                    window + [p, p, p, p, i64, i64, p]),
        "pack": (lib.cobrix_pack_records,
                 [p, i64, p, p, i64, i64, i64, p, i32, i64, i32, i32, i32,
                  i32, i32, p]),
    }
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {name: fn for name, (fn, _) in fns.items()}


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _check_tile(tile: int) -> int:
    tile = int(tile)
    if not MIN_SCAN_TILE <= tile <= MAX_SCAN_TILE or tile & (tile - 1):
        raise ValueError(f"the scan tile is a power of two from "
                         f"{MIN_SCAN_TILE} to {MAX_SCAN_TILE}, not {tile}")
    return tile


class ScanPasses:
    """One window's scan on the card, pass by pass (csrc/rdw_framing.cu):
    `exits()`, `chain()` and `count()` are launched in turn, `head()`
    reads back the record count, the `WindowStatus` and the tiles the
    chain entered, and `records(n)` writes the n payload offsets and
    lengths. Scratch: an int32 exit a position and two int32 a tile.
    `scan_window` runs the passes in order; chip_smoke.py times them one
    by one."""

    def __init__(self, image: torch.Tensor, start: int, last_window: bool,
                 big_endian: bool, adjustment: int, tile: int):
        self.fns = _kernels()
        self.device = image.device
        L = image.numel()
        self.start = start
        self.window = (image.data_ptr(), L, tile.bit_length() - 1,
                       int(big_endian), int(adjustment), int(last_window))
        self.exit_table = torch.empty(L, dtype=torch.int32,
                                      device=self.device)
        # per tile: the chain's entry (-1: none), then the first output index
        self.entry, self.base = torch.empty(
            (2, -(-L // tile)), dtype=torch.int32, device=self.device)
        self.head_d = torch.empty(5, dtype=torch.int64, device=self.device)

    def _launch(self, name: str, *args) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _raise_on(self.fns[name](*args, stream), f"rdw_scan {name}")

    def exits(self) -> None:
        self._launch("exits", *self.window, self.exit_table.data_ptr(),
                     self.entry.data_ptr())

    def chain(self) -> None:
        img, L, log2, be, adj, last = self.window
        self._launch("chain", img, L, self.start, log2, be, adj, last,
                     self.exit_table.data_ptr(), self.entry.data_ptr(),
                     self.head_d.data_ptr())

    def count(self, min_len: int = 0, cap: int = -1,
              live: Optional[torch.Tensor] = None) -> None:
        """Count each tile's records; the capped mode (`min_len`, `cap`,
        `live`: a 0-d int32 device tensor for min(count, cap)) counts only
        the records whose header length is at least `min_len`."""
        self._launch("count", *self.window, self.entry.data_ptr(),
                     self.base.data_ptr(), self.head_d.data_ptr(),
                     int(min_len), int(cap),
                     live.data_ptr() if live is not None else None)

    def head(self) -> Tuple[int, WindowStatus, int]:
        n, code, at, length, hops = self.head_d.cpu().tolist()
        return n, WindowStatus(code, at, length), hops

    def records(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        offsets = torch.empty(n, dtype=torch.int64, device=self.device)
        lengths = torch.empty(n, dtype=torch.int64, device=self.device)
        if n:
            self.records_into(offsets, lengths)
        return offsets, lengths

    def records_into(self, offsets: torch.Tensor, lengths: torch.Tensor,
                     min_len: int = 0, cap: int = -1) -> None:
        """Write the records' offsets and lengths (the capped mode: those
        `count` counted, the first `cap`) into int64 device tensors."""
        self._launch("records", *self.window, self.entry.data_ptr(),
                     self.base.data_ptr(), offsets.data_ptr(),
                     lengths.data_ptr(), int(min_len), int(cap))


def scan_window(image: torch.Tensor, start: int = 0,
                last_window: bool = True, big_endian: bool = False,
                adjustment: int = 0, tile: int = SCAN_TILE
                ) -> Tuple[torch.Tensor, torch.Tensor, WindowStatus]:
    """Frame the RDW records of one window from `start`. Returns int64
    payload offsets and lengths (window-relative, on the image's device)
    and the `WindowStatus`. In the last window a record may run past the
    end and is clamped to it; in any other window only records that end
    inside it are kept. `tile` is the kernel's tile of positions (it does
    not change the result)."""
    _check_image(image, "scan_window")
    tile = _check_tile(tile)
    L = image.numel()
    if L >= 2 ** 31 - 8:
        raise ValueError(f"a scan window holds under 2 GiB, not {L} bytes")
    if not 0 <= start <= L:
        raise ValueError(f"scan start {start} outside the window [0, {L}]")
    if image.device.type == "cpu":
        return scan_window_plain(image, start, last_window, big_endian,
                                 adjustment)
    scan = ScanPasses(image, start, last_window, big_endian, adjustment,
                      tile)
    scan.exits()
    scan.chain()
    scan.count()
    n, status, _ = scan.head()
    offsets, lengths = scan.records(n)
    count_launch(scan_window)
    return offsets, lengths, status


scan_window.launches = 0


def pack_records(image: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor, extent: int,
                 start_offset: int = 0) -> torch.Tensor:
    """Zero-padded [n, extent] uint8 matrix of the records at int64
    `offsets` / `lengths` (tensors on the image's device), read from
    `start_offset` into each record. A CUDA image launches the kernel, a
    CPU image runs `pack_records_plain`."""
    _check_image(image, "pack_records")
    for t, name in ((offsets, "offsets"), (lengths, "lengths")):
        if t.dtype != torch.int64 or t.dim() != 1 \
                or t.device != image.device:
            raise ValueError(f"pack_records takes 1-D int64 {name} on "
                             f"{image.device}")
    if offsets.numel() != lengths.numel():
        raise ValueError("pack_records takes as many lengths as offsets")
    extent = int(extent)
    if extent < 0:
        raise ValueError(f"pack_records takes extent >= 0, not {extent}")
    if image.device.type == "cpu":
        count_launch(pack_records_plain)
        return pack_records_plain(image, offsets, lengths, extent,
                                  start_offset)
    n = offsets.numel()
    out = torch.empty((n, extent), dtype=torch.uint8, device=image.device)
    if n == 0 or extent == 0:
        return out
    if out.data_ptr() % 16:
        raise RuntimeError("pack_records: the output is not 16-byte aligned")
    plan = plan_pack_tiles(n, extent)
    offsets = offsets.contiguous()
    lengths = lengths.contiguous()
    with torch.cuda.device(image.device):
        _raise_on(_kernels()["pack"](
            image.data_ptr(), image.numel(), offsets.data_ptr(),
            lengths.data_ptr(), n, extent, int(start_offset), out.data_ptr(),
            plan.rows, plan.tiles, plan.chunk_words, plan.threads, plan.slots,
            plan.slot_words, plan.lanes.bit_length() - 1,
            torch.cuda.current_stream(image.device).cuda_stream),
            "pack_records")
    count_launch(pack_records)
    return out


pack_records.launches = 0
# the wrapper's plain route (a CPU image), counted as the kernel's
# launches are, so that CPU tests can assert a path's launches
pack_records_plain.launches = 0


# ---------------------------------------------------------------------------
# the on-HBM wide pipeline (the JAX package's build_wide_pipeline)
# ---------------------------------------------------------------------------

def _check_whole_image(image: torch.Tensor, what: str) -> None:
    _check_image(image, what)
    if image.numel() >= 2 ** 31 - 8:
        raise ValueError(f"{what} frames images under 2 GiB, not "
                         f"{image.numel()} bytes")


def scan_capped_plain(image: torch.Tensor, min_len: int, cap: int,
                      big_endian: bool = False, adjustment: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`scan_capped` in torch ops: the plain scan of the whole image,
    then the records whose header length is at least `min_len`, the first
    `cap` of them; rows past the count are offset 0, length 0."""
    offs, lens, _ = scan_window_plain(image, 0, True, big_endian,
                                      adjustment)
    header = _header_lengths(image, big_endian, adjustment)[offs - 4]
    keep = torch.nonzero(header >= min_len).flatten()
    live = min(int(keep.numel()), cap)
    keep = keep[:live]
    offsets = torch.zeros(cap, dtype=torch.int64, device=image.device)
    lengths = torch.zeros(cap, dtype=torch.int64, device=image.device)
    offsets[:live] = offs[keep]
    lengths[:live] = lens[keep]
    return offsets, lengths, torch.tensor(live, dtype=torch.int32,
                                          device=image.device)


def scan_capped(image: torch.Tensor, min_len: int, cap: int,
                big_endian: bool = False, adjustment: int = 0,
                tile: int = SCAN_TILE
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame a whole file image (the last window, from 0) and keep the
    records whose header length (adjustment included, before the clamp
    to the image) is at least `min_len`, the first `cap` of them: [cap]
    int64 payload offsets and clamped lengths (rows past the count: 0
    and 0) and the count, min(total, cap), as a 0-d int32 tensor on the
    image's device. A zero or invalid header ends the chain quietly. A
    CUDA image runs the scan kernels' capped mode and reads nothing back;
    a CPU image runs `scan_capped_plain`."""
    _check_whole_image(image, "scan_capped")
    tile = _check_tile(tile)
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"scan_capped takes cap >= 0, not {cap}")
    if image.device.type == "cpu":
        return scan_capped_plain(image, min_len, cap, big_endian, adjustment)
    scan = ScanPasses(image, 0, True, big_endian, adjustment, tile)
    live = torch.empty((), dtype=torch.int32, device=image.device)
    offsets = torch.zeros(cap, dtype=torch.int64, device=image.device)
    lengths = torch.zeros(cap, dtype=torch.int64, device=image.device)
    scan.exits()
    scan.chain()
    scan.count(min_len, cap, live)
    if cap:
        scan.records_into(offsets, lengths, min_len, cap)
    count_launch(scan_window)
    return offsets, lengths, live


def build_wide_pipeline(extent: int, cap: int, min_len: int = 1000,
                        big_endian: bool = False, adjustment: int = 0,
                        columns: Optional[Sequence[int]] = None):
    """A function from a file image on the device ([L] uint8) to (the
    packed [cap, width] uint8 matrix of the records whose header length
    is at least `min_len`, zero rows past them; their count as a 0-d
    int32 tensor), with no host round trip: `scan_capped`, then
    `pack_records` at `extent` (truncated records clamped and zero
    padded), then, for `columns` (the per-record byte indices of
    ``DeviceAggregator.gather_index``), a torch gather of those columns
    (width = len(columns); else extent). `cap` bounds the rows (records
    past it are dropped). Feed the result to ``DeviceAggregator.submit``."""
    cols = None if columns is None else np.asarray(columns, dtype=np.int64)
    pack_extent = (int(extent) if cols is None or not len(cols)
                   else int(cols.max()) + 1)
    on_device = {}

    def cols_on(device: torch.device) -> torch.Tensor:
        t = on_device.get(str(device))
        if t is None:
            host = torch.from_numpy(cols.copy())
            # a pinned, non-blocking copy: the first call waits for nothing
            t = (host if device.type == "cpu"
                 else host.pin_memory().to(device, non_blocking=True))
            on_device[str(device)] = t
        return t

    def fn(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        offsets, lengths, live = scan_capped(image, min_len, cap, big_endian,
                                             adjustment)
        packed = pack_records(image, offsets, lengths, pack_extent)
        if cols is not None:
            packed = packed.index_select(1, cols_on(image.device))
        return packed, live

    return fn


def rdw_scan_device(data, big_endian: bool = False, rdw_adjustment: int = 0,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """All RDW record (payload offset, length) pairs of a file image
    (bytes or a uint8 array), framed on `device` (None: the CUDA device)
    with `scan_window`; host int64 arrays, as ``native.rdw_scan`` gives
    them for well-formed files. A zero or invalid header stops the scan
    quietly, keeping the records before it (the JAX device scan)."""
    from ..device import resolve_device

    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    image = torch.from_numpy(buf.copy()).to(resolve_device(device))
    _check_whole_image(image, "rdw_scan_device")
    offsets, lengths, _ = scan_window(image, 0, True, big_endian,
                                      rdw_adjustment)
    return offsets.cpu().numpy(), lengths.cpu().numpy()


def pack_records_device(data, offsets, lengths, extent: int,
                        device=None) -> torch.Tensor:
    """The zero-padded [n, extent] record matrix gathered on `device`
    (None: the CUDA device; a tensor image stays where it is) by
    `pack_records`, with ``native.pack_records``'s clamps. Returns a
    device tensor."""
    from ..device import resolve_device

    if isinstance(data, torch.Tensor):
        image = data
    else:
        buf = (np.frombuffer(data, dtype=np.uint8)
               if isinstance(data, (bytes, bytearray, memoryview))
               else np.asarray(data, dtype=np.uint8))
        image = torch.from_numpy(buf.copy()).to(resolve_device(device))
    offs = torch.as_tensor(np.asarray(offsets, dtype=np.int64)
                           if not isinstance(offsets, torch.Tensor)
                           else offsets, dtype=torch.int64).to(image.device)
    lens = torch.as_tensor(np.asarray(lengths, dtype=np.int64)
                           if not isinstance(lengths, torch.Tensor)
                           else lengths, dtype=torch.int64).to(image.device)
    return pack_records(image, offs, lens, extent)
