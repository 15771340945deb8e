"""The grid of the Arrow assembly's cases, shared by the tests and
``chip_smoke.py``.

`grid(n, seed)` lays planes of `n` rows out in one host buffer (a 1-D
uint8 tensor, as ``ColumnarDecoder._decode_device`` fills one: every
plane a numpy view of it, some contiguous, some a column of a wider
matrix) and returns the requests of one assembly over them: every
source and output kind; decimals with static shifts 0, 18, 19, 38 and
out of range, per-row shifts from a dot plane and from the digit count,
precisions that overflow; all-valid, all-null and mixed validity; rows
hidden by a visibility mask; row tables; flat arrays of `slots` slots,
as a list of per-slot planes and as `SlotPlanes` over column-major
fused planes (a [C, n] region whose every other column is a slot, as a
kernel group holds an OCCURS field's slots beside another field's);
and strings of uint8 and uint16 code points (non-ASCII of one, two and
three UTF-8 bytes, a surrogate), all-blank and empty values, under each
trim policy, with rows a column of a wider matrix, contiguous rows, and
rows too wide for a string tile's shared buffer. The tests hold the
plain version to a Python reference over it; ``chip_smoke.py`` holds the
kernels to the plain version.

`strings(n, width, seed)` is one array of `n` contiguous strings of
`width` uint8 code points: ``chip_smoke.py``'s case of many waves of
string tiles (4,000,000 x 16, 15,625 tiles).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import arrow_assemble as asm


class _Planes:
    """Arrays gathered into one 256-byte-aligned host buffer."""

    def __init__(self):
        self.arrays = []

    def add(self, arr: np.ndarray, column_of: int = 0):
        """Keep `arr` ([n] or [n, w]); with `column_of` = k it becomes
        column 1 of a [n, k] (or [n, k, w]) matrix, a strided view."""
        self.arrays.append((arr, column_of))
        return len(self.arrays) - 1

    def add_fused(self, arr: np.ndarray):
        """Keep `arr` ([n, S]) as the odd columns 1, 3, ... of a
        column-major [2S + 1, n] region: its view is [n, S], rows
        contiguous, slots 2n elements apart."""
        self.arrays.append((arr, -1))
        return len(self.arrays) - 1

    def build(self, pin: bool = False) -> Tuple[torch.Tensor, list]:
        total, spans = 0, []
        for arr, k in self.arrays:
            size = (arr.nbytes * max(k, 1) if k >= 0
                    else arr.itemsize * arr.shape[0] * (2 * arr.shape[1] + 1))
            spans.append((total, size))
            total += -(-size // 256) * 256
        buf = torch.zeros(max(total, 256), dtype=torch.uint8,
                          pin_memory=pin)
        flat = buf.numpy()
        views = []
        for (arr, k), (at, size) in zip(self.arrays, spans):
            region = flat[at:at + size].view(arr.dtype)
            if k < 0:
                view = region.reshape(-1, arr.shape[0]).T[:, 1::2]
            elif k:
                mat = region.reshape((arr.shape[0], k) + arr.shape[1:])
                view = mat[:, 1]
            else:
                view = region.reshape(arr.shape)
            view[...] = arr
            views.append(view)
        return buf, views


# the code points strings draw from: blanks, tabs, ASCII, Latin-1 (two
# UTF-8 bytes), Greek and the euro sign (two and three)
_CP_POOL = np.array([0x20] * 6 + [0x09, 0x00, 0x1F, 0x41, 0x61, 0x7A, 0x7F,
                                  0xA0, 0xE9, 0xFF, 0x391, 0x3C9, 0x20AC,
                                  0x2015], dtype=np.uint16)


def _strings(rng, n: int, w: int, wide: bool) -> np.ndarray:
    cps = rng.choice(_CP_POOL if wide else _CP_POOL[_CP_POOL < 0x80],
                     size=(n, w))
    # all-blank rows, and rows blank at both ends
    cps[rng.random(n) < 0.2] = 0x20
    edge = rng.random(n) < 0.4
    cps[edge, :min(2, w)] = 0x20
    cps[edge, max(0, w - 2):] = 0x09
    return cps.astype(np.uint16 if wide else np.uint8)


def _validity(rng, n: int, kind: str) -> np.ndarray:
    if kind == "all":
        return np.ones(n, dtype=bool)
    if kind == "none":
        return np.zeros(n, dtype=bool)
    return rng.random(n) < 0.7


def grid(n: int, seed: int = 0, slots: int = 3, pin: bool = False
         ) -> Tuple[List["asm.Request"], torch.Tensor]:
    """(requests, host buffer) of one assembly over `n` rows; `pin`:
    the buffer is page-locked, as a CUDA batch's is."""
    rng = np.random.default_rng(seed)
    planes = _Planes()
    specs = []   # (plane indices by name per slot, request fields)
    mask = rng.random(n) < 0.6
    rows = np.sort(rng.choice(n, size=max(1, n // 2), replace=False))

    def valid_plane(kind, column_of):
        return planes.add(_validity(rng, n, kind), column_of=column_of)

    def fused(src, out, dec=asm.DEC_NONE, shift=0, **extra):
        """A flat array of `slots` slots as `SlotPlanes` over fused
        column-major planes."""
        dt = {asm.SRC_I32: np.int32, asm.SRC_I64: np.int64,
              asm.SRC_F64: np.float64}[src]
        if dt is np.float64:
            v = rng.standard_normal((n, slots))
        else:
            v = rng.integers(-10 ** 8, 10 ** 8, (n, slots), dtype=dt,
                             endpoint=True)
        slot_planes = {"values": planes.add_fused(v.astype(dt)),
                       "valid": planes.add_fused(rng.random((n, slots))
                                                 < 0.7)}
        specs.append((slot_planes, dict(src_kind=src, out_kind=out,
                                        dec_mode=dec, shift=shift,
                                        **extra)))

    def number(src, out, validity="mixed", dec=asm.DEC_NONE, shift=0,
               maxd=0, values=None, dots=None, s=1, **extra):
        slot_list = []
        for _ in range(s):
            # every plane of a request has one row stride: the wide
            # limbs are contiguous, as the fused planes are; the others a
            # column of a [n, 3] matrix, as the float groups' outputs are
            wide = src == asm.SRC_WIDE
            slot = {"valid": valid_plane(validity, 0 if wide else 3)}
            if wide:
                mag = values() if values is not None else [
                    int(v) for v in rng.integers(0, 2 ** 62, n)]
                lo = np.array([m & (2 ** 64 - 1) for m in mag],
                              dtype=np.uint64).view(np.int64)
                hi = np.array([m >> 64 for m in mag],
                              dtype=np.uint64).view(np.int64)
                slot["values"] = planes.add(lo)
                slot["hi"] = planes.add(hi)
                slot["neg"] = planes.add(rng.random(n) < 0.5)
            else:
                dt = {asm.SRC_I32: np.int32, asm.SRC_I64: np.int64,
                      asm.SRC_F32: np.int32, asm.SRC_F64: np.int64}[src]
                v = (values() if values is not None else rng.integers(
                    np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt,
                    endpoint=True))
                v = np.asarray(v).astype(dt)
                if src == asm.SRC_F32:
                    v = v.view(np.float32)
                elif src == asm.SRC_F64:
                    v = v.view(np.float64)
                slot["values"] = planes.add(v, column_of=3)
            if dec == asm.DEC_DOTS:
                slot["dots"] = planes.add(np.asarray(dots(), dtype=np.int32),
                                          column_of=0 if wide else 3)
            slot_list.append(slot)
        specs.append((slot_list, dict(src_kind=src, out_kind=out,
                                      dec_mode=dec, shift=shift, maxd=maxd,
                                      **extra)))

    def small(limit):
        return lambda: rng.integers(-limit, limit, n, endpoint=True)

    I32, I64, F32, F64, WIDE = (asm.SRC_I32, asm.SRC_I64, asm.SRC_F32,
                                asm.SRC_F64, asm.SRC_WIDE)
    for validity in ("all", "none", "mixed"):
        number(I32, asm.OUT_I32, validity)
    number(I32, asm.OUT_I64)
    number(I64, asm.OUT_I64, mask=mask)
    number(I64, asm.OUT_I32)                       # wraps, as astype does
    number(F32, asm.OUT_F32)
    number(F64, asm.OUT_F64, rows=rows)
    # a cast between widths rounds to nearest (finite values: the card's
    # conversion makes NaN payloads canonical)
    number(F64, asm.OUT_F32, values=lambda: (rng.standard_normal(n) * 10.0
                                             ** rng.integers(-40, 40, n)
                                             ).view(np.int64))
    number(F32, asm.OUT_F64, values=lambda: rng.standard_normal(n).astype(
        np.float32).view(np.int32))
    # narrow decimals, each bounded by a declared precision: static
    # shifts in and out of 0..38, products that hold, overflow 128 bits
    # or pass the precision (a binary field holding more digits than its
    # PIC, ROADMAP C5)
    for shift, maxd in ((0, 19), (18, 37), (19, 38), (20, 38), (-1, 38),
                        (0, 18)):
        number(I64, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=shift, maxd=maxd)
    number(I32, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=3, maxd=13,
           mask=mask)
    number(I64, asm.OUT_DEC, "none", dec=asm.DEC_STATIC, shift=25, maxd=38)
    number(I64, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=2, maxd=21,
           values=lambda: np.where(rng.random(n) < 0.1,
                                   np.iinfo(np.int64).min,
                                   rng.integers(-10 ** 15, 10 ** 15, n)))
    # per-row shifts: the dot plane, the digit count
    number(I64, asm.OUT_DEC, dec=asm.DEC_DOTS, shift=4, maxd=17,
           dots=lambda: rng.integers(0, 5, n), values=small(10 ** 12))
    number(I64, asm.OUT_DEC, dec=asm.DEC_DOTS, shift=2, maxd=9,
           dots=lambda: rng.integers(0, 4, n), values=small(10 ** 6),
           mask=mask)
    number(I32, asm.OUT_DEC, dec=asm.DEC_DIGITS, shift=7, maxd=13,
           values=small(10 ** 6))
    number(I64, asm.OUT_DEC, dec=asm.DEC_DIGITS, shift=21, maxd=21,
           values=lambda: np.where(rng.random(n) < 0.2, 10 ** 17,
                                   rng.integers(-10 ** 18, 10 ** 18, n)))
    # bounded decimals: shifts 0, 18, 19, 38 and out of range; precisions
    # that hold and that overflow
    digits = lambda k: lambda: [int(v) for v in rng.integers(  # noqa: E731
        0, 10 ** min(k, 18), n)]
    for shift, maxd in ((0, 38), (18, 38), (19, 38), (38, 38), (39, 38),
                        (2, 20), (5, 8), (0, 5)):
        number(WIDE, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=shift,
               maxd=maxd, values=digits(3 if shift >= 19 else 15))
    number(WIDE, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=1, maxd=38,
           values=lambda: [int(v) * 10 ** 20 + int(w) for v, w in zip(
               rng.integers(0, 10 ** 17, n), rng.integers(0, 10 ** 18, n))])
    number(WIDE, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=0, maxd=38,
           values=lambda: [2 ** 127 + 5] * n)      # past 128 bits signed
    number(WIDE, asm.OUT_DEC, "none", dec=asm.DEC_STATIC, shift=50,
           maxd=38)
    number(WIDE, asm.OUT_DEC, dec=asm.DEC_DOTS, shift=10, maxd=30,
           dots=lambda: rng.integers(0, 12, n), values=digits(15),
           mask=mask, rows=rows)
    number(WIDE, asm.OUT_DEC, dec=asm.DEC_DIGITS, shift=30, maxd=30,
           values=digits(12))
    # flat arrays of `slots` slots: plain, hidden rows, compact rows
    number(I32, asm.OUT_I32, s=slots)
    number(I32, asm.OUT_I64, s=slots, mask=mask)
    number(I64, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=2, maxd=21, s=slots,
           rows=rows)
    fused(I32, asm.OUT_I32)
    fused(I64, asm.OUT_DEC, dec=asm.DEC_STATIC, shift=2, maxd=11, mask=mask)
    fused(I32, asm.OUT_I64, rows=rows)
    fused(F64, asm.OUT_F64)
    # strings
    for wide in (False, True):
        for trim in (asm.TRIM_NONE, asm.TRIM_BOTH, asm.TRIM_LEFT,
                     asm.TRIM_RIGHT):
            for w, extra in ((7, {}), (1, {"mask": mask}),
                             (12, {"rows": rows})):
                k = planes.add(_strings(rng, n, w, wide), column_of=3)
                specs.append(([{"values": k}], dict(
                    src_kind=asm.SRC_CP16 if wide else asm.SRC_CP8,
                    out_kind=asm.OUT_UTF8, width=w, trim=trim, **extra)))
    # contiguous rows (a run of a tile's code points), and rows of 80
    # uint16 code points: a 256-string tile of them overflows the shared
    # buffer and writes directly
    for w, wide, trim in ((9, False, asm.TRIM_BOTH), (6, True, asm.TRIM_NONE),
                          (80, True, asm.TRIM_RIGHT)):
        k = planes.add(_strings(rng, n, w, wide))
        specs.append(([{"values": k}], dict(
            src_kind=asm.SRC_CP16 if wide else asm.SRC_CP8,
            out_kind=asm.OUT_UTF8, width=w, trim=trim)))
    cps = _strings(rng, n, 5, True)
    cps[n // 2, 2] = 0xD800                        # a surrogate: bad
    specs.append(([{"values": planes.add(cps)}], dict(
        src_kind=asm.SRC_CP16, out_kind=asm.OUT_UTF8, width=5,
        trim=asm.TRIM_BOTH)))

    buf, views = planes.build(pin)
    requests = []
    for slot_list, fields in specs:
        length = n if fields.get("rows") is None else len(fields["rows"])
        if isinstance(slot_list, dict):
            requests.append(asm.Request(
                length * slots, asm.SlotPlanes(
                    {name: views[i] for name, i in slot_list.items()}),
                **fields))
            continue
        requests.append(asm.Request(
            length * len(slot_list),
            [{name: views[i] for name, i in slot.items()}
             for slot in slot_list], **fields))
    return requests, buf


def strings(n: int, width: int = 16, seed: int = 0, pin: bool = False
            ) -> Tuple[List["asm.Request"], torch.Tensor]:
    """(requests, host buffer) of one assembly of one string array: `n`
    contiguous rows of `width` uint8 code points, trimmed at both ends."""
    planes = _Planes()
    k = planes.add(_strings(np.random.default_rng(seed), n, width, False))
    buf, views = planes.build(pin)
    return [asm.Request(n, [{"values": views[k]}], src_kind=asm.SRC_CP8,
                        out_kind=asm.OUT_UTF8, width=width,
                        trim=asm.TRIM_BOTH)], buf
