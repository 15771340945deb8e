"""The per-kind grid of fused-kernel cases, shared by the tests and
``chip_smoke.py``.

Each case is a list of group specs (the plain attributes of a
``StridedGroup``, so both packages can build their spec from one dict)
and a seeded [n, row_len] uint8 record matrix. The grid covers what the
JAX package's ``tests/test_pallas_kernels.py`` covers: binary in every
signed/endian/width variant, binary wide at 9, 12 and 16 bytes, BCD and
BCD wide, DISPLAY EBCDIC and ASCII across widths, out kinds,
``allow_dot``, ``require_digits`` and ``dyn_sf < 0``, irregular offsets,
and fields that end at or run past the row end. The edge cases of the
CUDA kernel's staging stand beside them: an odd row length, a record
count that is not a multiple of the 32-record tile, a single record, a
row wider than one staging window, and a record matrix passed as the
slice ``x[1:]`` (see `kernel_input`).

`kernel_cases()` is the whole grid; `kernel_input` turns a case's matrix
into the tensor the kernel is given. `jax_subset()` names the cases the
CPU tests run through the Pallas kernel in interpret mode, where every
case is a compile: each kind, width and out bucket appears, and every
DISPLAY flag combination appears at least once.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np

Case = Callable[[int, int], Tuple[List[dict], np.ndarray]]

BINARY_WIDTHS = [(1, "i32"), (2, "i32"), (3, "i32"), (4, "i32"),
                 (5, "i64"), (6, "i64"), (7, "i64"), (8, "i64")]
DISPLAY_WIDTHS = [(3, "i32"), (9, "i32"), (12, "i64"), (18, "i64"),
                  (22, "wide"), (38, "wide")]
# (allow_dot, require_digits, dyn_sf)
DISPLAY_FLAGS = [(False, True, 0), (True, True, 0), (False, False, 0),
                 (False, False, -2)]


def _strided(base: int, stride: int, count: int, width: int, kind: str,
             **kw) -> dict:
    return dict(offsets=[base + stride * k for k in range(count)],
                width=width, kind=kind, **kw)


def _random_rows(rng, n: int, row_len: int) -> np.ndarray:
    data = rng.integers(0, 256, size=(n, row_len), dtype=np.uint8)
    # edge rows: all ones, all zeros, lone sign bit, max positive
    for r, fill in enumerate((0xFF, 0x00, 0x80, 0x7F)):
        if r < n:
            data[r] = fill
    return data


def _binary(signed, big_endian, width, out, n, seed):
    rng = np.random.default_rng(seed)
    g = _strided(8, 16, 12, width, "binary", out=out, signed=signed,
                 big_endian=big_endian)
    return [g], _random_rows(rng, n, 200)


def _binary_wide(signed, big_endian, width, n, seed):
    rng = np.random.default_rng(seed)
    g = _strided(2, 18, 8, width, "binary", out="wide", signed=signed,
                 big_endian=big_endian)
    return [g], _random_rows(rng, n, 150)


def _bcd_fields(rng, n: int, width: int) -> np.ndarray:
    """[n, width] packed BCD: valid digits with C/D/F signs on most rows,
    bad sign nibbles on some, random bytes on the rest."""
    digits = rng.integers(0, 10, size=(n, 2 * width - 1), dtype=np.uint8)
    signs = np.array([0x0C, 0x0D, 0x0F, 0x0C, 0x0D, 0x0F, 0x0A, 0x0E],
                     dtype=np.uint8)
    nib = np.concatenate([digits, signs[rng.integers(0, len(signs), n)]
                          [:, None]], axis=1)
    out = (nib[:, 0::2] << 4) | nib[:, 1::2]
    junk = rng.random(n) < 0.25
    out[junk] = rng.integers(0, 256, size=(int(junk.sum()), width))
    return out.astype(np.uint8)


def _bcd(width, out, n, seed):
    rng = np.random.default_rng(seed)
    g = _strided(4, 24, 10, width, "bcd", out=out)
    data = _random_rows(rng, n, 250)
    for off in g["offsets"]:
        data[:, off:off + width] = _bcd_fields(rng, n, width)
    return [g], data


def display_payload(rng, n: int, width: int, ascii_mode: bool) -> np.ndarray:
    """[n, width] DISPLAY bytes mixing valid digits, overpunch and
    separate signs, points, spaces and random garbage."""
    if ascii_mode:
        digits = rng.integers(0x30, 0x3A, size=(n, width))
        specials = np.array([0x2D, 0x2B, 0x2E, 0x2C, 0x20, 0x00, 0x41])
    else:
        digits = rng.integers(0xF0, 0xFA, size=(n, width))
        specials = np.array([0x60, 0x4E, 0x4B, 0x6B, 0x40, 0x00, 0xC5,
                             0xD7, 0x7A])
    data = digits.astype(np.uint8)
    mask = rng.random((n, width)) < 0.3
    repl = specials[rng.integers(0, len(specials), size=(n, width))]
    data = np.where(mask, repl, data).astype(np.uint8)
    data[: n // 4] = rng.integers(0, 256, size=(n // 4, width))
    return data


def _display(ascii_mode, width, out, signed, allow_dot, require_digits,
             dyn_sf, n, seed):
    rng = np.random.default_rng(seed)
    count, stride = 5, width + 3
    kind = "display_ascii" if ascii_mode else "display_ebcdic"
    g = _strided(2, stride, count, width, kind, out=out, signed=signed,
                 allow_dot=allow_dot, require_digits=require_digits,
                 dyn_sf=dyn_sf)
    data = np.zeros((n, 2 + stride * count), dtype=np.uint8)
    for off in g["offsets"]:
        data[:, off:off + width] = display_payload(rng, n, width, ascii_mode)
    return [g], data


def _irregular(n, seed):
    rng = np.random.default_rng(seed)
    g = dict(offsets=[0, 7, 19, 40], width=4, kind="binary", out="i32",
             signed=True)
    return [g], _random_rows(rng, n, 64)


def _row_end(n, seed):
    """One field ending exactly at the row end and one running past it:
    bytes past the end read as zero."""
    rng = np.random.default_rng(seed)
    groups = [dict(offsets=[16], width=4, kind="binary", out="i32"),
              dict(offsets=[14, 18], width=4, kind="bcd", out="i32"),
              dict(offsets=[12, 17], width=6, kind="display_ebcdic",
                   out="i32", signed=True)]
    data = _random_rows(rng, n, 20)
    data[n // 2:, 16:20] = 0x01
    return groups, data


def _mixed_groups(row_len: int) -> List[dict]:
    """One group of each kind on a row of `row_len` >= 45 bytes, the last
    field ending at the row end."""
    return [dict(offsets=[0, row_len - 4], width=4, kind="binary",
                 out="i32", signed=True),
            dict(offsets=[4], width=5, kind="bcd", out="i64"),
            dict(offsets=[9, 19], width=9, kind="display_ebcdic", out="i32",
                 signed=True, allow_dot=True),
            dict(offsets=[28], width=12, kind="binary", out="wide",
                 signed=True, big_endian=False)]


def _mixed_rows(rng, n: int, row_len: int) -> np.ndarray:
    data = _random_rows(rng, n, row_len)
    data[:, 4:9] = _bcd_fields(rng, n, 5)
    for off in (9, 19):
        data[:, off:off + 9] = display_payload(rng, n, 9, False)
    return data


def _odd_row(n, seed):
    """A 45-byte row: odd and not a multiple of 16, so the records of a
    tile start at every 16-byte phase."""
    rng = np.random.default_rng(seed)
    return _mixed_groups(45), _mixed_rows(rng, n, 45)


def _ragged_tile(n, seed):
    """A record count that is not a multiple of the 32-record tile."""
    rng = np.random.default_rng(seed)
    return _mixed_groups(61), _mixed_rows(rng, max(1, n - 13), 61)


def _single_record(n, seed):
    rng = np.random.default_rng(seed)
    return _mixed_groups(45), _mixed_rows(rng, 1, 45)


def _wide_row(n, seed):
    """A 3,301-byte row, wider than one staging window: fields all along
    it, some of them across the byte positions where windows are cut."""
    rng = np.random.default_rng(seed)
    row_len = 3301
    groups = [
        _strided(0, 37, 89, 4, "binary", out="i32", signed=True),
        _strided(6, 37, 89, 6, "bcd", out="i64"),
        _strided(14, 37, 89, 18, "display_ebcdic", out="i64", signed=True),
        dict(offsets=[1495, 2996, row_len - 10], width=10, kind="binary",
             out="wide", signed=True)]
    data = _random_rows(rng, n, row_len)
    for off in groups[1]["offsets"]:
        data[:, off:off + 6] = _bcd_fields(rng, n, 6)
    for off in groups[2]["offsets"]:
        data[:, off:off + 18] = display_payload(rng, n, 18, False)
    return groups, data


def _unaligned_slice(n, seed):
    """n + 1 records of 45 bytes; the kernel is given ``x[1:]``, whose
    first byte is not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    return _mixed_groups(45), _mixed_rows(rng, n + 1, 45)


# cases whose record matrix the kernel gets as the slice x[1:]
SLICED = ("unaligned_slice",)


def kernel_input(name: str, data: np.ndarray, device):
    """The tensor case `name` hands the kernel: `data` on `device`, cut
    to ``x[1:]`` for the cases in `SLICED` (a contiguous view whose base
    is not 16-byte aligned)."""
    import torch

    t = torch.from_numpy(data).to(device)
    return t[1:] if name in SLICED else t


def kernel_cases() -> Dict[str, Case]:
    """name -> case(n_rows, seed) over the whole grid."""
    cases: Dict[str, Case] = {}
    for signed in (False, True):
        for be in (False, True):
            for width, out in BINARY_WIDTHS:
                cases[f"binary-s{int(signed)}-be{int(be)}-w{width}"] = \
                    functools.partial(_binary, signed, be, width, out)
            for width in (9, 12, 16):
                cases[f"binary_wide-s{int(signed)}-be{int(be)}-w{width}"] = \
                    functools.partial(_binary_wide, signed, be, width)
    for width, out in [(2, "i32"), (4, "i32"), (5, "i32"), (6, "i64"),
                       (10, "i64")]:
        cases[f"bcd-w{width}-{out}"] = functools.partial(_bcd, width, out)
    for width in (10, 11, 19, 20):
        cases[f"bcd_wide-w{width}"] = functools.partial(_bcd, width, "wide")
    for ascii_mode in (False, True):
        mode = "ascii" if ascii_mode else "ebcdic"
        for width, out in DISPLAY_WIDTHS:
            for signed in (False, True):
                for k, (dot, req, sf) in enumerate(DISPLAY_FLAGS):
                    cases[f"display_{mode}-w{width}-s{int(signed)}-f{k}"] = \
                        functools.partial(_display, ascii_mode, width, out,
                                          signed, dot, req, sf)
    cases["irregular"] = _irregular
    cases["row_end"] = _row_end
    cases["odd_row"] = _odd_row
    cases["ragged_tile"] = _ragged_tile
    cases["single_record"] = _single_record
    cases["wide_row"] = _wide_row
    cases["unaligned_slice"] = _unaligned_slice
    return cases


def jax_subset() -> List[str]:
    """Cases cheap enough to compile through the Pallas interpreter in
    the CPU tests: all binary, BCD and staging edge cases but the wide
    row, and per DISPLAY width two flag settings for the narrow buckets
    and one for the wide ones, rotated so every flag combination
    appears."""
    names = [k for k in kernel_cases()
             if not k.startswith("display") and k != "wide_row"]
    combos = [(s, k) for k in range(len(DISPLAY_FLAGS)) for s in (0, 1)]
    i = 0
    for mode in ("ebcdic", "ascii"):
        for width, out in DISPLAY_WIDTHS:
            for _ in range(1 if out == "wide" else 2):
                s, k = combos[i % len(combos)]
                names.append(f"display_{mode}-w{width}-s{s}-f{k}")
                i += 1
    return names
