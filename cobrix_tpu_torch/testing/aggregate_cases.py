"""Inputs of the aggregate kernel's wide and PIC P modes, shared by the
tests and ``chip_smoke.py``.

`WIDE_COPYBOOK` holds a 23-digit COMP-3 field (wide uint128 limbs, a
constant scale), a binary PIC P field (int64 values scaled by their
decimal digit count) and a zoned PIC P field. `wide_rows()` encodes 12
seeded records of it, with the binary field's digit-count edges
(``999...9`` with 18 nines, its negative, ``10 ** 17``): the cases of
``tests/test_wide_numerics.py``.
"""
from __future__ import annotations

import numpy as np

from .generators import encode_bcd_digits

WIDE_COPYBOOK = """
       01 REC.
          05 WIDE-BCD PIC S9(21)V99 COMP-3.
          05 P-BIN    PIC SPPP9(18) COMP.
          05 P-DISP   PIC SVPP9(5).
"""


def wide_rows() -> np.ndarray:
    """[12, 25] uint8 records of `WIDE_COPYBOOK`."""
    rng = np.random.default_rng(7)
    digits = rng.integers(0, 10, size=(12, 23)).astype(np.uint8)
    neg = rng.integers(0, 2, size=12).astype(bool)
    pbin = [int(v) for v in rng.integers(-10 ** 17, 10 ** 17, size=12)]
    # float64(999999999999999999) == 1e18: a float digit count is 19
    pbin[0] = 999_999_999_999_999_999
    pbin[1] = -999_999_999_999_999_999
    pbin[2] = 10 ** 17
    return np.concatenate([
        encode_bcd_digits(digits, np.where(neg, 0x0D, 0x0C).astype(np.uint8)),
        np.stack([np.frombuffer(v.to_bytes(8, "big", signed=True),
                                dtype=np.uint8) for v in pbin]),
        (0xF0 + digits[:, :5]).astype(np.uint8),
    ], axis=1)
