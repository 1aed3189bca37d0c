"""Kernel B's op: the stem's 3x3 / stride 2 / pad 1 max pool and its
backward (`ops/pool.py`), from the arguments of each call: 8 maxima a
window forward; 8 maxima, 9 tests and 9 sums a window backward."""

from __future__ import annotations

import math

from .peaks import PEAK_F32_S, nbytes


def pooled(n: int) -> int:
    return (n - 1) // 2 + 1


def work(op: str, args: tuple):
    (x, dt) = args[0]
    B, C, H, W = x
    y = ((B, C, pooled(H), pooled(W)), dt)
    windows = math.prod(y[0])
    if op == "fwd":
        return nbytes(args[0], y), 8.0 * windows, PEAK_F32_S
    return nbytes(args[0], args[1], args[0]), 26.0 * windows, PEAK_F32_S
