"""Kernel C's op: the fused SSIM + L1 reprojection loss and its backward
(`ops/reproj.py`), from the arguments of each call. Operations per pixel
and channel, as `chip_smoke.py` counts them: about 100 forward (9 taps x
5 sums and 3 products of the moments, the SSIM quotient, the clip, the
L1), 120 for the moments' derivatives and 72 for the pool's and pad's
adjoints backward; float32 on the CUDA cores."""

from __future__ import annotations

import math

from .peaks import PEAK_F32_S, nbytes


def work(op: str, args: tuple):
    (x, dt) = args[0]
    B, C, H, W = x
    n = math.prod(x)
    if op == "fwd":
        return nbytes(args[0], args[1], ((B, H, W), dt)), 100.0 * n, \
            PEAK_F32_S
    need_dy = args[3] if len(args) > 3 else True
    outs = (args[0], args[1]) if need_dy else (args[0],)
    return nbytes(args[0], args[1], args[2], *outs), 192.0 * n, PEAK_F32_S
