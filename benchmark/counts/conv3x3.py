"""Kernel D's op: the decoder's narrow 3x3 convolutions, forward and
input gradient (`ops/conv.py`), from the arguments of each call: each
input read once, each output written once; 2 operations a multiply-add,
and the forward's epilogue as `chip_smoke.py` counts it: 1 operation an
output for the bias, 3 with the ELU."""

from __future__ import annotations

import math

from .peaks import matmul_peak, nbytes


def work(op: str, args: tuple):
    """(bytes, operations, peak FLOP/s) of one call of the op's pass
    `op` (the range's suffix) with argument descriptions `args`."""
    if op in ("fwd", "fwd_reflect"):
        (x, dt), (w, _), bias = args[0], args[1], args[2]
        B, cin, h, wd = x
        if op == "fwd":
            h, wd = h - 2, wd - 2
        out = ((B, w[0], h, wd), dt)
        elu = len(args) > 3 and args[3] is True
        flops = (2.0 * cin * 9 + (3 if elu else 1)) * math.prod(out[0])
        return nbytes(args[0], args[1], bias if isinstance(bias, tuple)
                      else None, out), flops, matmul_peak(dt)
    (g, dt), (w, _) = args[0], args[1]
    B, co, h, wd = g
    cin = w[1]
    pad = 2 if op == "dgrad" else 0
    dx = ((B, cin, h + pad, wd + pad), dt)
    flops = 2.0 * math.prod(g) * cin * 9
    return nbytes(args[0], args[1], dx), flops, matmul_peak(dt)
