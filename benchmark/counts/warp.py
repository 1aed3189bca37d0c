"""Warp A's op: the EoT warp's vertical resample and its adjoint
(`ops/warp.py`), from the arguments of each call and its row maps A, B,
as `chip_smoke.py:_warp_work` counts them: only a tile row with a tap
in [0, OH) does work. The forward reads the object rows some tap
reaches and writes all of its output; the adjoint reads the cotangent
at the tile rows with a tap in range and writes all of its output; both
read A and B. Operations per channel: the forward's two products, sum
and 1 - w a row, the adjoint's product and sum a tap in range; float32
on the CUDA cores."""

from __future__ import annotations


import torch

from .peaks import PEAK_F32_S, nbytes


def _reach(A, B, th: int, oh: int):
    """(object rows touched, tile rows with a tap in range, taps in
    range), each summed over the batch and the columns."""
    Bn, TW = A.shape
    ys = torch.arange(th, dtype=torch.float32, device=A.device)
    k0 = torch.floor(A[:, None, :] * ys[None, :, None] + B[:, None, :])
    reached = torch.zeros((Bn, oh + 1, TW), device=A.device)
    hit_any = torch.zeros_like(k0, dtype=torch.bool)
    taps = 0
    for k in (k0, k0 + 1.0):
        ok = (k >= 0) & (k < oh)
        hit_any |= ok
        taps += int(ok.sum())
        reached.scatter_(1, torch.where(ok, k, float(oh)).to(torch.int64),
                         1.0)
    return int(reached[:, :oh].sum()), int(hit_any.sum()), taps


def work(op: str, args: tuple):
    """args: the call's (tensor, A, B, rows) descriptions, then A and B
    themselves."""
    (t, dt), a_desc, b_desc, rows, A, B = args
    Bn, C, R, TW = t
    if op == "fwd":
        touched, hit, _ = _reach(A, B, rows, R)
        out = ((Bn, C, rows, TW), dt)
        return (4 * C * touched + nbytes(a_desc, b_desc, out),
                4.0 * C * hit, PEAK_F32_S)
    _, hit, taps = _reach(A, B, R, rows)
    d = ((Bn, C, rows, TW), dt)
    return 4 * C * hit + nbytes(a_desc, b_desc, d), 2.0 * C * taps, \
        PEAK_F32_S
