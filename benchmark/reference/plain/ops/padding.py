"""Reflection padding of the depth decoder's 3x3 convolutions.

Counterpart of `depthmodelhardening_tpu/ops/padding.py` (`reflect_pad1`
and `conv3x3_reflect_same` :53; reference layers.py:121-136). Reflect
padding follows numpy's rule, under which a size-1 axis is its own
reflection, so the deepest decoder maps of small test inputs match the
JAX package. The convolution itself is `ops/conv.py:conv3x3_reflect`.

On a CUDA tensor the pad's backward is `reflect_pad1_adjoint`, in the
order of the JAX package's custom VJP (`padding.py:_bwd`): the interior,
then the reflected rows, columns and corners. F.pad's own CUDA backward
adds every padded pixel into its source with an atomic add, so a source
pixel that takes four addends (each corner's diagonal neighbour) sums
them in the order the card runs them, and two runs of one step differed
in their last bits. On a CPU tensor F.pad's own backward runs: it sums
in one fixed order there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import on_cuda


def _reflect_index(n: int, device) -> torch.Tensor:
    inner = torch.arange(n, device=device)
    first = torch.tensor([min(1, n - 1)], device=device)
    last = torch.tensor([max(n - 2, 0)], device=device)
    return torch.cat([first, inner, last])


def _pad(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[2:]
    if H >= 2 and W >= 2:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = x.index_select(2, _reflect_index(H, x.device))
    return x.index_select(3, _reflect_index(W, x.device))


def reflect_pad1_adjoint(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of `reflect_pad1`: (B, C, H+2, W+2) -> (B, C, H, W), the
    interior plus the reflected edges and corners, added in the order of
    `depthmodelhardening_tpu/ops/padding.py:_bwd` (the top and bottom
    rows, the left and right columns, then the four corners; a size-1
    axis takes all three of its padded lines) in float32, rounded once
    to g's dtype. The interior is a copy of g's; the reflected lines of
    d are summed apart, each by basic indexing (an index tensor would be
    copied from the host, and that copy waits for the card)."""
    H, W = g.shape[2] - 2, g.shape[3] - 2
    r1, rm = min(1, H - 1), max(H - 2, 0)
    c1, cm = min(1, W - 1), max(W - 2, 0)
    line = lambda t: t.to(torch.float32, copy=True)
    d = g[:, :, 1:-1, 1:-1].clone()
    rows = {r: line(g[:, :, r + 1, 1:-1]) for r in (r1, rm)}
    rows[r1] += g[:, :, 0, 1:-1]
    rows[rm] += g[:, :, -1, 1:-1]
    cols = {c: line(g[:, :, 1:-1, c + 1]) for c in (c1, cm)}
    for r, row in rows.items():
        for c, col in cols.items():
            col[:, :, r] = row[:, :, c]
    cols[c1] += g[:, :, 1:-1, 0]
    cols[cm] += g[:, :, 1:-1, -1]
    cols[c1][:, :, r1] += g[:, :, 0, 0]
    cols[cm][:, :, r1] += g[:, :, 0, -1]
    cols[c1][:, :, rm] += g[:, :, -1, 0]
    cols[cm][:, :, rm] += g[:, :, -1, -1]
    for r, row in rows.items():
        d[:, :, r] = row
    for c, col in cols.items():
        d[:, :, :, c] = col
    return d


class ReflectPad1(torch.autograd.Function):
    """The pad with `reflect_pad1_adjoint` as its backward (any device)."""

    @staticmethod
    def forward(ctx, x):
        return _pad(x)

    @staticmethod
    def backward(ctx, g):
        return reflect_pad1_adjoint(g)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad (B, C, H, W) by one pixel on each side; on a CUDA
    tensor the gradient is `reflect_pad1_adjoint`."""
    if on_cuda(x, "reflect_pad1"):
        return ReflectPad1.apply(x)
    return _pad(x)
