"""Reflection padding of the depth decoder's 3x3 convolutions.

Counterpart of `depthmodelhardening_tpu/ops/padding.py` (`reflect_pad1`
and `conv3x3_reflect_same` :53; reference layers.py:121-136). Reflect
padding follows numpy's rule, under which a size-1 axis is its own
reflection, so the deepest decoder maps of small test inputs match the
JAX package. The convolution itself is `ops/conv.py:conv3x3_reflect`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reflect_index(n: int, device) -> torch.Tensor:
    inner = torch.arange(n, device=device)
    first = torch.tensor([min(1, n - 1)], device=device)
    last = torch.tensor([max(n - 2, 0)], device=device)
    return torch.cat([first, inner, last])


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad (B, C, H, W) by one pixel on each side."""
    H, W = x.shape[2:]
    if H >= 2 and W >= 2:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = x.index_select(2, _reflect_index(H, x.device))
    return x.index_select(3, _reflect_index(W, x.device))
