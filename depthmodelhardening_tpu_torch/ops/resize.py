"""Resizes with torch's F.interpolate conventions, NHWC at the interface.

Counterpart of `depthmodelhardening_tpu/ops/resize.py:42,69`. The
reference resizes composited scenes 1242x375 -> 1024x320 with bilinear,
align_corners=False and no antialiasing (docs/FIDELITY.md #7), which is
exactly `F.interpolate`'s bilinear mode; the decoder upsamples with
nearest x2.

The bilinear resize's forward is F.interpolate's. On a CUDA tensor its
gradient is two matrix products, R_h^T g R_w with the resize's own
interpolation matrices, as the JAX package's resize (two matmuls)
differentiates: F.interpolate's CUDA backward adds each output pixel's
four weighted parts into the input with atomic adds, in the order the
card runs them, so the gradient of the same step differed in its last
bits from run to run (the photometric loss upsamples three coarse
disparities each step); the products sum in a fixed order. On a CPU
tensor F.interpolate's own backward runs: it sums in one fixed order
there.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._build import on_cuda


def _interpolate(x, out_h: int, out_w: int):
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


@functools.lru_cache(maxsize=64)
def interp_matrix(n_in: int, n_out: int, device: torch.device):
    """(n_in, n_out) float32: column j holds the weights output j of a
    bilinear resize n_in -> n_out takes from each input, as F.interpolate
    computes them (the resize of the identity's rows)."""
    eye = torch.eye(n_in, device=device)[:, None, :, None]
    return _interpolate(eye, n_out, 1)[:, 0, :, 0].contiguous()


class BilinearResize(torch.autograd.Function):
    """F.interpolate's bilinear resize of (B, C, H, W); backward
    R_h^T g R_w in float32, rounded once to g's dtype (any device)."""

    @staticmethod
    def forward(ctx, x, out_h: int, out_w: int):
        ctx.in_hw = x.shape[2:]
        return _interpolate(x, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        (H, W), (oh, ow) = ctx.in_hw, g.shape[2:]
        rh = interp_matrix(H, oh, g.device)
        rw = interp_matrix(W, ow, g.device)
        d = torch.matmul(torch.matmul(rh, g.float()), rw.T)
        return d.to(g.dtype), None, None


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int):
    """(B, H, W, C) -> (B, out_h, out_w, C), bilinear, half-pixel
    centres, edge-clamped, no antialiasing; on a CUDA tensor the
    gradient is `BilinearResize`'s."""
    if img.shape[1] == out_h and img.shape[2] == out_w:
        return img
    x = img.permute(0, 3, 1, 2)
    if on_cuda(x, "bilinear_resize") and torch.is_grad_enabled() \
            and x.requires_grad:
        y = BilinearResize.apply(x, out_h, out_w)
    else:
        y = _interpolate(x, out_h, out_w)
    return y.permute(0, 2, 3, 1)


def nearest_upsample2(x: torch.Tensor):
    """2x nearest upsample of (B, C, H, W) (layers.py:201-204)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
