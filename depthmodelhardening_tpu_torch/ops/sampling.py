"""Bilinear sampling at pixel coordinates, NHWC.

Counterpart of `depthmodelhardening_tpu/ops/sampling.py:35`
(`bilinear_sample_pixels`, "zeros" and "border" padding): four gathers
and a weighted sum, differentiable w.r.t. the image through autograd.
"zeros" is the zero-filled resampling inside torchvision's perspective()
that the EoT finals reproduce.
"""

from __future__ import annotations

import torch


def _gather_2d(flat, ix, iy, W: int):
    """flat (B, H*W, C); ix/iy (B, Ho, Wo) in range -> (B, Ho, Wo, C)."""
    Bn, Ho, Wo = ix.shape
    idx = (iy * W + ix).reshape(Bn, Ho * Wo, 1).expand(-1, -1,
                                                       flat.shape[-1])
    return torch.gather(flat, 1, idx).reshape(Bn, Ho, Wo, -1)


def bilinear_sample_pixels(img, x, y, padding_mode: str = "border"):
    """Sample img (B, H, W, C) at pixel coords x, y (B, Ho, Wo).

    "border" clamps the coordinates (grid_sample border semantics);
    "zeros" gives out-of-range neighbours zero weight. Returns
    (B, Ho, Wo, C).
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    Bn, H, W, C = img.shape
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(img.dtype)[..., None]
    wy = (y - y0f).to(img.dtype)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1

    flat = img.reshape(Bn, H * W, C)
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    v00 = _gather_2d(flat, x0c, y0c, W)
    v01 = _gather_2d(flat, x1c, y0c, W)
    v10 = _gather_2d(flat, x0c, y1c, W)
    v11 = _gather_2d(flat, x1c, y1c, W)

    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    if padding_mode == "zeros":
        vx0 = (x0 >= 0) & (x0 <= W - 1)
        vx1 = (x1 >= 0) & (x1 <= W - 1)
        vy0 = (y0 >= 0) & (y0 <= H - 1)
        vy1 = (y1 >= 0) & (y1 <= H - 1)
        w00 = w00 * (vx0 & vy0).to(img.dtype)[..., None]
        w01 = w01 * (vx1 & vy0).to(img.dtype)[..., None]
        w10 = w10 * (vx0 & vy1).to(img.dtype)[..., None]
        w11 = w11 * (vx1 & vy1).to(img.dtype)[..., None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
