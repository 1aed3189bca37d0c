"""Bilinear sampling, NHWC.

Counterpart of `depthmodelhardening_tpu/ops/sampling.py`:

* `bilinear_sample_pixels` (:35, "zeros" and "border" padding): four
  gathers and a weighted sum, differentiable through autograd. "zeros"
  is the zero-filled resampling inside torchvision's perspective() that
  the EoT finals reproduce.
* `grid_sample` (:293): F.grid_sample's bilinear mode on normalised
  coordinates, align_corners=True (the reprojection warp's).
* `bilinear_sample_rows` (:173-278): the rectified-stereo warp, each
  output row resampled from its own source row, with the JAX package's
  tap split and coordinate gradient.

All plain PyTorch: in the JAX package these are XLA, not kernels.
"""

from __future__ import annotations

import torch


def _gather_2d(flat, ix, iy, W: int):
    """flat (B, H*W, C); ix/iy (B, Ho, Wo) in range -> (B, Ho, Wo, C)."""
    Bn, Ho, Wo = ix.shape
    idx = (iy * W + ix).reshape(Bn, Ho * Wo, 1).expand(-1, -1,
                                                       flat.shape[-1])
    return torch.gather(flat, 1, idx).reshape(Bn, Ho, Wo, -1)


class _ClipJax(torch.autograd.Function):
    """clamp(x, lo, hi) with jnp.clip's derivative: 1 inside, 1/2 on a
    bound (its max and min split a tie), 0 outside. torch.clamp passes 1
    on a bound, F.grid_sample's border clamp 0; the port keeps the JAX
    package's, its parity reference, as kernel C's clip does."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def bilinear_sample_pixels(img, x, y, padding_mode: str = "border"):
    """Sample img (B, H, W, C) at pixel coords x, y (B, Ho, Wo).

    "border" clamps the coordinates (grid_sample border semantics, with
    jnp.clip's derivative: `_ClipJax`); "zeros" gives out-of-range
    neighbours zero weight. Returns (B, Ho, Wo, C).
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    Bn, H, W, C = img.shape
    if padding_mode == "border":
        x = _ClipJax.apply(x, 0.0, float(W - 1))
        y = _ClipJax.apply(y, 0.0, float(H - 1))
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


def grid_sample(img, grid):
    """torch.nn.functional.grid_sample (bilinear, border padding,
    align_corners=True) for NHWC img (B, H, W, C) at grid (B, Ho, Wo, 2)
    of normalised (x, y) in [-1, 1]; returns (B, Ho, Wo, C)."""
    H, W = img.shape[1:3]
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    return bilinear_sample_pixels(img, x, y, padding_mode="border")


def _row_taps(x, W: int):
    """Left tap index i = clip(floor(xc), 0, W-2) and weight frac = xc - i
    of the border-clamped column xc = clip(x, 0, W-1)."""
    xc = x.clamp(0.0, W - 1)
    i = torch.floor(xc).clamp(0.0, W - 2)
    return i.to(torch.int64), xc - i


def _gather_cols(img, idx):
    """img (B, H, W, C), idx (B, H, Xo) -> img[b, h, idx, :]."""
    return torch.gather(img, 2, idx[..., None].expand(-1, -1, -1,
                                                      img.shape[-1]))


class _SampleRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, x):
        W = img.shape[2]
        idx, frac = _row_taps(x, W)
        ctx.save_for_backward(img, x, idx, frac)
        a0, a1 = _gather_cols(img, idx), _gather_cols(img, idx + 1)
        f = frac[..., None]
        return a0 * (1.0 - f) + a1 * f

    @staticmethod
    def backward(ctx, g):
        img, x, idx, frac = ctx.saved_tensors
        W = img.shape[2]
        d_img = d_x = None
        if ctx.needs_input_grad[0]:
            f = frac[..., None]
            e = idx[..., None].expand_as(g)
            d_img = torch.zeros_like(img)
            d_img.scatter_add_(2, e, g * (1.0 - f))
            d_img.scatter_add_(2, e + 1, g * f)
        if ctx.needs_input_grad[1]:
            # the right-derivative at integer columns; no gradient where
            # the column was clamped to the border (the clip's transpose)
            a0, a1 = _gather_cols(img, idx), _gather_cols(img, idx + 1)
            d_x = ((a1 - a0) * g).sum(dim=-1)
            d_x = torch.where((x >= 0) & (x <= W - 1), d_x, 0.0)
        return d_img, d_x


def bilinear_sample_rows(img, x):
    """out[b, h, xo] interpolates img[b, h] (B, H, W, C) at column
    x[b, h, xo] (B, H, Xo), border clamp; needs W >= 2."""
    return _SampleRows.apply(img, x)
