"""Photometric and smoothness loss primitives, NHWC.

Counterpart of `depthmodelhardening_tpu/ops/losses.py:19-43` (reference
monodepth2/trainer.py:525-537 and layers.py:207-220). |.| takes JAX's
derivative, +1 at 0, where torch's is 0: an exact tie (a constant
disparity patch, identical pixels) then gets the reference's gradient.
"""

from __future__ import annotations

import torch

from .reproj import reproj_loss


class _AbsJax(torch.autograd.Function):
    """|x| with the derivative where(x >= 0, 1, -1)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_jax(x):
    return _AbsJax.apply(x)


def reprojection_loss(pred, target, use_ssim: bool = True):
    """Per-pixel reprojection loss map (B, H, W, 1) of (B, H, W, C)
    images: 0.85 SSIM + 0.15 L1 through the fused kernel
    (`ops/reproj.py`), or the channel-mean L1 alone."""
    if not use_ssim:
        return abs_jax(target - pred).mean(dim=-1, keepdim=True)
    loss = reproj_loss(pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2))
    return loss[..., None]


def smooth_loss(disp, img):
    """Edge-aware smoothness of disp (B, H, W, 1) against img
    (B, H, W, C); a scalar."""
    grad_disp_x = abs_jax(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_disp_y = abs_jax(disp[:, :-1, :, :] - disp[:, 1:, :, :])
    grad_img_x = abs_jax(img[:, :, :-1, :] - img[:, :, 1:, :]).mean(
        dim=-1, keepdim=True)
    grad_img_y = abs_jax(img[:, :-1, :, :] - img[:, 1:, :, :]).mean(
        dim=-1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()
