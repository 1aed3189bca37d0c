"""SSIM dissimilarity map (counterpart of `depthmodelhardening_tpu/ops/
ssim.py:29-63`; reference DepthNetworks/monodepth2/layers.py:223-253).

Reflect padding 1, 3x3 mean pools for all five moments, C1 = 0.01^2,
C2 = 0.03^2, output clip((1 - SSIM) / 2, 0, 1). Plain PyTorch; the
window sums add their nine taps row by row, the order the reprojection
kernel (`csrc/reproj_loss.cu`) uses, so the two round alike.
"""

from __future__ import annotations

import torch

from .padding import reflect_pad1

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def sum_taps(p, H: int, W: int):
    """3x3 VALID window sums of a padded (..., H+2, W+2) tensor, taps
    added row by row."""
    acc = p[..., 0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                acc = acc + p[..., dy:dy + H, dx:dx + W]
    return acc


def moments(x, y):
    """The 3x3 means of reflect-padded x, y, x^2, y^2 and xy, for planar
    (B, C, H, W) x and y. The means multiply by 1/9, as PyTorch's CUDA
    division by a scalar does, so CPU, card and kernel round alike."""
    H, W = x.shape[-2:]
    xp, yp = reflect_pad1(x), reflect_pad1(y)
    return [sum_taps(t, H, W) * (1.0 / 9.0)
            for t in (xp, yp, xp * xp, yp * yp, xp * yp)]


def ssim_planar(x, y):
    """clip((1 - SSIM) / 2, 0, 1) of (B, C, H, W) -> (B, C, H, W)."""
    mu_x, mu_y, e_xx, e_yy, e_xy = moments(x, y)
    sigma_x = e_xx - mu_x * mu_x
    sigma_y = e_yy - mu_y * mu_y
    sigma_xy = e_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - num / den) / 2, 0.0, 1.0)


def ssim(x, y):
    """Per-pixel SSIM dissimilarity of (B, H, W, C) images in [0, 1]:
    (B, H, W, C) values in [0, 1]."""
    out = ssim_planar(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1)
