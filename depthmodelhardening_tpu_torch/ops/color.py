"""Colour jitter with torchvision's tensor semantics, NHWC in [0, 1].

Counterpart of `depthmodelhardening_tpu/ops/color.py:1-102`. Used by
the L0 attack (a fixed jitter sampled once, torchattacks/attacks/
phy_obj_atk_l0.py:41, 121-124) and the hardening batch's augmentation
(mono_dataset.py:88-98, 344-348). Differentiable; factors are Python
floats or tensors that broadcast against the image (per item: (B, 1, 1,
1), and (B, 1, 1) for the hue, which shifts the (B, H, W) hue plane).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling as prof

_GRAY_W = (0.2989, 0.587, 0.114)  # torchvision rgb_to_grayscale weights


def _blend(img1, img2, ratio):
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def rgb_to_grayscale(img):
    with prof.host_copy(_GRAY_W, "color.gray"):
        w = torch.tensor(_GRAY_W, dtype=img.dtype, device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    mean = torch.mean(rgb_to_grayscale(img), dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_grayscale(img), factor)


def adjust_hue(img, factor):
    """Shift the hue by `factor` turns ([-0.5, 0.5]) through HSV and back,
    as torchvision's tensor implementation does (`%` on floats)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.amax(img, dim=-1)
    minc = torch.amin(img, dim=-1)
    v = maxc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(maxc > 0, maxc, ones)
    cr_div = torch.where(cr > 0, cr, ones)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = torch.where(cr == 0, torch.zeros_like(h), h)

    h = (h + factor) % 1.0

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    i = i.to(torch.int64) % 6

    def sel(*planes):
        stacked = torch.stack(planes, dim=-1)
        return torch.gather(stacked, -1, i[..., None])[..., 0]

    r2 = sel(v, q, p, p, t, v)
    g2 = sel(t, v, v, q, p, p)
    b2 = sel(p, p, t, v, v, q)
    return torch.stack([r2, g2, b2], dim=-1)


_JITTER_FNS = (adjust_brightness, adjust_contrast, adjust_saturation,
               adjust_hue)


def sample_color_jitter(rng: np.random.RandomState,
                        brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                        saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
    """torchvision ColorJitter.get_params: (order, factors) drawn once on
    the host, to be applied as a fixed transform."""
    order = tuple(rng.permutation(4).tolist())
    factors = (
        float(rng.uniform(*brightness)),
        float(rng.uniform(*contrast)),
        float(rng.uniform(*saturation)),
        float(rng.uniform(*hue)),
    )
    return order, factors


def apply_color_jitter(img, order: Sequence[int],
                       factors: Tuple[float, float, float, float]):
    for idx in order:
        img = _JITTER_FNS[idx](img, factors[idx])
    return img
