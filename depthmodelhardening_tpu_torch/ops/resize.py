"""Resizes with torch's F.interpolate conventions, NHWC at the interface.

Counterpart of `depthmodelhardening_tpu/ops/resize.py:42,69`. The
reference resizes composited scenes 1242x375 -> 1024x320 with bilinear,
align_corners=False and no antialiasing (docs/FIDELITY.md #7), which is
exactly `F.interpolate`'s bilinear mode; the decoder upsamples with
nearest x2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int):
    """(B, H, W, C) -> (B, out_h, out_w, C), bilinear, half-pixel
    centres, edge-clamped, no antialiasing."""
    if img.shape[1] == out_h and img.shape[2] == out_w:
        return img
    x = img.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def nearest_upsample2(x: torch.Tensor):
    """2x nearest upsample of (B, C, H, W) (layers.py:201-204)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
