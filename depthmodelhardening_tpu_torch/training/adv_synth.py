"""Training batches built on the device from raw frames.

Counterpart of the non-adversarial part of `depthmodelhardening_tpu/
training/adv_synth.py` (`_flip_where` :60, `build_plain_batch` :196,
`stereo_T_batch` :217): the reference's vanilla Monodepth2 item
pipeline (mono_dataset.py:294-373) with per-item flips. The adversarial
synthesis (`synthesize_adv_batch`) comes with the full hardening step
(ROADMAP Queue 1, slice 5).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.resize import bilinear_resize
from .config import SelfSupConfig


def _flip_where(img, do_flip):
    """Flip the W axis of the items of img (B, H, W, C) where do_flip
    (B,) is set."""
    return torch.where(do_flip[:, None, None, None], img.flip(2), img)


def build_plain_batch(frames: Dict[str, torch.Tensor], side_is_l, do_flip,
                      selfsup_cfg: SelfSupConfig, color_aug: bool = False):
    """Non-adversarial batch from raw frames {fid: (B, ori_h, ori_w, 3)}:
    each flipped per item and resized to the model's resolution, as both
    "color" and "color_aug", plus the per-item "stereo_T"."""
    if color_aug:
        raise NotImplementedError(
            "color_aug=True: colour jitter (ops/color.py) is not ported yet "
            "(ROADMAP Queue 1, slice 4)")
    H, W = selfsup_cfg.height, selfsup_cfg.width
    out = {"color": {}, "color_aug": {}}
    for fid in selfsup_cfg.frame_ids:
        col = bilinear_resize(_flip_where(frames[fid], do_flip), H, W)
        out["color"][fid] = col
        out["color_aug"][fid] = col
    out["stereo_T"] = stereo_T_batch(side_is_l, do_flip)
    return out


def stereo_T_batch(side_is_l, do_flip) -> torch.Tensor:
    """Per-item normalised stereo extrinsic (B, 4, 4) for the photometric
    warp (mono_dataset.py:367-373): x-translation 0.1, its sign flipped
    by the side and by a horizontal flip."""
    side_sign = torch.where(side_is_l, -1.0, 1.0)
    baseline_sign = torch.where(do_flip, -1.0, 1.0)
    T = torch.eye(4, device=side_is_l.device).repeat(side_is_l.shape[0], 1, 1)
    T[:, 0, 3] = side_sign * baseline_sign * 0.1
    return T
