"""Depth-error metrics of the attack evaluator.

Counterpart of `depthmodelhardening_tpu/ops/metrics.py:43,74,139`
(reference: DepthNetworks/monodepth2/evaluate_depth.py:57-99 and
my_utils.py:31-41).
"""

from __future__ import annotations

import torch

from .geometry import disp_to_depth

STEREO_SCALE_FACTOR = 5.4
MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0


def compute_errors_masked(gt, pred, mask=None):
    """8-tuple (abs_err, abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) of
    0-dim tensors. With a mask every statistic is a mask-weighted sum
    over mask.sum() (evaluate_depth.py:77-96)."""
    thresh = torch.maximum(gt / pred, pred / gt)
    if mask is None:
        mask = torch.ones_like(gt)
    total = mask.sum()

    def wmean(v):
        return (v * mask).sum() / total

    a1 = wmean((thresh < 1.25).to(gt.dtype))
    a2 = wmean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = wmean((thresh < 1.25 ** 3).to(gt.dtype))
    abs_err = wmean((gt - pred).abs())
    rmse = torch.sqrt(wmean((gt - pred) ** 2))
    rmse_log = torch.sqrt(wmean((torch.log(gt) - torch.log(pred)) ** 2))
    abs_rel = wmean((gt - pred).abs() / gt)
    sq_rel = wmean((gt - pred) ** 2 / gt)
    return abs_err, abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def get_mean_depth_diff(adv_disp, ben_disp, scene_car_mask=None,
                        use_abs: bool = False):
    """Mean depth difference of two disparity maps (my_utils.py:31-41):
    depth = clamp(disp_to_depth(|disp|, 0.1, 100) * mask * 5.4, max=100),
    sum(d_adv - d_ben) / sum(mask)."""
    if scene_car_mask is None:
        scene_car_mask = torch.ones_like(adv_disp)
    scale = STEREO_SCALE_FACTOR
    dep_adv = torch.clamp(disp_to_depth(adv_disp.abs(), 0.1, 100)[1]
                          * scene_car_mask * scale, max=100.0)
    dep_ben = torch.clamp(disp_to_depth(ben_disp.abs(), 0.1, 100)[1]
                          * scene_car_mask * scale, max=100.0)
    diff = dep_adv - dep_ben
    if use_abs:
        diff = diff.abs()
    return diff.sum() / scene_car_mask.sum()


def scaled_clamped_depth(disp, scale: float = STEREO_SCALE_FACTOR,
                         min_depth: float = MIN_DEPTH,
                         max_depth: float = MAX_DEPTH):
    """Metric depth of the attack evaluator (evaluate_depth.py:193-194):
    clamp(disp_to_depth(|disp|, 0.1, 100).depth * 5.4, 1e-3, 80)."""
    depth = disp_to_depth(disp.abs(), 0.1, 100)[1] * scale
    return torch.clamp(depth, min_depth, max_depth)
