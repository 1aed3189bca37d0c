"""Depth-error metrics.

Counterpart of `depthmodelhardening_tpu/ops/metrics.py:26-139`:

  * compute_depth_errors - the 7-tuple of the training monitor and the
    clean eval (DepthNetworks/monodepth2/layers.py:256-274);
  * compute_errors_masked - the 8-tuple (abs_err first) of the attack
    evaluator, mask-weighted (evaluate_depth.py:57-99);
  * get_mean_depth_diff - the mean depth difference (my_utils.py:31-41);
  * compute_depth_losses - the in-training depth monitor
    (trainer.py:676-704), with `masked_median`.
"""

from __future__ import annotations

import torch

from .geometry import disp_to_depth
from .resize import bilinear_resize

STEREO_SCALE_FACTOR = 5.4
MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0


def compute_depth_errors(gt, pred):
    """7-tuple (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) of 0-dim
    tensors; gt, pred: flat (already masked) positive depths."""
    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = torch.mean((thresh < 1.25).to(gt.dtype))
    a2 = torch.mean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = torch.mean((thresh < 1.25 ** 3).to(gt.dtype))
    rmse = torch.sqrt(torch.mean((gt - pred) ** 2))
    rmse_log = torch.sqrt(torch.mean((torch.log(gt) - torch.log(pred)) ** 2))
    abs_rel = torch.mean(torch.abs(gt - pred) / gt)
    sq_rel = torch.mean((gt - pred) ** 2 / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


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


DEPTH_METRIC_NAMES = ("de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms",
                      "da/a1", "da/a2", "da/a3")


def masked_median(x, mask):
    """The median of x where mask > 0, as jnp.nanmedian gives it (the
    mean of the two middle values of an even count; torch.median takes
    the lower one)."""
    v, _ = torch.sort(x[mask > 0])
    n = v.numel()
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def compute_depth_losses(depth_pred, depth_gt, ori_h: int = 375,
                         ori_w: int = 1242):
    """The in-training depth monitor (trainer.py:676-704): the predicted
    depth resized to native resolution and clamped to [1e-3, 80], masked
    to the ground truth's returns inside the hard crop (rows 153:371,
    cols 44:1197), median-scaled, clamped again; the 7 metrics as
    mask-weighted means. depth_pred (B, h, w, 1); depth_gt (B, ori_h,
    ori_w, 1), 0 where there is no return. Returns {DEPTH_METRIC_NAMES:
    0-dim tensor}."""
    pred = torch.clamp(bilinear_resize(depth_pred, ori_h, ori_w), 1e-3,
                       80.0)
    crop = torch.zeros((ori_h, ori_w), dtype=pred.dtype, device=pred.device)
    crop[153:371, 44:1197] = 1.0
    mask = (depth_gt > 0).to(pred.dtype) * crop[None, :, :, None]
    ratio = masked_median(depth_gt, mask) / masked_median(pred, mask)
    pred = torch.clamp(pred * ratio, 1e-3, 80.0)
    gt_s = torch.where(mask > 0, depth_gt, 1.0)
    pr_s = torch.where(mask > 0, pred, 1.0)
    errs = compute_errors_masked(gt_s, pr_s, mask)[1:]
    return dict(zip(DEPTH_METRIC_NAMES, errs))
