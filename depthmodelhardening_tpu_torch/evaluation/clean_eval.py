"""Clean KITTI Eigen-split depth evaluation.

Counterpart of `depthmodelhardening_tpu/evaluation/clean_eval.py:1-126`
(reference evaluate_depth.py:245-395 `evaluate()`):

  * the disparity of each test frame at the working resolution,
    optionally averaged with the flipped frame's through the side-masked
    post-process (batch_post_process_disparity, evaluate_depth.py:
    102-110);
  * against the ground-truth depths with the Eigen crop (rows
    0.40810811..0.99189189, cols 0.03594771..0.96405229 of the native
    frame, :363-367);
  * median scaling per frame unless stereo (a fixed x5.4, :340-344),
    clamped to [1e-3, 80];
  * the mean 7-tuple (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3).

The predictor runs on its own device (the card unless the caller built
it on the CPU); the disparity's resize and the metrics run there too,
the crop, the masks and the median scaling on the host in numpy, as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from ..ops.metrics import STEREO_SCALE_FACTOR, compute_depth_errors
from ..ops.resize import bilinear_resize

CLEAN_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log",
                      "a1", "a2", "a3")


@dataclasses.dataclass(frozen=True)
class CleanEvalConfig:
    eval_stereo: bool = True  # a fixed 5.4 scale, else median scaling
    min_depth: float = 1e-3
    max_depth: float = 80.0
    post_process: bool = False  # flip-average (evaluate_depth.py:280-291)
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0


def batch_post_process_disparity(l_disp: np.ndarray,
                                 r_disp: np.ndarray) -> np.ndarray:
    """Flip-averaging with smooth side masks (evaluate_depth.py:102-110,
    from Monodepth v1). l_disp, r_disp: (B, H, W)."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    l_grid, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h),
                            indexing="xy")
    l_mask = (1.0 - np.clip(20 * (l_grid - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + \
        (1.0 - l_mask - r_mask) * m_disp


def eigen_crop_mask(gt_height: int, gt_width: int) -> np.ndarray:
    """The Eigen evaluation crop at native resolution
    (evaluate_depth.py:363-367)."""
    crop = np.array([0.40810811 * gt_height, 0.99189189 * gt_height,
                     0.03594771 * gt_width, 0.96405229 * gt_width]
                    ).astype(np.int32)
    mask = np.zeros((gt_height, gt_width), bool)
    mask[crop[0]:crop[1], crop[2]:crop[3]] = True
    return mask


def disp_to_scaled_depth(disp):
    """The sigmoid disparity (working resolution, [0, 1]) as the scaled
    disparity 1/depth of the eval (evaluate_depth.py:306-311,
    disp_to_depth's with min/max depth 0.1/100)."""
    min_disp, max_disp = 1.0 / 100.0, 1.0 / 0.1
    return min_disp + (max_disp - min_disp) * disp


def evaluate_clean(predictor, frames_and_gts: Iterable[Tuple[np.ndarray,
                                                             np.ndarray]],
                   cfg: CleanEvalConfig = CleanEvalConfig()):
    """frames_and_gts yields (image (H, W, 3) at working resolution,
    gt_depth (gt_h, gt_w) at native resolution), numpy. predictor:
    images (B, H, W, 3) -> disp (B, H, W, 1) on `predictor.device`.

    Returns ({metric: mean}, ratios): ratios are the per-frame median
    scale factors (empty under stereo scaling).
    """
    dev = predictor.device
    predict = lambda imgs: predictor(torch.as_tensor(
        np.ascontiguousarray(imgs), dtype=torch.float32, device=dev))
    errors, ratios = [], []
    for img, gt in frames_and_gts:
        with torch.no_grad():
            disp = predict(img[None])
            if cfg.post_process:
                # the side-masked average in float64 on the host, as the
                # JAX package does, rounded to float32 for the resize
                disp_f = predict(img[None, :, ::-1])
                pp = batch_post_process_disparity(
                    disp.cpu().numpy()[..., 0],
                    disp_f.cpu().numpy()[:, :, ::-1, 0])
                scaled = torch.from_numpy(disp_to_scaled_depth(pp)[
                    ..., None].astype(np.float32)).to(disp.device)
            else:
                scaled = disp_to_scaled_depth(disp)
            gt_h, gt_w = gt.shape
            pred_disp = bilinear_resize(scaled, gt_h, gt_w)[
                0, ..., 0].cpu().numpy()
        pred_depth = 1.0 / pred_disp

        # valid-depth bounds + the Eigen crop (evaluate_depth.py:360-367)
        mask = ((gt > cfg.min_depth) & (gt < cfg.max_depth)
                & eigen_crop_mask(gt_h, gt_w))
        pred = pred_depth[mask]
        gt_m = gt[mask]
        pred *= cfg.pred_depth_scale_factor
        if cfg.eval_stereo:
            pred *= STEREO_SCALE_FACTOR  # evaluate_depth.py:340-344
        elif not cfg.disable_median_scaling:
            ratio = np.median(gt_m) / np.median(pred)
            ratios.append(ratio)
            pred *= ratio
        pred = np.clip(pred, cfg.min_depth, cfg.max_depth)
        errors.append([float(x) for x in compute_depth_errors(
            torch.as_tensor(gt_m, dtype=torch.float32, device=dev),
            torch.as_tensor(pred, dtype=torch.float32, device=dev))])
    mean_errors = np.asarray(errors).mean(axis=0)
    return dict(zip(CLEAN_METRIC_NAMES, mean_errors.tolist())), ratios
