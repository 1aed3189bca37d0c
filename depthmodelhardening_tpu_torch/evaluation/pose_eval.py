"""KITTI odometry pose evaluation (trajectory ATE).

Counterpart of `depthmodelhardening_tpu/evaluation/pose_eval.py`
(reference DepthNetworks/monodepth2/evaluate_pose.py:18-130): the
two-frame pose networks predict each frame-to-frame transform of a
sequence, the transforms accumulate into 5-frame local trajectories, each
is scale-aligned to its ground-truth segment, and the absolute
trajectory error is averaged. The trajectory arithmetic is the JAX
package's numpy, copied; `predict_pair_poses` runs the port's pose
networks in eval mode on the card (or on the device asked for).
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import transformation_from_parameters

TRACK_LENGTH = 5  # evaluate_pose.py:117


def dump_xyz(source_to_target_transformations) -> List[np.ndarray]:
    """Accumulate local transforms into camera positions
    (evaluate_pose.py:18-26)."""
    xyzs = [np.array([0.0, 0.0, 0.0])]
    cam_to_world = np.eye(4)
    for T in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, T)
        xyzs.append(cam_to_world[:3, 3])
    return xyzs


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz_o: np.ndarray) -> float:
    """Scale-aligned absolute trajectory RMSE (evaluate_pose.py:29-46)."""
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz ** 2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    return float(np.sqrt(np.sum(alignment_error ** 2)) /
                 gtruth_xyz.shape[0])


@torch.no_grad()
def predict_pair_poses(pose_encoder, pose_decoder,
                       frame_pairs: Sequence, device=None) -> np.ndarray:
    """(N, 4, 4) predicted frame-to-frame transforms for a sequence of
    stacked [frame_t, frame_t+1] inputs, each (B, H, W, 6) in [0, 1]
    (evaluate_pose.py:88-101): the pose networks in eval mode on `device`
    (default the current CUDA card; networks that lie elsewhere run as
    copies moved there, and each network's mode is restored after)."""
    dev = resolve_device(device)
    nets = [m if next(m.parameters()).device == dev
            else copy.deepcopy(m).to(dev)
            for m in (pose_encoder, pose_decoder)]
    modes = [m.training for m in nets]
    out = []
    try:
        for m in nets:
            m.eval()
        for pair in frame_pairs:
            x = torch.as_tensor(pair, dtype=torch.float32, device=dev)
            feats = nets[0](x.permute(0, 3, 1, 2))
            axisangle, translation = nets[1]([feats])
            T = transformation_from_parameters(axisangle[:, 0],
                                               translation[:, 0])
            out.append(T.cpu().numpy())
    finally:
        for m, mode in zip(nets, modes):
            m.train(mode)
    return np.concatenate(out)


def local_gt_poses(gt_global_poses: np.ndarray) -> np.ndarray:
    """KITTI poses/<seq>.txt (N, 3, 4) -> (N-1, 4, 4) local transforms
    (evaluate_pose.py:104-112)."""
    g = np.concatenate(
        (gt_global_poses, np.zeros((gt_global_poses.shape[0], 1, 4))), 1)
    g[:, 3, 3] = 1
    locals_ = []
    for i in range(1, len(g)):
        locals_.append(np.linalg.inv(
            np.dot(np.linalg.inv(g[i - 1]), g[i])))
    return np.stack(locals_)


def trajectory_ates(pred_poses: np.ndarray, gt_global_poses: np.ndarray,
                    track_length: int = TRACK_LENGTH
                    ) -> Tuple[float, float, List[float]]:
    """Mean and std ATE over all track_length-frame windows, and each
    window's (evaluate_pose.py:114-123)."""
    gt_locals = local_gt_poses(gt_global_poses)
    num_frames = gt_global_poses.shape[0]
    ates = []
    for i in range(0, num_frames - 1):
        local_xyzs = np.array(dump_xyz(pred_poses[i:i + track_length - 1]))
        gt_xyzs = np.array(dump_xyz(gt_locals[i:i + track_length - 1]))
        ates.append(compute_ate(gt_xyzs, local_xyzs))
    return float(np.mean(ates)), float(np.std(ates)), ates
