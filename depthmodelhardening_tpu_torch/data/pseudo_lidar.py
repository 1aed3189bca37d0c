"""Pseudo-LiDAR generation + ground-plane fitting.

A numpy copy of `depthmodelhardening_tpu/data/pseudo_lidar.py` (the same
clouds and planes bit for bit, the RANSAC draws from the same numpy
generator and seed; tests/test_torch_data.py). Re-designs of:
  * preprocessing/generate_lidar.py:10-33 — disparity/depth map ->
    3-D point cloud in velodyne coordinates (baseline 0.54, points
    behind the camera and above max_high removed);
  * preprocessing/kitti_process_RANSAC.py:10-52 — road-plane RANSAC fit
    over the near-road slab of the cloud, written as a dependency-free
    numpy RANSAC (sklearn's RANSACRegressor with a LinearRegression
    estimator is a plain least-squares fit over inlier subsets; the
    residual threshold default is the MAD of y, reproduced here).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..physics.calibration import Calibration

BASELINE = 0.54  # generate_lidar.py:12


def project_disp_to_points(calib: Calibration, disp: np.ndarray,
                           max_high: float = 1.0) -> np.ndarray:
    """Disparity map -> (N, 3) velodyne-frame points
    (generate_lidar.py:10-23)."""
    disp = np.array(disp, np.float32)
    disp[disp < 0] = 0
    mask = disp > 0
    depth = calib.f_u * BASELINE / (disp + 1.0 - mask)
    rows, cols = depth.shape
    c, r = np.meshgrid(np.arange(cols), np.arange(rows))
    points = np.stack([c, r, depth]).reshape((3, -1)).T
    points = points[mask.reshape(-1)]
    cloud = calib.image_to_velo(points)
    valid = (cloud[:, 0] >= 0) & (cloud[:, 2] < max_high)
    return cloud[valid]


def project_depth_to_points(calib: Calibration, depth: np.ndarray,
                            max_high: float = 1.0) -> np.ndarray:
    """Depth map -> (N, 3) velodyne points (generate_lidar.py:25-33)."""
    rows, cols = depth.shape
    c, r = np.meshgrid(np.arange(cols), np.arange(rows))
    points = np.stack([c, r, depth]).reshape((3, -1)).T
    cloud = calib.image_to_velo(points)
    valid = (cloud[:, 0] >= 0) & (cloud[:, 2] < max_high)
    return cloud[valid]


def generate_disparity_from_velo(pc_velo: np.ndarray, height: int,
                                 width: int,
                                 calib: Calibration) -> np.ndarray:
    """Velodyne points -> per-pixel disparity map with -1 holes
    (preprocessing/generate_disp.py:10-26: FOV filter at x > 2 m,
    rounded pixel coords, disp = f_u * 0.54 / depth — holes become
    negative disparities exactly as the reference leaves them)."""
    pts_2d = calib.velo_to_image(pc_velo)
    fov = ((pts_2d[:, 0] < width - 1) & (pts_2d[:, 0] >= 0) &
           (pts_2d[:, 1] < height - 1) & (pts_2d[:, 1] >= 0) &
           (pc_velo[:, 0] > 2))
    pts_2d = np.round(pts_2d[fov]).astype(int)
    rect = calib.velo_to_rect(pc_velo[fov])
    depth_map = np.zeros((height, width)) - 1
    depth_map[pts_2d[:, 1], pts_2d[:, 0]] = rect[:, 2]
    return (calib.f_u * BASELINE) / depth_map


def save_pseudo_lidar(cloud: np.ndarray, path: str) -> None:
    """Append unit intensity and write KITTI .bin
    (generate_lidar.py:74-77)."""
    lidar = np.concatenate(
        [cloud, np.ones((cloud.shape[0], 1))], 1).astype(np.float32)
    lidar.tofile(path)


def _ransac_plane(X: np.ndarray, y: np.ndarray, n_trials: int = 100,
                  seed: int = 0) -> Tuple[np.ndarray, float]:
    """RANSACRegressor(LinearRegression) equivalent: fit y = X@coef + b
    from 2-point minimal samples, residual threshold = MAD(y), refit on
    the best consensus set."""
    rs = np.random.RandomState(seed)
    thresh = np.median(np.abs(y - np.median(y)))
    thresh = max(thresh, 1e-6)
    n = X.shape[0]
    best_inliers: Optional[np.ndarray] = None
    Xh = np.concatenate([X, np.ones((n, 1))], axis=1)
    # sklearn min_samples default: n_features + 1 = 3 for the plane fit
    for _ in range(n_trials):
        idx = rs.choice(n, size=min(3, n), replace=False)
        sol, *_ = np.linalg.lstsq(Xh[idx], y[idx], rcond=None)
        resid = np.abs(Xh @ sol - y)
        inliers = resid < thresh
        if best_inliers is None or inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    sol, *_ = np.linalg.lstsq(Xh[best_inliers], y[best_inliers],
                              rcond=None)
    return sol[:2], float(sol[2])


def fit_ground_plane(pc_velo: np.ndarray, calib: Calibration,
                     seed: int = 0) -> Tuple[np.ndarray, float]:
    """Fit the road plane (kitti_process_RANSAC.py:24-45).

    Returns (w (3,) unit normal with w[1] < 0, h intercept). Falls back
    to the flat road at camera height 1.65 when no points survive the
    road slab filter.
    """
    pc_rect = calib.velo_to_rect(pc_velo[:, :3])
    valid = ((pc_rect[:, 1] > 1.5) & (pc_rect[:, 1] < 1.86) &
             (pc_rect[:, 2] > 0) & (pc_rect[:, 2] < 40) &
             (pc_rect[:, 0] > -15) & (pc_rect[:, 0] < 15))
    pc_rect = pc_rect[valid]
    if len(pc_rect) < 3:
        return np.array([0.0, -1.0, 0.0]), 1.65
    coef, intercept = _ransac_plane(pc_rect[:, [0, 2]], pc_rect[:, 1],
                                    seed=seed)
    w = np.array([coef[0], -1.0, coef[1]])
    w = w / np.linalg.norm(w)
    return w, intercept


def write_plane_file(path: str, w: np.ndarray, h: float) -> None:
    """KITTI planes/*.txt format (kitti_process_RANSAC.py:46-52)."""
    lines = ["# Plane", "Width 4", "Height 1",
             "{:e} {:e} {:e} {:e}".format(w[0], w[1], w[2], h)]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def extract_ransac(calib_dir: str, lidar_dir: str,
                   planes_dir: str) -> None:
    """The batch run over a directory (kitti_process_RANSAC.py:10-52)."""
    os.makedirs(planes_dir, exist_ok=True)
    for fn in sorted(os.listdir(lidar_dir)):
        if not fn.endswith(".bin"):
            continue
        idx = fn[:-4]
        calib = Calibration.from_file(
            os.path.join(calib_dir, idx + ".txt"))
        pc = np.fromfile(os.path.join(lidar_dir, fn),
                         dtype=np.float32).reshape(-1, 4)
        w, h = fit_ground_plane(pc, calib)
        write_plane_file(os.path.join(planes_dir, idx + ".txt"), w, h)
