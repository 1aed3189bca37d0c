"""Velodyne LiDAR -> sparse depth maps (KITTI raw-data calibration).

Host-side numpy preprocessing, a copy of
`depthmodelhardening_tpu/data/velodyne.py` (the same arrays bit for bit,
held by tests/test_torch_data.py). Reference:
DepthNetworks/monodepth2/kitti_utils.py:11-98 (load_velodyne_points,
read_calib_file, sub2ind, generate_depth_map) and
preprocessing/generate_disp.py:10-26 (LiDAR -> disparity with baseline
0.54).
"""

from __future__ import annotations

import os

import numpy as np


def load_velodyne_points(filename: str) -> np.ndarray:
    """(N, 4) float32 [forward, left, up, reflectance]; the last column
    is set to 1 for homogeneous use (kitti_utils.py:11-18)."""
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def read_raw_calib_file(path: str) -> dict:
    """KITTI raw calib text file -> {key: np.array} (kitti_utils.py:21-35
    semantics: values parsed as float arrays where possible)."""
    data = {}
    with open(path, "r") as f:
        for line in f.readlines():
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array(
                    [float(x) for x in value.split()])
            except ValueError:
                data[key.strip()] = value.strip()
    return data


def velo_to_image_projection(cam2cam: dict, velo2cam: dict,
                             cam: int = 2) -> np.ndarray:
    """(3, 4) velodyne -> image-plane projection P_rect @ R_rect @ Tr."""
    Tr = np.hstack((velo2cam["R"].reshape(3, 3),
                    velo2cam["T"][..., np.newaxis]))
    Tr = np.vstack((Tr, np.array([0, 0, 0, 1.0])))
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    return P_rect @ R_rect @ Tr


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse depth map from a velodyne scan (kitti_utils.py:46-98).

    Keeps the reference's KITTI-matlab convention: pixel coords rounded
    then shifted by -1, duplicates resolved to the minimum depth.
    """
    cam2cam = read_raw_calib_file(
        os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_raw_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)
    P = velo_to_image_projection(cam2cam, velo2cam, cam)

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0, :]

    pts = (P @ velo.T).T
    pts[:, :2] = pts[:, :2] / pts[:, 2][..., np.newaxis]
    if vel_depth:
        pts[:, 2] = velo[:, 0]

    x = np.round(pts[:, 0]) - 1
    y = np.round(pts[:, 1]) - 1
    valid = (x >= 0) & (y >= 0) & (x < im_shape[1]) & (y < im_shape[0])
    pts, x, y = pts[valid], x[valid].astype(np.int64), \
        y[valid].astype(np.int64)

    depth = np.zeros(tuple(im_shape[:2]), dtype=np.float64)
    # vectorized duplicate resolution: sort by depth descending so the
    # *minimum* depth lands last per pixel (same result as the
    # reference's per-duplicate min loop, kitti_utils.py:90-96)
    order = np.argsort(-pts[:, 2])
    depth[y[order], x[order]] = pts[order, 2]
    depth[depth < 0] = 0
    return depth


def lin_interp(sparse_depth: np.ndarray) -> np.ndarray:
    """Densify a sparse depth map by Delaunay linear interpolation
    (dataLoader.py:92-104)."""
    from scipy import interpolate

    m, n = sparse_depth.shape
    x, y = np.where(sparse_depth > 0)
    if len(x) < 4:
        return np.zeros_like(sparse_depth)
    d = sparse_depth[x, y]
    f = interpolate.LinearNDInterpolator(
        np.stack([x, y], axis=1), d, fill_value=0)
    J, I = np.meshgrid(np.arange(n), np.arange(m))
    IJ = np.vstack([I.flatten(), J.flatten()]).T
    return f(IJ).reshape(sparse_depth.shape)


def depth_to_disparity(depth: np.ndarray, focal: float,
                       baseline: float = 0.54) -> np.ndarray:
    """Depth map -> stereo disparity (preprocessing/generate_disp.py:10-26)."""
    disp = np.zeros_like(depth)
    valid = depth > 0
    disp[valid] = focal * baseline / depth[valid]
    return disp
