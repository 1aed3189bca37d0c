"""Camera geometry (counterpart of `depthmodelhardening_tpu/ops/
geometry.py`; reference DepthNetworks/monodepth2/layers.py:16-198).

Depth maps are (B, H, W, 1), camera matrices (B, 4, 4), float32.
"""

from __future__ import annotations

import torch

from ..utils import profiling as prof


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth), layers.py:16-25:
    depth = 1 / (1/max + (1/min - 1/max) * disp)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32):
    """Homogeneous pixel coordinates (3, H*W), rows [x, y, 1]."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=dtype),
                            torch.arange(width, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)


def backproject_depth(depth, inv_K):
    """Depth (B, H, W, 1) -> camera-space points (B, 4, H*W):
    inv_K[:3, :3] @ pix * depth, with a ones row (layers.py:163-168)."""
    B, H, W, _ = depth.shape
    pix = pixel_grid(H, W, depth.device, depth.dtype)
    cam = torch.matmul(inv_K[:, :3, :3], pix) * depth.reshape(B, 1, H * W)
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points, K, T, height: int, width: int, eps: float = 1e-7):
    """Points (B, 4, N) seen by a camera at extrinsics T -> normalised
    sampling grid (B, H, W, 2) as (x, y) in [-1, 1] (align_corners=True;
    layers.py:182-198)."""
    B = points.shape[0]
    P = torch.matmul(K, T)[:, :3, :]
    cam = torch.matmul(P, points)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(B, 2, height, width).permute(0, 2, 3, 1)
    with prof.host_copy(None, "geometry.scale"):
        scale = torch.tensor([width - 1, height - 1], dtype=pix.dtype,
                             device=pix.device)
    return (pix / scale - 0.5) * 2.0


def reproject_coords(depth, inv_K, K, T, eps: float = 1e-7):
    """Backproject depth (B, H, W, 1), move by T and project: the grid
    (B, H, W, 2) for sampling the other view (trainer.py:508-519)."""
    _, H, W, _ = depth.shape
    return project_3d(backproject_depth(depth, inv_K), K, T, H, W, eps)


def rot_from_axisangle(vec):
    """Axis-angle (B, 1, 3) or (B, 3) -> rotations as 4x4 matrices (B, 4,
    4): Rodrigues' formula with the reference's 1e-7 guard on the angle
    (layers.py:64-103)."""
    vec = vec.reshape(vec.shape[0], 3)
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[:, 0], torch.sin(angle)[:, 0]
    C = 1.0 - ca
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zeros,
        xyC + zs, y * yC + ca, yzC - xs, zeros,
        zxC - ys, yzC + xs, z * zC + ca, zeros,
        zeros, zeros, zeros, ones], dim=-1).reshape(-1, 4, 4)


def get_translation_matrix(translation):
    """Translations (B, 3) or (B, 1, 3) -> 4x4 matrices (B, 4, 4)
    (layers.py:48-61)."""
    t = translation.reshape(translation.shape[0], 3)
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return T


def transformation_from_parameters(axisangle, translation,
                                   invert: bool = False):
    """The pose network's (axisangle, translation) -> a 4x4 camera
    transform (B, 4, 4) (layers.py:28-45): M = T @ R, or with `invert`
    R^T @ T(-t)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)
