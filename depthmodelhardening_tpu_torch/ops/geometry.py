"""Camera geometry (counterpart of `depthmodelhardening_tpu/ops/
geometry.py`; reference DepthNetworks/monodepth2/layers.py:16-198).

Depth maps are (B, H, W, 1), camera matrices (B, 4, 4), float32.
"""

from __future__ import annotations

import torch


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
    scale = torch.tensor([width - 1, height - 1], dtype=pix.dtype,
                         device=pix.device)
    return (pix / scale - 0.5) * 2.0


def reproject_coords(depth, inv_K, K, T, eps: float = 1e-7):
    """Backproject depth (B, H, W, 1), move by T and project: the grid
    (B, H, W, 2) for sampling the other view (trainer.py:508-519)."""
    _, H, W, _ = depth.shape
    return project_3d(backproject_depth(depth, inv_K), K, T, H, W, eps)
