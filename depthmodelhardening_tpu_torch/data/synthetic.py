"""Deterministic synthetic fixtures: car-like object textures + KITTI-like
scenes (numpy; a copy of `depthmodelhardening_tpu/data/synthetic.py`,
held array-equal to it by tests/test_torch_package.py).

The reference pipeline depends on external assets (car crops resized to
width 300) and the KITTI-object dataset, which are not redistributable;
these generators produce shape-compatible deterministic stand-ins.
"""

from __future__ import annotations

import numpy as np

OBJ_W = 300  # image_preprocess.py:11 (car_img_width)
OBJ_H = 200  # typical aspect of the reference car crops


def make_car_object(width: int = OBJ_W, height: int = OBJ_H, seed: int = 0):
    """Returns (obj_rgb (1,H,W,3) float32 in [0,1], mask (1,H,W,1) binary).

    A car-like silhouette: rounded body + cabin + wheels, with a smooth
    deterministic texture. The mask is binary like the reference's
    thresholded *_CarMask (image_preprocess.py:42-46).
    """
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    xn = xs / width
    yn = ys / height

    body = (yn > 0.35) & (yn < 0.85) & (xn > 0.05) & (xn < 0.95)
    cabin = (yn > 0.12) & (yn <= 0.35) & (xn > 0.25) & (xn < 0.72)
    wheel1 = ((xn - 0.22) ** 2 + ((yn - 0.85) * height / width) ** 2) < 0.006
    wheel2 = ((xn - 0.78) ** 2 + ((yn - 0.85) * height / width) ** 2) < 0.006
    mask = (body | cabin | wheel1 | wheel2).astype(np.float32)

    base = np.stack([
        0.55 + 0.25 * np.sin(6.283 * (xn + yn)),
        0.35 + 0.25 * np.sin(6.283 * (2 * xn - yn) + 1.3),
        0.45 + 0.25 * np.sin(6.283 * (xn - 2 * yn) + 2.1),
    ], axis=-1)
    noise = rng.rand(height, width, 3).astype(np.float32) * 0.05
    rgb = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    rgb = rgb * mask[..., None]

    return rgb[None], mask[None, ..., None]


def make_scene(batch: int = 1, height: int = 375, width: int = 1242,
               seed: int = 0):
    """KITTI-like road scenes (B,H,W,3) float32 in [0,1]: sky gradient,
    road wedge, deterministic texture."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    yn = ys / height
    xn = xs / width

    sky = np.stack([0.55 + 0.2 * (1 - yn), 0.65 + 0.2 * (1 - yn),
                    0.8 + 0.15 * (1 - yn)], axis=-1)
    road_mask = (yn > 0.55) & (np.abs(xn - 0.5) < 0.05 + 0.8 * (yn - 0.55))
    road = np.stack([0.35 + 0.1 * yn] * 3, axis=-1)
    scene = np.where(road_mask[..., None], road, sky)

    out = np.empty((batch, height, width, 3), np.float32)
    for b in range(batch):
        texture = rng.rand(height // 8 + 1, width // 8 + 1, 3)
        texture = np.kron(texture, np.ones((8, 8, 1)))[:height, :width]
        out[b] = np.clip(scene * (0.85 + 0.3 * texture), 0.0, 1.0)
    return out


def make_stereo_pair(batch: int = 1, height: int = 375, width: int = 1242,
                     shift: int = 18, seed: int = 0):
    """(left, right) scenes where right is a horizontal shift of left —
    a crude but consistent stereo geometry for smoke tests."""
    left = make_scene(batch, height, width, seed)
    right = np.roll(left, -shift, axis=2)
    return left, right
