"""Expectation-over-Transformation (EoT) compositor of the object attacks.

Counterpart of `depthmodelhardening_tpu/physics/eot.py` (reference
physicalTrans.py:11-196). A textured vehicle quad (1.82 m x 1.6 m,
camera 1.65 m up) is placed at distance z0 and yaw alpha, its corners
are projected through the KITTI P2 and truncated to integers, and the
texture + mask are inverse-warped by the closed-form homography that
maps the projected quad back to the object's resting box.

Batched over EoT samples (the JAX package vmaps per sample). The small
per-sample geometry (corners, homographies, separable row maps) is
computed in float32 on the CPU, next to the draws that feed it, and
only its per-column results go to the image's device; the warps run on
the image's device.

Two warps:
  * `warp_obj_mask`: the exact warp at native scene resolution
    (bilinear, zero fill), used by the eval finals and `exact_composite`.
  * `tiles_separable`: the attack loop's warp straight to model
    resolution inside a tile around the quad. The quad has exactly
    vertical edges, so the homography's b and h are 0 and the 2-D
    bilinear warp factors into a horizontal pass (one batched matrix
    product) and a per-column vertical pass (`ops/warp.py`, the
    hand-written kernel on the card), whose backward is the exact
    texture adjoint.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sampling import bilinear_sample_pixels
from ..ops.warp import vertical_resample

ORI_H = 375
ORI_W = 1242

# Vehicle quad geometry, physicalTrans.py:35-48 (BMW defaults).
VEH_W = 1.82
VEH_H = 1.6
CAM_H = 1.65

# Object catalogue (physicalTrans.py:35-40): name -> (height_m, width_m).
VEHICLE_SIZES = {
    "BMW": (1.6, 1.82),
    "Sedan": (1.43, 1.78),
    "Subaru": (1.49, 1.83),
    "Truck": (3.0, 2.5),
    "SUV": (1.77, 2.00),
    "TrafficBarrier": (0.75, 1.5),
}

# Default sampling ranges (my_utils.py:14, physicalTrans.py:13).
TRAIN_DIST_RANGE = np.arange(5, 10, 0.2, dtype=np.float32)
EVAL_DIST_RANGE = np.arange(5, 31, 2, dtype=np.float32)
ANGLE_RANGE = np.arange(-30, 31, 5, dtype=np.float32)

_F32 = torch.float32


def quad_corners_world(z0, alpha_deg, veh_w: float = VEH_W,
                       veh_h: float = VEH_H, cam_h: float = CAM_H):
    """(B,) distances and yaws -> (B, 4, 3) rect-camera corners in the
    order [tl, tr, br, bl] (physicalTrans.py:83-105)."""
    alpha = torch.deg2rad(alpha_deg)
    x_off = torch.cos(alpha) * veh_w / 2.0
    z_off = torch.sin(alpha) * veh_w / 2.0
    x1, x2 = -x_off, x_off
    zl, zr = z0 - z_off, z0 + z_off
    y0 = cam_h - veh_h / 2.0
    y1 = torch.full_like(z0, y0 - veh_h / 2.0)
    y2 = torch.full_like(z0, y0 + veh_h / 2.0)
    return torch.stack([
        torch.stack([x1, y1, zl], -1),
        torch.stack([x2, y1, zr], -1),
        torch.stack([x2, y2, zr], -1),
        torch.stack([x1, y2, zl], -1),
    ], 1)


def project_corners(world, P, eps: float = 1e-7):
    """(B, 4, 3) corners -> (B, 4, 2) pixel coords truncated toward zero
    (the reference's astype(np.int32), physicalTrans.py:75/186).

    The 4-term dot products are summed pairwise, (x p0 + y p1) +
    (z p2 + p3): that is the float32 rounding of the JAX package's
    projection on CPU, so a corner that lands within an ulp of an
    integer truncates the same way (a library matmul's order moves
    the tile offsets by a pixel there)."""
    t = world[..., None, :] * P[:, :3]  # (B, 4, 3 rows of P, xyz)
    cam = (t[..., 0] + t[..., 1]) + (t[..., 2] + P[:, 3])
    pix = cam[..., :2] / (cam[..., 2:3] + eps)
    return torch.trunc(pix)


def _unit_square_to_quad(q):
    """(B, 4, 2) quads [tl, tr, br, bl] -> (B, 3, 3) homographies that
    map the unit square's corners onto them (Heckbert's closed form)."""
    x0, y0 = q[:, 0, 0], q[:, 0, 1]
    x1, y1 = q[:, 1, 0], q[:, 1, 1]
    x2, y2 = q[:, 2, 0], q[:, 2, 1]
    x3, y3 = q[:, 3, 0], q[:, 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    affine = (sx.abs() < 1e-9) & (sy.abs() < 1e-9)
    g = torch.where(affine, torch.zeros_like(g), g)
    h = torch.where(affine, torch.zeros_like(h), h)
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    return torch.stack([torch.stack([a, b, x0], -1),
                        torch.stack([d, e, y0], -1),
                        torch.stack([g, h, torch.ones_like(g)], -1)], 1)


def _adjugate3(M):
    """(B, 3, 3) adjugates (inverses up to scale)."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], 1)


def _matmul3(X, Y):
    """(B, 3, 3) float32 X @ Y, accumulated as the JAX package's CPU dot
    does: the first product, then two fused multiply-adds (each product
    is exact in float64, each step rounds once to float32)."""
    acc = X[:, :, 0, None] * Y[:, None, 0, :]
    for k in (1, 2):
        acc = (acc.double() + X[:, :, k, None].double()
               * Y[:, None, k, :].double()).float()
    return acc


def solve_homography(endpoints, startpoints):
    """(B, 8) coefficients of the maps sending endpoint pixels to
    startpoint pixels (torchvision perspective()'s system, solved in
    closed form through the unit square). endpoints (B, 4, 2);
    startpoints (4, 2) or (B, 4, 2)."""
    e = endpoints.to(_F32)
    s = startpoints.to(_F32).expand_as(e)
    H = _matmul3(_unit_square_to_quad(s), _adjugate3(_unit_square_to_quad(e)))
    H = H / H[:, 2:3, 2:3]
    return H.reshape(-1, 9)[:, :8]


def perspective_src_coords(coeffs, out_h: int, out_w: int):
    """Source pixel coords (sx, sy), each (B, out_h, out_w), of every
    output pixel, torchvision's convention (the map is applied to pixel
    centres, sampling at H(x + 0.5, y + 0.5) - 0.5)."""
    dev = coeffs.device
    a, b, c, d, e, f, g, h = (coeffs[:, i, None, None] for i in range(8))
    x = (torch.arange(out_w, dtype=_F32, device=dev) + 0.5)[None, None, :]
    y = (torch.arange(out_h, dtype=_F32, device=dev) + 0.5)[None, :, None]
    denom = g * x + h * y + 1.0
    sx = (a * x + b * y + c) / denom - 0.5
    sy = (d * x + e * y + f) / denom - 0.5
    shape = (coeffs.shape[0], out_h, out_w)
    return sx.expand(shape), sy.expand(shape)


def _cpu_f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32).cpu().reshape(-1)


@dataclasses.dataclass(frozen=True)
class EoTConfig:
    """Static EoT configuration."""

    obj_h: int
    obj_w: int
    scene_h: int = ORI_H
    scene_w: int = ORI_W
    veh_w: float = VEH_W
    veh_h: float = VEH_H
    cam_h: float = CAM_H
    # (3, 4) projection: K[:3, :] or the calib P2 (default)
    projection: Optional[np.ndarray] = None
    proj_eps: float = 1e-7

    def resolved_projection(self) -> np.ndarray:
        if self.projection is not None:
            return np.asarray(self.projection, np.float32).reshape(3, 4)
        from .calibration import Calibration

        return Calibration.default().P.astype(np.float32)


class EoTCompositor:
    """Batched EoT projector/compositor (PhysicalTrans,
    physicalTrans.py:11-196). The object's resting box ("startpoints")
    is the centred zero-padding the reference applies
    (physicalTrans.py:107-123)."""

    def __init__(self, cfg: EoTConfig):
        self.cfg = cfg
        l_pad = (cfg.scene_w - cfg.obj_w) // 2
        t_pad = (cfg.scene_h - cfg.obj_h) // 2
        self.startpoints = torch.tensor([
            [l_pad, t_pad],
            [l_pad + cfg.obj_w, t_pad],
            [l_pad + cfg.obj_w, t_pad + cfg.obj_h],
            [l_pad, t_pad + cfg.obj_h],
        ], dtype=_F32)
        self.l_pad = float(l_pad)
        self.t_pad = float(t_pad)
        self.P = torch.from_numpy(cfg.resolved_projection())

    # -- geometry (CPU, float32) ------------------------------------------------
    def corners(self, z0s, alphas):
        """(B, 4, 2) integer-truncated projected corners."""
        world = quad_corners_world(_cpu_f32(z0s), _cpu_f32(alphas),
                                   self.cfg.veh_w, self.cfg.veh_h,
                                   self.cfg.cam_h)
        return project_corners(world, self.P, self.cfg.proj_eps)

    def _separable_geometry(self, z0s, alphas, model_h: int, model_w: int,
                            tile_h: int, tile_w: int):
        """Per-sample separable warp parameters at model resolution:
        (sx (B, TW), A (B, TW), B (B, TW), y0 (B,), x0 (B,)).

        With b = h = 0 the source coords factor per tile column x:
          sx(x) = (a X + c) / (g X + 1),  sy(x, y) = A(x) y + B(x),
          A = e / (g X + 1), X the global output column.
        (y0, x0) is the tile's integer-valued offset in the model frame.
        """
        sx_f = model_w / self.cfg.scene_w
        sy_f = model_h / self.cfg.scene_h
        ep = self.corners(z0s, alphas)
        # the torch half-pixel resize folded into the endpoints
        ep_m = torch.stack([(ep[..., 0] + 0.5) * sx_f - 0.5,
                            (ep[..., 1] + 0.5) * sy_f - 0.5], -1)
        coeffs = solve_homography(ep_m, self.startpoints)
        a, c, d, e, f, g = (coeffs[:, i, None] for i in (0, 2, 3, 4, 5, 6))
        y0 = torch.clamp(torch.floor(ep_m[..., 1].amin(1)) - 1.0,
                         0.0, float(model_h - tile_h))
        x0 = torch.clamp(torch.floor(ep_m[..., 0].amin(1)) - 1.0,
                         0.0, float(model_w - tile_w))
        X = torch.arange(tile_w, dtype=_F32)[None, :] + 0.5 + x0[:, None]
        den = g * X + 1.0
        sx = (a * X + c) / den - 0.5 - self.l_pad
        A = e / den
        B = (d * X + e * (0.5 + y0[:, None]) + f) / den - 0.5 - self.t_pad
        return sx, A, B, y0, x0

    # -- warps ----------------------------------------------------------------
    def warp_obj_mask(self, obj, mask, z0s, alphas):
        """Exact warp at scene resolution. obj (1|B, oh, ow, C), mask
        (1|B, oh, ow, 1) -> (obj_scene (B, H, W, C), mask_scene
        (B, H, W, 1))."""
        z0s = _cpu_f32(z0s)
        Bn, C = z0s.shape[0], obj.shape[-1]
        stacked = torch.cat([obj.expand((Bn,) + obj.shape[1:]),
                             mask.expand((Bn,) + mask.shape[1:])], -1)
        coeffs = solve_homography(self.corners(z0s, alphas),
                                  self.startpoints).to(obj.device)
        sx, sy = perspective_src_coords(coeffs, self.cfg.scene_h,
                                        self.cfg.scene_w)
        # the unpadded object sampled with zero fill == the padded one
        warped = bilinear_sample_pixels(stacked, sx - self.l_pad,
                                        sy - self.t_pad, padding_mode="zeros")
        return warped[..., :C], warped[..., C:]

    @staticmethod
    def composite(scenes, obj_scene, mask_scene):
        """scene * (1 - m) + obj * m (phy_obj_atk.py:88)."""
        return scenes * (1.0 - mask_scene) + obj_scene * mask_scene

    def project_and_composite(self, scenes, obj, mask, z0s, alphas):
        """Exact EoT step -> (composite (B, H, W, C), mask (B, H, W, 1))."""
        obj_s, mask_s = self.warp_obj_mask(obj, mask, z0s, alphas)
        return self.composite(scenes, obj_s, mask_s), mask_s

    def tiles_separable(self, textures: Sequence[torch.Tensor], mask,
                        z0s, alphas, model_h: int, model_w: int,
                        tile_h: int, tile_w: int):
        """Warp textures + mask (channel-stacked, mask last) into
        (B, tile_h, tile_w, sum(C) + 1) tiles; returns (tiles, y0s, x0s)
        with integer tile offsets (lists of ints) in the model frame."""
        oh, ow = self.cfg.obj_h, self.cfg.obj_w
        dev = textures[0].device
        sx, A, B, y0, x0 = self._separable_geometry(
            z0s, alphas, model_h, model_w, tile_h, tile_w)
        sx, A, B = sx.to(dev), A.to(dev), B.to(dev)

        # pass 1 (horizontal): wx[b, j, x] = tri(sx[b, x] - j); the zero
        # fill outside the object box falls out of the triangular support
        j = torch.arange(ow, dtype=_F32, device=dev)[None, :, None]
        Wx = torch.relu(1.0 - (sx[:, None, :] - j).abs())
        lead = max(t.shape[0] for t in textures)
        stacked = torch.cat(
            [t.expand((lead,) + t.shape[1:]) for t in textures]
            + [mask.expand(lead, oh, ow, 1)], -1)
        if lead == 1:
            inter = torch.einsum("kjc,bjx->bckx", stacked[0], Wx)
        else:
            inter = torch.einsum("bkjc,bjx->bckx", stacked, Wx)
        # pass 2 (vertical): the hand-written kernel on the card
        tiles = vertical_resample(inter, A, B, tile_h)
        y0s = [int(v) for v in y0.tolist()]
        x0s = [int(v) for v in x0.tolist()]
        return tiles.permute(0, 2, 3, 1), y0s, x0s

    def _tiled_separable(self, scenes_model, textures, mask, z0s, alphas,
                         model_h: int, model_w: int, tile_h: int,
                         tile_w: int) -> Tuple[List[torch.Tensor],
                                               torch.Tensor]:
        """tiles_separable + per-sample paste into the model-resolution
        scenes. Returns ([composite per texture], mask_full)."""
        tiles, y0s, x0s = self.tiles_separable(
            textures, mask, z0s, alphas, model_h, model_w, tile_h, tile_w)
        m_t = tiles[..., -1:]
        comps = [scenes_model.clone() for _ in textures]
        mask_full = scenes_model.new_zeros(scenes_model.shape[:3] + (1,))
        for b, (y0, x0) in enumerate(zip(y0s, x0s)):
            win = (b, slice(y0, y0 + tile_h), slice(x0, x0 + tile_w))
            scene_t = scenes_model[win]
            off = 0
            for comp, t in zip(comps, textures):
                c = t.shape[-1]
                obj_t = tiles[b, ..., off:off + c]
                off += c
                comp[win] = scene_t * (1.0 - m_t[b]) + obj_t * m_t[b]
            mask_full[win] = m_t[b]
        return comps, mask_full

    def composite_tiled_pair(self, scenes_model, obj_a, obj_b, mask, z0s,
                             alphas, model_h: int, model_w: int,
                             tile_h: int = 256, tile_w: int = 256):
        """Two textures against the same scenes, mask and EoT samples in
        one warp -> (comp_a, comp_b, mask)."""
        comps, mask_full = self._tiled_separable(
            scenes_model, (obj_a, obj_b), mask, z0s, alphas, model_h,
            model_w, tile_h, tile_w)
        return comps[0], comps[1], mask_full

    def composite_tiled_model(self, scenes_model, obj, mask, z0s, alphas,
                              model_h: int, model_w: int, tile_h: int = 256,
                              tile_w: int = 256):
        """Warp + composite at model resolution inside a tile around the
        quad, through the exact separable warp; scenes_model
        (B, model_h, model_w, 3) is the resized scene batch. Returns
        (adv_model, mask_model), both full frame."""
        comps, mask_full = self._tiled_separable(
            scenes_model, (obj,), mask, z0s, alphas, model_h, model_w,
            tile_h, tile_w)
        return comps[0], mask_full
