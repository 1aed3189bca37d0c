"""Shared machinery of the physical-object depth attacks.

Counterpart of `depthmodelhardening_tpu/attacks/base.py`
(PhysObjAttackConfig :43-160, PhysObjAttack :163-523); reference
torchattacks/attack.py and phy_obj_atk.py:59-123:

  1. replicate one 1242x375 scene to the attack batch (or take a batch),
  2. optimise the object texture; every step draws a fresh EoT sample,
     composites, resizes to 1024x320 and differentiates the targeted
     zero-disparity MSE inside the object mask,
  3. produce the finals (adv_scenes, ben_scenes, masks) with one more
     EoT draw, sample 0 pinned to (7.0, 0) in eval mode; the benign
     composite reuses the adversarial projection's masks.

The model is a frozen `DepthPredictor` (eval-mode BatchNorm). Random
draws come from an explicit CPU `torch.Generator`, or are handed in by
the caller (see `attacks/pgd_object.py:PGDDraws`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.resize import bilinear_resize
from ..physics.calibration import Calibration
from ..physics.eot import (
    ANGLE_RANGE, EVAL_DIST_RANGE, ORI_H, ORI_W, EoTCompositor, EoTConfig,
)

SCENE_H, SCENE_W = 320, 1024  # model input (phy_obj_atk.py:50)


@dataclasses.dataclass(frozen=True)
class PhysObjAttackConfig:
    """Static attack configuration shared by the family."""

    obj_h: int
    obj_w: int
    dist_range: Tuple[float, ...] = tuple(float(x) for x in EVAL_DIST_RANGE)
    angle_range: Tuple[float, ...] = tuple(float(x) for x in ANGLE_RANGE)
    eval_pin_z0: float = 7.0  # 6.1 for the L0 attack (phy_obj_atk_l0.py:162)
    eval_pin_alpha: float = 0.0
    scene_h: int = SCENE_H
    scene_w: int = SCENE_W
    ori_h: int = ORI_H
    ori_w: int = ORI_W
    veh_h: float = 1.6
    veh_w: float = 1.82
    projection: Optional[np.ndarray] = None  # default: KITTI calib P2
    # False: the inner loop warps straight to model resolution inside a
    # tile around the quad (the exact separable warp); True: the exact
    # warp-at-native-then-resize chain (phy_obj_atk.py:83-90). Finals
    # always use the exact chain.
    exact_composite: bool = False
    tile_h: int = 256
    tile_w: int = 256
    # The cropped objective: the inner loop's model runs on a (crop_h,
    # crop_w) window centred on the object mask, its cost rescaled to the
    # full-frame mean. None (or >= the scene size) keeps the full frame.
    # Finals are never cropped.
    attack_crop_w: Optional[int] = None
    attack_crop_h: Optional[int] = None
    # Not ported yet: any other value than the default raises.
    attack_scale: int = 0
    attack_view_dtype: str = "float32"

    def __post_init__(self):
        later = ("is not ported yet (ROADMAP Queue 1, slice 3b: the "
                 "coarse-scale objective and the bfloat16 model path)")
        if self.attack_scale:
            raise NotImplementedError(
                f"attack_scale > 0: the coarse-scale objective {later}")
        if self.attack_view_dtype != "float32":
            raise NotImplementedError(
                f"attack_view_dtype={self.attack_view_dtype!r} {later}")
        # the JAX package's checks (attacks/base.py:126-141)
        for name, crop, full, tile in (
                ("attack_crop_w", self.attack_crop_w, self.scene_w,
                 self.tile_w),
                ("attack_crop_h", self.attack_crop_h, self.scene_h,
                 self.tile_h)):
            if crop is not None and crop < full:
                if crop < min(tile, full):
                    raise ValueError(
                        f"{name}={crop} is smaller than the object tile "
                        f"({tile}); the mask would be truncated")
                if crop % 32:
                    raise ValueError(f"{name}={crop} must be a multiple of "
                                     "32 (the encoder halves it 5 times)")

    def make_eot(self) -> EoTCompositor:
        P = self.projection
        if P is None:
            # dataset calibration without epsilon (kitti_util.py:139-147),
            # scaled for reduced-resolution scenes (a no-op at 1242x375)
            P = Calibration.default().P.astype(np.float32).copy()
            P[0] *= self.ori_w / ORI_W
            P[1] *= self.ori_h / ORI_H
            eps = 0.0
        else:
            eps = 1e-7
        return EoTCompositor(EoTConfig(
            obj_h=self.obj_h, obj_w=self.obj_w, scene_h=self.ori_h,
            scene_w=self.ori_w, veh_h=self.veh_h, veh_w=self.veh_w,
            projection=np.asarray(P, np.float32), proj_eps=eps))


class PhysObjAttack:
    """Base class; subclasses implement `_optimize`.

        atk = SomeAttack(predictor, obj_img, obj_mask, cfg, ...)
        adv, ben, masks, obj_adv = atk(scenes, batch_size, generator,
                                       eval_mode=False)

    predictor(images (B, 320, 1024, 3)) -> disp (B, 320, 1024, 1), frozen
    and in eval mode. obj_img (1, h, w, 3) and obj_mask (1, h, w, 1) are
    moved to the predictor's device; all images are NHWC float32.
    """

    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig):
        self.predictor = predictor
        dev = predictor.device
        self.obj_img = torch.as_tensor(obj_img, dtype=torch.float32,
                                       device=dev)
        self.obj_mask = torch.as_tensor(obj_mask, dtype=torch.float32,
                                        device=dev)
        self.cfg = cfg
        self.eot = cfg.make_eot()

    # -- common pieces --------------------------------------------------------
    @staticmethod
    def _replicate(scenes, batch_size: int):
        if scenes.shape[0] == 1:
            return scenes.expand((batch_size,) + tuple(scenes.shape[1:]))
        if scenes.shape[0] != batch_size:
            raise ValueError("Batch size doesn't match!")
        return scenes

    def _sample_za(self, generator: torch.Generator, batch: int):
        """(z0s, alphas), each (batch,) float32 on the CPU: random.sample
        semantics (phy_obj_atk.py:108-109), without replacement while the
        batch fits the range, with replacement beyond it."""
        out = []
        for values in (self.cfg.dist_range, self.cfg.angle_range):
            vals = torch.tensor(values, dtype=torch.float32)
            n = vals.shape[0]
            if batch > n:
                idx = torch.randint(n, (batch,), generator=generator)
            else:
                idx = torch.randperm(n, generator=generator)[:batch]
            out.append(vals[idx])
        return out[0], out[1]

    def _final_za(self, generator: torch.Generator, batch: int):
        """EoT draw of the final composites (subclasses with bespoke
        final sampling override this)."""
        return self._sample_za(generator, batch)

    def _resize_scenes(self, scenes_full):
        return bilinear_resize(scenes_full, self.cfg.scene_h,
                               self.cfg.scene_w)

    def _model_view(self, scenes_full, obj_adv, z0s, alphas,
                    scenes_model=None):
        """One EoT step -> (adv_scenes, masks) at model resolution.

        Exact path: composite at native resolution, then resize
        (phy_obj_atk.py:83-90). Default: the tiled separable warp
        straight to model resolution; `scenes_model` is the resized
        scene batch, which does not change across steps."""
        cfg = self.cfg
        if cfg.exact_composite:
            adv_full, mask_full = self.eot.project_and_composite(
                scenes_full, obj_adv, self.obj_mask, z0s, alphas)
            return (bilinear_resize(adv_full, cfg.scene_h, cfg.scene_w),
                    bilinear_resize(mask_full, cfg.scene_h, cfg.scene_w))
        if scenes_model is None:
            scenes_model = self._resize_scenes(scenes_full)
        return self.eot.composite_tiled_model(
            scenes_model, obj_adv, self.obj_mask, z0s, alphas,
            model_h=cfg.scene_h, model_w=cfg.scene_w,
            tile_h=min(cfg.tile_h, cfg.scene_h),
            tile_w=min(cfg.tile_w, cfg.scene_w))

    def _objective(self, scenes_full, obj_adv, z0s, alphas,
                   scenes_model=None):
        """The inner-loop cost: EoT view + targeted masked-disparity MSE."""
        adv_scenes, masks = self._model_view(scenes_full, obj_adv, z0s,
                                             alphas, scenes_model)
        return self._targeted_cost(adv_scenes, masks)

    def _targeted_cost(self, adv_scenes, masks):
        """Targeted zero-disparity masked MSE of the disp0 head,
        mean((disp * mask)^2) over full-frame composites
        (phy_obj_atk.py:94). With the cropped objective the composites
        are cut to the window first and the mean is rescaled to the
        full frame's (JAX `attacks/base.py:383-404`)."""
        _, H, W, _ = adv_scenes.shape
        cw, ch = self.cfg.attack_crop_w, self.cfg.attack_crop_h
        cw = cw if cw is not None and cw < W else None
        ch = ch if ch is not None and ch < H else None
        scale = 1.0
        if cw is not None or ch is not None:
            adv_scenes, masks, scale = self._crop_to_object(
                adv_scenes, masks, cw or W, ch or H)
        disp = self.predictor(adv_scenes)
        return torch.mean((disp.float() * masks.float()) ** 2) * scale

    @staticmethod
    def _crop_to_object(adv_scenes, masks, cw: int, ch: int):
        """Cut each sample to (ch, cw) centred on its mask's centre of
        mass (the frame centre for an empty mask), offsets rounded half
        to even and clipped into the frame, as JAX's `_crop_to_object`
        (`attacks/base.py:407-433`); the offsets carry no gradient.
        Returns (adv, masks, ch * cw / (H * W))."""
        B, H, W, _ = adv_scenes.shape
        with torch.no_grad():
            m = masks[..., 0].float()
            total = m.sum(dim=(1, 2))
            denom = total.clamp(min=1e-6)
            xs = torch.arange(W, dtype=torch.float32, device=m.device)
            ys = torch.arange(H, dtype=torch.float32, device=m.device)
            cx = torch.where(total > 0, (m * xs).sum(dim=(1, 2)) / denom,
                             torch.full_like(total, W / 2.0))
            cy = torch.where(total > 0,
                             (m * ys[:, None]).sum(dim=(1, 2)) / denom,
                             torch.full_like(total, H / 2.0))
            x0 = torch.round(cx - cw / 2).to(torch.int64).clamp(0, W - cw)
            y0 = torch.round(cy - ch / 2).to(torch.int64).clamp(0, H - ch)
        offsets = list(zip(y0.tolist(), x0.tolist()))
        crop = lambda t: torch.stack([t[b, oy:oy + ch, ox:ox + cw]
                                      for b, (oy, ox) in enumerate(offsets)])
        return crop(adv_scenes), crop(masks), (ch * cw) / (H * W)

    def objective_and_grad(self, scenes_full, obj, z0s, alphas,
                           scenes_model=None):
        """(cost, d cost / d obj) of one EoT draw."""
        with torch.enable_grad():
            obj = obj.detach().requires_grad_(True)
            cost = self._objective(scenes_full, obj, z0s, alphas,
                                   scenes_model)
            (g,) = torch.autograd.grad(cost, obj)
        return cost.detach(), g

    @torch.no_grad()
    def _final_outputs(self, scenes_full, obj_adv, z0s, alphas,
                       eval_mode: bool):
        """Finals with the pinned eval sample; the benign composite uses
        the adversarial masks (phy_obj_atk.py:114-121). Eval mode and
        `exact_composite` take the exact warp-at-native-then-resize
        chain; training-time finals take the tiled pair warp."""
        cfg = self.cfg
        z0s = torch.as_tensor(z0s, dtype=torch.float32).clone()
        alphas = torch.as_tensor(alphas, dtype=torch.float32).clone()
        if eval_mode:
            z0s[0] = cfg.eval_pin_z0
            alphas[0] = cfg.eval_pin_alpha
        if eval_mode or cfg.exact_composite:
            obj_adv_s, mask_s = self.eot.warp_obj_mask(
                obj_adv, self.obj_mask, z0s, alphas)
            obj_ben_s, _ = self.eot.warp_obj_mask(
                self.obj_img, self.obj_mask, z0s, alphas)
            adv_full = self.eot.composite(scenes_full, obj_adv_s, mask_s)
            ben_full = self.eot.composite(scenes_full, obj_ben_s, mask_s)
            resize = lambda t: bilinear_resize(t, cfg.scene_h, cfg.scene_w)
            return resize(adv_full), resize(ben_full), resize(mask_s)
        return self.eot.composite_tiled_pair(
            self._resize_scenes(scenes_full), obj_adv, self.obj_img,
            self.obj_mask, z0s, alphas, model_h=cfg.scene_h,
            model_w=cfg.scene_w, tile_h=min(cfg.tile_h, cfg.scene_h),
            tile_w=min(cfg.tile_w, cfg.scene_w))

    # -- subclass hooks -----------------------------------------------------------
    def draw(self, generator: torch.Generator, batch: int):
        """Every random draw of one attack call, from `generator`; the
        result has at least `final_z0s` and `final_alphas`."""
        raise NotImplementedError

    def _optimize(self, scenes_full, draws):
        """Returns the optimised adversarial texture (1, h, w, 3)."""
        raise NotImplementedError

    # -- entry --------------------------------------------------------------------
    def __call__(self, scenes, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 eval_mode: bool = False, draws=None):
        """scenes (1 | batch_size, ori_h, ori_w, 3) on the predictor's
        device -> (adv (B, H, W, 3), ben (B, H, W, 3), masks
        (B, H, W, 1), obj_adv (1, h, w, 3)) at model resolution.
        `draws` replaces the draws from `generator` when given."""
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the draws")
            draws = self.draw(generator, batch_size)
        scenes_full = self._replicate(scenes, batch_size)
        obj_adv = self._optimize(scenes_full, draws)
        adv, ben, masks = self._final_outputs(
            scenes_full, obj_adv, draws.final_z0s, draws.final_alphas,
            eval_mode)
        return adv, ben, masks, obj_adv
