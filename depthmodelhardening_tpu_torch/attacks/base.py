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

Two options of the JAX package's inner loop (`attacks/base.py:98-125`):
the coarse-scale objective (`attack_scale` s = 1 or 2: the targeted MSE
read from the scale-s disparity head through the `predict_scale` hook,
which the trainer supplies, against the mask resized to that head) and
the view dtype (`attack_view_dtype`: the cropped objective's composite
and its model input in bfloat16; warp A stays float32). Finals, the
full-frame objective and `exact_composite` are never affected.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import bilinear_resize
from ..physics.calibration import Calibration
from ..physics.eot import (
    ANGLE_RANGE, EVAL_DIST_RANGE, ORI_H, ORI_W, EoTCompositor, EoTConfig,
)

SCENE_H, SCENE_W = 320, 1024  # model input (phy_obj_atk.py:50)


@dataclasses.dataclass
class FinalDraws:
    """The draws of an attack that optimises nothing (the vanilla and
    physical projections): the finals' (B,) EoT sample, before the eval
    pin."""

    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


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
    # The coarse-scale objective: the first steps - fine_steps PGD steps
    # read the targeted MSE from the ("disp", attack_scale) head, the last
    # min(attack_scale_fine_steps, steps) from disp0. 0: disp0 throughout.
    attack_scale: int = 0
    attack_scale_fine_steps: int = 1
    # dtype of the cropped objective's composite (pass 1, tiles, paste)
    # and so of the model's input; the cost is reduced in float32
    attack_view_dtype: str = "float32"

    def __post_init__(self):
        # the JAX package's checks (attacks/base.py:117-141)
        if self.attack_scale not in (0, 1, 2):
            raise ValueError("attack_scale must be 0, 1 or 2")
        if self.attack_view_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "attack_view_dtype must be 'float32' or 'bfloat16', "
                f"got {self.attack_view_dtype!r}")
        if self.attack_scale_fine_steps < 0:
            raise ValueError("attack_scale_fine_steps must be >= 0")
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
    moved to the predictor's device; all images are NHWC float32. An
    optimised texture is (1, h, w, 3), or (B, h, w, 3) with one texture
    a sample (the L2 attack's): the views, the warps and the finals
    take either.
    """

    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig):
        self.predictor = predictor
        # images -> ("disp", cfg.attack_scale) NHWC; the trainer assigns
        # it when cfg.attack_scale > 0 (JAX `predict_scale_fn`)
        self.predict_scale = None
        # averages the texture's gradients over the ranks of a data-
        # parallel mesh (`Mesh.all_mean`: a list in, the list out); the
        # trainers set it, None elsewhere
        self.grad_mean = None
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
                    scenes_model=None, geometry=None):
        """One EoT step -> (adv_scenes, masks) at model resolution.

        Exact path: composite at native resolution, then resize
        (phy_obj_atk.py:83-90). Default: the tiled separable warp
        straight to model resolution; `scenes_model` is the resized
        scene batch, which does not change across steps; `geometry` the
        draws' warp parameters when computed beforehand
        (`view_geometry`; the exact path ignores it)."""
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
            tile_w=min(cfg.tile_w, cfg.scene_w), geometry=geometry)

    def view_geometry(self, z0s, alphas):
        """The tiled view's warp parameters of these draws on the
        texture's device (`EoTCompositor.separable_geometry`), or None
        on the exact path. z0s, alphas: (n,) for one view, or n = N * B
        for N views of batch B (`SeparableGeometry.select`)."""
        cfg = self.cfg
        if cfg.exact_composite:
            return None
        return self.eot.separable_geometry(
            z0s, alphas, cfg.scene_h, cfg.scene_w,
            min(cfg.tile_h, cfg.scene_h), min(cfg.tile_w, cfg.scene_w),
            self.obj_img.device)

    def _crop_window(self):
        """(crop_w, crop_h) of the cropped objective, each None where it
        does not cut the model frame; (None, None) when it is off."""
        cfg = self.cfg
        cw, ch = cfg.attack_crop_w, cfg.attack_crop_h
        return (cw if cw is not None and cw < cfg.scene_w else None,
                ch if ch is not None and ch < cfg.scene_h else None)

    def _objective(self, scenes_full, obj_adv, z0s, alphas,
                   scenes_model=None, fine: bool = False,
                   transform: Optional[Callable] = None, geometry=None):
        """The inner-loop cost: EoT view + targeted masked-disparity MSE.
        With the cropped objective on the tiled warp (JAX `_objective`'s
        fused route) the view is `_model_view_cropped`, in the view
        dtype; else the full-frame view in float32, cropped afterwards
        when the crop is on. `fine`: read disp0 whatever attack_scale.
        `transform` (the L0 attack's colour jitter) maps the full-frame
        composites before the model sees them; it forces the full-frame
        path (JAX `attacks/base.py:255-286`), because the jitter's
        contrast term reads the whole image's mean. `geometry`: the
        draws' `view_geometry`, when computed beforehand."""
        cw, ch = self._crop_window()
        if (cw is not None or ch is not None) and transform is None and \
                not self.cfg.exact_composite:
            adv, masks, scale = self._model_view_cropped(
                scenes_full, obj_adv, z0s, alphas, cw or self.cfg.scene_w,
                ch or self.cfg.scene_h, scenes_model, geometry)
            return self._cost_tail(adv, masks, scale, fine)
        adv_scenes, masks = self._model_view(scenes_full, obj_adv, z0s,
                                             alphas, scenes_model, geometry)
        if transform is not None:
            adv_scenes = transform(adv_scenes)
        return self._targeted_cost(adv_scenes, masks, fine)

    def _model_view_cropped(self, scenes_full, obj_adv, z0s, alphas,
                            cw: int, ch: int, scenes_model=None,
                            geometry=None):
        """(adv_crop, mask_crop, scale) of one EoT step: the tiled warp in
        the view dtype, pasted into the resized scenes (also in the view
        dtype), cut to the (ch, cw) window centred on each sample's
        mask. The offsets are JAX `_model_view_cropped`'s (base.py:
        436-470): the tile mask's centre of mass plus the tile's offset,
        its mass summed in the view dtype. The JAX package relocates the
        tile into the window with one-hot products (a TPU layout); the
        paste-then-crop here gives the same values."""
        cfg = self.cfg
        dt = getattr(torch, cfg.attack_view_dtype)
        if scenes_model is None:
            scenes_model = self._resize_scenes(scenes_full)
        tiles, y0s, x0s = self.eot.tiles_separable(
            (obj_adv,), self.obj_mask, z0s, alphas, cfg.scene_h,
            cfg.scene_w, min(cfg.tile_h, cfg.scene_h),
            min(cfg.tile_w, cfg.scene_w), dtype=dt, geometry=geometry)
        (adv,), masks = self.eot.paste_tiles(scenes_model.to(dt), tiles,
                                             y0s, x0s, (obj_adv.shape[-1],))
        th, tw = tiles.shape[1:3]
        with torch.no_grad():
            m = tiles[..., -1].float()
            mass = m.sum(dim=(1, 2)).to(dt).float()
            tys = torch.arange(th, dtype=torch.float32, device=m.device)
            txs = torch.arange(tw, dtype=torch.float32, device=m.device)
            cy = torch.tensor(y0s, dtype=torch.float32, device=m.device) + (
                m * tys[:, None]).sum(dim=(1, 2)) / mass.clamp(min=1e-6)
            cx = torch.tensor(x0s, dtype=torch.float32, device=m.device) + (
                m * txs).sum(dim=(1, 2)) / mass.clamp(min=1e-6)
        return self._cut(adv, masks, cx, cy, mass > 0, cw, ch)

    def _cost_tail(self, adv_scenes, masks, scale: float,
                   fine: bool = False):
        """Targeted zero-disparity masked MSE, mean((disp * mask)^2) * scale,
        the product and mean in float32 (JAX `_cost_tail`, base.py:
        357-384). Head s = attack_scale unless `fine`: read through
        `predict_scale`, against the mask resized to (H / 2^s, W / 2^s)
        (the mean does not depend on the resolution, so `scale`, the
        crop's rescale, carries over)."""
        s = 0 if fine else self.cfg.attack_scale
        if s:
            if self.predict_scale is None:
                raise ValueError(
                    "attack_scale > 0 needs predict_scale (the trainer "
                    "supplies the scale-s disparity head)")
            f = 2 ** s
            masks = bilinear_resize(masks, adv_scenes.shape[1] // f,
                                    adv_scenes.shape[2] // f)
            disp = self.predict_scale(adv_scenes)
        else:
            disp = self.predictor(adv_scenes)
        return torch.mean((disp.float() * masks.float()) ** 2) * scale

    def _targeted_cost(self, adv_scenes, masks, fine: bool = False):
        """The targeted cost of full-frame composites (phy_obj_atk.py:94).
        With the cropped objective the composites are cut to the window
        first and the mean is rescaled to the full frame's (JAX
        `attacks/base.py:386-404`)."""
        _, H, W, _ = adv_scenes.shape
        cw, ch = self.cfg.attack_crop_w, self.cfg.attack_crop_h
        cw = cw if cw is not None and cw < W else None
        ch = ch if ch is not None and ch < H else None
        scale = 1.0
        if cw is not None or ch is not None:
            adv_scenes, masks, scale = self._crop_to_object(
                adv_scenes, masks, cw or W, ch or H)
        return self._cost_tail(adv_scenes, masks, scale, fine)

    @classmethod
    def _crop_to_object(cls, adv_scenes, masks, cw: int, ch: int):
        """Cut each sample to (ch, cw) centred on its mask's centre of
        mass (the frame centre for an empty mask), as JAX's
        `_crop_to_object` (`attacks/base.py:407-433`). Returns (adv,
        masks, ch * cw / (H * W))."""
        H, W = adv_scenes.shape[1:3]
        with torch.no_grad():
            m = masks[..., 0].float()
            total = m.sum(dim=(1, 2))
            denom = total.clamp(min=1e-6)
            xs = torch.arange(W, dtype=torch.float32, device=m.device)
            ys = torch.arange(H, dtype=torch.float32, device=m.device)
            cx = (m * xs).sum(dim=(1, 2)) / denom
            cy = (m * ys[:, None]).sum(dim=(1, 2)) / denom
        return cls._cut(adv_scenes, masks, cx, cy, total > 0, cw, ch)

    @staticmethod
    def _cut(adv_scenes, masks, cx, cy, has, cw: int, ch: int):
        """Cut each sample to (ch, cw) around (cy, cx), the frame centre
        where `has` is False: offsets rounded half to even and clipped
        into the frame, carrying no gradient. Returns (adv, masks,
        ch * cw / (H * W))."""
        H, W = adv_scenes.shape[1:3]
        with torch.no_grad():
            cx = torch.where(has, cx, torch.full_like(cx, W / 2.0))
            cy = torch.where(has, cy, torch.full_like(cy, H / 2.0))
            x0 = torch.round(cx - cw / 2).to(torch.int64).clamp(0, W - cw)
            y0 = torch.round(cy - ch / 2).to(torch.int64).clamp(0, H - ch)
        offsets = list(zip(y0.tolist(), x0.tolist()))
        crop = lambda t: torch.stack([t[b, oy:oy + ch, ox:ox + cw]
                                      for b, (oy, ox) in enumerate(offsets)])
        return crop(adv_scenes), crop(masks), (ch * cw) / (H * W)

    def objective_and_grad(self, scenes_full, obj, z0s, alphas,
                           scenes_model=None, fine: bool = False,
                           geometry=None):
        """(cost, d cost / d obj) of one EoT draw; `fine` and `geometry`
        as `_objective`'s. Under a mesh the gradient is the ranks' mean
        (`grad_mean`), the cost this rank's."""
        with torch.enable_grad():
            obj = obj.detach().requires_grad_(True)
            cost = self._objective(scenes_full, obj, z0s, alphas,
                                   scenes_model, fine, geometry=geometry)
            (g,) = torch.autograd.grad(cost, obj)
        if self.grad_mean is not None:
            (g,) = self.grad_mean([g])
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
        """Returns the optimised adversarial texture, (1, h, w, 3) or
        (B, h, w, 3)."""
        raise NotImplementedError

    # -- entry --------------------------------------------------------------------
    def __call__(self, scenes, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 eval_mode: bool = False, draws=None):
        """scenes (1 | batch_size, ori_h, ori_w, 3) on the predictor's
        device -> (adv (B, H, W, 3), ben (B, H, W, 3), masks
        (B, H, W, 1), obj_adv (1 | B, h, w, 3)) at model resolution.
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
