"""Whole-image L-inf PGD on depth (no physical object).

Counterpart of `depthmodelhardening_tpu/attacks/pgd_image.py:1-75`
(reference torchattacks/attacks/pgd_depth.py:7-80). The scenes are
resized to the model's resolution first, a uniform random start added,
and each step pushes the predicted disparity towards zero (the targeted
mode: descends mean(disp^2)). Returns (adv_images, ben_images) at model
resolution. No object, so no EoT view and no warp. The JAX package's
untargeted mode and its option of no random start have no caller in the
port and are not ported.

The predictor may be an `EvalView` of a trainable student (the
distillation step's `adv_type="image"`): its passes run on detached
weights, so no PGD step computes a weight gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.resize import bilinear_resize
from .base import SCENE_H, SCENE_W


@dataclasses.dataclass
class ImageDraws:
    """The random start of one call: noise (B, H, W, 3) uniform in
    [-eps, eps) at model resolution (CPU float32)."""

    noise: torch.Tensor


class PGDImageAttack:
    """attack(scenes (B, ori_h, ori_w, 3), generator | draws=) -> (adv,
    ben), both (B, H, W, 3) at `scene_hw`; predictor(images) -> disp."""

    def __init__(self, predictor, eps: float = 0.3, alpha: float = 2 / 255,
                 steps: int = 40, scene_hw=(SCENE_H, SCENE_W)):
        self.predictor = predictor
        self.eps = eps
        self.alpha = alpha
        self.steps = steps
        self.scene_hw = tuple(scene_hw)

    def draw(self, generator: torch.Generator, batch: int) -> ImageDraws:
        u = torch.rand((batch,) + self.scene_hw + (3,), generator=generator)
        return ImageDraws(u * (2.0 * self.eps) - self.eps)

    def __call__(self, scenes, generator: Optional[torch.Generator] = None,
                 draws: Optional[ImageDraws] = None):
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the draws")
            draws = self.draw(generator, scenes.shape[0])
        images = bilinear_resize(scenes, *self.scene_hw)
        noise = draws.noise.to(device=images.device, dtype=images.dtype)
        adv = torch.clamp(images + noise, 0.0, 1.0)
        for _ in range(self.steps):
            # ascend -MSE(disp, 0), i.e. descend mean(disp^2)
            with torch.enable_grad():
                x = adv.detach().requires_grad_(True)
                cost = torch.mean(self.predictor(x) ** 2)
                (g,) = torch.autograd.grad(cost, x)
            with torch.no_grad():
                adv = adv - self.alpha * torch.sign(g)
                delta = torch.clamp(adv - images, -self.eps, self.eps)
                adv = torch.clamp(images + delta, 0.0, 1.0)
        return adv.detach(), images
