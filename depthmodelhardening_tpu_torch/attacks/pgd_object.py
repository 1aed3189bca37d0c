"""L-inf PGD on the physical object texture (EoT).

Counterpart of `depthmodelhardening_tpu/attacks/pgd_object.py:21-78`
(reference torchattacks/attacks/phy_obj_atk.py:13-123). Random start in
the eps-ball; each step draws a fresh EoT sample, composites, and steps
the texture against the sign of the targeted masked-MSE gradient; the
perturbation is clipped to eps and the texture to [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .base import PhysObjAttack, PhysObjAttackConfig


@dataclasses.dataclass
class PGDDraws:
    """Every random draw of one PGD call (CPU float32 tensors).

    noise: (1, h, w, 3) random start in [-eps, eps] (None: no random start)
    z0s, alphas: (steps, B) per-step EoT samples
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    noise: Optional[torch.Tensor]
    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


class PGDObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, eps: float = 0.3,
                 alpha: float = 2 / 255, steps: int = 40,
                 random_start: bool = True):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.eps = eps
        self.alpha = alpha
        self.steps = steps
        self.random_start = random_start

    def draw(self, generator: torch.Generator, batch: int) -> PGDDraws:
        noise = None
        if self.random_start:
            u = torch.rand(tuple(self.obj_img.shape), generator=generator)
            noise = u * (2.0 * self.eps) - self.eps
        za = [self._sample_za(generator, batch) for _ in range(self.steps)]
        fz, fa = self._final_za(generator, batch)
        return PGDDraws(
            noise=noise,
            z0s=torch.stack([z for z, _ in za]).reshape(self.steps, batch),
            alphas=torch.stack([a for _, a in za]).reshape(self.steps, batch),
            final_z0s=fz, final_alphas=fa)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: PGDDraws):
        obj_clean = self.obj_img
        obj_adv = obj_clean
        if self.random_start:
            noise = draws.noise.to(device=obj_clean.device,
                                   dtype=torch.float32)
            obj_adv = torch.clamp(obj_clean + noise, 0.0, 1.0)
        scenes_model = self._resize_scenes(scenes_full)
        for step in range(self.steps):
            _, g = self.objective_and_grad(
                scenes_full, obj_adv, draws.z0s[step], draws.alphas[step],
                scenes_model)
            # the reference ascends -MSE (phy_obj_atk.py:94-99):
            # equivalently descend the MSE by the gradient sign
            obj_adv = obj_adv - self.alpha * torch.sign(g)
            delta = torch.clamp(obj_adv - obj_clean, -self.eps, self.eps)
            obj_adv = torch.clamp(obj_clean + delta, 0.0, 1.0)
        return obj_adv
