"""Projection of a real photographed adversarial object.

Counterpart of `depthmodelhardening_tpu/attacks/physical.py:1-34`
(reference torchattacks/attacks/physical.py:20-94): nothing is
optimised; a separately supplied photographed texture is projected
with the benign object's mask (physical.py:63), and sample 0 is always
pinned to (z0, alpha) = (6.1, 0) (physical.py:80-81), in eval mode
whatever the caller asks. evaluate_depth_physical.py:133-137 uses it to
validate a real-world patch.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import FinalDraws, PhysObjAttack, PhysObjAttackConfig

PHYSICAL_PIN_Z0 = 6.1  # physical.py:80


class PhysicalObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask, adv_obj_img,
                 cfg: PhysObjAttackConfig):
        cfg = dataclasses.replace(cfg, eval_pin_z0=PHYSICAL_PIN_Z0)
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.adv_obj_img = torch.as_tensor(adv_obj_img, dtype=torch.float32,
                                           device=self.obj_img.device)

    def draw(self, generator: torch.Generator, batch: int) -> FinalDraws:
        return FinalDraws(*self._final_za(generator, batch))

    def _optimize(self, scenes_full, draws):
        return self.adv_obj_img

    def __call__(self, scenes, batch_size: int, generator=None,
                 eval_mode: bool = True, draws=None):
        # the pin is unconditional in the reference (physical.py:80-81)
        return super().__call__(scenes, batch_size, generator,
                                eval_mode=True, draws=draws)
