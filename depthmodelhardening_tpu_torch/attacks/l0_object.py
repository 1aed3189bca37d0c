"""L0 physical object attack: dual positive/negative patterns and Adam.

Counterpart of `depthmodelhardening_tpu/attacks/l0_object.py:34-148`
(reference torchattacks/attacks/phy_obj_atk_l0.py:16-174). Two pattern
tensors are optimised with Adam (lr 0.5, betas (0.5, 0.9), eps 1e-8, as
optax's `adam` computes it) for up to 2 * steps iterations:

  pattern = clip(pos, 0, 1) - clip(neg, 0, 1)
  obj_adv = clip(obj + pattern, 0, 1)
  cost    = MSE(disp(adv_scene) * mask, 0)
            + mask_weight * (mean(max_c tanh(pos/10)/(2-1e-7)+0.5)
                             + mean(max_c tanh(neg/10)/(2-1e-7)+0.5))

The L0 ratio (nonzero pixels of the 1/255-thresholded pattern over the
starting count) sets mask_weight (0 once the ratio reaches l0_thresh)
and breaks the loop early once ratio <= l0_thresh after `steps`
iterations. As in the reference (phy_obj_atk_l0.py:92-111) the loop is a
Python loop that reads the pattern's nonzero count on the host once per
iteration. The final texture thresholds the patterns at 1/255 (:142-
150). The eval pin is z0 = 6.1 (:161-163).

Every draw is injectable (`L0Draws`), as `pgd_object.PGDDraws` is for
PGD. The clips are JAX's (`jnp.clip`: at a bound the gradient halves),
so the gradients agree where a texel sits exactly on 0 or 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.color import apply_color_jitter, sample_color_jitter
from .base import PhysObjAttack, PhysObjAttackConfig

L0_EVAL_PIN_Z0 = 6.1  # phy_obj_atk_l0.py:162


@dataclasses.dataclass
class L0Draws:
    """Every random draw of one L0 call (CPU float32 tensors).

    pos, neg: (1, h, w, 3) uniform [0, 1) starting patterns
    z0s, alphas: (2 * steps, B) per-iteration EoT samples
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    jitter: the fixed colour jitter's (order, factors), or None
    """

    pos: torch.Tensor
    neg: torch.Tensor
    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor
    jitter: Optional[Tuple[Sequence[int], Sequence[float]]] = None

    def rows(self, sl: slice) -> "L0Draws":
        """The draws of the samples `sl` of the batch (the patterns are
        shared)."""
        return dataclasses.replace(
            self, z0s=self.z0s[:, sl], alphas=self.alphas[:, sl],
            final_z0s=self.final_z0s[sl], final_alphas=self.final_alphas[sl])


def _clip01(x):
    """jnp.clip(x, 0, 1) with JAX's gradient: half at a bound (autodiff of
    max(min(.)) splits a tie), where torch.clamp passes all of it."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


class L0ObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, adam_lr: float = 0.5,
                 steps: int = 10, mask_wt: float = 0.1,
                 l0_thresh: float = 1 / 10, color_jit: bool = False,
                 jitter_seed: int = 0):
        if cfg.eval_pin_z0 == 7.0:
            cfg = dataclasses.replace(cfg, eval_pin_z0=L0_EVAL_PIN_Z0)
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.adam_lr = adam_lr
        self.steps = steps
        self.mask_wt = mask_wt
        self.l0_thresh = l0_thresh
        self.l0_clip = 1.0 / 255.0
        self.betas = (0.5, 0.9)
        self.eps = 1e-8
        self.jitter = (sample_color_jitter(np.random.RandomState(jitter_seed))
                       if color_jit else None)
        # iterations run and whether the early break fired, of the last
        # `_optimize`
        self.last_iterations = 0
        self.last_early_break = False

    def draw(self, generator: torch.Generator, batch: int) -> L0Draws:
        shape = tuple(self.obj_img.shape)
        pos = torch.rand(shape, generator=generator)
        neg = torch.rand(shape, generator=generator)
        za = [self._sample_za(generator, batch)
              for _ in range(2 * self.steps)]
        fz, fa = self._final_za(generator, batch)
        return L0Draws(
            pos=pos, neg=neg,
            z0s=torch.stack([z for z, _ in za]).reshape(-1, batch),
            alphas=torch.stack([a for _, a in za]).reshape(-1, batch),
            final_z0s=fz, final_alphas=fa, jitter=self.jitter)

    # -- L0 bookkeeping --------------------------------------------------------
    def _thresholded(self, pos_t, neg_t):
        """The patterns clipped to [0, 1] (neg negated), each zeroed where
        its magnitude is below 1/255 (phy_obj_atk_l0.py:43-52, 142-150)."""
        pp, pn = _clip01(pos_t), -_clip01(neg_t)
        pp = torch.where(pp < self.l0_clip, torch.zeros_like(pp), pp)
        pn = torch.where(pn > -self.l0_clip, torch.zeros_like(pn), pn)
        return pp, pn

    def _cal_l0(self, pos_t, neg_t):
        """Nonzero pixel count of the thresholded pattern, a float32
        scalar tensor."""
        pp, pn = self._thresholded(pos_t, neg_t)
        per_pixel = torch.sum(torch.abs(pp + pn), dim=-1)
        return torch.sum((per_pixel != 0).to(torch.float32))

    @staticmethod
    def _mask_cost(pos_t, neg_t):
        mp = torch.amax(torch.tanh(pos_t / 10.0) / (2 - 1e-7) + 0.5, dim=-1)
        mn = torch.amax(torch.tanh(neg_t / 10.0) / (2 - 1e-7) + 0.5, dim=-1)
        return torch.mean(mp) + torch.mean(mn)

    def _adam(self, params, grads, moments, count: int):
        """One optax.adam update of `params` in place: the moments as
        optax's update_moment, bias corrections 1 - beta ** count in
        float32, p - lr * mu_hat / (sqrt(nu_hat) + eps)."""
        b1, b2 = self.betas
        c1 = np.float32(1.0) - np.float32(b1) ** np.float32(count)
        c2 = np.float32(1.0) - np.float32(b2) ** np.float32(count)
        for p, g, (mu, nu) in zip(params, grads, moments):
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_((1.0 - b2) * (g * g))
            upd = (mu / float(c1)) / (torch.sqrt(nu / float(c2)) + self.eps)
            p.add_(-self.adam_lr * upd)

    # -- optimisation --------------------------------------------------------------
    def cost_and_grads(self, scenes_full, pos_t, neg_t, z0s, alphas,
                       mask_weight: float, transform=None,
                       scenes_model=None):
        """One iteration's total cost (the targeted MSE of the texture
        clip(obj + clip(pos) - clip(neg)) plus mask_weight times the mask
        cost) and its gradients with respect to (pos, neg); under a mesh
        the gradients are the ranks' mean (`grad_mean`), the cost this
        rank's."""
        with torch.enable_grad():
            pos = pos_t.detach().requires_grad_(True)
            neg = neg_t.detach().requires_grad_(True)
            obj_adv = _clip01(self.obj_img + _clip01(pos) - _clip01(neg))
            cost = self._objective(scenes_full, obj_adv, z0s, alphas,
                                   scenes_model, transform=transform)
            cost = cost + mask_weight * self._mask_cost(pos, neg)
            grads = torch.autograd.grad(cost, (pos, neg))
        if self.grad_mean is not None:
            grads = tuple(self.grad_mean(grads))
        return cost.detach(), grads

    def _optimize(self, scenes_full, draws: L0Draws):
        dev = self.obj_img.device
        pos_t = draws.pos.to(device=dev, dtype=torch.float32).clone()
        neg_t = draws.neg.to(device=dev, dtype=torch.float32).clone()
        jitter = draws.jitter
        transform = (None if jitter is None else
                     (lambda s: apply_color_jitter(s, *jitter)))
        scenes_model = self._resize_scenes(scenes_full)
        moments = [(torch.zeros_like(pos_t), torch.zeros_like(pos_t)),
                   (torch.zeros_like(neg_t), torch.zeros_like(neg_t))]
        thresh = np.float32(self.l0_thresh)
        l0_init = np.float32(self._cal_l0(pos_t, neg_t).item())
        step = 0
        early_break = False
        while step < 2 * self.steps:
            # the one host read of the iteration (phy_obj_atk_l0.py:92-98)
            ratio = np.float32(self._cal_l0(pos_t, neg_t).item()) / l0_init
            if ratio <= thresh and step >= self.steps:
                early_break = True
                break
            mask_weight = 0.0 if ratio <= thresh else self.mask_wt
            _, grads = self.cost_and_grads(
                scenes_full, pos_t, neg_t, draws.z0s[step],
                draws.alphas[step], mask_weight, transform, scenes_model)
            with torch.no_grad():
                self._adam((pos_t, neg_t), grads, moments, step + 1)
            step += 1
        self.last_iterations = step
        self.last_early_break = early_break
        with torch.no_grad():
            pp, pn = self._thresholded(pos_t, neg_t)
            return torch.clamp(self.obj_img + pp + pn, 0.0, 1.0)


def default_l0_config(obj_h: int, obj_w: int,
                      dist_range=None) -> PhysObjAttackConfig:
    kwargs = {}
    if dist_range is not None:
        kwargs["dist_range"] = tuple(float(x) for x in dist_range)
    return PhysObjAttackConfig(obj_h=obj_h, obj_w=obj_w,
                               eval_pin_z0=L0_EVAL_PIN_Z0, **kwargs)
