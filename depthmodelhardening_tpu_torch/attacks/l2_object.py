"""L2-ball PGD on the physical object texture.

Counterpart of `depthmodelhardening_tpu/attacks/l2_object.py:1-76`
(reference torchattacks/attacks/phy_obj_atk_l2.py:37-142): step size
2.5 * eps / steps, a random start uniform inside the L2 eps-ball, a
fresh EoT sample every step, the gradient normalised to unit L2 norm,
the perturbation projected back onto the eps-ball, the texture clipped
to [0, 1].

As in the JAX package (its fidelity note, `l2_object.py:8-15`), each
sample of the batch has its own texture, (B, h, w, 3), with its own
gradient normalisation: the reference's per-batch chunked norm expands
its (1, h, w, 3) texture to one copy a sample from the second step on.
The views, the warps and the finals take the (B, h, w, 3) texture as
they take a (1, h, w, 3) one. Every step's warp parameters are computed
in one call before the loop (`view_geometry`).
"""

from __future__ import annotations

import dataclasses

import torch

from .base import PhysObjAttack, PhysObjAttackConfig

_EPS_DIV = 1e-10  # the reference's eps_for_division


@dataclasses.dataclass
class L2Draws:
    """Every random draw of one L2 call (CPU float32 tensors).

    delta: (B, h, w, 3) standard normal direction of the random start,
      r: (B,) its uniform radius fraction
    z0s, alphas: (steps, B) per-step EoT samples
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    delta: torch.Tensor
    r: torch.Tensor
    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


def _per_sample_norm(t):
    """(B,) L2 norms of the samples of t (B, ...)."""
    return torch.sqrt(torch.sum(t.reshape(t.shape[0], -1) ** 2, dim=1))


class L2ObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, eps: float = 1.0,
                 steps: int = 40):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.eps = eps
        self.alpha = 2.5 * eps / steps  # phy_obj_atk_l2.py:44
        self.steps = steps

    def draw(self, generator: torch.Generator, batch: int) -> L2Draws:
        delta = torch.randn((batch,) + tuple(self.obj_img.shape[1:]),
                            generator=generator)
        r = torch.rand((batch,), generator=generator)
        za = [self._sample_za(generator, batch) for _ in range(self.steps)]
        fz, fa = self._final_za(generator, batch)
        return L2Draws(
            delta=delta, r=r,
            z0s=torch.stack([z for z, _ in za]).reshape(self.steps, batch),
            alphas=torch.stack([a for _, a in za]).reshape(self.steps, batch),
            final_z0s=fz, final_alphas=fa)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: L2Draws):
        B = scenes_full.shape[0]
        dev = self.obj_img.device
        obj0 = self.obj_img.expand((B,) + tuple(self.obj_img.shape[1:]))
        view = (B, 1, 1, 1)
        # a uniform point inside the L2 ball (phy_obj_atk_l2.py:83-90)
        delta = draws.delta.to(device=dev, dtype=torch.float32)
        r = draws.r.to(device=dev, dtype=torch.float32)
        delta = delta * (r / _per_sample_norm(delta)).reshape(view) * self.eps
        adv = torch.clamp(obj0 + delta, 0.0, 1.0)
        scenes_model = self._resize_scenes(scenes_full)
        geometry = self.view_geometry(draws.z0s.reshape(-1),
                                      draws.alphas.reshape(-1))
        for step in range(self.steps):
            _, g = self.objective_and_grad(
                scenes_full, adv, draws.z0s[step], draws.alphas[step],
                scenes_model,
                geometry=None if geometry is None
                else geometry.select(step * B, (step + 1) * B))
            g = -g  # ascend -MSE (phy_obj_atk_l2.py:100-112)
            g = g / (_per_sample_norm(g) + _EPS_DIV).reshape(view)
            adv = adv + self.alpha * g
            delta = adv - obj0
            dn = torch.clamp(_per_sample_norm(delta), min=_EPS_DIV)
            # a true division (a scalar over a tensor is x^-1 * scalar)
            factor = torch.clamp(torch.full_like(dn, self.eps) / dn, max=1.0)
            adv = torch.clamp(obj0 + delta * factor.reshape(view), 0.0, 1.0)
        return adv
