"""Black-box Square Attack on the object texture (L-inf).

Counterpart of `depthmodelhardening_tpu/attacks/square_object.py:1-117`
(reference torchattacks/attacks/phy_obj_atk_square.py:55-511,
Andriushchenko et al.'s Square Attack on the EoT depth objective):

  * start: the vertical-stripe perturbation x + eps * rademacher(1, 1,
    w, c) (:258-260);
  * each query: the square side s from the p schedule (p_init / 2^k
    over iteration milestones rescaled to n_queries, :222-250),
    s = clip(round(sqrt(p n / c)), 1, min(h, w) - 1), a uniformly placed
    s x s square shifted by +-2 eps a channel, the candidate projected
    into the eps-box and [0, 1] (:275-290), kept when the targeted cost
    falls;
  * every evaluation projects with the same pinned EoT sample (the
    reference's fixed-seed sampler, :123-133);
  * the margin is degenerate (the reference's depth_loss returns ones):
    the loop always runs n_queries.

As the JAX package does (its fidelity note, `square_object.py:18-24`),
the candidate x_new is evaluated (the reference evaluates x_best, :291,
and so never accepts a move), and only L-inf is supported.

The schedule, the side s and the square's position are host numbers,
computed in float32 as the JAX package computes them from the injected
uniforms (`square`), so no query reads anything back from the card; the
best-so-far stays on the card (`torch.where`). The pinned sample's warp
parameters are computed once a call (`view_geometry`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import PhysObjAttack, PhysObjAttackConfig

# the p schedule's start and its iteration milestones
_P_INIT = 0.8
_P_MILESTONES = np.asarray([10, 50, 200, 500, 1000, 2000, 4000, 6000,
                            8000, 10001], np.float32)


@dataclasses.dataclass
class SquareDraws:
    """Every random draw of one Square call (CPU float32 tensors).

    stripes: (1, 1, w, c) +-1 signs of the stripe start
    z0s, alphas: (B,) the pinned EoT sample of every evaluation
    u_h, u_w: (n_queries,) uniform [0, 1) placing each query's square
    signs: (n_queries, c) +-1 signs of each query's channel shifts
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    stripes: torch.Tensor
    z0s: torch.Tensor
    alphas: torch.Tensor
    u_h: torch.Tensor
    u_w: torch.Tensor
    signs: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


def _rademacher(shape, generator):
    return torch.randint(0, 2, shape, generator=generator).float() * 2 - 1


class SquareObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, eps: float = 0.1,
                 n_queries: int = 5000, seed: int = 17):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.eps = eps
        self.n_queries = n_queries
        self.seed = seed
        # the last `_optimize`'s winning query (-1: the stripe start), its
        # best cost and accepted queries, tensors on the texture's device
        self.last_best = None
        self.last_cost = None
        self.last_accepted = None

    def _pinned_za(self, batch: int):
        return self._sample_za(torch.Generator().manual_seed(self.seed),
                               batch)

    def draw(self, generator: torch.Generator, batch: int) -> SquareDraws:
        c, w = self.obj_img.shape[-1], self.cfg.obj_w
        stripes = _rademacher((1, 1, w, c), generator)
        z, a = self._pinned_za(batch)
        u = torch.rand((2, self.n_queries), generator=generator)
        signs = _rademacher((self.n_queries, c), generator)
        fz, fa = self._final_za(generator, batch)
        return SquareDraws(stripes=stripes, z0s=z, alphas=a, u_h=u[0],
                           u_w=u[1], signs=signs, final_z0s=fz,
                           final_alphas=fa)

    def p_selection(self, it: int) -> np.float32:
        """p of query `it` (phy_obj_atk_square.py:222-250), in float32, the
        milestones rescaled to n_queries."""
        t = np.float32(it) / np.float32(self.n_queries) * np.float32(10000.0)
        k = int(np.sum(t >= _P_MILESTONES[:-1]))
        return np.float32(_P_INIT) / np.float32(2.0 ** k)

    def square(self, it: int, u_h: float, u_w: float) -> Tuple[int, int, int]:
        """(s, row, col) of query `it`'s square from its uniforms, in
        float32 as the JAX package computes them: s = clip(round(sqrt(p
        n / c)), 1, min(h, w) - 1) (round half to even), row =
        floor(u_h max(h - s, 1)), col likewise."""
        h, w = self.cfg.obj_h, self.cfg.obj_w
        c = self.obj_img.shape[-1]
        f32 = np.float32
        p = self.p_selection(it)
        s = np.clip(np.round(np.sqrt(p * f32(c * h * w) / f32(c))), f32(1.0),
                    f32(min(h, w) - 1.0))
        vh = np.floor(f32(u_h) * np.maximum(f32(h) - s, f32(1.0)))
        vw = np.floor(f32(u_w) * np.maximum(f32(w) - s, f32(1.0)))
        return int(s), int(vh), int(vw)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: SquareDraws):
        x0 = self.obj_img
        dev = x0.device
        scenes_model = self._resize_scenes(scenes_full)
        geometry = self.view_geometry(draws.z0s, draws.alphas)

        def loss(x):
            return self._objective(scenes_full, x, draws.z0s, draws.alphas,
                                   scenes_model, geometry=geometry)

        lo, hi = x0 - self.eps, x0 + self.eps
        x_best = torch.clamp(
            x0 + self.eps * draws.stripes.to(device=dev, dtype=torch.float32),
            0.0, 1.0)
        loss_min = loss(x_best)
        offs = (2.0 * self.eps) * draws.signs.to(device=dev,
                                                  dtype=torch.float32)
        u_h, u_w = draws.u_h.tolist(), draws.u_w.tolist()
        best_q = torch.full((), -1, dtype=torch.int64, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(self.n_queries):
            s, vh, vw = self.square(i, u_h[i], u_w[i])
            x_new = x_best.clone()
            x_new[:, vh:vh + s, vw:vw + s, :] += offs[i]
            x_new = torch.clamp(torch.minimum(torch.maximum(x_new, lo), hi),
                                0.0, 1.0)
            cost = loss(x_new)
            better = cost < loss_min
            x_best = torch.where(better, x_new, x_best)
            loss_min = torch.where(better, cost, loss_min)
            best_q = torch.where(better, i, best_q)
            accepted += better
        self.last_best, self.last_cost = best_q, loss_min
        self.last_accepted = accepted
        return x_best
