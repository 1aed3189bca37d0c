"""Black-box random-search light attack on the object.

Counterpart of `depthmodelhardening_tpu/attacks/light_object.py:1-86`
(reference torchattacks/attacks/phy_obj_atk_light.py:63-167): n_inits
random light parameter vectors [wavelength, angle (degrees), b, beta];
for each, n_neighbors times one of 10 coordinate patterns Q times a step
in [1, 20) gives the candidates init - step q and init + step q. The
reference never commits a move: all n_inits * n_neighbors * 2
candidates compete for the lowest targeted cost, each under a fresh EoT
sample. The winner's texture is the tube light (`physics/light.py`) of
its parameters added to the object.

The candidates come from `np.random.RandomState(seed)` as the JAX
package draws them (`_candidates`), so both sides search the same list.
The search runs on the card: each candidate's light is built there from
its parameters, the best cost and index are tensors updated with
`torch.where`, and nothing is read back inside the loop. The warp
parameters of all the candidates' EoT samples are computed in one call
before it (`view_geometry`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics.light import light_k, simple_add, tube_light_by_func
from .base import PhysObjAttack, PhysObjAttackConfig

# coordinate search patterns (phy_obj_atk_light.py:90-100)
_Q = np.asarray([
    [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
    [1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1], [0, 1, 1, 0],
    [0, 1, 0, 1], [0, 0, 1, 1]], np.float32)

_LO = np.asarray([380, 0, 0, 10], np.float32)
_HI = np.asarray([750, 180, 400, 1600], np.float32)


@dataclasses.dataclass
class LightDraws:
    """The candidates and every random draw of one light call (CPU
    float32 tensors).

    params: (N, 4) candidate [wavelength, angle, b, beta]
    z0s, alphas: (N, B) each candidate's EoT sample
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    params: torch.Tensor
    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


class LightObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, n_inits: int = 200,
                 n_neighbors: int = 20, seed: int = 0):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.n_inits = n_inits
        self.n_neighbors = n_neighbors
        self.seed = seed
        # the last `_optimize`'s winning candidate and its cost, tensors
        # on the texture's device
        self.last_best = None
        self.last_cost = None

    def _candidates(self) -> np.ndarray:
        """All candidate parameter vectors, (N, 4) float32 (JAX
        `LightObjectAttack._candidates`)."""
        rs = np.random.RandomState(self.seed)
        cands = []
        inits = [np.asarray([rs.randint(380, 750), rs.randint(0, 180),
                             rs.randint(0, 400), rs.randint(10, 1600)],
                            np.float32) for _ in range(self.n_inits)]
        for init_v in inits:
            for _ in range(self.n_neighbors):
                q = _Q[rs.randint(len(_Q))] * rs.randint(1, 20)
                for a in (-1.0, 1.0):
                    cands.append(np.clip(init_v + a * q, _LO, _HI))
        return np.stack(cands)

    def draw(self, generator: torch.Generator, batch: int) -> LightDraws:
        params = torch.from_numpy(self._candidates())
        za = [self._sample_za(generator, batch)
              for _ in range(params.shape[0])]
        fz, fa = self._final_za(generator, batch)
        return LightDraws(params=params,
                          z0s=torch.stack([z for z, _ in za]),
                          alphas=torch.stack([a for _, a in za]),
                          final_z0s=fz, final_alphas=fa)

    def apply_light(self, params):
        """The object with the tube light of params [wavelength, angle,
        b, beta] (a (4,) tensor) added (JAX `_apply_light`)."""
        light = tube_light_by_func(light_k(params[1]), params[2], 1.0,
                                   params[3], params[0], w=self.cfg.obj_w,
                                   h=self.cfg.obj_h)
        return simple_add(self.obj_img, light, 1.0)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: LightDraws):
        B = scenes_full.shape[0]
        dev = self.obj_img.device
        params = draws.params.to(device=dev, dtype=torch.float32)
        scenes_model = self._resize_scenes(scenes_full)
        geometry = self.view_geometry(draws.z0s.reshape(-1),
                                      draws.alphas.reshape(-1))
        best_cost = torch.full((), 1e10, dtype=torch.float32, device=dev)
        best = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(params.shape[0]):
            cost = self._objective(
                scenes_full, self.apply_light(params[i]), draws.z0s[i],
                draws.alphas[i], scenes_model,
                geometry=None if geometry is None
                else geometry.select(i * B, (i + 1) * B))
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best = torch.where(better, i, best)
        self.last_best, self.last_cost = best, best_cost
        return self.apply_light(params[best])
