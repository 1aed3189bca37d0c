"""Baseline object attacks that project, paint or blur the texture.

Counterpart of `depthmodelhardening_tpu/attacks/random_object.py:1-173`:

  * VanilaObjectAttack - projects a texture given with each call, no
    optimisation (phy_obj_atk_vanila.py:40-96; evaluate_depth.py:180-182
    re-evaluates a fixed patch across scenes);
  * ArbiObjectAttack - paints rows 90:170 x cols 100:200 of the texture
    with uniform noise or one flat random colour (phy_obj_atk_arbi.py:
    75-84); its finals put the car at linspace(5, 30) m with seeded yaws
    (:91-92);
  * GaussianObjectAttack - blurs the same region progressively (sigma
    up to max(h, w) / 2) and keeps the texture of the lowest targeted
    cost (phy_obj_atk_guassian.py:80-120).

The blur is scipy's `gaussian_filter` (mode "reflect", numpy's
"symmetric" pad) as the JAX package computes it (`_blur_hw`): two
separable 1-D passes, each a depthwise convolution (F.conv2d, groups =
C; JAX `lax.conv_general_dilated`, outside any Pallas kernel), the pad
clamped to H - 1 / W - 1 with the cut kernel renormalised. The search
stays on the card: the best cost and texture are updated with
`torch.where`; the blur kernels of every step reach the card once, when
the attack is built (`blur_kernels`), and the warp parameters of every
step's EoT sample in one call before the search (`view_geometry`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .base import FinalDraws, PhysObjAttack, PhysObjAttackConfig

# blur and paint region in object pixels (phy_obj_atk_guassian.py:90-91)
REGION_ROWS = (90, 170)
REGION_COLS = (100, 200)


def _region_mask(obj_h: int, obj_w: int,
                 rows: Tuple[int, int] = REGION_ROWS,
                 cols: Tuple[int, int] = REGION_COLS) -> np.ndarray:
    m = np.zeros((1, obj_h, obj_w, 1), np.float32)
    m[:, rows[0]:rows[1], cols[0]:cols[1], :] = 1.0
    return m


class VanilaObjectAttack(PhysObjAttack):
    """No optimisation: the adversarial texture comes with each call. The
    benign composite keeps the attack's own texture
    (phy_obj_atk_vanila.py:55-56)."""

    def draw(self, generator: torch.Generator, batch: int) -> FinalDraws:
        return FinalDraws(*self._final_za(generator, batch))

    def __call__(self, scenes, obj_img, batch_size: int,
                 generator=None, eval_mode: bool = False, draws=None):
        """As `PhysObjAttack.__call__`, projecting `obj_img` (1 | B, h, w,
        3) as the adversarial texture."""
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the draws")
            draws = self.draw(generator, batch_size)
        obj = torch.as_tensor(obj_img, dtype=torch.float32,
                              device=self.obj_img.device)
        adv, ben, masks = self._final_outputs(
            self._replicate(scenes, batch_size), obj, draws.final_z0s,
            draws.final_alphas, eval_mode)
        return adv, ben, masks, obj


@dataclasses.dataclass
class ArbiDraws:
    """Every random draw of one arbi call (CPU float32 tensors).

    coin: () uniform [0, 1): the noise pattern if > 0.5, else the flat
    noise: (1, h, w, 3) uniform noise pattern
    flat: (1, 1, 1, 3) uniform flat colour
    final_z0s, final_alphas: (B,) the finals (linspace(5, 30), seeded yaws)
    """

    coin: torch.Tensor
    noise: torch.Tensor
    flat: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


class ArbiObjectAttack(PhysObjAttack):
    """The random or flat "arbitrary pattern" baseline."""

    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, seed: int = 17):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.seed = seed
        self._region = torch.from_numpy(
            _region_mask(cfg.obj_h, cfg.obj_w)).to(self.obj_img.device)

    def draw(self, generator: torch.Generator, batch: int) -> ArbiDraws:
        coin = torch.rand((), generator=generator)
        noise = torch.rand(tuple(self.obj_img.shape), generator=generator)
        flat = torch.rand((1, 1, 1, 3), generator=generator)
        return ArbiDraws(coin, noise, flat, *self._final_za(generator, batch))

    def _final_za(self, generator, batch: int):
        # phy_obj_atk_arbi.py:91-92: linspace distances, seeded yaws
        z0 = torch.linspace(5.0, 30.0, batch, dtype=torch.float32)
        alphas = np.random.RandomState(self.seed).choice(
            np.arange(-30, 31, 2, dtype=np.float32), batch, replace=True)
        return z0, torch.from_numpy(alphas)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: ArbiDraws):
        dev = self.obj_img.device
        if float(draws.coin) > 0.5:
            pattern = draws.noise.to(device=dev, dtype=torch.float32)
        else:
            pattern = draws.flat.to(device=dev, dtype=torch.float32).expand(
                self.obj_img.shape)
        return self._region * pattern + self.obj_img * (1 - self._region)


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's _gaussian_kernel1d, normalised, radius
    int(truncate * sigma + 0.5), as float32."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


def _symmetric_index(n: int, rad: int, device) -> torch.Tensor:
    """Indices of numpy's 'symmetric' pad of an axis of n by rad <= n on
    both sides (the edge is repeated: x[rad-1..0], x, x[n-1..n-rad])."""
    i = torch.arange(n, device=device)
    return torch.cat([i[:rad].flip(0), i, i[n - rad:].flip(0)])


def blur_kernels(sigmas, h: int, w: int, device):
    """[(kernel over H, kernel over W)] of `_blur_hw` for each sigma > 0 on
    an (h, w) image: scipy's kernel, cut to the pad's clamp at n - 1 and
    renormalised where cut. All of them reach `device` in one copy."""
    cut = []
    for sigma in sigmas:
        k = _gaussian_kernel1d(sigma)
        r = (k.shape[0] - 1) // 2
        for n in (h, w):
            rad = min(r, n - 1)
            kk = k[r - rad:r + rad + 1]
            cut.append(kk if rad == r else kk / kk.sum(dtype=np.float32))
    flat = torch.from_numpy(np.concatenate(cut)).to(device)
    parts = flat.split([k.shape[0] for k in cut])
    return list(zip(parts[0::2], parts[1::2]))


def _blur_hw(img: torch.Tensor, kernels) -> torch.Tensor:
    """Separable Gaussian blur over H and W, scipy 'reflect' boundary, as
    JAX `random_object._blur_hw`: img (1, H, W, C), kernels one entry of
    `blur_kernels` on img's device (a depthwise F.conv2d a pass)."""
    C = img.shape[-1]

    def conv_axis(x, axis: int, kernel):
        rad = (kernel.shape[0] - 1) // 2
        xp = x.index_select(axis, _symmetric_index(x.shape[axis], rad,
                                                   x.device))
        shape = (C, 1, kernel.shape[0], 1) if axis == 1 else \
            (C, 1, 1, kernel.shape[0])
        out = F.conv2d(xp.permute(0, 3, 1, 2),
                       kernel.reshape(shape[2:]).expand(shape).contiguous(),
                       groups=C)
        return out.permute(0, 2, 3, 1)

    return conv_axis(conv_axis(img, 1, kernels[0]), 2, kernels[1])


@dataclasses.dataclass
class GaussianDraws:
    """Every random draw of one Gaussian call (CPU float32 tensors).

    z0s, alphas: (steps, B) per-step EoT samples
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


class GaussianObjectAttack(PhysObjAttack):
    """Increasing-blur search keeping the lowest targeted cost."""

    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, steps: int = 10):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        self.steps = steps
        self._region = torch.from_numpy(
            _region_mask(cfg.obj_h, cfg.obj_w)).to(self.obj_img.device)
        # every step's blur kernels, on the texture's device once
        self._kernels = blur_kernels(self.sigmas(), cfg.obj_h, cfg.obj_w,
                                     self.obj_img.device)
        # the last `_optimize`'s winning step (-1: the clean texture) and
        # its cost, tensors on the texture's device
        self.last_best = None
        self.last_cost = None

    def sigmas(self):
        """The blur of each step: (step + 1) / steps * max(h, w) // 2."""
        max_sigma = max(self.cfg.obj_h, self.cfg.obj_w) // 2
        return [(s + 1) / self.steps * max_sigma for s in range(self.steps)]

    def draw(self, generator: torch.Generator,
             batch: int) -> GaussianDraws:
        za = [self._sample_za(generator, batch) for _ in range(self.steps)]
        return GaussianDraws(torch.stack([z for z, _ in za]),
                             torch.stack([a for _, a in za]),
                             *self._final_za(generator, batch))

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: GaussianDraws):
        B = scenes_full.shape[0]
        dev = self.obj_img.device
        scenes_model = self._resize_scenes(scenes_full)
        geometry = self.view_geometry(draws.z0s.reshape(-1),
                                      draws.alphas.reshape(-1))
        best_cost = torch.full((), 1e10, dtype=torch.float32, device=dev)
        best_step = torch.full((), -1, dtype=torch.int64, device=dev)
        best = cur = self.obj_img
        for step, kernels in enumerate(self._kernels):
            pattern = torch.clamp(_blur_hw(self.obj_img, kernels), 0.0, 1.0)
            cur = self._region * pattern + cur * (1 - self._region)
            cost = self._objective(
                scenes_full, cur, draws.z0s[step], draws.alphas[step],
                scenes_model,
                geometry=None if geometry is None
                else geometry.select(step * B, (step + 1) * B))
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_step = torch.where(better, step, best_step)
            best = torch.where(better, cur, best)
        self.last_best, self.last_cost = best_step, best_cost
        return best
