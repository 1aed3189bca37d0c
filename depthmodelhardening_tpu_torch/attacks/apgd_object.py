"""Auto-PGD (momentum + adaptive step halving) on the object texture.

Counterpart of `depthmodelhardening_tpu/attacks/apgd_object.py:1-173`
(reference torchattacks/attacks/phy_obj_atk_apgd.py:49-343, Croce and
Hein's APGD on the EoT depth objective):

  * every loss evaluation projects with the same pinned EoT sample (the
    reference's fixed-seed RandomState, :104-110; the JAX package's
    `PRNGKey(seed)`; here a generator seeded with `seed`);
  * a random start on the L-inf sphere scaled by max |t| (:140-142), or
    under L2 on the eps-sphere, t / ||t||;
  * the momentum iterate z = x + a (x_cand - x) + (1 - a)(x - x_old),
    a = 0.75 (1.0 on step 0), x_cand a step of sign(g) (L-inf) or
    g / ||g|| (L2), each stage projected into the eps-box (or ball) and
    [0, 1] (:203-209);
  * checkpointed step-size control: at each checkpoint (the first after
    steps_2 = max(int(0.22 steps), 1) steps, the interval shrinking by
    size_decr = max(int(0.03 steps), 1) to steps_min = max(int(0.06
    steps), 1)) the step halves and the iterate restarts from the best
    one when the loss rose in at most rho k of the last k steps, or the
    best loss did not improve since the last checkpoint (:253-289);
    `reduced_last_check` starts True, the loss history at -inf;
  * the result is the final iterate, not the best one (:122);
  * `n_restarts` runs once: the reference keeps the first restart's
    result (its always-"fooled" accuracy logic, perturb :315-327), and
    so does the JAX package (:170).

The loop runs on the card: the best-so-far, the loss history and the
halving are tensors updated with `torch.where`, and no value is read
back to the host inside it. The checkpoints themselves do not depend on
the data (counter3 and k are host integers). The pinned sample's warp
parameters are computed once a call (`view_geometry`).
"""

from __future__ import annotations

import dataclasses

import torch

from .base import PhysObjAttack, PhysObjAttackConfig

# the oscillation test's share of rising steps (the reference's rho)
_RHO = 0.75


def _l2(x):
    """The L2 norm of the whole texture."""
    return torch.sqrt(torch.sum(x ** 2))


@dataclasses.dataclass
class APGDDraws:
    """Every random draw of one APGD call (CPU float32 tensors).

    t: (1, h, w, 3) uniform [-1, 1) random start
    z0s, alphas: (B,) the pinned EoT sample of every evaluation
    final_z0s, final_alphas: (B,) finals draw, before the eval pin
    """

    t: torch.Tensor
    z0s: torch.Tensor
    alphas: torch.Tensor
    final_z0s: torch.Tensor
    final_alphas: torch.Tensor


class APGDObjectAttack(PhysObjAttack):
    def __init__(self, predictor, obj_img, obj_mask,
                 cfg: PhysObjAttackConfig, norm: str = "Linf",
                 eps: float = 8 / 255, steps: int = 100,
                 n_restarts: int = 1, seed: int = 17):
        super().__init__(predictor, obj_img, obj_mask, cfg)
        if norm not in ("Linf", "L2"):
            raise ValueError(norm)
        self.norm = norm
        self.n_restarts = n_restarts
        self.eps = eps
        self.steps = steps
        self.seed = seed
        self.steps_2 = max(int(0.22 * steps), 1)
        self.steps_min = max(int(0.06 * steps), 1)
        self.size_decr = max(int(0.03 * steps), 1)
        # the loop's final state of the last `_optimize` (tensors on the
        # texture's device; k and counter3 host ints)
        self.last_state = None

    def _pinned_za(self, batch: int):
        return self._sample_za(torch.Generator().manual_seed(self.seed),
                               batch)

    def draw(self, generator: torch.Generator, batch: int) -> APGDDraws:
        t = torch.rand(tuple(self.obj_img.shape), generator=generator)
        z, a = self._pinned_za(batch)
        fz, fa = self._final_za(generator, batch)
        return APGDDraws(t=t * 2.0 - 1.0, z0s=z, alphas=a, final_z0s=fz,
                         final_alphas=fa)

    def _project(self, x0, z):
        if self.norm == "Linf":
            z = torch.minimum(torch.maximum(z, x0 - self.eps),
                              x0 + self.eps)
            return torch.clamp(z, 0.0, 1.0)
        delta = z - x0
        n = _l2(delta) + 1e-12
        return torch.clamp(x0 + delta / n * torch.clamp(n, max=self.eps),
                           0.0, 1.0)

    @torch.no_grad()
    def _optimize(self, scenes_full, draws: APGDDraws):
        # one run whatever n_restarts: the reference keeps the first
        # restart's result (its always-"fooled" accuracy logic, perturb
        # :315-327)
        x0 = self.obj_img
        dev = x0.device
        scenes_model = self._resize_scenes(scenes_full)
        geometry = self.view_geometry(draws.z0s, draws.alphas)

        def loss_grad(x):
            # APGD maximises -MSE(masked disp, 0)
            cost, g = self.objective_and_grad(
                scenes_full, x, draws.z0s, draws.alphas, scenes_model,
                geometry=geometry)
            return -cost, -g

        t = draws.t.to(device=dev, dtype=torch.float32)
        if self.norm == "Linf":
            x_adv = x0 + self.eps * t / torch.max(torch.abs(t))
        else:
            x_adv = x0 + self.eps * t / (_l2(t) + 1e-12)
        x_adv = torch.clamp(x_adv, 0.0, 1.0)
        loss, grad = loss_grad(x_adv)

        x_old, x_best, grad_best = x_adv, x_adv, grad
        loss_best = loss_best_last_check = loss
        reduced_last_check = torch.ones((), dtype=torch.bool, device=dev)
        step_size = torch.full((), 2.0 * self.eps, dtype=torch.float32,
                               device=dev)
        loss_steps = torch.full((self.steps,), float("-inf"),
                                dtype=torch.float32, device=dev)
        idx = torch.arange(self.steps, device=dev)
        counter3, k = 0, self.steps_2
        for i in range(self.steps):
            a = 0.75 if i > 0 else 1.0
            step = (torch.sign(grad) if self.norm == "Linf"
                    else grad / (_l2(grad) + 1e-12))
            cand = self._project(x0, x_adv + step_size * step)
            z = x_adv + a * (cand - x_adv) + (1.0 - a) * (x_adv - x_old)
            x_new = self._project(x0, z)
            loss, grad = loss_grad(x_new)

            better = loss > loss_best
            x_best = torch.where(better, x_new, x_best)
            grad_best = torch.where(better, grad, grad_best)
            loss_best = torch.where(better, loss, loss_best)
            loss_steps[i] = loss

            counter3 += 1
            if counter3 == k:
                # the oscillation test over the last k steps (:124-129)
                prev = torch.cat([loss_steps.new_full((1,), float("-inf")),
                                  loss_steps[:-1]])
                window = (idx <= i) & (idx > i - k)
                n_rose = torch.sum(((loss_steps > prev) & window).float())
                fl = (n_rose <= k * _RHO) | (
                    ~reduced_last_check & (loss_best_last_check >= loss_best))
                step_size = torch.where(fl, step_size / 2.0, step_size)
                x_new = torch.where(fl, x_best, x_new)
                grad = torch.where(fl, grad_best, grad)
                k = max(k - self.size_decr, self.steps_min)
                counter3 = 0
                loss_best_last_check = loss_best
                reduced_last_check = fl
            x_old, x_adv = x_adv, x_new
        self.last_state = dict(
            x_best=x_best, loss_best=loss_best, step_size=step_size,
            loss_steps=loss_steps, reduced_last_check=reduced_last_check,
            loss_best_last_check=loss_best_last_check, k=k,
            counter3=counter3)
        return x_adv
