"""The AutoAttack family of classifier attacks, NCHW: APGD, APGD-T, FAB,
Square, MultiAttack and AutoAttack.

Counterpart of `depthmodelhardening_tpu/attacks/classifier_auto.py`
(reference torchattacks/attacks/{apgd, apgdt, fab, square, autoattack,
multiattack}.py, torchattacks v3.2.2, Croce and Hein's suite), with
`classifier.py`'s interface: `model(images (B, C, H, W) in [0, 1]) ->
logits (B, n_classes)` in eval mode, labels int64, and a CPU
`torch.Generator` (`None`: one seeded with `seed`) or injected draws.

As JAX computes them:

* APGD runs every sample's momentum iterate and its step halving at
  Croce and Hein's checkpoints (`_apgd_checkpoints`, fixed by the step
  count alone) on the device, the loss history in a (steps, B) buffer:
  no host read in the loop. `eot_iter` gradients are averaged, each
  from its own model call (a stochastic model draws anew in each).
* FAB's box-constrained projection onto a hyperplane is JAX's bisection
  on the Lagrange multiplier of min ||d||_p s.t. w.(x + d) = b, 0 <= x +
  d <= 1 (`_proj_box_hyperplane`: 60 doublings, 50 halvings, no host
  read), batched over the samples; the Jacobian is one backward pass a
  class for the whole batch.
* Square places each query's square by slicing at the draws' host
  integers (JAX masks with iota): the same values, no host read.
* MultiAttack reads back once an attack whether every sample is fooled,
  as JAX does, and stops there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .classifier import (
    Model, _bshape, _ce, _generator, _grad, _jacobian, _l2, _on, _one_hot,
    _rows,
)


# -- losses -------------------------------------------------------------------
def _dlr_loss(logits, labels):
    """The difference-of-logits ratio (apgd.py:147-153)."""
    z_sorted = torch.sort(logits, dim=1, descending=True).values
    z_y = torch.sum(_one_hot(labels, logits) * logits, dim=1)
    pi1_is_y = logits.argmax(dim=1) == labels
    top = z_y - torch.where(pi1_is_y, z_sorted[:, 1], z_sorted[:, 0])
    return -top / (z_sorted[:, 0] - z_sorted[:, 2] + 1e-12)


def _dlr_loss_targeted(logits, labels, targets):
    """The targeted DLR (apgdt.py:130-136)."""
    z_sorted = torch.sort(logits, dim=1, descending=True).values
    z_y = torch.sum(_one_hot(labels, logits) * logits, dim=1)
    z_t = torch.sum(_one_hot(targets, logits) * logits, dim=1)
    return -(z_y - z_t) / (
        z_sorted[:, 0] - (z_sorted[:, 2] + z_sorted[:, 3]) / 2 + 1e-12)


def _target_classes(logits_clean, n_classes):
    """(order, n_targets): the classes by clean logit, ascending (a
    stable sort), so order[:, -tc] is the tc-th most likely; the targets
    are the 2nd .. (n_targets + 1)-th (apgdt.py:52-53, fab.py:97-107)."""
    order = torch.argsort(logits_clean, dim=1, stable=True)
    return order, min(n_classes - 1, logits_clean.shape[-1] - 1)


# -- APGD ---------------------------------------------------------------------
def _apgd_checkpoints(steps):
    """Croce and Hein's checkpoints (apgd.py:85, 192-211): (mask (steps,)
    bool, window (steps,) int32). The first at loop index k - 1 for k =
    max(int(0.22 steps), 1), then every k steps, k shrinking by
    max(int(0.03 steps), 1) down to max(int(0.06 steps), 1); the
    oscillation window at a checkpoint is the k in force there."""
    n2 = max(int(0.22 * steps), 1)
    nmin = max(int(0.06 * steps), 1)
    decr = max(int(0.03 * steps), 1)
    mask = np.zeros(steps, dtype=bool)
    win = np.zeros(steps, dtype=np.int32)
    k, pos = n2, n2 - 1
    while pos < steps:
        mask[pos], win[pos] = True, k
        k = max(k - decr, nmin)
        pos += k
    return mask, win


def _project(norm, x, x_orig, eps):
    if norm == "Linf":
        return torch.clamp(torch.clamp(x, x_orig - eps, x_orig + eps),
                           0.0, 1.0)
    d = x - x_orig
    d = d * torch.clamp(eps / (_bshape(_l2(d)) + 1e-12), max=1.0)
    return torch.clamp(x_orig + d, 0.0, 1.0)


@dataclasses.dataclass
class APGDDraws:
    """One APGD run's random start (B, C, H, W): 2u - 1 for u uniform in
    [0, 1) under L-inf, standard normal under L2."""

    t: torch.Tensor


def apgd_draws(generator: torch.Generator, images, norm) -> APGDDraws:
    shape = tuple(images.shape)
    if norm == "Linf":
        return APGDDraws(2.0 * torch.rand(shape, generator=generator) - 1.0)
    return APGDDraws(torch.randn(shape, generator=generator))


def _apgd_single_run(model: Model, images, labels, loss_fn, norm, eps,
                     steps, rho, draws: APGDDraws, eot_iter=1):
    """One APGD restart, batched: (x_best, x_best_adv, found,
    loss_best)."""
    B = images.shape[0]
    ck_mask, ck_win = _apgd_checkpoints(steps)

    def loss_and_grad(x):
        if eot_iter == 1:
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                logits = model(xr)
                loss = loss_fn(logits)
                (g,) = torch.autograd.grad(loss.sum(), xr)
            return loss.detach(), g, logits.detach().argmax(dim=1)
        g = torch.zeros_like(x)
        for _ in range(eot_iter):
            g = g + _grad(lambda a: loss_fn(model(a)).sum(), x)
        logits = model(x)
        return loss_fn(logits), g / eot_iter, logits.argmax(dim=1)

    # the random start (apgd.py:181-190)
    t = _on(draws.t, images)
    tn = (t.flatten(1).abs().amax(dim=1) if norm == "Linf" else _l2(t))
    x_adv = torch.clamp(images + eps * t / (_bshape(tn) + 1e-12), 0.0, 1.0)

    loss_indiv, grad, preds = loss_and_grad(x_adv)
    found = preds != labels
    x_best, grad_best = x_adv, grad
    x_best_adv = torch.where(_bshape(found), x_adv, images)
    loss_best = loss_indiv
    # the first step 2 eps for both norms, L2's on the normalised
    # gradient (apgd.py:192, 215-228)
    step_size = torch.full((B, 1, 1, 1), 2.0 * eps, device=images.device)
    loss_steps = torch.zeros((steps, B), device=images.device)
    loss_best_last_check = loss_best
    reduced_last_check = torch.ones(B, dtype=torch.bool,
                                    device=images.device)
    idx = torch.arange(steps, device=images.device)
    x_adv_old = x_adv
    for i in range(steps):
        a = 1.0 if i == 0 else 0.75
        if norm == "Linf":
            z = x_adv + step_size * torch.sign(grad)
        else:
            z = x_adv + step_size * grad / (_bshape(_l2(grad)) + 1e-12)
        z = _project(norm, z, images, eps)
        x_new = _project(norm, x_adv + a * (z - x_adv)
                         + (1 - a) * (x_adv - x_adv_old), images, eps)
        x_adv_old, x_adv = x_adv, x_new
        loss_indiv, grad, preds = loss_and_grad(x_adv)
        is_adv = preds != labels
        # the latest adversarial iterate every step (apgd.py:200-205)
        x_best_adv = torch.where(_bshape(is_adv), x_adv, x_best_adv)
        found = found | is_adv
        improved = loss_indiv > loss_best
        x_best = torch.where(_bshape(improved), x_adv, x_best)
        grad_best = torch.where(_bshape(improved), grad, grad_best)
        loss_best = torch.maximum(loss_best, loss_indiv)
        loss_steps[i] = loss_indiv

        if ck_mask[i]:
            # the step-size control (apgd.py:244-267): count the steps j
            # in (i - k, i] whose loss rose over step j - 1 (j = 0 against
            # the reference's zero-initialised history)
            k = int(ck_win[i])
            prev = torch.cat([loss_steps.new_zeros((1, B)), loss_steps[:-1]])
            in_win = ((idx > i - k) & (idx <= i))[:, None]
            rises = torch.sum(in_win & (loss_steps > prev), dim=0)
            reduce = (rises <= rho * k) | (
                ~reduced_last_check & (loss_best_last_check >= loss_best))
            step_size = torch.where(_bshape(reduce), step_size / 2.0,
                                    step_size)
            # restarting from x_best restores its gradient (apgd.py:269-271)
            x_adv = torch.where(_bshape(reduce), x_best, x_adv)
            grad = torch.where(_bshape(reduce), grad_best, grad)
            loss_best_last_check = loss_best
            reduced_last_check = reduce
    return x_best, x_best_adv, found, loss_best


@torch.no_grad()
def apgd(model: Model, images, labels, norm="Linf", eps=8 / 255, steps=100,
         n_restarts=1, seed=0, loss="ce", rho=0.75, eot_iter=1,
         generator=None, draws: Optional[Sequence[APGDDraws]] = None):
    """torchattacks/attacks/apgd.py: Auto-PGD with the ce or dlr loss;
    `draws`: one `apgd_draws` a restart. A sample no restart fooled keeps
    its image (apgd.py:55-80)."""
    if norm not in ("Linf", "L2"):
        raise ValueError(norm)
    if loss == "ce":
        loss_fn = lambda lg: _ce(lg, labels)
    elif loss == "dlr":
        loss_fn = lambda lg: _dlr_loss(lg, labels)
    else:
        raise ValueError(loss)
    if draws is None:
        gen = _generator(generator, seed)
        draws = [apgd_draws(gen, images, norm) for _ in range(n_restarts)]
    adv = images
    fooled = torch.zeros(images.shape[0], dtype=torch.bool,
                         device=images.device)
    for r in range(n_restarts):
        _, x_best_adv, found, _ = _apgd_single_run(
            model, images, labels, loss_fn, norm, eps, steps, rho, draws[r],
            eot_iter=eot_iter)
        adv = torch.where(_bshape(found & ~fooled), x_best_adv, adv)
        fooled = fooled | found
    return adv


@torch.no_grad()
def apgdt(model: Model, images, labels, norm="Linf", eps=8 / 255, steps=100,
          n_restarts=1, seed=0, rho=0.75, n_classes=10, generator=None,
          draws: Optional[Sequence[APGDDraws]] = None):
    """torchattacks/attacks/apgdt.py: one APGD run on the targeted DLR a
    target class (the 2nd .. n_classes-th most likely) and restart,
    keeping each sample's first success; `draws`: one `apgd_draws` a run,
    targets outer, restarts inner."""
    if norm not in ("Linf", "L2"):
        raise ValueError(norm)
    order, n_targets = _target_classes(model(images), n_classes)
    if draws is None:
        gen = _generator(generator, seed)
        draws = [apgd_draws(gen, images, norm)
                 for _ in range(n_targets * n_restarts)]
    adv = images
    fooled = torch.zeros(images.shape[0], dtype=torch.bool,
                         device=images.device)
    run = 0
    for tc in range(2, n_targets + 2):
        targets = order[:, -tc]
        loss_fn = lambda lg, t=targets: _dlr_loss_targeted(lg, labels, t)
        for _ in range(n_restarts):
            _, x_best_adv, found, _ = _apgd_single_run(
                model, images, labels, loss_fn, norm, eps, steps, rho,
                draws[run])
            run += 1
            adv = torch.where(_bshape(found & ~fooled), x_best_adv, adv)
            fooled = fooled | found
    return adv


# -- FAB ----------------------------------------------------------------------
def _proj_box_hyperplane(x, w, b, norm, n_bisect=50):
    """Each sample's min ||d||_p s.t. w.(x + d) = b, 0 <= x + d <= 1, for
    p in {Linf, L2}; x, w (B, ...), b (B,). The KKT form d = clip(x - t
    u, 0, 1) - x, u = sign(w) (L-inf) or w (L2) on the side of b, where
    w.clip(x - t u) is monotone in t: solved by 60 doublings of t from
    1e-3 (up to ~1e15) and n_bisect halvings. If b is out of the box's
    reach, the saturated d."""
    xf, wf = x.flatten(1), w.flatten(1)
    c = torch.sum(wf * xf, dim=1) - b
    s = torch.sign(torch.where(c == 0, torch.ones_like(c), c))
    u = s[:, None] * (torch.sign(wf) if norm == "Linf" else wf)

    def h(t):
        return torch.sum(wf * torch.clamp(xf - t[:, None] * u, 0.0, 1.0),
                         dim=1) - b

    t_hi = torch.full_like(c, 1e-3)
    for _ in range(60):
        t_hi = torch.where(h(t_hi) * c > 0, t_hi * 2.0, t_hi)
    lo, hi = torch.zeros_like(c), t_hi
    for _ in range(n_bisect):
        mid = (lo + hi) / 2.0
        same_side = h(mid) * c > 0
        lo, hi = torch.where(same_side, mid, lo), torch.where(same_side, hi,
                                                              mid)
    t = (lo + hi) / 2.0
    return (torch.clamp(xf - t[:, None] * u, 0.0, 1.0) - xf).view_as(x)


def _lp_norm(d, norm):
    """Per-sample L-inf or L2 norm of (B, ...) as (B,)."""
    return d.flatten(1).abs().amax(dim=1) if norm == "Linf" else _l2(d)


@dataclasses.dataclass
class FABDraws:
    """The random starts (B, C, H, W) of FAB's restarts 1 ..
    n_restarts - 1 (restart 0 starts at the images): 2u - 1 under
    L-inf, standard normal under L2 (`fab_draws`)."""

    starts: List[torch.Tensor]


def fab_draws(generator: torch.Generator, images, norm,
              n_restarts=1) -> FABDraws:
    return FABDraws([apgd_draws(generator, images, norm).t
                     for _ in range(n_restarts - 1)])


def _fab_single(model: Model, images, labels, norm, eps, steps, n_restarts,
                alpha_max, eta, beta, draws: FABDraws, target=None):
    B = images.shape[0]

    def closest_boundary(x):
        logits, jac = _jacobian(model, x)
        fk = logits - _rows(logits, labels)[:, None]
        wk = jac - _rows(jac, labels)[:, None]
        if target is not None:
            # targeted: always the target class's boundary (fab.py
            # attack_single_run_targeted)
            cls = target
        else:
            q = wk.flatten(2)
            qnorm = (q.abs().sum(dim=2) if norm == "Linf"
                     else torch.sqrt(torch.sum(q ** 2, dim=2)))
            dist = (fk.abs() / (qnorm + 1e-12)).scatter(
                1, labels[:, None], float("inf"))
            cls = dist.argmin(dim=1)
        w = _rows(wk, cls)
        return w, torch.sum((w * x).flatten(1), dim=1) - _rows(fk, cls)

    def is_adv(x):
        return model(x).argmax(dim=1) != labels

    def run(x_i):
        best = images
        best_norm = torch.full((B,), float("inf"), device=images.device)
        for _ in range(steps):
            w, bb = closest_boundary(x_i)
            # the iterate's and the original's projections in one call
            d = _proj_box_hyperplane(torch.cat([x_i, images]),
                                     torch.cat([w, w]), torch.cat([bb, bb]),
                                     norm)
            d_i, d_o = d[:B], d[B:]
            ni, no = _lp_norm(d_i, norm), _lp_norm(d_o, norm)
            alpha = _bshape(torch.clamp(ni / (ni + no + 1e-12), 0.0,
                                        alpha_max))
            x_new = torch.clamp((1 - alpha) * (x_i + eta * d_i)
                                + alpha * (images + eta * d_o), 0.0, 1.0)
            adv = is_adv(x_new)
            nrm = _lp_norm(x_new - images, norm)
            better = adv & (nrm < best_norm)
            best = torch.where(_bshape(better), x_new, best)
            best_norm = torch.where(better, nrm, best_norm)
            # the biased backward step towards the original on success
            # (fab.py:500-507)
            x_i = torch.where(_bshape(adv), beta * x_new + (1 - beta) * images,
                              x_new)
        return best, best_norm

    best = images
    best_norm = torch.full((B,), float("inf"), device=images.device)
    for r in range(n_restarts):
        if r == 0:
            x0 = images
        else:
            # a random point within eps / 2 (fab.py:436-448)
            t = _on(draws.starts[r - 1], images)
            x0 = torch.clamp(images + 0.5 * eps * t
                             / (_bshape(_lp_norm(t, norm)) + 1e-12), 0.0, 1.0)
        b_r, n_r = run(x0)
        best = torch.where(_bshape(n_r < best_norm), b_r, best)
        best_norm = torch.minimum(best_norm, n_r)

    # three bisections between the best adversarial and the original
    lo = images
    for _ in range(3):
        mid = (best + lo) / 2.0
        adv = _bshape(is_adv(mid))
        best, lo = torch.where(adv, mid, best), torch.where(adv, lo, mid)
    # only perturbations within eps are reported (fab.py:86-93)
    ok = torch.isfinite(best_norm) & (_lp_norm(best - images, norm) <= eps)
    return torch.where(_bshape(ok), best, images)


@torch.no_grad()
def fab(model: Model, images, labels, norm="Linf", eps=None, steps=100,
        n_restarts=1, alpha_max=0.1, eta=1.05, beta=0.9, seed=0,
        targeted=False, n_classes=10, generator=None, draws=None):
    """torchattacks/attacks/fab.py: the Fast Adaptive Boundary attack, a
    minimal-norm attack by iterated projection onto the linearised
    decision boundary with biased backward steps. eps defaults per norm
    as fab.py:57 ({Linf: 0.3, L2: 1.0}). targeted=True runs it once a
    target class (the 2nd .. n_classes-th most likely), projecting onto
    that class's boundary, and keeps each sample's smallest flipping
    perturbation. `draws`: a `FABDraws`, or one a target class when
    targeted."""
    if norm not in ("Linf", "L2"):
        raise ValueError(norm)
    if eps is None:
        eps = {"Linf": 0.3, "L2": 1.0}[norm]
    gen = _generator(generator, seed) if draws is None else None
    args = (norm, eps, steps, n_restarts, alpha_max, eta, beta)
    if not targeted:
        if draws is None:
            draws = fab_draws(gen, images, norm, n_restarts)
        return _fab_single(model, images, labels, *args, draws)
    B = images.shape[0]
    order, n_targets = _target_classes(model(images), n_classes)
    if draws is None:
        draws = [fab_draws(gen, images, norm, n_restarts)
                 for _ in range(n_targets)]
    best = images
    best_norm = torch.full((B,), float("inf"), device=images.device)
    for j, tc in enumerate(range(2, n_targets + 2)):
        adv = _fab_single(model, images, labels, *args, draws[j],
                          target=order[:, -tc])
        flipped = model(adv).argmax(dim=1) != labels
        nrm = _lp_norm(adv - images, norm)
        better = flipped & (nrm < best_norm)
        best = torch.where(_bshape(better), adv, best)
        best_norm = torch.where(better, nrm, best_norm)
    return best


# -- Square -------------------------------------------------------------------
def _square_margin_loss(model: Model, x, y, loss, targeted=False):
    """(margin, the loss minimised) (square.py:71-91)."""
    logits = model(x)
    one_hot = _one_hot(y, logits)
    y_corr = torch.sum(one_hot * logits, dim=1)
    y_others = torch.amax(torch.where(one_hot > 0, float("-inf"), logits),
                          dim=1)
    margin = (y_others - y_corr) if targeted else (y_corr - y_others)
    if loss == "ce":
        xent = _ce(logits, y)
        return margin, (xent if targeted else -xent)
    return margin, margin


def _square_schedule(n_queries, p_init, n_features, c, max_side,
                     rescale=True):
    """Each query's square side from the p schedule (square.py:160-186),
    clamped to `max_side` (the shorter image side - 1, square.py:215)."""
    sizes = np.zeros(n_queries, dtype=np.int32)
    for it in range(n_queries):
        t = int(it / n_queries * 10000) if rescale else it
        p = p_init
        for bound, div in ((8000, 512), (6000, 256), (4000, 128),
                           (2000, 64), (1000, 32), (500, 16),
                           (200, 8), (50, 4), (10, 2)):
            if t > bound:
                p = p_init / div
                break
        s_it = max(int(round(np.sqrt(p * n_features / c))), 1)
        sizes[it] = min(s_it, max_side)
    return sizes


def _rand_sign(generator, shape):
    return torch.sign(2.0 * torch.rand(shape, generator=generator) - 1.0
                      + 1e-12)


@dataclasses.dataclass
class SquareDraws:
    """Square L-inf: the initial stripes' signs (B, C, 1, W), and a
    query's square position vh, vw (n_queries,) int64 (shared by the
    batch, as in JAX) and its channel signs (n_queries, C)."""

    stripes: torch.Tensor
    vh: torch.Tensor
    vw: torch.Tensor
    signs: torch.Tensor


@dataclasses.dataclass
class SquareL2Draws:
    """Square L2: a 5x5 grid cell's pattern orientation (cells,) bool
    (True: upright, False: transposed) and signs (cells, B, C), in row
    order; a query's windows vh, vw, vh2, vw2 (n_queries,) int64, its
    pattern's orientation (n_queries,) bool and signs (n_queries, B,
    C)."""

    init_upright: torch.Tensor
    init_signs: torch.Tensor
    vh: torch.Tensor
    vw: torch.Tensor
    vh2: torch.Tensor
    vw2: torch.Tensor
    upright: torch.Tensor
    signs: torch.Tensor


def _square_sizes(images, norm, n_queries, p_init, rescale):
    C, H, W = images.shape[1:]
    if norm == "Linf":
        return _square_schedule(n_queries, p_init, C * H * W, C,
                                max(min(H, W) - 1, 1), rescale)
    return _square_l2_sizes(n_queries, p_init, C * H * W, C,
                            max(min(H, W) - 1, 3), rescale)


def _l2_grid(H, W):
    """The L2 init's grid: (side s0, [(vh, vw) of each whole cell])
    (square.py:325-343)."""
    s0 = max(H // 5, 1)
    sp = (H - (H // 5) * 5) // 2
    return s0, [(sp + gi * s0, sp + gj * s0)
                for gi in range(H // s0) for gj in range(W // s0)
                if sp + gi * s0 + s0 <= H and sp + gj * s0 + s0 <= W]


def square_draws(generator: torch.Generator, images, norm="Linf",
                 n_queries=5000, p_init=0.8, resc_schedule=True):
    B, C, H, W = images.shape
    sizes = _square_sizes(images, norm, n_queries, p_init, resc_schedule)
    span = lambda n: torch.tensor(
        [int(torch.randint(0, n - int(s) + 1, (), generator=generator))
         for s in sizes], dtype=torch.int64)
    if norm == "Linf":
        stripes = _rand_sign(generator, (B, C, 1, W))
        vh, vw = span(H), span(W)
        return SquareDraws(stripes, vh, vw,
                           _rand_sign(generator, (n_queries, C)))
    cells = len(_l2_grid(H, W)[1])
    init_upright = torch.rand(cells, generator=generator) > 0.5
    init_signs = _rand_sign(generator, (cells, B, C))
    vh, vw, vh2, vw2 = span(H), span(W), span(H), span(W)
    upright = torch.rand(n_queries, generator=generator) > 0.5
    return SquareL2Draws(init_upright, init_signs, vh, vw, vh2, vw2, upright,
                         _rand_sign(generator, (n_queries, B, C)))


@torch.no_grad()
def square(model: Model, images, labels, norm="Linf", eps=8 / 255,
           n_queries=5000, p_init=0.8, loss="margin", resc_schedule=True,
           seed=0, generator=None, draws=None, targeted=False):
    """torchattacks/attacks/square.py: the black-box random search. L-inf:
    vertical stripes, then one eps-signed square a query; L2
    (`_square_l2`): eta patterns on a grid, then mass moved between two
    windows a query. A query is kept where it lowers the loss or fools,
    for samples not yet fooled (square.py:202-214). `draws`:
    `square_draws`."""
    if norm not in ("Linf", "L2"):
        raise ValueError(norm)
    if loss not in ("margin", "ce"):
        raise ValueError(loss)
    if draws is None:
        draws = square_draws(_generator(generator, seed), images, norm,
                             n_queries, p_init, resc_schedule)
    sizes = _square_sizes(images, norm, n_queries, p_init,
                          resc_schedule).tolist()
    if norm == "L2":
        return _square_l2(model, images, labels, eps, sizes, loss, draws,
                          targeted)
    C = images.shape[1]
    x_best = torch.clamp(images + eps * _on(draws.stripes, images), 0.0, 1.0)
    margin_min, loss_min = _square_margin_loss(model, x_best, labels, loss,
                                               targeted)
    vh, vw = draws.vh.tolist(), draws.vw.tolist()
    deltas = 2.0 * eps * _on(draws.signs, images).view(-1, 1, C, 1, 1)
    for i, s in enumerate(sizes):
        x_new = x_best.clone()
        x_new[:, :, vh[i]:vh[i] + s, vw[i]:vw[i] + s] += deltas[i]
        x_new = torch.clamp(torch.clamp(x_new, images - eps, images + eps),
                            0.0, 1.0)
        margin, lo = _square_margin_loss(model, x_new, labels, loss,
                                         targeted)
        upd = ((lo < loss_min) | (margin <= 0.0)) & (margin_min > 0.0)
        x_best = torch.where(_bshape(upd), x_new, x_best)
        loss_min = torch.where(upd, lo, loss_min)
        margin_min = torch.where(upd, margin, margin_min)
    return x_best


def _eta_rectangles(x, y):
    """The concentric rectangles pattern (square.py:130-146)."""
    delta = np.zeros((x, y), np.float32)
    x_c, y_c = x // 2 + 1, y // 2 + 1
    cx, cy = x_c - 1, y_c - 1
    for counter in range(max(x_c, y_c)):
        delta[max(cx, 0):min(cx + 2 * counter + 1, x),
              max(cy, 0):min(cy + 2 * counter + 1, y)] += \
            1.0 / (counter + 1) ** 2
        cx -= 1
        cy -= 1
    return delta / np.sqrt((delta ** 2).sum())


def _eta(s):
    """The +/- rectangles pattern of side s (square.py:148-158), upright
    (the random transpose is applied where it is used)."""
    delta = np.zeros((s, s), np.float32)
    delta[:s // 2] = _eta_rectangles(s // 2, s)
    delta[s // 2:] = -_eta_rectangles(s - s // 2, s)
    return delta / np.sqrt((delta ** 2).sum())


def _square_l2_sizes(n_queries, p_init, n_features, c, max_side,
                     rescale=True):
    """The L2 side schedule: at least 3 and odd (square.py:300-302),
    clamped."""
    base = _square_schedule(n_queries, p_init, n_features, c, max_side,
                            rescale)
    sizes = np.maximum(base, 3)
    sizes = np.where(sizes % 2 == 0, sizes + 1, sizes)
    sizes = np.minimum(sizes, max_side if max_side % 2 else max_side - 1)
    return sizes.astype(np.int32)


def _square_l2(model: Model, images, labels, eps, sizes, loss,
               draws: SquareL2Draws, targeted):
    """Square L2 (square.py:325-439): eta patterns on a 5x5 grid with
    random signs, then each query zeroes one random window's mass and
    moves it, with a fresh eta pattern, into another, keeping
    ||delta||_2 = eps."""
    B, C, H, W = images.shape
    dev = images.device
    etas = {s: torch.from_numpy(_eta(s)).to(dev) for s in set(sizes)}
    orient = lambda p, up: p if up else p.T

    s0, cells = _l2_grid(H, W)
    eta0 = torch.from_numpy(_eta(s0)).to(dev)
    delta = torch.zeros_like(images)
    init_signs = _on(draws.init_signs, images)
    for j, (vh, vw) in enumerate(cells):
        pat = orient(eta0, bool(draws.init_upright[j]))
        delta[:, :, vh:vh + s0, vw:vw + s0] += pat * init_signs[j].view(
            B, C, 1, 1)
    x_best = torch.clamp(
        images + delta / (_bshape(_l2(delta)) + 1e-12) * eps, 0.0, 1.0)
    margin_min, loss_min = _square_margin_loss(model, x_best, labels, loss,
                                               targeted)
    vh, vw = draws.vh.tolist(), draws.vw.tolist()
    vh2, vw2 = draws.vh2.tolist(), draws.vw2.tolist()
    upright = draws.upright.tolist()
    signs = _on(draws.signs, images)
    for i, s in enumerate(sizes):
        w1 = (slice(None), slice(None), slice(vh[i], vh[i] + s),
              slice(vw[i], vw[i] + s))
        w2 = (slice(None), slice(None), slice(vh2[i], vh2[i] + s),
              slice(vw2[i], vw2[i] + s))
        delta_curr = x_best - images
        win1 = delta_curr[w1]
        norms_w1 = torch.sqrt(torch.sum(win1 ** 2, dim=(2, 3), keepdim=True))
        both = torch.zeros((H, W), device=dev)
        both[w1[2:]] = 1.0
        both[w2[2:]] = 1.0
        norms_windows = _bshape(_l2(delta_curr * both))
        # a fresh eta pattern at window 1, randomly transposed, signed a
        # channel (square.py:320-323)
        new = orient(etas[s], upright[i]) * signs[i].view(B, C, 1, 1) \
            + win1 / (norms_w1 + 1e-12)
        nd_norm = torch.sqrt(torch.sum(new ** 2, dim=(2, 3), keepdim=True))
        budget = torch.sqrt(
            torch.clamp(eps ** 2 - _bshape(_l2(delta_curr)) ** 2, min=0.0)
            / C + norms_windows ** 2)
        delta_new = delta_curr.clone()
        delta_new[w2] = 0.0
        delta_new[w1] = new / (nd_norm + 1e-12) * budget
        x_new = torch.clamp(
            images + delta_new / (_bshape(_l2(delta_new)) + 1e-12) * eps,
            0.0, 1.0)
        margin, lo = _square_margin_loss(model, x_new, labels, loss,
                                         targeted)
        upd = ((lo < loss_min) | (margin <= 0.0)) & (margin_min > 0.0)
        x_best = torch.where(_bshape(upd), x_new, x_best)
        loss_min = torch.where(upd, lo, loss_min)
        margin_min = torch.where(upd, margin, margin_min)
    return x_best


# -- ensembles ----------------------------------------------------------------
@torch.no_grad()
def multiattack(attacks: Sequence[Callable], model: Model, images, labels):
    """torchattacks/attacks/multiattack.py: the attacks in turn, each
    sample keeping the first adversarial one found; each entry is
    `fn(images, labels) -> adv`. Stops once every sample is fooled (one
    host read an attack)."""
    adv = images
    fooled = torch.zeros(images.shape[0], dtype=torch.bool,
                         device=images.device)
    for fn in attacks:
        cand = fn(images, labels)
        is_adv = model(cand).argmax(dim=1) != labels
        adv = torch.where(_bshape(is_adv & ~fooled), cand, adv)
        fooled = fooled | is_adv
        if bool(fooled.all()):
            break
    return adv


def autoattack(model: Model, images, labels, norm="Linf", eps=8 / 255,
               n_classes=10, seed=0, version="standard",
               square_queries=5000, steps=100):
    """torchattacks/attacks/autoattack.py: `multiattack` ensembles.
    standard: APGD-CE, APGD-T, FAB, Square (autoattack.py:48-54); plus:
    5-restart APGD-CE, APGD-DLR and FAB, Square, APGD-T, targeted FAB
    (:56-64); rand: APGD-CE and APGD-DLR with eot_iter 20 for randomised
    defences (:66-70). `steps`: the APGD, APGD-T and FAB iterations (100
    in the reference and in JAX)."""
    if norm not in ("Linf", "L2"):
        raise ValueError(norm)
    kw = dict(norm=norm, eps=eps, seed=seed)

    def _apgd(loss, nr=1, eot=1):
        return lambda x, y: apgd(model, x, y, loss=loss, n_restarts=nr,
                                 eot_iter=eot, steps=steps, **kw)

    def _apgdt():
        return lambda x, y: apgdt(model, x, y, n_classes=n_classes,
                                  n_restarts=1, steps=steps, **kw)

    def _fab(nr=1, targeted=False):
        return lambda x, y: fab(model, x, y, n_restarts=nr, targeted=targeted,
                                n_classes=n_classes, steps=steps, **kw)

    def _square():
        return lambda x, y: square(model, x, y, n_queries=square_queries,
                                   **kw)

    if version == "standard":
        fns = [_apgd("ce"), _apgdt(), _fab(), _square()]
    elif version == "plus":
        fns = [_apgd("ce", nr=5), _apgd("dlr", nr=5), _fab(nr=5), _square(),
               _apgdt(), _fab(targeted=True)]
    elif version == "rand":
        fns = [_apgd("ce", eot=20), _apgd("dlr", eot=20)]
    else:
        raise ValueError("Not valid version. ['standard', 'plus', 'rand']")
    return multiattack(fns, model, images, labels)
