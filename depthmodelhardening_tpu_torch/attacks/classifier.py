"""The stock classifier attacks (torchattacks' surface), NCHW.

Counterpart of `depthmodelhardening_tpu/attacks/classifier.py`. The
reference vendors torchattacks v3.2.2, whose classifier attacks no
pipeline code calls (torchattacks/__init__.py:1-36); this is their
gradient core: FGSM, BIM, RFGSM, PGD, PGDL2, EOTPGD, FFGSM, TPGD,
MIFGSM, GN, VANILA, CW, DeepFool, DIFGSM, Jitter, UPGD, TIFGSM,
SparseFool and OnePixel (JAX's compact best/1 differential evolution,
not SciPy's). The AutoAttack family lives in `classifier_auto.py`.

Interface, in PyTorch's idiom where JAX has `logits_fn(variables, x)` on
NHWC: `model(images) -> logits (B, n_classes)` on images (B, C, H, W) in
[0, 1]; labels int64 (B,). The model is run as given: put it in eval
mode, so that a sample's logits depend on that sample alone (DeepFool,
SparseFool and FAB take a whole batch's Jacobian with one backward pass
a class). `targeted=True` flips the loss's sign, as torchattacks does
(attack.py:60-108). Every attack runs under `torch.no_grad` and takes
input gradients with `torch.autograd.grad` only, so no parameter
gets a gradient.

Random draws: an attack that draws takes `generator` (a CPU
`torch.Generator`; `None` seeds one with 0, as JAX's `rng=None` takes
`PRNGKey(0)`) or its draws, a dataclass of CPU tensors that a caller
fills, e.g. from JAX's keys (random streams cannot be matched). The
draws are moved to the images' device once.

Loops: the fixed-length ones run on the device without a host read.
DeepFool and SparseFool's outer loop end when every sample is done
(JAX's per-sample `while_loop`s): finished samples are masked with
`torch.where`, and one host read an iteration (whether all are done)
ends the loop, against an iteration of n_classes + 2 model passes.
SparseFool's one-coordinate linear solver reads back every
`SOLVER_CHECK_EVERY` of its iterations instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Model = Callable[[torch.Tensor], torch.Tensor]

# SparseFool's linear solver: iterations between host reads of whether
# any sample still walks (its iterations are a few elementwise passes)
SOLVER_CHECK_EVERY = 32
# OnePixel: perturbed images a forward pass takes at most
ONEPIXEL_CHUNK = 1024


def _generator(generator: Optional[torch.Generator], seed: int = 0):
    return (torch.Generator().manual_seed(seed) if generator is None
            else generator)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float draw on `like`'s device and dtype."""
    return t.to(device=like.device, dtype=like.dtype)


def _ce(logits, labels):
    return -F.log_softmax(logits, dim=1).gather(1, labels[:, None])[:, 0]


def _grad(loss_fn: Callable[[torch.Tensor], torch.Tensor], x):
    """d loss_fn(x) / d x for a scalar loss."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), x)
    return g


def _loss_grad(model: Model, images, labels, targeted: bool):
    """The gradient of the batch's mean cross entropy, negated when
    targeted."""
    def loss(x):
        lo = _ce(model(x), labels).mean()
        return -lo if targeted else lo
    return _grad(loss, images)


def _linf_step(adv, images, g, alpha, eps):
    """A signed step of alpha, projected into the eps-box and [0, 1]."""
    adv = adv + alpha * torch.sign(g)
    delta = torch.clamp(adv - images, -eps, eps)
    return torch.clamp(images + delta, 0.0, 1.0)


def _mean_abs_normalise(g, floor: float = 0.0):
    return g / (g.abs().mean(dim=(1, 2, 3), keepdim=True) + floor)


def _l2(x):
    """Per-sample L2 norm of (B, ...) as (B,)."""
    return torch.sqrt(torch.sum(x.flatten(1) ** 2, dim=1))


def _bshape(v):
    return v.view(-1, 1, 1, 1)


def _one_hot(labels, logits):
    return F.one_hot(labels, logits.shape[-1]).to(logits.dtype)


# -- draws --------------------------------------------------------------------
@dataclasses.dataclass
class NoiseDraws:
    """One draw the images' shape (B, C, H, W), CPU float32: the uniform
    random start in [-eps, eps) (PGD, EOTPGD, FFGSM, Jitter, UPGD,
    TIFGSM: `uniform_start`) or standard normal noise (RFGSM, TPGD, GN:
    `normal_noise`)."""

    noise: torch.Tensor


def uniform_start(generator: torch.Generator, images, eps) -> NoiseDraws:
    u = torch.rand(tuple(images.shape), generator=generator)
    return NoiseDraws(u * (2.0 * eps) - eps)


def normal_noise(generator: torch.Generator, images) -> NoiseDraws:
    return NoiseDraws(torch.randn(tuple(images.shape), generator=generator))


@dataclasses.dataclass
class L2StartDraws:
    """PGDL2's random start: a standard normal direction (B, C, H, W) and
    a uniform radius fraction (B,)."""

    direction: torch.Tensor
    radius: torch.Tensor


def l2_start(generator: torch.Generator, images) -> L2StartDraws:
    return L2StartDraws(
        torch.randn(tuple(images.shape), generator=generator),
        torch.rand((images.shape[0],), generator=generator))


@dataclasses.dataclass
class JitterDraws:
    """Jitter's uniform start (B, C, H, W) in [-eps, eps) and the normal
    noise (steps, B, n_classes) added to each step's softmax."""

    start: torch.Tensor
    logit_noise: torch.Tensor


@dataclasses.dataclass
class DiversityDraws:
    """DI-FGSM's input diversity, one draw a step (steps,): the pasted
    image's top and left (int64) and whether the step diversifies
    (bool); TIFGSM's uniform start (B, C, H, W) where it starts at
    random."""

    top: torch.Tensor
    left: torch.Tensor
    use: torch.Tensor
    start: Optional[torch.Tensor] = None


def diversity_draws(generator: torch.Generator, images, steps: int,
                    resize_rate: float, diversity_prob: float,
                    start_eps: Optional[float] = None) -> DiversityDraws:
    H, W = images.shape[2:]
    low_h, low_w = _low_size(H, W, resize_rate)
    top = torch.randint(0, H - low_h + 1, (steps,), generator=generator)
    left = torch.randint(0, W - low_w + 1, (steps,), generator=generator)
    use = torch.rand((steps,), generator=generator) < diversity_prob
    start = (None if start_eps is None
             else uniform_start(generator, images, start_eps).noise)
    return DiversityDraws(top, left, use, start)


@dataclasses.dataclass
class OnePixelDraws:
    """OnePixel's differential evolution: the initial population's
    uniforms (B, N, D) in [0, 1), and a generation's dithered F (B,
    steps) in [0.5, 1) and donors r1, r2 (B, steps, N) in [0, N)."""

    init: torch.Tensor
    f: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor


def onepixel_draws(generator: torch.Generator, images, pixels: int = 1,
                   steps: int = 75, popsize: int = 400) -> OnePixelDraws:
    B = images.shape[0]
    N, D = _onepixel_population(images.shape[1], pixels, popsize)
    init = torch.rand((B, N, D), generator=generator)
    f = torch.rand((B, steps), generator=generator) * 0.5 + 0.5
    r1 = torch.randint(0, N, (B, steps, N), generator=generator)
    r2 = torch.randint(0, N, (B, steps, N), generator=generator)
    return OnePixelDraws(init, f, r1, r2)


# -- gradient-sign attacks ----------------------------------------------------
@torch.no_grad()
def fgsm(model: Model, images, labels, eps=8 / 255, targeted=False):
    """torchattacks/attacks/fgsm.py."""
    g = _loss_grad(model, images, labels, targeted)
    return torch.clamp(images + eps * torch.sign(g), 0.0, 1.0)


@torch.no_grad()
def bim(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
        steps=10, targeted=False):
    """torchattacks/attacks/bim.py: iterative FGSM, clamped each step
    into the eps-box around the original and [0, 1]."""
    lo = torch.clamp(images - eps, min=0.0)
    hi = torch.clamp(images + eps, max=1.0)
    adv = images
    for _ in range(steps):
        g = _loss_grad(model, adv, labels, targeted)
        adv = torch.minimum(hi, torch.maximum(lo, adv + alpha * torch.sign(g)))
    return adv


@torch.no_grad()
def rfgsm(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
          steps=10, generator=None, draws: Optional[NoiseDraws] = None,
          targeted=False):
    """torchattacks/attacks/rfgsm.py: a random signed step of eps -
    alpha (`normal_noise`), then FGSM steps."""
    if draws is None:
        draws = normal_noise(_generator(generator), images)
    adv = torch.clamp(images + (eps - alpha) * torch.sign(
        _on(draws.noise, images)), 0.0, 1.0)
    for _ in range(steps):
        g = _loss_grad(model, adv, labels, targeted)
        adv = _linf_step(adv, images, g, alpha, eps)
    return adv


@torch.no_grad()
def pgd(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
        steps=10, random_start=True, generator=None,
        draws: Optional[NoiseDraws] = None, targeted=False):
    """torchattacks/attacks/pgd.py (`uniform_start`)."""
    adv = images
    if random_start:
        if draws is None:
            draws = uniform_start(_generator(generator), images, eps)
        adv = torch.clamp(images + _on(draws.noise, images), 0.0, 1.0)
    for _ in range(steps):
        g = _loss_grad(model, adv, labels, targeted)
        adv = _linf_step(adv, images, g, alpha, eps)
    return adv


@torch.no_grad()
def pgdl2(model: Model, images, labels, eps=1.0, alpha=0.2, steps=10,
          random_start=True, generator=None,
          draws: Optional[L2StartDraws] = None, targeted=False,
          eps_div=1e-10):
    """torchattacks/attacks/pgdl2.py: normalised gradient steps, the
    perturbation scaled back into the eps-ball (`l2_start`)."""
    adv = images
    if random_start:
        if draws is None:
            draws = l2_start(_generator(generator), images)
        d = _on(draws.direction, images)
        r = _bshape(_on(draws.radius, images))
        adv = torch.clamp(images + d * r / _bshape(_l2(d)) * eps, 0.0, 1.0)
    for _ in range(steps):
        g = _loss_grad(model, adv, labels, targeted)
        adv = adv + alpha * g / (_bshape(_l2(g)) + eps_div)
        delta = adv - images
        factor = torch.clamp(eps / torch.clamp(_l2(delta), min=eps_div),
                             max=1.0)
        adv = torch.clamp(images + delta * _bshape(factor), 0.0, 1.0)
    return adv


@torch.no_grad()
def eotpgd(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
           steps=10, eot_iter=2, generator=None,
           draws: Optional[NoiseDraws] = None, targeted=False):
    """torchattacks/attacks/eotpgd.py: PGD on the mean of eot_iter
    gradients, each from its own model call (a stochastic model, such as
    a randomised defence, draws anew in each; a deterministic one gives
    PGD). The start is `uniform_start`."""
    if draws is None:
        draws = uniform_start(_generator(generator), images, eps)
    adv = torch.clamp(images + _on(draws.noise, images), 0.0, 1.0)
    for _ in range(steps):
        g = torch.stack([_loss_grad(model, adv, labels, targeted)
                         for _ in range(eot_iter)]).mean(dim=0)
        adv = _linf_step(adv, images, g, alpha, eps)
    return adv


@torch.no_grad()
def ffgsm(model: Model, images, labels, eps=8 / 255, alpha=10 / 255,
          generator=None, draws: Optional[NoiseDraws] = None,
          targeted=False):
    """torchattacks/attacks/ffgsm.py: a random start (`uniform_start`)
    and one signed step."""
    if draws is None:
        draws = uniform_start(_generator(generator), images, eps)
    adv = torch.clamp(images + _on(draws.noise, images), 0.0, 1.0)
    g = _loss_grad(model, adv, labels, targeted)
    return _linf_step(adv, images, g, alpha, eps)


@torch.no_grad()
def tpgd(model: Model, images, generator=None,
         draws: Optional[NoiseDraws] = None, eps=8 / 255, alpha=2 / 255,
         steps=10):
    """torchattacks/attacks/tpgd.py: PGD on KL(clean || adv) (TRADES),
    from the images plus 0.001 times `normal_noise` (not clamped)."""
    if draws is None:
        draws = normal_noise(_generator(generator), images)
    logit_ori = model(images)
    p_ori = torch.softmax(logit_ori, dim=1)
    logp_ori = F.log_softmax(logit_ori, dim=1)

    def kl(x):
        logp = F.log_softmax(model(x), dim=1)
        return torch.sum(p_ori * (logp_ori - logp)) / x.shape[0]

    adv = images + 0.001 * _on(draws.noise, images)
    for _ in range(steps):
        adv = _linf_step(adv, images, _grad(kl, adv), alpha, eps)
    return adv


@torch.no_grad()
def mifgsm(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
           steps=10, decay=1.0, targeted=False):
    """torchattacks/attacks/mifgsm.py: momentum on the mean-|g|
    normalised gradient."""
    adv, momentum = images, torch.zeros_like(images)
    for _ in range(steps):
        g = _mean_abs_normalise(_loss_grad(model, adv, labels, targeted))
        momentum = g + decay * momentum
        adv = _linf_step(adv, images, momentum, alpha, eps)
    return adv


@torch.no_grad()
def gn(images, generator=None, draws: Optional[NoiseDraws] = None,
       std=0.1):
    """torchattacks/attacks/gn.py: additive Gaussian noise
    (`normal_noise`)."""
    if draws is None:
        draws = normal_noise(_generator(generator), images)
    return torch.clamp(images + std * _on(draws.noise, images), 0.0, 1.0)


def vanila(images):
    """torchattacks/attacks/vanila.py: the identity."""
    return images


# -- CW -----------------------------------------------------------------------
def _margin(logits, labels, targeted, kappa):
    one_hot = _one_hot(labels, logits)
    real = torch.sum(one_hot * logits, dim=1)
    other = torch.amax(logits - one_hot * 1e4, dim=1)
    d = other - real if targeted else real - other
    return torch.clamp(d, min=-kappa)


@torch.no_grad()
def cw(model: Model, images, labels, c=1.0, kappa=0.0, steps=50, lr=0.01,
       targeted=False):
    """torchattacks/attacks/cw.py: Carlini-Wagner L2 in tanh space with
    the f6 margin objective, Adam (optax's, b1 0.9, b2 0.999, eps 1e-8)
    on the tanh-space variable; keeps each sample's smallest successful
    perturbation (the images where none succeeds). The forward that
    checks step i's iterate is step i + 1's gradient pass."""
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    w = torch.atanh(torch.clamp(images * 2.0 - 1.0, -1 + 1e-6, 1 - 1e-6))
    mu, nu = torch.zeros_like(w), torch.zeros_like(w)
    best = images
    best_l2 = torch.full((images.shape[0],), 1e10, device=images.device)

    def decode(w):
        return (torch.tanh(w) + 1.0) / 2.0

    def forward(w, need_grad):
        with torch.set_grad_enabled(need_grad):
            w = w.detach().requires_grad_(need_grad)
            adv = decode(w)
            l2 = torch.sum((adv - images) ** 2, dim=(1, 2, 3))
            logits = model(adv)
        return w, adv, l2, logits

    wr, adv, l2, logits = forward(w, steps > 0)
    for t in range(1, steps + 1):
        with torch.enable_grad():
            loss = torch.sum(l2 + c * _margin(logits, labels, targeted,
                                              kappa))
            (g,) = torch.autograd.grad(loss, wr)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        mu_hat = mu / (1 - torch.tensor(b1) ** t)
        nu_hat = nu / (1 - torch.tensor(b2) ** t)
        w = w + mu_hat / (torch.sqrt(nu_hat) + adam_eps) * (-lr)
        wr, adv, l2, logits = forward(w, t < steps)
        pred = logits.argmax(dim=1)
        succ = (pred == labels) if targeted else (pred != labels)
        better = succ & (l2.detach() < best_l2)
        best = torch.where(_bshape(better), adv.detach(), best)
        best_l2 = torch.where(better, l2.detach(), best_l2)
    return best


# -- DeepFool -----------------------------------------------------------------
def _jacobian(model: Model, x):
    """(logits (B, K), d logits / d x (B, K, C, H, W)): one backward pass
    a class for the whole batch, which holds while a sample's logits
    depend on that sample alone (an eval-mode model)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        logits = model(xr)
        K = logits.shape[1]
        jac = torch.stack([
            torch.autograd.grad(logits[:, k].sum(), xr,
                                retain_graph=k < K - 1)[0]
            for k in range(K)], dim=1)
    return logits.detach(), jac


def _rows(t, idx):
    """t[b, idx[b]] for every b."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _deepfool_step(model: Model, x, labels, overshoot):
    """One DeepFool step of every sample: (the pushed iterate, the class
    of the nearest linearised boundary)."""
    logits, jac = _jacobian(model, x)
    fk = logits - _rows(logits, labels)[:, None]
    wk = jac - _rows(jac, labels)[:, None]
    norms = torch.linalg.vector_norm(wk.flatten(2), dim=2) + 1e-8
    dist = (fk.abs() / norms).scatter(1, labels[:, None], float("inf"))
    nearest = dist.argmin(dim=1)
    r = _bshape(_rows(fk, nearest).abs() / _rows(norms, nearest) ** 2) \
        * _rows(wk, nearest)
    return torch.clamp(x + (1 + overshoot) * r, 0.0, 1.0), nearest


@torch.no_grad()
def deepfool(model: Model, images, labels, steps=50, overshoot=0.02,
             return_target_labels=False):
    """torchattacks/attacks/deepfool.py: each sample pushed across its
    nearest linearised boundary until its prediction leaves its label,
    for at most `steps` steps. `return_target_labels` (deepfool.py:44,
    for SparseFool) also returns each sample's last boundary class
    (int64, 0 where it never stepped)."""
    x = images
    done = torch.zeros(images.shape[0], dtype=torch.bool,
                       device=images.device)
    boundary = torch.zeros_like(labels)
    for _ in range(steps):
        x_new, nearest = _deepfool_step(model, x, labels, overshoot)
        fooled = model(x_new).argmax(dim=1) != labels
        active = ~done
        x = torch.where(_bshape(active), x_new, x)
        boundary = torch.where(active, nearest, boundary)
        done = done | (active & fooled)
        if bool(done.all()):
            break
    return (x, boundary) if return_target_labels else x


# -- input diversity (DI-FGSM, TI-FGSM) ---------------------------------------
def _low_size(H: int, W: int, resize_rate: float) -> Tuple[int, int]:
    if resize_rate < 1:
        return int(H * resize_rate), int(W * resize_rate)
    return H, W


def _input_diversity(x, top: int, left: int, use: bool, low_h: int,
                     low_w: int):
    """DI-FGSM's random resize and pad (difgsm.py:28-46), shared by
    difgsm and tifgsm: x resized to (low_h, low_w) (bilinear,
    half-pixel, no antialiasing) and pasted into zeros at (top, left),
    where the step diversifies. The size is one per attack, as JAX has
    it (the reference draws one a step)."""
    if not use:
        return x
    small = F.interpolate(x, size=(low_h, low_w), mode="bilinear",
                          align_corners=False, antialias=False)
    return F.pad(small, (left, x.shape[3] - low_w - left,
                         top, x.shape[2] - low_h - top))


def _diverse_momentum(model, images, labels, adv, draws, resize_rate,
                      steps, alpha, eps, decay, targeted, smooth=None):
    """The DI/TI-FGSM loop: momentum on the mean-|g| normalised gradient
    (optionally smoothed first) of the diversified input's loss."""
    low_h, low_w = _low_size(*images.shape[2:], resize_rate)
    top, left, use = (draws.top.tolist(), draws.left.tolist(),
                      draws.use.tolist())
    momentum = torch.zeros_like(images)
    for i in range(steps):
        def loss(a):
            lo = _ce(model(_input_diversity(a, top[i], left[i], use[i],
                                            low_h, low_w)), labels).mean()
            return -lo if targeted else lo

        g = _grad(loss, adv)
        if smooth is not None:
            g = smooth(g)
        momentum = _mean_abs_normalise(g, 1e-12) + decay * momentum
        adv = _linf_step(adv, images, momentum, alpha, eps)
    return adv


@torch.no_grad()
def difgsm(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
           steps=10, decay=0.0, resize_rate=0.9, diversity_prob=0.5,
           generator=None, draws: Optional[DiversityDraws] = None,
           targeted=False):
    """torchattacks/attacks/difgsm.py: MI-FGSM on a randomly resized and
    padded input each step (`diversity_draws`)."""
    if draws is None:
        draws = diversity_draws(_generator(generator), images, steps,
                                resize_rate, diversity_prob)
    return _diverse_momentum(model, images, labels, images, draws,
                             resize_rate, steps, alpha, eps, decay, targeted)


@torch.no_grad()
def jitter(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
           steps=10, scale=10.0, std=0.1, generator=None,
           draws: Optional[JitterDraws] = None):
    """torchattacks/attacks/jitter.py: PGD on the Jitter loss (the
    scaled, norm-divided logits' softmax plus noise, its MSE to the
    one-hot label, divided by the perturbation's L2 norm). Without
    draws, the start is drawn first and each step's noise as the step
    runs."""
    gen = _generator(generator)
    start = (uniform_start(gen, images, eps).noise if draws is None
             else draws.start)
    adv = torch.clamp(images + _on(start, images), 0.0, 1.0)
    for i in range(steps):
        def loss(a):
            logits = model(a)
            norm_z = torch.linalg.vector_norm(logits, dim=1, keepdim=True)
            hat_z = torch.softmax(scale * logits / (norm_z + 1e-12), dim=1)
            noise = (torch.randn(tuple(hat_z.shape), generator=gen)
                     if draws is None else draws.logit_noise[i])
            hat_z = hat_z + std * _on(noise, hat_z)
            f = torch.mean((hat_z - _one_hot(labels, logits)) ** 2, dim=1)
            dn = _l2(a - images)
            f = torch.where(dn > 0, f / (dn + 1e-12), f)
            return f.mean()

        adv = _linf_step(adv, images, _grad(loss, adv), alpha, eps)
    return adv


@torch.no_grad()
def upgd(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
         steps=10, decay=1.0, generator=None,
         draws: Optional[NoiseDraws] = None, targeted=False,
         random_start=False, loss_type="ce"):
    """torchattacks/attacks/upgd.py: "ultimate" PGD, momentum with the
    cross entropy or the margin loss, optionally from `uniform_start`."""
    adv = images
    if random_start:
        if draws is None:
            draws = uniform_start(_generator(generator), images, eps)
        adv = torch.clamp(images + _on(draws.noise, images), 0.0, 1.0)

    def loss(a):
        logits = model(a)
        if loss_type == "margin":
            one_hot = _one_hot(labels, logits)
            real = torch.sum(one_hot * logits, dim=1)
            other = torch.amax(logits - one_hot * 1e4, dim=1)
            lo = torch.mean(other - real)
        else:
            lo = _ce(logits, labels).mean()
        return -lo if targeted else lo

    momentum = torch.zeros_like(images)
    for _ in range(steps):
        momentum = _mean_abs_normalise(_grad(loss, adv), 1e-12) \
            + decay * momentum
        adv = _linf_step(adv, images, momentum, alpha, eps)
    return adv


# -- TI-FGSM ------------------------------------------------------------------
def _ti_kernel(kernel_name="gaussian", len_kernel=15, nsig=3):
    """The translation-invariance kernel (tifgsm.py:70-101): gaussian,
    uniform or linear, summing to 1 (float32, (len, len))."""
    if kernel_name == "gaussian":
        x = torch.linspace(-nsig, nsig, len_kernel)
        k1 = torch.exp(-0.5 * x * x)
        kern = torch.outer(k1, k1)
    elif kernel_name == "uniform":
        kern = torch.ones(len_kernel, len_kernel)
    elif kernel_name == "linear":
        r = 1.0 - torch.abs(torch.linspace(-1.0, 1.0, len_kernel))
        kern = torch.outer(r, r)
    else:
        raise ValueError(kernel_name)
    return kern / torch.sum(kern)


def _depthwise_smooth(g, kern):
    """g (B, C, H, W) convolved channel by channel with `kern`, SAME
    zero padding (an even kernel pads one more after, as XLA does)."""
    C = g.shape[1]
    kh, kw = kern.shape
    k = kern.to(device=g.device, dtype=g.dtype).expand(C, 1, kh, kw)
    g = F.pad(g, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(g, k, groups=C)


@torch.no_grad()
def tifgsm(model: Model, images, labels, eps=8 / 255, alpha=2 / 255,
           steps=20, decay=0.0, kernel_name="gaussian", len_kernel=15,
           nsig=3, resize_rate=0.9, diversity_prob=0.5, random_start=False,
           generator=None, draws: Optional[DiversityDraws] = None,
           targeted=False):
    """torchattacks/attacks/tifgsm.py: DI-FGSM whose gradient is smoothed
    by a depthwise kernel (`_ti_kernel`) before its normalisation
    (`diversity_draws`, with the start where `random_start`)."""
    if draws is None:
        draws = diversity_draws(_generator(generator), images, steps,
                                resize_rate, diversity_prob,
                                eps if random_start else None)
    kern = _ti_kernel(kernel_name, len_kernel, nsig)
    adv = images
    if random_start:
        adv = torch.clamp(images + _on(draws.start, images), 0.0, 1.0)
    return _diverse_momentum(model, images, labels, adv, draws,
                             resize_rate, steps, alpha, eps, decay, targeted,
                             smooth=lambda g: _depthwise_smooth(g, kern))


# -- SparseFool ---------------------------------------------------------------
def _sparsefool_linear_solver(x0, coord_vec, boundary_point):
    """The L1-greedy projection onto each sample's linearised boundary
    (sparsefool.py:96-129): walk the coordinate of largest |w| left, one
    at a time, by what would reach the plane (at least 1e-4, clipped to
    [0, 1]), until the side of w.(x - x_b) flips or no coordinate is
    left. Batched: (B, ...) tensors, a finished sample masked.

    The coordinates are taken in one stable sort of |w| (the order of
    JAX's argmax over what is left). Every SOLVER_CHECK_EVERY steps the
    host reads which samples still walk, and ends a walk whose rest is
    known: every remaining step then saturates its coordinate at the
    bound its sign points to and the side never flips, which holds on the
    far side of the plane once u = w.(x - x_b) + 0.001 >= the next |w|
    (u then at least doubles or grows by |w| room each step, and |w|
    only shrinks), and on the near side once w.(x - x_b) plus every
    remaining coordinate's |w| room stays below 0 (then no step
    reaches the plane). The walk can otherwise take a step a coordinate,
    150528 at 3x224x224."""
    B = x0.shape[0]
    normal = coord_vec.flatten(1)
    bpf = boundary_point.flatten(1)
    x_i = x0.flatten(1).clone()
    rows = torch.arange(B, device=x0.device)
    order = torch.sort(normal.abs(), dim=1, descending=True,
                       stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=x0.device).expand_as(
            order))
    nonzero = (normal != 0).sum(dim=1)
    bound = (normal > 0).to(x_i.dtype)  # where each coordinate saturates
    sign_true = torch.sign(torch.sum(normal * (x_i - bpf), dim=1))
    beta = 0.001 * sign_true
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    n = 0
    while True:
        dot = torch.sum(normal * (x_i - bpf), dim=1)
        active = (torch.sign(dot) == sign_true) & (n < nonzero) & ~done
        if n % SOLVER_CHECK_EVERY == 0:
            if not bool(active.any()):
                break
            rest = rank >= n
            far = (sign_true > 0) & (dot + beta >= normal.gather(
                1, order[:, n:n + 1].clamp(max=order.shape[1] - 1))[:, 0]
                .abs())
            room = torch.where(normal > 0, 1.0 - x_i, x_i)
            near = (sign_true < 0) & (dot + torch.sum(
                torch.where(rest, normal.abs() * room, 0.0), dim=1) < -1e-6)
            ends = active & (far | near)
            x_i = torch.where(ends[:, None] & rest & (normal != 0), bound,
                              x_i)
            done = done | ends
            active = active & ~ends
        idx = order[:, min(n, order.shape[1] - 1)]
        c_idx = normal[rows, idx]
        pert = (dot + beta).abs() / (c_idx.abs() + 1e-12)
        step = torch.clamp(pert, min=1e-4) * torch.sign(c_idx)
        x_idx = x_i[rows, idx]
        x_i[rows, idx] = torch.where(
            active, torch.clamp(x_idx + step, 0.0, 1.0), x_idx)
        n += 1
    return x_i.view_as(x0)


@torch.no_grad()
def sparsefool(model: Model, images, labels, steps=20, lam=3.0,
               overshoot=0.02, deepfool_steps=50):
    """torchattacks/attacks/sparsefool.py: a sparse (L0) attack. Each
    outer step takes DeepFool's boundary point, moves lam times as far,
    and projects back from the images with the one-coordinate linear
    solver; a sample already misclassified at a step's start keeps its
    iterate and stops (sparsefool.py:64-68)."""
    x = images
    done = torch.zeros(images.shape[0], dtype=torch.bool,
                       device=images.device)
    for _ in range(steps):
        pre0 = model(x).argmax(dim=1)
        df, boundary = deepfool(model, x, labels, deepfool_steps, 0.02,
                                return_target_labels=True)
        x_b = x + lam * (df - x)
        pre = model(x_b).argmax(dim=1)
        pre = torch.where(pre == labels, boundary, pre)

        def cost(a):
            lg = model(a)
            return torch.sum(_rows(lg, pre) - _rows(lg, labels))

        g = _grad(cost, x_b)
        g = g / (_bshape(_l2(g)) + 1e-12)
        x_new = _sparsefool_linear_solver(images, g, x_b)
        x_new = torch.clamp(images + (1 + overshoot) * (x_new - images),
                            0.0, 1.0)
        fooled = pre0 != labels
        active = ~done
        x = torch.where(_bshape(active & ~fooled), x_new, x)
        done = done | (active & fooled)
        if bool(done.all()):
            break
    return x


# -- OnePixel -----------------------------------------------------------------
def _onepixel_population(C: int, pixels: int, popsize: int):
    """(N members, D dimensions): SciPy's population size is popmul
    times the dimensions (onepixel.py:61-62)."""
    D = pixels * (2 + C)
    return max(1, popsize // D) * D, D


def _onepixel_perturb(images, members, pixels: int):
    """images (B, C, H, W), members (B, M, D) -> (B, M, C, H, W): each
    member's `pixels` pixels (row, col, values) set in turn
    (onepixel.py:125-140); a coordinate truncates to its pixel."""
    B, C, H, W = images.shape
    M = members.shape[1]
    out = images[:, None].expand(B, M, C, H, W).clone()
    bi = torch.arange(B, device=images.device)[:, None].expand(B, M)
    mi = torch.arange(M, device=images.device)[None].expand(B, M)
    for p in range(pixels):
        base = p * (2 + C)
        r = members[..., base].long()
        c = members[..., base + 1].long()
        out[bi, mi, :, r, c] = members[..., base + 2:base + 2 + C]
    return out


@torch.no_grad()
def onepixel(model: Model, images, labels, pixels=1, steps=75, popsize=400,
             generator=None, draws: Optional[OnePixelDraws] = None,
             targeted=False):
    """torchattacks/attacks/onepixel.py: a black-box L0 attack on (row,
    col, values) of `pixels` pixels by differential evolution. The
    reference drives a SciPy DE port (best1bin, recombination 1, no
    polish); as in JAX this is best/1 with a dithered F in [0.5, 1) and
    full crossover, the whole population of every sample scored in
    forward passes of at most ONEPIXEL_CHUNK images a generation
    (`onepixel_draws`). Minimises the label's probability (targeted: 1
    minus it)."""
    B, C, H, W = images.shape
    N, D = _onepixel_population(C, pixels, popsize)
    if draws is None:
        draws = onepixel_draws(_generator(generator), images, pixels, steps,
                               popsize)
    dev = images.device
    lo = torch.tensor([0.0, 0.0] + [0.0] * C, device=dev).repeat(pixels)
    hi = torch.tensor([H - 1e-3, W - 1e-3] + [1.0] * C,
                      device=dev).repeat(pixels)
    rows = torch.arange(B, device=dev)

    def fitness(pop):
        advs = _onepixel_perturb(images, pop, pixels).flatten(0, 1)
        logits = torch.cat([model(a) for a in advs.split(ONEPIXEL_CHUNK)])
        p = torch.softmax(logits, dim=1).view(B, -1, logits.shape[1])
        p = p.gather(2, labels.view(B, 1, 1).expand(B, p.shape[1], 1))[..., 0]
        return 1.0 - p if targeted else p

    pop = lo + (hi - lo) * draws.init.to(dev)
    fit = fitness(pop)
    f, r1, r2 = draws.f.to(dev), draws.r1.to(dev), draws.r2.to(dev)
    for i in range(steps):
        best = pop[rows, fit.argmin(dim=1)]
        donors = pop[rows[:, None], r1[:, i]] - pop[rows[:, None], r2[:, i]]
        trial = torch.clamp(best[:, None] + f[:, i, None, None] * donors,
                            lo, hi)
        fit_t = fitness(trial)
        better = fit_t < fit
        pop = torch.where(better[..., None], trial, pop)
        fit = torch.where(better, fit_t, fit)
    return _onepixel_perturb(images, pop[rows, fit.argmin(dim=1)][:, None],
                             pixels)[:, 0]
