"""The port's classifier attacks (`attacks/classifier.py`) against the JAX
package's, on JAX's tiny linear classifier (tests/classifier_common.py:
B 4, 8x8x3, 3 classes, random labels as tests/test_classifier_attacks.py
draws them), every draw rebuilt from JAX's keys and injected; and BIM
through a small ResNet-18 classifier at 32x32 with flax's weights, whose
input gradient runs the stem pool's plain backward.

Tolerances, measured on this CPU:

* every attack's output: ADV_ATOL = 1e-5 absolute (float32 products in
  another order: the linear logits, softmax, CW's Adam in tanh space,
  DeepFool's Jacobian; 2.4e-7 measured on the sign attacks, 1.2e-6 on
  CW, 6.0e-7 on DeepFool, 6.0e-8 on TIFGSM's smoothing, 0 on OnePixel);
  a signed step splits nowhere on this model (its gradient is
  W[:, y] - softmax-weighted W, far from 0 at every texel);
* DeepFool's boundary classes, its predictions off ties, and the
  pixels OnePixel changes: equal;
* the ResNet-18 BIM: the logits 1e-4 relative (deep float32 features, as
  tests/test_torch_models.py holds them), the first step's input
  gradient rtol 1e-3 with an atol of 1e-3 of its largest magnitude
  (tests/test_torch_attack_eval.py's rule), and the adversarial images
  after 2 steps by the sign-split rule of the PGD texels: at most
  SPLIT_SHARE of the values differ, by at most two steps of alpha.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.attacks import classifier as jatk
from depthmodelhardening_tpu_torch.attacks import classifier as atk
from depthmodelhardening_tpu_torch.attacks.classifier import (
    DiversityDraws, JitterDraws, L2StartDraws, NoiseDraws, OnePixelDraws,
)

from classifier_common import (
    B, H, W, accuracy, j_linear, labels_t, linear_setup, nchw, nhwc,
    resnet_classifier,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

NC = 3
ADV_ATOL = 1e-5
SPLIT_SHARE = 2e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    wm, model, x, y = linear_setup(NC, own_labels=False)
    return dict(wm=wm, model=model, x=x, y=y, xt=nchw(x), yt=labels_t(y))


def _close(got, want, atol=ADV_ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=atol,
                               rtol=0)


def _box(adv, x, eps):
    assert float((adv - x).abs().max()) <= eps + 1e-6
    assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0


def _uniform(key, x, eps):
    return NoiseDraws(nchw(jax.random.uniform(key, x.shape, minval=-eps,
                                              maxval=eps)))


def _normal(key, x):
    return NoiseDraws(nchw(jax.random.normal(key, x.shape)))


def _diversity(key, x, steps, resize_rate=0.9, prob=0.5, start_eps=None):
    """difgsm's / tifgsm's draws from JAX's keys (fold_in(rng, i), split
    3: top, left, use)."""
    low_h, low_w = int(H * resize_rate), int(W * resize_rate)
    top, left, use = [], [], []
    for i in range(steps):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i), 3)
        top.append(int(jax.random.randint(k1, (), 0, H - low_h + 1)))
        left.append(int(jax.random.randint(k2, (), 0, W - low_w + 1)))
        use.append(bool(jax.random.uniform(k3, ()) < prob))
    start = (None if start_eps is None
             else _uniform(key, x, start_eps).noise)
    return DiversityDraws(torch.tensor(top), torch.tensor(left),
                          torch.tensor(use), start)


# (name, kwargs, draws from (key, x)): JAX's default key PRNGKey(0)
LINF = [
    ("fgsm", dict(eps=0.1), None),
    ("bim", dict(eps=0.1, alpha=0.03, steps=5), None),
    ("rfgsm", dict(eps=0.1, alpha=0.03, steps=5), _normal),
    ("pgd", dict(eps=0.1, alpha=0.03, steps=5),
     functools.partial(_uniform, eps=0.1)),
    ("eotpgd", dict(eps=0.1, alpha=0.03, steps=3, eot_iter=2),
     functools.partial(_uniform, eps=0.1)),
    ("ffgsm", dict(eps=0.1, alpha=0.15), functools.partial(_uniform, eps=0.1)),
    ("mifgsm", dict(eps=0.1, alpha=0.03, steps=5), None),
    ("difgsm", dict(eps=0.1, alpha=0.05, steps=3, decay=1.0),
     lambda k, x: _diversity(k, x, 3)),
    ("upgd", dict(eps=0.1, alpha=0.05, steps=3), None),
    ("upgd", dict(eps=0.1, alpha=0.05, steps=3, random_start=True,
                  loss_type="margin"), functools.partial(_uniform, eps=0.1)),
    ("tifgsm", dict(eps=0.1, alpha=0.03, steps=5, len_kernel=5, nsig=3),
     lambda k, x: _diversity(k, x, 5)),
    ("tifgsm", dict(eps=0.1, alpha=0.03, steps=4, len_kernel=4,
                    kernel_name="linear", random_start=True,
                    diversity_prob=1.0),
     lambda k, x: _diversity(k, x, 4, prob=1.0, start_eps=0.1)),
]


@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("name,kwargs,draw", LINF,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(LINF)])
def test_linf_attack_matches_jax(setup, name, kwargs, draw, targeted):
    """Each L-inf attack from JAX's draws: the same images, inside the
    eps-box and [0, 1]; untargeted ones raise no accuracy, targeted ones
    (towards label + 1) lower no target accuracy."""
    x, y, xt, yt = setup["x"], setup["y"], setup["xt"], setup["yt"]
    kw = dict(kwargs)
    lab, labt = (y, yt) if not targeted else ((y + 1) % NC, (yt + 1) % NC)
    want = getattr(jatk, name)(j_linear, setup["wm"], x, lab,
                               targeted=targeted, **kw)
    if draw is not None:
        kw["draws"] = draw(KEY, x)
    got = getattr(atk, name)(setup["model"], xt, labt, targeted=targeted,
                             **kw)
    _close(got, want)
    _box(got, xt, kwargs["eps"])
    model = setup["model"]
    if targeted:
        assert accuracy(model, got, labt) >= accuracy(model, xt, labt)
    else:
        assert accuracy(model, got, yt) <= accuracy(model, xt, yt)


def test_pgdl2_matches_jax_inside_the_ball(setup):
    """PGDL2 from JAX's direction and radius (split(rng): normal, then
    uniform (B, 1, 1, 1)): the same images, inside the L2 ball of eps."""
    x, y = setup["x"], setup["y"]
    kn, kr = jax.random.split(KEY)
    draws = L2StartDraws(nchw(jax.random.normal(kn, x.shape)),
                         torch.from_numpy(np.array(jax.random.uniform(
                             kr, (B, 1, 1, 1)))).view(B))
    want = jatk.pgdl2(j_linear, setup["wm"], x, y, eps=1.0, alpha=0.3,
                      steps=5)
    got = atk.pgdl2(setup["model"], setup["xt"], setup["yt"], eps=1.0,
                    alpha=0.3, steps=5, draws=draws)
    _close(got, want)
    d = (got - setup["xt"]).flatten(1)
    assert float(d.norm(dim=1).max()) <= 1.0 + 1e-4
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_tpgd_gn_and_vanila_match_jax(setup):
    """TPGD (the KL to the clean prediction, from 0.001 of JAX's normal
    draw), GN (std 0.05 of its normal draw) and the identity."""
    x, xt = setup["x"], setup["xt"]
    want = jatk.tpgd(j_linear, setup["wm"], x, eps=0.1, alpha=0.03, steps=3)
    got = atk.tpgd(setup["model"], xt, draws=_normal(KEY, x), eps=0.1,
                   alpha=0.03, steps=3)
    _close(got, want)
    _box(got, xt, 0.1)
    want = jatk.gn(x, std=0.05)
    got = atk.gn(xt, draws=_normal(KEY, x), std=0.05)
    _close(got, want)
    assert float((got - xt).abs().mean()) > 0
    assert atk.vanila(xt) is xt


def test_jitter_matches_jax(setup):
    """Jitter from JAX's start and each step's softmax noise
    (fold_in(rng, 1000 + i))."""
    x, y = setup["x"], setup["y"]
    steps = 3
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(KEY, 1000 + i), (B, NC))) for i in range(steps)])
    draws = JitterDraws(_uniform(KEY, x, 0.1).noise, torch.from_numpy(noise))
    want = jatk.jitter(j_linear, setup["wm"], x, y, eps=0.1, alpha=0.05,
                       steps=steps)
    got = atk.jitter(setup["model"], setup["xt"], setup["yt"], eps=0.1,
                     alpha=0.05, steps=steps, draws=draws)
    _close(got, want)
    _box(got, setup["xt"], 0.1)


@pytest.fixture(scope="module")
def own(setup):
    """The linear model's own predictions as labels (DeepFool's and
    SparseFool's regime: every sample correctly classified)."""
    y = jnp.argmax(j_linear(setup["wm"], setup["x"]), 1)
    return y, labels_t(y)


@pytest.mark.parametrize("targeted", [False, True])
def test_cw_matches_jax(setup, own, targeted):
    """CW (c 5, 30 Adam steps of 0.05) on the model's own labels: the
    same best images; untargeted it lowers the accuracy, targeted
    (towards label + 1) it raises the target's. (Where a sample is
    already on the goal's side at the start, the margin term is flat and
    the first gradient is the L2 term of tanh(atanh(x)) - x, pure
    rounding, which Adam's normalisation turns into full steps of lr:
    such a sample's iterate follows the rounding of tanh, in JAX as
    here.)"""
    x, xt = setup["x"], setup["xt"]
    y, yt = own
    lab, labt = (y, yt) if not targeted else ((y + 1) % NC, (yt + 1) % NC)
    want = jatk.cw(j_linear, setup["wm"], x, lab, c=5.0, steps=30, lr=0.05,
                   targeted=targeted)
    got = atk.cw(setup["model"], xt, labt, c=5.0, steps=30, lr=0.05,
                 targeted=targeted)
    _close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    model = setup["model"]
    if targeted:
        assert accuracy(model, got, labt) > accuracy(model, xt, labt)
    else:
        assert accuracy(model, got, yt) < accuracy(model, xt, yt)


def _same_predictions_off_ties(model, got, want_logits, tie=1e-4):
    """The port's predictions equal JAX's wherever JAX's top two logits
    are further apart than `tie` (DeepFool's clipped iterates can settle
    on a boundary, where rounding picks the side)."""
    top2 = np.sort(want_logits, axis=1)[:, -2:]
    off_tie = top2[:, 1] - top2[:, 0] > tie
    with torch.no_grad():
        pred = model(got).argmax(1).numpy()
    np.testing.assert_array_equal(pred[off_tie],
                                  want_logits.argmax(1)[off_tie])


def test_deepfool_matches_jax(setup, own):
    """DeepFool (20 steps): the same images, boundary classes and
    predictions off ties, in [0, 1]; without target labels the same
    images."""
    y, yt = own
    want, want_tl = jatk.deepfool(j_linear, setup["wm"], setup["x"], y,
                                  steps=20, return_target_labels=True)
    got, tl = atk.deepfool(setup["model"], setup["xt"], yt, steps=20,
                           return_target_labels=True)
    _close(got, want)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(want_tl))
    _same_predictions_off_ties(setup["model"], got,
                               np.asarray(j_linear(setup["wm"], want)))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert torch.equal(atk.deepfool(setup["model"], setup["xt"], yt,
                                    steps=20), got)


def test_sparsefool_matches_jax_and_is_sparse(setup, own):
    """SparseFool (10 steps, DeepFool 20): the same images; it fools, and
    a fooled sample differs in under half of its values."""
    y, yt = own
    want = jatk.sparsefool(j_linear, setup["wm"], setup["x"], y, steps=10,
                           deepfool_steps=20)
    got = atk.sparsefool(setup["model"], setup["xt"], yt, steps=10,
                         deepfool_steps=20)
    _close(got, want)
    fooled = setup["model"](got).argmax(1) != yt
    assert bool(fooled.any())
    changed = ((got - setup["xt"]).abs() > 1e-6).flatten(1).float().mean(1)
    assert float(changed[fooled].max()) < 0.5
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def _onepixel_draws(key, x, pixels, steps, popsize):
    """OnePixel's draws from JAX's keys: split(rng, B) a sample; per
    sample split -> the population's uniforms; per generation
    split(fold_in(key, i), 3) -> F, r1, r2."""
    D = pixels * 5
    N = max(1, popsize // D) * D
    init, f, r1, r2 = [], [], [], []
    for kb in jax.random.split(key, x.shape[0]):
        k0, kb = jax.random.split(kb)
        init.append(np.asarray(jax.random.uniform(k0, (N, D))))
        fs, a, b = [], [], []
        for i in range(steps):
            kf, k1, k2 = jax.random.split(jax.random.fold_in(kb, i), 3)
            fs.append(float(jax.random.uniform(kf, (), minval=0.5,
                                               maxval=1.0)))
            a.append(np.asarray(jax.random.randint(k1, (N,), 0, N)))
            b.append(np.asarray(jax.random.randint(k2, (N,), 0, N)))
        f.append(fs)
        r1.append(a)
        r2.append(b)
    t = lambda v, dt: torch.from_numpy(np.array(v)).to(dt)
    return OnePixelDraws(t(init, torch.float32), t(f, torch.float32),
                         t(r1, torch.int64), t(r2, torch.int64))


@pytest.mark.parametrize("targeted", [False, True])
def test_onepixel_matches_jax_and_changes_at_most_k_pixels(setup, targeted):
    """OnePixel (2 pixels, 8 generations of 40): the same images; at most
    2 pixels change; the label's probability does not rise (targeted:
    the target's does not fall)."""
    x, y, xt, yt = setup["x"], setup["y"], setup["xt"], setup["yt"]
    kw = dict(pixels=2, steps=8, popsize=40, targeted=targeted)
    want = jatk.onepixel(j_linear, setup["wm"], x, y, **kw)
    got = atk.onepixel(setup["model"], xt, yt,
                       draws=_onepixel_draws(KEY, x, 2, 8, 40), **kw)
    _close(got, want)
    diff = ((got - xt).abs() > 1e-6).any(dim=1)
    np.testing.assert_array_equal(
        diff.numpy(), np.any(np.abs(np.asarray(want - x)) > 1e-6, axis=-1))
    assert int(diff.flatten(1).sum(1).max()) <= 2
    with torch.no_grad():
        p = lambda a: torch.softmax(setup["model"](a), 1)[torch.arange(B), yt]
        if targeted:
            assert float(p(got).mean()) >= float(p(xt).mean()) - 1e-6
        else:
            assert float(p(got).mean()) <= float(p(xt).mean()) + 1e-6


def test_bim_through_a_resnet18_classifier_matches_jax():
    """BIM for 2 steps through a ResNet-18 classifier at 32x32 (flax's
    weights, converted): the logits, the first step's input gradient,
    which runs the stem pool's plain backward, and the images by the
    split rule. JAX's three results come from one jitted program."""
    logits_fn, v, model = resnet_classifier()
    x = jax.random.uniform(jax.random.PRNGKey(5), (2, 32, 32, 3))
    kw = dict(eps=8 / 255, alpha=2 / 255, steps=2)

    @jax.jit
    def reference(x):
        lg = logits_fn(v, x)
        y = jnp.argmax(lg, 1)
        return (lg, jatk._loss_grad(logits_fn, v, x, y, False),
                jatk.bim(logits_fn, v, x, y, **kw))

    lg_j, g_j, want = (np.asarray(a) for a in reference(x))
    xt = nchw(x)
    with torch.no_grad():
        lg = model(xt)
    np.testing.assert_allclose(lg.numpy(), lg_j, rtol=1e-4,
                               atol=1e-4 * np.abs(lg_j).max())
    yt = labels_t(lg_j.argmax(1))
    g = nhwc(atk._loss_grad(model, xt, yt, False))
    np.testing.assert_allclose(g, g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    assert np.abs(g_j).max() > 0  # the softmax is not saturated
    got = atk.bim(model, xt, yt, **kw)
    _box(got, xt, 8 / 255)
    assert float((got - xt).abs().max()) > 0
    d = np.abs(nhwc(got) - want)
    assert d.max() <= 2 * 2 / 255 + 1e-6
    assert (d > 1e-5).mean() <= SPLIT_SHARE, (d > 1e-5).mean()
