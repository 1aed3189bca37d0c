"""The port's AutoAttack family (`attacks/classifier_auto.py`) against the
JAX package's, on JAX's tiny linear classifier with 4 classes and the
model's own labels (tests/test_classifier_auto.py's setup,
tests/classifier_common.py), every draw rebuilt from JAX's keys and
injected.

Tolerances, measured on this CPU:

* the DLR losses, the projections and FAB's hyperplane projection:
  1e-5 relative + 1e-6 absolute (float32 reductions in another order;
  4.8e-7 measured on the projection);
* every attack's output: ADV_ATOL = 1e-5 absolute (2.4e-7 measured on
  APGD, 6.0e-7 on FAB, 1.2e-7 on Square);
* the schedules (APGD's checkpoints, Square's sides, the eta patterns),
  target orders and the attacks an ensemble runs: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.attacks import classifier_auto as jauto
from depthmodelhardening_tpu_torch.attacks import classifier_auto as auto
from depthmodelhardening_tpu_torch.attacks.classifier_auto import (
    APGDDraws, FABDraws, SquareDraws, SquareL2Draws,
)

from classifier_common import (
    B, H, W, accuracy, j_linear, labels_t, linear_setup, nchw, nhwc,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

NC = 4
ADV_ATOL = 1e-5
RNG = jax.random.PRNGKey(0)  # the attacks' seed=0


@pytest.fixture(scope="module")
def setup():
    wm, model, x, y = linear_setup(NC, own_labels=True)
    return dict(wm=wm, model=model, x=x, y=y, xt=nchw(x), yt=labels_t(y))


def _close(got, want, atol=ADV_ATOL):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=atol,
                               rtol=0)


def _norms(adv, x):
    d = (adv - x).flatten(1)
    return d.abs().amax(1), d.norm(dim=1)


def _in_box(adv, x, eps, norm):
    linf, l2 = _norms(adv, x)
    assert float((linf if norm == "Linf" else l2).max()) <= eps + 1e-5
    assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# -- losses and helpers ---------------------------------------------------------
def test_losses_targets_and_projection_match_jax():
    """The DLR losses, the target order (ties included) and both norms'
    projections on random logits and images."""
    rs = np.random.RandomState(0)
    lg = rs.standard_normal((6, 5)).astype(np.float32)
    lg[0, 1] = lg[0, 3]  # a tie: the stable order keeps index order
    y = np.array([0, 1, 2, 3, 4, 1])
    t = np.array([2, 2, 0, 1, 3, 4])
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    close(auto._dlr_loss(_t(lg), _t(y, torch.int64)),
          jauto._dlr_loss(jnp.asarray(lg), jnp.asarray(y)))
    close(auto._dlr_loss_targeted(_t(lg), _t(y, torch.int64),
                                  _t(t, torch.int64)),
          jauto._dlr_loss_targeted(jnp.asarray(lg), jnp.asarray(y),
                                   jnp.asarray(t)))
    for n_classes in (3, 10):
        order, n = auto._target_classes(_t(lg), n_classes)
        j_order, j_n = jauto._target_classes(jnp.asarray(lg), n_classes)
        assert n == j_n
        np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    x = rs.rand(3, 4, 4, 3).astype(np.float32)
    z = x + rs.standard_normal(x.shape).astype(np.float32)
    for norm, eps in (("Linf", 0.1), ("L2", 0.5)):
        close(nhwc(auto._project(norm, nchw(z), nchw(x), eps)),
              jauto._project(norm, jnp.asarray(z), jnp.asarray(x), eps))


@pytest.mark.parametrize("steps", [1, 10, 25, 100, 250])
def test_apgd_checkpoints_match_jax(steps):
    mask, win = auto._apgd_checkpoints(steps)
    j_mask, j_win = jauto._apgd_checkpoints(steps)
    np.testing.assert_array_equal(mask, np.asarray(j_mask))
    np.testing.assert_array_equal(win, np.asarray(j_win))


def test_proj_box_hyperplane_matches_jax_and_meets_the_plane():
    """Both norms, batched in the port, against JAX's per-sample
    bisection: the same d; w.(x + d) = b and x + d in [0, 1]."""
    k = jax.random.PRNGKey(3)
    x = jax.random.uniform(k, (3, 10))
    w = jax.random.normal(jax.random.fold_in(k, 1), (3, 10))
    b = jnp.sum(w * x, 1) - jnp.array([0.5, -0.3, 0.0])
    for norm in ("Linf", "L2"):
        want = np.stack([np.asarray(jauto._proj_box_hyperplane(
            x[i], w[i], b[i], norm)) for i in range(3)])
        d = auto._proj_box_hyperplane(_t(x), _t(w), _t(b), norm)
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-6)
        z = _t(x) + d
        assert float((torch.sum(_t(w) * z, 1) - _t(b)).abs().max()) < 1e-3
        assert float(z.min()) >= -1e-6 and float(z.max()) <= 1 + 1e-6
        np.testing.assert_allclose(
            auto._lp_norm(d, norm).numpy(),
            [float(jauto._lp_norm(jnp.asarray(r), norm)) for r in d.numpy()],
            rtol=1e-6)


# -- APGD, APGD-T -------------------------------------------------------------
def _apgd_t(key, x, norm):
    if norm == "Linf":
        return APGDDraws(nchw(2.0 * jax.random.uniform(key, x.shape) - 1.0))
    return APGDDraws(nchw(jax.random.normal(key, x.shape)))


APGD_CASES = [
    dict(norm="Linf", eps=0.1, steps=20),
    dict(norm="L2", eps=1.0, steps=20),
    dict(norm="Linf", eps=0.05, steps=5, loss="dlr", n_restarts=2),
    dict(norm="Linf", eps=0.1, steps=8, eot_iter=3),
]


@pytest.mark.parametrize("kw", APGD_CASES,
                         ids=["linf", "l2", "dlr-restarts", "eot"])
def test_apgd_matches_jax(setup, kw):
    """APGD from JAX's restart draws (fold_in(rng, r)): the same images,
    inside the ball; it lowers the accuracy. eot_iter 3 on this
    deterministic model averages three equal gradients (JAX takes one).
    The DLR case stops at 5 steps: by step 10 one sample's DLR sits on
    its plateau of 1 (its label's logit third: (z0 - z_y) / (z0 - z2)),
    1 up to an ulp either way, and the checkpoint's count of rising
    steps compares those ulps."""
    x, xt = setup["x"], setup["xt"]
    want = jauto.apgd(j_linear, setup["wm"], x, setup["y"], **kw)
    draws = [_apgd_t(jax.random.fold_in(RNG, r), x, kw["norm"])
             for r in range(kw.get("n_restarts", 1))]
    got = auto.apgd(setup["model"], xt, setup["yt"], draws=draws, **kw)
    _close(got, want)
    _in_box(got, xt, kw["eps"], kw["norm"])
    assert accuracy(setup["model"], got, setup["yt"]) < 1.0


@pytest.mark.parametrize("norm,eps", [("Linf", 0.15), ("L2", 1.0)])
def test_apgdt_matches_jax(setup, norm, eps):
    """APGD-T over the 3 other classes (fold_in(rng, tc * 1000 + r))."""
    x, xt = setup["x"], setup["xt"]
    kw = dict(norm=norm, eps=eps, steps=10, n_classes=NC)
    want = jauto.apgdt(j_linear, setup["wm"], x, setup["y"], **kw)
    draws = [_apgd_t(jax.random.fold_in(RNG, tc * 1000), x, norm)
             for tc in range(2, NC + 1)]
    got = auto.apgdt(setup["model"], xt, setup["yt"], draws=draws, **kw)
    _close(got, want)
    _in_box(got, xt, eps, norm)
    assert accuracy(setup["model"], got, setup["yt"]) < 1.0


# -- FAB ------------------------------------------------------------------------
def _fab_draws(rng, x, norm, n_restarts):
    """FAB's restart starts: split(rng, B) a sample, fold_in(key, r)."""
    keys = jax.random.split(rng, x.shape[0])
    starts = []
    for r in range(1, n_restarts):
        t = [jax.random.uniform(jax.random.fold_in(k, r), x.shape[1:]) * 2.0
             - 1.0 if norm == "Linf" else
             jax.random.normal(jax.random.fold_in(k, r), x.shape[1:])
             for k in keys]
        starts.append(nchw(jnp.stack(t)))
    return FABDraws(starts)


FAB_CASES = [
    dict(norm="Linf", eps=0.3, steps=20),
    dict(norm="L2", eps=2.0, steps=15),
    dict(norm="Linf", eps=0.3, steps=5, n_restarts=2),
    dict(norm="Linf", eps=0.3, steps=5, targeted=True, n_classes=NC),
]


@pytest.mark.parametrize("kw", FAB_CASES,
                         ids=["linf", "l2", "restarts", "targeted"])
def test_fab_matches_jax(setup, kw):
    """FAB from JAX's restart draws (targeted: fold_in(rng, tc) a
    target): the same images; a flipped sample lies within eps, the
    others are returned as they were."""
    x, xt, yt = setup["x"], setup["xt"], setup["yt"]
    want = jauto.fab(j_linear, setup["wm"], x, setup["y"], **kw)
    nr = kw.get("n_restarts", 1)
    if kw.get("targeted"):
        draws = [_fab_draws(jax.random.fold_in(RNG, tc), x, kw["norm"], nr)
                 for tc in range(2, NC + 1)]
    else:
        draws = _fab_draws(RNG, x, kw["norm"], nr)
    got = auto.fab(setup["model"], xt, yt, draws=draws, **kw)
    _close(got, want)
    _in_box(got, xt, kw["eps"], kw["norm"])
    flipped = setup["model"](got).argmax(1) != yt
    assert bool(flipped.any())
    assert torch.equal(got[~flipped], xt[~flipped])


# -- Square ---------------------------------------------------------------------
def _rand_sign(key, shape):
    return jnp.sign(2.0 * jax.random.uniform(key, shape) - 1.0 + 1e-12)


def _square_draws(rng, x, n_queries, p_init=0.8):
    k_init, rng = jax.random.split(rng)
    sizes = jauto._square_schedule(n_queries, p_init, H * W * 3, 3,
                                   min(H, W) - 1)
    keys = [jax.random.split(jax.random.fold_in(rng, i), 3)
            for i in range(n_queries)]
    vh = [int(jax.random.randint(k[0], (), 0, max(H - s, 0) + 1))
          for k, s in zip(keys, sizes)]
    vw = [int(jax.random.randint(k[1], (), 0, max(W - s, 0) + 1))
          for k, s in zip(keys, sizes)]
    signs = np.stack([np.asarray(_rand_sign(k[2], (1, 1, 1, 3))).reshape(3)
                      for k in keys])
    stripes = nchw(_rand_sign(k_init, (x.shape[0], 1, W, 3)))
    return SquareDraws(stripes, _t(vh, torch.int64), _t(vw, torch.int64),
                       _t(signs))


def _square_l2_draws(rng, x, n_queries, p_init=0.8):
    k_init, rng = jax.random.split(rng)
    sizes = jauto._square_l2_sizes(n_queries, p_init, H * W * 3, 3,
                                   max(min(H, W) - 1, 3))
    s0 = H // 5
    sp = (H - s0 * 5) // 2
    up0, sg0 = [], []
    for gi in range(H // s0):
        for gj in range(W // s0):
            if sp + gi * s0 + s0 > H or sp + gj * s0 + s0 > W:
                continue
            kt, ks = jax.random.split(jax.random.fold_in(k_init,
                                                         gi * 1000 + gj))
            up0.append(bool(jax.random.uniform(kt, ()) > 0.5))
            sg0.append(np.asarray(_rand_sign(ks, (B, 1, 1, 3))).reshape(B, 3))
    f = {n: [] for n in ("vh", "vw", "vh2", "vw2", "up", "sg")}
    for i, sv in enumerate(sizes):
        k1, k2, k3, k4, k5 = jax.random.split(jax.random.fold_in(rng, i), 5)
        f["vh"].append(int(jax.random.randint(k1, (), 0, H - sv + 1)))
        f["vw"].append(int(jax.random.randint(k2, (), 0, W - sv + 1)))
        f["vh2"].append(int(jax.random.randint(k3, (), 0, H - sv + 1)))
        f["vw2"].append(int(jax.random.randint(k4, (), 0, W - sv + 1)))
        f["up"].append(bool(jax.random.uniform(k5, ()) > 0.5))
        f["sg"].append(np.asarray(_rand_sign(jax.random.fold_in(k5, 1),
                                             (B, 1, 1, 3))).reshape(B, 3))
    i64 = lambda v: _t(v, torch.int64)
    return SquareL2Draws(torch.tensor(up0), _t(sg0), i64(f["vh"]),
                         i64(f["vw"]), i64(f["vh2"]), i64(f["vw2"]),
                         torch.tensor(f["up"]), _t(f["sg"]))


@pytest.mark.parametrize("norm,eps,n_queries,loss",
                         [("Linf", 0.1, 100, "margin"),
                          ("L2", 1.0, 60, "margin"),
                          ("Linf", 0.1, 40, "ce")])
def test_square_matches_jax(setup, norm, eps, n_queries, loss):
    """Square from JAX's stripes or grid, windows and signs: the same
    images, inside the ball; the accuracy does not rise."""
    x, xt, yt = setup["x"], setup["xt"], setup["yt"]
    kw = dict(norm=norm, eps=eps, n_queries=n_queries, loss=loss)
    want = jauto.square(j_linear, setup["wm"], x, setup["y"], **kw)
    draws = (_square_draws(RNG, x, n_queries) if norm == "Linf"
             else _square_l2_draws(RNG, x, n_queries))
    got = auto.square(setup["model"], xt, yt, draws=draws, **kw)
    _close(got, want)
    _in_box(got, xt, eps, norm)
    assert accuracy(setup["model"], got, yt) <= accuracy(setup["model"], xt,
                                                         yt)


def test_square_schedules_and_patterns_match_jax():
    for n, side in ((100, 7), (5000, 223), (60, 7)):
        np.testing.assert_array_equal(
            auto._square_schedule(n, 0.8, 3 * 224 * 224, 3, side),
            jauto._square_schedule(n, 0.8, 3 * 224 * 224, 3, side))
        np.testing.assert_array_equal(
            auto._square_l2_sizes(n, 0.8, 3 * side ** 2, 3, side),
            jauto._square_l2_sizes(n, 0.8, 3 * side ** 2, 3, side))
    for s in (1, 3, 8, 9, 45):
        np.testing.assert_array_equal(auto._eta(s), jauto._eta(s))
    np.testing.assert_array_equal(auto._eta_rectangles(4, 7),
                                  jauto._eta_rectangles(4, 7))
    pat = auto._eta(9)
    assert abs(float((pat ** 2).sum()) - 1.0) < 1e-5
    assert (pat[:4] >= 0).all() and (pat[4:] <= 0).all()


# -- ensembles ------------------------------------------------------------------
def test_multiattack_keeps_the_first_success(setup):
    """An attack that never fools, then one that fools some samples,
    then one that fools all: every sample keeps the first adversarial
    image found, the last attack still runs (not all fooled before it),
    and an ensemble stops once all are fooled."""
    xt, yt, model = setup["xt"], setup["yt"], setup["model"]
    first = auto.apgd(model, xt, yt, eps=0.03, steps=5)
    strong = auto.apgd(model, xt, yt, eps=0.3, steps=10)
    assert 0 < int((model(first).argmax(1) != yt).sum()) < B
    calls = []

    def attack(name, out):
        def fn(x, y):
            calls.append(name)
            return out
        return fn

    adv = auto.multiattack([attack("weak", xt), attack("first", first),
                            attack("strong", strong),
                            attack("after", xt + 0.5)], model, xt, yt)
    assert calls == ["weak", "first", "strong"]
    hit = model(first).argmax(1) != yt
    assert torch.equal(adv[hit], first[hit])
    assert torch.equal(adv[~hit], strong[~hit])
    assert accuracy(model, adv, yt) == 0.0


@pytest.mark.parametrize("version", ["standard", "plus", "rand"])
def test_autoattack_picks_its_attacks_per_version(setup, monkeypatch,
                                                  version):
    """Each version's ensemble, in order and with JAX's arguments, on both
    packages (every attack returns the images, so none is skipped)."""
    seen = {"jax": [], "torch": []}

    def recorder(side, name):
        def fn(*args, **kw):
            keys = ("loss", "n_restarts", "eot_iter", "targeted",
                    "n_classes", "n_queries")
            seen[side].append((name,) + tuple(kw.get(k) for k in keys))
            return args[2 if side == "jax" else 1]  # the images
        return fn

    for side, mod in (("jax", jauto), ("torch", auto)):
        for name in ("apgd", "apgdt", "fab", "square"):
            monkeypatch.setattr(mod, name, recorder(side, name))
    jauto.autoattack(j_linear, setup["wm"], setup["x"], setup["y"],
                     n_classes=NC, version=version, square_queries=7)
    adv = auto.autoattack(setup["model"], setup["xt"], setup["yt"],
                          n_classes=NC, version=version, square_queries=7)
    assert seen["torch"] == seen["jax"]
    want = {"standard": ["apgd", "apgdt", "fab", "square"],
            "plus": ["apgd", "apgd", "fab", "square", "apgdt", "fab"],
            "rand": ["apgd", "apgd"]}[version]
    assert [c[0] for c in seen["torch"]] == want
    assert torch.equal(adv, setup["xt"])
    with pytest.raises(ValueError):
        auto.autoattack(setup["model"], setup["xt"], setup["yt"],
                        version="bogus")


def test_autoattack_standard_stops_after_apgd(setup):
    """AutoAttack standard, L-inf eps 0.15, 20 steps: APGD-CE fools every
    sample of this model, so the ensemble returns its images (seed 0's
    draws) and runs nothing after it."""
    xt, yt, model = setup["xt"], setup["yt"], setup["model"]
    got = auto.autoattack(model, xt, yt, eps=0.15, n_classes=NC, steps=20,
                          square_queries=50)
    assert accuracy(model, got, yt) == 0.0
    _in_box(got, xt, 0.15, "Linf")
    assert torch.equal(got, auto.apgd(model, xt, yt, eps=0.15, steps=20))
