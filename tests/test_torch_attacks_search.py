"""The port's search and projection attacks of the evaluation zoo, the
light physics, the presets, the depth metrics, the clean eval and the
sweeps against the JAX package: `attacks/{square_object, light_object,
random_object, physical}.py`, `physics/light.py`,
`evaluation/{presets, attack_eval, clean_eval, sweeps}.py` and
`ops/metrics.py`.

The JAX attacks run their own code eagerly around one jitted objective
per object size (tests/zoo_common.py), with their draws rebuilt from
their keys and injected into the port; the golden weights at 96x320,
batch 2, 375x1242 scenes, a 40x60 car (200x300 for the attacks that
paint rows 90:170 x cols 100:200). The port runs its plain CPU versions
of the kernels.

Tolerances, measured on this CPU:

* light physics, the JAX functions jitted as the JAX attack runs them:
  2e-6 absolute (float32 pow, sqrt and division; 6e-8 measured on the
  wavelength map, 1.8e-7 on the angle-form tube light, 0 on the line
  tube and the area lights), the rotation 1e-5 (bilinear taps of
  rotated coordinates; 1.2e-6 measured);
  `light_k` equal at every integer angle 0..180 but 90, where tan's
  float32 argument (1.5707964, above pi / 2) gives -22877332.0 in the
  port and -22877336.0 in XLA (two float32 ulps, 1.7e-7 relative; the
  test holds it to 1e-6 relative); `simple_add` equal except where base
  + light lands within an ulp of a 1/255 step and the floor goes one
  level apart: counted, at most 0.1% of the values (0 of 57600 measured
  on the 8 candidates' lights);
* the Square schedule, side and position: equal at every query;
* the searches' winners (Square's final texture, light's winning
  candidate, the Gaussian's winning step): equal; the best cost 1e-5
  relative (7.6e-8 Square, 1.6e-6 light measured); the textures 1e-6
  absolute (0 measured);
* the blur: 2e-6 absolute against JAX (1.1e-6 measured at all 100
  sigmas of the Gaussian preset, 42 s: JAX compiles one convolution a
  sigma) at the sigmas 30, 60 and 150 of the preset with the 200x300
  car (one for each regime of the clamp: none, rows only, rows and
  columns), at every fourth of the 100 against float64 scipy of the
  same definition (2e-6), and 2e-6 against
  scipy.ndimage.gaussian_filter (mode "reflect") at each of the 100
  where the radius is not clamped;
* evaluate_attacks' 8 metrics, for every object norm type, on the
  port's texture through JAX's finals: rtol 1e-3, atol 1e-3
  (tests/test_torch_attack_eval.py's rule);
* compute_depth_errors and compute_depth_losses 1e-5 relative (2.7e-7
  and 8.2e-6 measured: the resize's float32 weights);
  evaluate_clean 1e-4 relative (the resize of the disparity: float32
  weights against JAX's float64 ones, ROADMAP Queue 3; with median
  scaling a1 moves by one pixel of the crop, 2.7e-5 measured);
* physical_eval end to end, with JAX's finals draw injected: the
  metrics rule above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import depthmodelhardening_tpu.evaluation.sweeps as j_sweeps
from depthmodelhardening_tpu.data.synthetic import make_scene
import depthmodelhardening_tpu.physics.light as j_light
from depthmodelhardening_tpu.attacks import random_object as j_random
from depthmodelhardening_tpu.evaluation import clean_eval as j_clean
from depthmodelhardening_tpu.evaluation.attack_eval import (
    AttackEvalConfig as JAttackEvalConfig, build_attack as j_build_attack,
)
from depthmodelhardening_tpu.evaluation.presets import (
    EVAL_PRESETS as J_EVAL_PRESETS,
)
from depthmodelhardening_tpu.ops import metrics as j_metrics
from depthmodelhardening_tpu_torch.attacks import random_object
from depthmodelhardening_tpu_torch.attacks.base import FinalDraws
from depthmodelhardening_tpu_torch.attacks.light_object import LightDraws
from depthmodelhardening_tpu_torch.attacks.random_object import (
    ArbiDraws, GaussianDraws,
)
from depthmodelhardening_tpu_torch.attacks.square_object import SquareDraws
from depthmodelhardening_tpu_torch.evaluation import clean_eval, sweeps
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    NORM_TYPES, AttackEvalConfig, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.evaluation.presets import EVAL_PRESETS
from depthmodelhardening_tpu_torch.ops import metrics
from depthmodelhardening_tpu_torch.physics import light

import zoo_common as zc
from zoo_common import (  # noqa: F401 (autouse)
    few_torch_threads, remembered_band_sweeps,
)

LIGHT_ATOL, ROTATE_ATOL = 2e-6, 1e-5
BLUR_ATOL = 2e-6
COST_RTOL, TEX_ATOL = 1e-5, 1e-6
N_QUERIES = 10
N_INITS, N_NEIGHBORS = 2, 2
# 30, 60, 90, 120, 150: three of the blur test's JAX sigmas again
GAUSS_STEPS = 5
CLEAN_RTOL = 1e-4
# the JAX light functions jitted, as the JAX attack runs them: one compile
# a function and shape instead of one a primitive and shape
J_WAVELENGTH = jax.jit(j_light.wavelength_to_rgb)
J_TUBE = jax.jit(j_light.tube_light_by_func, static_argnames=("w", "h"))
J_AREA = jax.jit(j_light.area_light,
                 static_argnames=("w", "h", "direction"))
J_TUBE_GEN = jax.jit(j_light.tube_light_generation,
                     static_argnames=("w", "h"))
J_ROTATE = jax.jit(j_light._rotate_image)
# one sigma of each regime of the blur's clamp (radius below 199, between
# 199 and 299, above 299 on the 200x300 car): the preset's 20th, 40th and
# 100th, sigmas 30, 60 and 150
JAX_BLUR_STEPS = (19, 39, 99)


@pytest.fixture(scope="module")
def zoo():
    return zc.shared_zoo()


def _attacks(zoo, big=False, **kw):
    cfg = dict(zc.EVAL_KW, **kw)
    obj, mask = (zoo.big, zoo.big_mask) if big else (zoo.obj, zoo.mask)
    adv = {"adv_obj_img": np.clip(obj * 0.8 + 0.1, 0, 1) * (mask > 0)}
    j_atk = j_build_attack(JAttackEvalConfig(**cfg), zoo.pred.apply_fn,
                           jnp.asarray(obj), jnp.asarray(mask),
                           adv_obj_img=jnp.asarray(adv["adv_obj_img"]))
    if hasattr(j_atk, "cfg"):
        zoo.share_objective(j_atk)
    t_cfg = AttackEvalConfig(**cfg)
    return j_atk, build_attack(t_cfg, zoo.t_pred, obj, mask, **adv), t_cfg


# -- presets and the factory ---------------------------------------------------
def test_presets_equal_the_jax_packages():
    assert list(EVAL_PRESETS) == list(J_EVAL_PRESETS)
    assert len(EVAL_PRESETS) == 16
    for name, cfg in EVAL_PRESETS.items():
        want = dataclasses.asdict(J_EVAL_PRESETS[name])
        assert dataclasses.asdict(cfg) == want, name


@pytest.mark.parametrize("norm", NORM_TYPES)
def test_build_attack_takes_every_norm_type(zoo, norm):
    """The port's factory builds the JAX package's attack for each norm
    type with the same hyperparameters and eval pin."""
    j_atk, atk, _ = _attacks(zoo, norm_type=norm, step=3, epsilon=0.2,
                             n_inits=4, n_neighbors=5, n_queries=7)
    assert type(atk).__name__ == type(j_atk).__name__
    for name in ("eps", "alpha", "steps", "n_queries", "n_inits",
                 "n_neighbors", "seed", "mask_wt", "l0_thresh", "adam_lr",
                 "scene_hw"):
        if hasattr(j_atk, name):
            assert getattr(atk, name) == pytest.approx(
                getattr(j_atk, name)), name
    if hasattr(j_atk, "cfg"):
        assert atk.cfg.eval_pin_z0 == j_atk.cfg.eval_pin_z0
        assert atk.cfg.eval_pin_z0 == (6.1 if norm in ("l_0", "physical")
                                       else 7.0)


def test_build_attack_refusals(zoo):
    with pytest.raises(ValueError, match="adv_obj_img"):
        build_attack(AttackEvalConfig(norm_type="physical"), zoo.t_pred,
                     zoo.obj, zoo.mask)
    with pytest.raises(ValueError, match="unknown norm_type"):
        build_attack(AttackEvalConfig(norm_type="l_1"), zoo.t_pred,
                     zoo.obj, zoo.mask)


# -- physics/light.py ----------------------------------------------------------
def test_wavelength_to_rgb_matches_jax():
    w = np.arange(370, 761, dtype=np.float32)
    want = np.stack(J_WAVELENGTH(jnp.asarray(w)))
    got = torch.stack(light.wavelength_to_rgb(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, want, atol=LIGHT_ATOL, rtol=0)


@pytest.mark.parametrize("params", [(0.5, 10.0, 1.0, 40.0, 520.0),
                                    (-1.73, 130.0, 0.7, 900.0, 610.0),
                                    (0.0, 0.0, 1.0, 10.0, 380.0),
                                    (57.29, 33.0, 1.0, 1600.0, 750.0)])
def test_tube_light_by_func_matches_jax(params):
    want = np.asarray(J_TUBE(*params, w=60, h=40))
    got = light.tube_light_by_func(*params, w=60, h=40).numpy()
    np.testing.assert_allclose(got, want, atol=LIGHT_ATOL, rtol=0)


@pytest.mark.parametrize("direction", ["left", "right", "top", "bottom"])
def test_area_light_matches_jax(direction):
    want = np.asarray(J_AREA(0.8, 300.0, 560.0, w=50, h=30,
                             direction=direction))
    got = light.area_light(0.8, 300.0, 560.0, w=50, h=30,
                           direction=direction).numpy()
    np.testing.assert_allclose(got, want, atol=LIGHT_ATOL, rtol=0)


@pytest.mark.parametrize("angle", [0.0, 30.0, 117.0])
def test_tube_light_generation_and_rotation_match_jax(angle):
    want = np.asarray(J_TUBE_GEN(angle, 0.9, 200.0, 470.0, w=48, h=40))
    got = light.tube_light_generation(angle, 0.9, 200.0, 470.0, w=48,
                                      h=40).numpy()
    np.testing.assert_allclose(got, want, atol=ROTATE_ATOL, rtol=0)
    img = np.random.RandomState(2).rand(20, 30, 3).astype(np.float32)
    np.testing.assert_allclose(
        light._rotate_image(torch.from_numpy(img), angle).numpy(),
        np.asarray(J_ROTATE(jnp.asarray(img), angle)),
        atol=ROTATE_ATOL, rtol=0)


def test_point_light_and_gaussian_add_match_jax():
    np.testing.assert_array_equal(
        light.point_light_generation(0, 1.0, 1.0, 500.0, w=8, h=6).numpy(),
        np.asarray(j_light.point_light_generation(0, 1.0, 1.0, 500.0, w=8,
                                                  h=6)))
    key = jax.random.PRNGKey(5)
    base = np.random.RandomState(1).rand(2, 30, 40, 3).astype(np.float32)
    pattern = np.asarray(J_TUBE(0.3, 5.0, 1.0, 50.0, 600.0, w=40, h=30))
    want = np.asarray(j_light.gaussian_add(jnp.asarray(base),
                                           jnp.asarray(pattern), key))
    noise = zc.t(jax.random.normal(key, base.shape, jnp.float32))
    got = light.gaussian_add(torch.from_numpy(base),
                             torch.from_numpy(pattern), noise).numpy()
    np.testing.assert_allclose(got, want, atol=LIGHT_ATOL, rtol=0)


def test_light_k_at_every_angle():
    """k = round(tan(angle) 100) / 100 at each integer angle a candidate
    can take (0..180)."""
    a = np.arange(0, 181, dtype=np.float32)
    want = np.asarray(jnp.round(jnp.tan(jnp.deg2rad(jnp.asarray(a)))
                                * 100.0) / 100.0)
    got = light.light_k(torch.from_numpy(a)).numpy()
    ok = a != 90
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_allclose(got[~ok], want[~ok], rtol=1e-6)
    assert got[90] < -2e7


def test_simple_add_floor_matches_jax(zoo):
    """simple_add's uint8 floor on the object under every light of the
    light search's candidates (n_inits 2, n_neighbors 2): the values that
    floor one level apart (an ulp from a 1/255 step) are counted."""
    j_atk, atk, _ = _attacks(zoo, norm_type="light", n_inits=N_INITS,
                             n_neighbors=N_NEIGHBORS)
    differ = total = 0
    for p in atk._candidates():
        want = np.asarray(j_atk._apply_light(jnp.asarray(p)))
        got = atk.apply_light(torch.from_numpy(p)).numpy()
        bad = np.abs(got - want) > 1e-6
        assert np.all(np.abs(got - want)[bad] <= 1 / 255 + 1e-6)
        differ += int(bad.sum())
        total += want.size
    assert differ <= 1e-3 * total, (differ, total)


# -- Square --------------------------------------------------------------------
def _square_draws(j_atk, k_opt, k_final, n):
    k_init, k_loop = jax.random.split(k_opt)
    c, w = j_atk.obj_img.shape[-1], j_atk.cfg.obj_w
    keys = [jax.random.split(jax.random.fold_in(k_loop, i), 3)
            for i in range(n)]
    u_h = np.asarray([jax.random.uniform(k[0], ()) for k in keys])
    u_w = np.asarray([jax.random.uniform(k[1], ()) for k in keys])
    signs = np.stack([np.asarray(jax.random.rademacher(
        k[2], (1, 1, 1, c), jnp.float32)).reshape(c) for k in keys])
    z, a = j_atk._pinned_za(zc.B)
    fz, fa = j_atk._final_za(k_final, zc.B)
    return SquareDraws(
        stripes=zc.t(jax.random.rademacher(k_init, (1, 1, w, c),
                                           jnp.float32)),
        z0s=zc.t(z), alphas=zc.t(a), u_h=zc.t(u_h), u_w=zc.t(u_w),
        signs=zc.t(signs), final_z0s=zc.t(fz), final_alphas=zc.t(fa))


@pytest.mark.parametrize("n_queries", [N_QUERIES, 5000])
def test_square_schedule_side_and_position_match_jax(zoo, n_queries):
    """p, the square's side s and its position at every query, from the
    same uniforms: the schedule rescaled to n_queries walks every
    milestone, and a round at .5 or a floor at an integer would show."""
    j_atk, atk, _ = _attacks(zoo, norm_type="Square", n_queries=n_queries)
    it = jnp.arange(n_queries, dtype=jnp.float32)
    p_j = np.asarray(jax.vmap(j_atk._p_selection)(it))
    p = np.asarray([atk.p_selection(i) for i in range(n_queries)])
    np.testing.assert_array_equal(p, p_j)
    if n_queries >= 1000:
        assert len(set(p.tolist())) == 10  # every step of the schedule
    h, w, c = j_atk.cfg.obj_h, j_atk.cfg.obj_w, 3
    u = np.random.RandomState(7).rand(2, n_queries).astype(np.float32)
    s_j = jnp.clip(jnp.round(jnp.sqrt(p_j * (c * h * w) / c)), 1.0,
                   min(h, w) - 1.0)
    vh_j = jnp.floor(jnp.asarray(u[0]) * jnp.maximum(h - s_j, 1.0))
    vw_j = jnp.floor(jnp.asarray(u[1]) * jnp.maximum(w - s_j, 1.0))
    want = np.stack([np.asarray(s_j), np.asarray(vh_j), np.asarray(vw_j)])
    got = np.asarray([atk.square(i, u[0, i], u[1, i])
                      for i in range(n_queries)]).T
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.fixture(scope="module")
def square(zoo):
    j_atk, atk, cfg = _attacks(zoo, norm_type="Square", n_queries=N_QUERIES)
    _, k_opt, k_final = zc.eval_key()
    record = []
    with zc.eager_loops(record):
        tex = j_atk._optimize(zoo.vars, zoo.sf, k_opt)
    return dict(j_atk=j_atk, atk=atk, cfg=cfg, tex=np.asarray(tex),
                loss=float(record[0][1]), k_final=k_final,
                draws=_square_draws(j_atk, k_opt, k_final, N_QUERIES))


def test_square_search_matches_jax(zoo, square):
    """Square (eps 0.1, 10 queries) from JAX's stripes, squares and pinned
    sample: the same accepted queries (the final texture) and best cost.
    The pinned sample's geometry, computed once a call, gives the cost
    the per-query geometry gives, bit for bit."""
    atk, d = square["atk"], square["draws"]
    scenes = torch.from_numpy(zoo.scenes)
    tex = atk._optimize(scenes, d)
    np.testing.assert_allclose(tex.numpy(), square["tex"], atol=TEX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(atk.last_cost), square["loss"],
                               rtol=COST_RTOL)
    assert int(atk.last_accepted) >= 1
    assert 0 <= int(atk.last_best) < N_QUERIES
    with torch.no_grad():
        a = atk._objective(scenes, tex, d.z0s, d.alphas)
        b = atk._objective(scenes, tex, d.z0s, d.alphas,
                           geometry=atk.view_geometry(d.z0s, d.alphas))
    assert torch.equal(a, b)


# -- light ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def light_search(zoo):
    j_atk, atk, cfg = _attacks(zoo, norm_type="light", n_inits=N_INITS,
                               n_neighbors=N_NEIGHBORS)
    _, k_opt, k_final = zc.eval_key()
    record = []
    with zc.eager_loops(record):
        tex = j_atk._optimize(zoo.vars, zoo.sf, k_opt)
    cands = j_atk._candidates()
    z0s, alphas = zc.stack_za([j_atk._sample_za(jax.random.fold_in(k_opt, i),
                                                zc.B)
                               for i in range(len(cands))])
    fz, fa = j_atk._final_za(k_final, zc.B)
    best = np.asarray(record[0][1])
    return dict(j_atk=j_atk, atk=atk, cfg=cfg, tex=np.asarray(tex),
                cost=float(record[0][0]), k_final=k_final,
                best=int(np.flatnonzero((cands == best).all(1))[0]),
                draws=LightDraws(zc.t(cands), z0s, alphas, zc.t(fz),
                                 zc.t(fa)))


def test_light_search_matches_jax(zoo, light_search):
    """The light search (2 inits x 2 neighbours x 2 = 8 candidates, each
    its own EoT sample): the same candidates, winner, cost and texture."""
    s = light_search
    atk, d = s["atk"], s["draws"]
    np.testing.assert_array_equal(atk._candidates(), d.params.numpy())
    tex = atk._optimize(torch.from_numpy(zoo.scenes), d)
    assert int(atk.last_best) == s["best"]
    np.testing.assert_allclose(float(atk.last_cost), s["cost"],
                               rtol=COST_RTOL)
    np.testing.assert_allclose(tex.numpy(), s["tex"], atol=TEX_ATOL, rtol=0)


# -- Gaussian, arbi, vanila, physical -----------------------------------------
def _np_blur(img, sigma):
    """float64 of `_blur_hw`'s definition: scipy's kernel, the symmetric
    pad clamped to n - 1, the cut kernel renormalised (scipy's
    correlate1d in mode "reflect" pads symmetrically, once when the pad
    is below n)."""
    k = random_object._gaussian_kernel1d(sigma).astype(np.float64)
    r = (len(k) - 1) // 2
    out = img.astype(np.float64)
    for axis in (1, 2):
        rad = min(r, out.shape[axis] - 1)
        kk = k[r - rad:r + rad + 1] / k[r - rad:r + rad + 1].sum()
        out = scipy.ndimage.correlate1d(out, kk, axis=axis, mode="reflect")
    return out


def test_blur_matches_jax_numpy_and_scipy(zoo):
    atk = build_attack(EVAL_PRESETS["gaussian"], zoo.t_pred, zoo.big,
                       zoo.big_mask)
    sigmas = atk.sigmas()
    assert len(sigmas) == 100 and sigmas[-1] == 150.0
    img = zoo.big
    kernels = random_object.blur_kernels(sigmas, *img.shape[1:3], "cpu")
    assert len(kernels) == 100 and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(kernels, atk._kernels))
    for i, sigma in enumerate(sigmas):
        unclamped = int(4 * sigma + 0.5) < min(img.shape[1:3]) - 1
        if not (i % 4 == 0 or unclamped or i in JAX_BLUR_STEPS):
            continue
        got = random_object._blur_hw(torch.from_numpy(img),
                                     kernels[i]).numpy()
        if i % 4 == 0:
            np.testing.assert_allclose(got, _np_blur(img, sigma),
                                       atol=BLUR_ATOL, rtol=0,
                                       err_msg=str(sigma))
        if unclamped:
            want = scipy.ndimage.gaussian_filter(
                img.astype(np.float64), (0, sigma, sigma, 0), mode="reflect")
            np.testing.assert_allclose(got, want, atol=BLUR_ATOL, rtol=0)
        if i in JAX_BLUR_STEPS:
            want = np.asarray(j_random._blur_hw(jnp.asarray(img), sigma))
            np.testing.assert_allclose(got, want, atol=BLUR_ATOL, rtol=0)


def test_gaussian_search_matches_jax(zoo):
    """The blur search (5 steps to sigma 150 on the 200x300 car): the
    winning step, its cost and texture."""
    j_atk, atk, _ = _attacks(zoo, big=True, norm_type="guassian",
                             step=GAUSS_STEPS)
    _, k_opt, k_final = zc.eval_key()
    costs = []
    fn = zoo.objective(j_atk)

    def objective(variables, sf, o, z, a, **kw):
        costs.append(float(fn(o, z, a)))
        return fn(o, z, a)

    j_atk._objective = objective
    tex = np.asarray(j_atk._optimize(zoo.vars, zoo.sf, k_opt))
    z0s, alphas = zc.stack_za([j_atk._sample_za(jax.random.fold_in(k_opt, s),
                                                zc.B)
                               for s in range(GAUSS_STEPS)])
    fz, fa = j_atk._final_za(k_final, zc.B)
    d = GaussianDraws(z0s, alphas, zc.t(fz), zc.t(fa))
    got = atk._optimize(torch.from_numpy(zoo.scenes), d)
    assert int(atk.last_best) == int(np.argmin(costs))
    np.testing.assert_allclose(float(atk.last_cost), min(costs),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(got.numpy(), tex, atol=BLUR_ATOL, rtol=0)


def _arbi_draws(j_atk, k_opt, k_final):
    ku, kp, kc = jax.random.split(k_opt, 3)
    fz, fa = j_atk._final_za(k_final, zc.B)
    return ArbiDraws(coin=zc.t(jax.random.uniform(ku, ())),
                     noise=zc.t(jax.random.uniform(kp, j_atk.obj_img.shape)),
                     flat=zc.t(jax.random.uniform(kc, (1, 1, 1, 3))),
                     final_z0s=zc.t(fz), final_alphas=zc.t(fa))


@pytest.mark.parametrize("batch", [2, 12, 32])
def test_arbi_finals_match_jax(zoo, batch):
    """The arbi finals: linspace(5, 30) distances (out to 30 m, beyond
    the eval range) and RandomState(17) yaws."""
    j_atk, atk, _ = _attacks(zoo, big=True, norm_type="arbi")
    want = j_atk._final_za(None, batch)
    got = atk._final_za(None, batch)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _port_draws(zoo, norm, j_atk, atk, k_opt, k_final):
    """The draws of batch 0 as JAX's attack makes them, or (l_inf, l_0:
    held elsewhere) the port's own with JAX's finals."""
    fz, fa = (zc.t(v) for v in j_atk._final_za(k_final, zc.B))
    if norm == "Square":
        return _square_draws(j_atk, k_opt, k_final, 2)
    if norm == "arbi":
        return _arbi_draws(j_atk, k_opt, k_final)
    if norm in ("vanila", "physical"):
        return FinalDraws(fz, fa)
    d = atk.draw(torch.Generator().manual_seed(3), zc.B)
    d.final_z0s, d.final_alphas = fz, fa
    return d


@pytest.mark.parametrize("norm", ["l_inf", "l_0", "Square", "arbi",
                                  "guassian", "light", "vanila", "physical"])
def test_evaluate_attacks_metrics_match_jax(zoo, norm):
    """evaluate_attacks' 8 metrics for each object norm type (l_2 and APGD:
    tests/test_torch_attacks_whitebox.py; image: the same file): one batch
    with JAX's finals draw, against JAX's eval-mode finals of the port's
    texture and JAX's metrics. Short attacks (1 step, 2 queries, 2
    candidates); the searches' textures are held above."""
    big = norm in ("arbi", "guassian")
    j_atk, atk, cfg = _attacks(zoo, big=big, norm_type=norm, step=1,
                               n_queries=2, n_inits=1, n_neighbors=1)
    key, k_opt, k_final = zc.eval_key()
    if norm == "vanila":
        k_final = key  # the vanila attack's finals take the key itself
    d = _port_draws(zoo, norm, j_atk, atk, k_opt, k_final)
    obj, _ = (zoo.big, None) if big else (zoo.obj, None)
    given = np.clip(obj * 0.6 + 0.2, 0, 1)
    res, tex = zc.evaluate_with_texture(zoo.t_pred, atk, zoo.scenes, cfg, d,
                                        vanila_obj=given)
    tex = given if tex is None else tex.numpy()
    zc.assert_metrics(res, zoo.finals_metrics(j_atk, tex, k_final), norm)


# -- metrics, clean eval -------------------------------------------------------
def _depths(seed, shape, holes=False):
    rs = np.random.RandomState(seed)
    d = rs.uniform(2.0, 70.0, shape).astype(np.float32)
    if holes:
        d[rs.rand(*shape) < 0.6] = 0.0
    return d


def test_compute_depth_errors_matches_jax():
    gt, pred = _depths(0, (500,)), _depths(1, (500,))
    want = j_metrics.compute_depth_errors(jnp.asarray(gt), jnp.asarray(pred))
    got = metrics.compute_depth_errors(torch.from_numpy(gt),
                                       torch.from_numpy(pred))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5)


@pytest.mark.parametrize("even", [True, False])
def test_compute_depth_losses_matches_jax(even):
    """The in-training monitor at 375x1242 with sparse ground truth: the
    masked medians (an even and an odd count of valid pixels) and the 7
    metrics."""
    pred = _depths(2, (2, 48, 160, 1))
    gt = _depths(3, (2, 375, 1242, 1), holes=True)
    mask = (gt > 0)
    mask[:, :153] = mask[:, 371:] = False
    mask[:, :, :44] = mask[:, :, 1197:] = False
    if (mask.sum() % 2 == 0) != even:
        gt[np.nonzero(mask)[0][0], np.nonzero(mask)[1][0],
           np.nonzero(mask)[2][0]] = 0.0
    want = j_metrics.compute_depth_losses(jnp.asarray(pred), jnp.asarray(gt))
    got = metrics.compute_depth_losses(torch.from_numpy(pred),
                                       torch.from_numpy(gt))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    x = torch.from_numpy(gt)
    m = torch.from_numpy((gt > 0).astype(np.float32))
    np.testing.assert_allclose(float(metrics.masked_median(x, m)),
                               float(np.median(gt[gt > 0])), rtol=1e-6)


def test_clean_eval_pieces_match_jax():
    rs = np.random.RandomState(4)
    l, r = rs.rand(2, 12, 40).astype(np.float32), rs.rand(2, 12, 40)
    np.testing.assert_array_equal(
        clean_eval.batch_post_process_disparity(l, r),
        j_clean.batch_post_process_disparity(l, r))
    np.testing.assert_array_equal(clean_eval.eigen_crop_mask(375, 1242),
                                  j_clean.eigen_crop_mask(375, 1242))
    np.testing.assert_array_equal(clean_eval.disp_to_scaled_depth(l),
                                  j_clean.disp_to_scaled_depth(l))


@pytest.mark.parametrize("kw", [dict(), dict(post_process=True),
                                dict(eval_stereo=False),
                                dict(eval_stereo=False, post_process=True,
                                     pred_depth_scale_factor=1.3)])
def test_evaluate_clean_matches_jax(zoo, kw):
    """evaluate_clean on two synthetic frames with synthetic sparse
    ground truth at 375x1242: stereo scaling or median scaling, with and
    without the flip post-process."""
    imgs = make_scene(2, zc.H, zc.W, seed=5)
    frames = [(imgs[i], _depths(10 + i, (375, 1242), holes=True))
              for i in range(2)]
    cfg = clean_eval.CleanEvalConfig(**kw)
    jcfg = j_clean.CleanEvalConfig(**kw)

    def j_predict(imgs):  # the jitted forward's batch, B = 2
        return zoo.fwd(zoo.vars, jnp.concatenate([imgs] * zc.B))[:1]

    want, want_r = j_clean.evaluate_clean(None, frames, jcfg,
                                          batched_predict=j_predict)
    got, got_r = clean_eval.evaluate_clean(zoo.t_pred, frames, cfg)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=CLEAN_RTOL)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5)
    assert len(got_r) == (0 if cfg.eval_stereo else 2)


# -- sweeps --------------------------------------------------------------------
def _recorded_sweep(mod, run, monkeypatch, rng_of):
    """Run a sweep of `mod` with its build_attack and evaluate_attacks
    replaced by recorders; returns [(cfg fields, the predictors' names,
    the run's seed)]."""
    calls = []
    built = {}

    def build(cfg, predictor, obj, mask, adv_obj_img=None):
        built["cfg"] = dataclasses.asdict(cfg)
        return ("attack", getattr(predictor, "name", predictor))

    def evaluate(predictor, attack, scenes, cfg, **kw):
        metric = kw.get("metric_predictor")
        calls.append((built["cfg"], attack[1], getattr(
            metric, "name", None), rng_of(kw), list(scenes)))
        return {"mean": {}, "max": {}}

    monkeypatch.setattr(mod, "build_attack", build)
    monkeypatch.setattr(mod, "evaluate_attacks", evaluate)
    run()
    return calls


class _Named:
    def __init__(self, name):
        self.name = self.apply_fn = name


@pytest.mark.parametrize("sweep", ["steps", "cross", "objects"])
def test_sweeps_call_what_jax_calls(monkeypatch, sweep):
    """Each sweep builds and evaluates the attacks the JAX package's does:
    the same configs, source and target models, scenes, and every run
    seeded with 17 (JAX: PRNGKey(17))."""
    cfg = AttackEvalConfig(norm_type="l_inf", **zc.EVAL_KW)
    jcfg = JAttackEvalConfig(norm_type="l_inf", **zc.EVAL_KW)
    preds = {"a": _Named("a"), "b": _Named("b")}
    objs = {"Sedan": ("o1", "m1"), "Truck": ("o2", "m2")}
    scenes = lambda: ["s0"]
    runs = {
        "steps": (lambda m, c: m.attack_steps_sweep(
            _Named("a"), "o", "m", scenes, c, candi_steps=(1, 11))),
        "cross": (lambda m, c: m.crosscheck_matrix(preds, "o", "m", scenes,
                                                   c)),
        "objects": (lambda m, c: m.objects_sweep(_Named("a"), objs, scenes,
                                                 c)),
    }
    got = _recorded_sweep(
        sweeps, lambda: runs[sweep](sweeps, cfg), monkeypatch,
        lambda kw: int(kw["generator"].initial_seed()))
    want = _recorded_sweep(
        j_sweeps, lambda: runs[sweep](j_sweeps, jcfg), monkeypatch,
        lambda kw: int(np.asarray(kw["rng"])[-1]))
    assert got == want and len(got) >= 2


def test_physical_eval_matches_jax(zoo, monkeypatch):
    """physical_eval end to end: a perturbed copy of the car stands in for
    the photographed patch; sample 0 pinned at 6.1 m. The port's eval
    gets the finals draw JAX's makes from PRNGKey(17)."""
    adv = np.clip(zoo.obj * 0.7 + 0.2, 0, 1)
    cfg = AttackEvalConfig(norm_type="l_inf", **zc.EVAL_KW)
    j_atk, _, _ = _attacks(zoo, norm_type="physical")
    _, _, k_final = zc.eval_key()
    draws = [FinalDraws(*map(zc.t, j_atk._final_za(k_final, zc.B)))]
    evaluate = sweeps.evaluate_attacks
    monkeypatch.setattr(sweeps, "evaluate_attacks",
                        lambda *a, **kw: evaluate(*a, draws=draws, **kw))
    want = j_sweeps.physical_eval(
        zoo.fast_pred, jnp.asarray(zoo.obj), jnp.asarray(zoo.mask),
        jnp.asarray(adv), lambda: [zoo.scenes],
        JAttackEvalConfig(norm_type="l_inf", **zc.EVAL_KW))
    got = sweeps.physical_eval(zoo.t_pred, zoo.obj, zoo.mask, adv,
                               lambda: [zoo.scenes], cfg)
    zc.assert_metrics(got, np.asarray([want["mean"][n] for n in
                                       zc.attack_eval.METRIC_NAMES]),
                      "physical_eval")
