"""The port's white-box attacks of the evaluation zoo against the JAX
package: L2 PGD (`attacks/l2_object.py`), APGD (`attacks/apgd_object.py`),
whole-image PGD (`attacks/pgd_image.py`) and the distillation step with
`adv_type="image"` (`training/distill.py`).

The JAX attacks run their own code eagerly around one jitted objective
and its gradient (tests/zoo_common.py), with their draws rebuilt from
their keys and injected into the port. Setup: the golden weights at
96x320, batch 2, 375x1242 scenes, a 40x60 car. The port runs its plain
CPU versions of the kernels.

Tolerances, measured on this CPU:

* a step's texture gradient: rtol 1e-3 with an atol of 1e-3 of its
  largest magnitude (tests/test_torch_attack_eval.py's rule; float32
  convolutions summed in another order; L2's two steps 5.6e-5 and
  8.4e-5 of the max measured);
* L2's texture after 2 steps: 1e-4 absolute (normalised steps of
  2.5 eps / steps = 1.25 at eps 1: a gradient that agrees to 1e-3 moves
  a texel by 1e-3 of its share of the step; 1.5e-5 measured);
* whole-image PGD: the resized images 1e-4 (float32 resize weights,
  ROADMAP Queue 3; 1.9e-5 measured); each step's image gradient at
  JAX's iterate rtol 1e-3 with an atol of 5e-3 of its max (2.3e-3
  measured: every pixel of the frame gets a gradient, and many sit near
  max-pool ties); one step from JAX's start by the split rule (4 of
  184320 pixels measured); after two steps the splits spread through
  the receptive fields of the first ones (486 pixels above 1e-3 of the
  max), so two steps are held by evaluate_attacks' metrics over the
  whole frame, rtol 5e-3 (2.8e-3 measured, on sq_rel: the random-weight
  model's whole-frame depths reach 80 m, abs_rel about 3);
* APGD on the golden model: the first evaluation's gradient by the
  gradient rule above (1.3e-4 of the max measured). The next iterates
  sit on kinks of the random-weight model: at JAX's second and third
  iterates the two gradients lie 2.3e-2 and 5.0e-2 of the max apart,
  while 1e-6 of noise moves the port's by 2e-5, and a central
  difference along their difference lies between the two (1.3e-5
  against 1.7e-5 and 9.0e-6): one-sided derivatives of a non-smooth
  point (ROADMAP Queue 3, max-pool ties), which then split 107 of 7200
  texels. So the loop is held on the per-pixel predictor, and on the
  model its first gradient, its schedule's state and the finals and
  metrics of its texture;
* APGD's schedule on the smooth per-pixel predictor of
  tests/test_torch_l0.py at steps 10 and 100: every step size, the
  checkpoints' k and counter, the flags and the final texture equal
  (the texture within 1e-6), the best loss 1e-6 relative; under the L2
  norm the same, the texture within 1e-4 (1.8e-5 measured: steps of up
  to 2 eps = 4 normalised by norms that sum 7200 squares in another
  order);
* whole-image PGD untargeted, and targeted without a random start: the
  step's gradient by the gradient rule, the step by the split rule;
  untargeted, the gradient is (f(x) - f(x0)) f'(x), whose first factor
  is small at the start and carries each package's rounding of f, so
  more pixels split: at most 2e-3 of them (0.102% measured, against
  4 of 184320 targeted);
* evaluate_attacks' 8 metrics: rtol 1e-3, atol 1e-3
  (tests/test_torch_attack_eval.py's; 3.2e-5 relative measured for L2);
* the image distillation step against JAX `_step` (its attack the image
  PGD above, its `value_and_grad` and Adam update jitted, the student's
  eval forward the zoo's jitted disp0 program of the same weights): the
  whole step's loss 1e-3 relative (4.4e-4 measured: the two steps'
  sign splits, above, change some pixels of the images it trains on)
  and every parameter within 2.5 lr (Adam's first step moves each by
  about lr in the sign of its gradient; 3.2% of the weights' updates
  take the other sign, 2 lr apart), the unused heads bit-unchanged; the
  training half on JAX's own images by tests/test_torch_distill.py's
  rule (loss 1e-5 relative, 1.1e-7 measured; parameters within 2.5 lr;
  BatchNorm statistics 1e-4 relative + 1e-5, the variance times
  n / (n - 1)); `eval_atk_perf` of JAX's stepped student 1e-3 relative
  (5.1e-6 and 8.5e-5 measured). Besides, the port's step equals its own
  attack plus `distill_step` (loss 1e-6 relative, every weight within
  1e-6), and its attack never gives a parameter a gradient.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthmodelhardening_tpu.attacks.apgd_object import (
    APGDObjectAttack as JAPGDObjectAttack,
)
from depthmodelhardening_tpu.attacks.base import (
    PhysObjAttackConfig as JPhysObjAttackConfig,
)
from depthmodelhardening_tpu.attacks.pgd_image import (
    PGDImageAttack as JPGDImageAttack,
)
from depthmodelhardening_tpu.evaluation.attack_eval import (
    AttackEvalConfig as JAttackEvalConfig, build_attack as j_build_attack,
)
from depthmodelhardening_tpu.training.config import (
    DistillConfig as JDistillConfig,
)
from depthmodelhardening_tpu.training.distill import (
    DistillTrainer as JDistillTrainer, eval_atk_perf as j_eval_atk_perf,
)
from depthmodelhardening_tpu_torch.attacks.apgd_object import (
    APGDDraws, APGDObjectAttack,
)
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.l2_object import L2Draws
from depthmodelhardening_tpu_torch.attacks.pgd_image import (
    ImageDraws, PGDImageAttack,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_distill_state,
)
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    METRIC_NAMES, AttackEvalConfig, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.models.wrappers import EvalView
from depthmodelhardening_tpu_torch.training.config import DistillConfig
from depthmodelhardening_tpu_torch.training.distill import (
    DistillTrainer, eval_atk_perf,
)

import zoo_common as zc
from test_torch_distill import HEADS, PARAM_ATOL, assert_state_matches
from zoo_common import (  # noqa: F401 (autouse)
    few_torch_threads, remembered_band_sweeps,
)

SIGN_FLOOR = 1e-6
STEPS = 2
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-3
L2_TEX_ATOL = 1e-4
IMAGE_GRAD_ATOL = 5e-3
IMAGE_METRIC_RTOL = 5e-3
APGD_L2_TEX_ATOL = 1e-4
UNTARGETED_SPLIT_SHARE = 2e-3


@pytest.fixture(scope="module")
def zoo():
    return zc.shared_zoo()


def _attacks(zoo, **kw):
    cfg = dict(zc.EVAL_KW, step=STEPS, **kw)
    j_atk = j_build_attack(JAttackEvalConfig(**cfg), zoo.pred.apply_fn,
                           jnp.asarray(zoo.obj), jnp.asarray(zoo.mask))
    t_cfg = AttackEvalConfig(**cfg)
    return j_atk, build_attack(t_cfg, zoo.t_pred, zoo.obj, zoo.mask), t_cfg


def _settled_split(got, want, grads, same=1e-6):
    """Values that differ by more than `same` where every JAX gradient
    was decided by more than rounding (tests/test_torch_attack_eval.py's
    rule)."""
    settled = np.ones(want.shape, bool)
    for g in grads:
        settled &= np.abs(g) >= SIGN_FLOOR * np.abs(g).max()
    assert settled.mean() > 0.5
    return int((settled & (np.abs(got - want) > same)).sum())


# -- L2 ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def l2(zoo):
    """JAX's L2 attack (eps 1) run by its own `_optimize` on JAX's
    draws, with the texture and gradient of every step recorded."""
    j_atk, t_atk, cfg = _attacks(zoo, norm_type="l_2", epsilon=1.0)
    _, k_opt, k_final = zc.eval_key()
    k_init, k_loop = jax.random.split(k_opt)
    kn, kr = jax.random.split(k_init)
    za = [j_atk._sample_za(jax.random.fold_in(k_loop, i), zc.B)
          for i in range(STEPS)]
    z0s, alphas = zc.stack_za(za)
    fz, fa = j_atk._final_za(k_final, zc.B)
    draws = L2Draws(
        delta=zc.t(jax.random.normal(kn, (zc.B,) + j_atk.obj_img.shape[1:])),
        r=zc.t(jax.random.uniform(kr, (zc.B,))), z0s=z0s, alphas=alphas,
        final_z0s=zc.t(fz), final_alphas=zc.t(fa))
    zoo.share_objective(j_atk)
    seen = []
    orig = jax.grad

    def recording_grad(fn):
        g = orig(fn)

        def run(o, key):
            out = g(o, key)
            seen.append((np.asarray(o), np.asarray(out)))
            return out
        return run

    jax.grad = recording_grad
    try:
        with zc.eager_loops():
            tex = j_atk._optimize(zoo.vars, zoo.sf, k_opt)
    finally:
        jax.grad = orig
    return dict(j_atk=j_atk, t_atk=t_atk, cfg=cfg, draws=draws, seen=seen,
                tex=np.asarray(tex), k_final=k_final)


@pytest.mark.parametrize("step", range(STEPS))
def test_l2_step_gradient_matches_jax(zoo, l2, step):
    """The port's per-sample texture gradient from JAX's texture at each
    step, under the same EoT draw."""
    tex, g_j = l2["seen"][step]
    assert tex.shape == (zc.B, zc.OBJ_H, zc.OBJ_W, 3)
    _, g = l2["t_atk"].objective_and_grad(
        torch.from_numpy(zoo.scenes), torch.from_numpy(tex.copy()),
        l2["draws"].z0s[step], l2["draws"].alphas[step])
    np.testing.assert_allclose(g.numpy(), g_j, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(g_j).max())


def test_l2_texture_and_metrics_match_jax(zoo, l2):
    """Per-sample textures inside the eps-ball, equal to JAX's; then
    evaluate_attacks' metrics on them."""
    res, tex = zc.evaluate_with_texture(zoo.t_pred, l2["t_atk"], zoo.scenes,
                                        l2["cfg"], l2["draws"])
    tex = tex.numpy()
    assert tex.shape == l2["tex"].shape == (zc.B, zc.OBJ_H, zc.OBJ_W, 3)
    np.testing.assert_allclose(tex, l2["tex"], atol=L2_TEX_ATOL, rtol=0)
    dn = np.sqrt(((tex - zoo.obj) ** 2).reshape(zc.B, -1).sum(1))
    assert np.all(dn <= 1.0 + 1e-4)
    zc.assert_metrics(res, zoo.finals_metrics(l2["j_atk"], l2["tex"],
                                              l2["k_final"]), "l_2")


# -- APGD ----------------------------------------------------------------------
def _j_apgd_run(j_atk, variables, sf, key):
    """JAX's `_single_run`, jitted, with its loop's final state (the
    `lax.fori_loop` carry, taken while tracing)."""
    def run(key):
        record = []
        orig = jax.lax.fori_loop

        def fori_loop(lo, hi, body, init):
            record.append(orig(lo, hi, body, init))
            return record[-1]

        jax.lax.fori_loop = fori_loop
        try:
            tex = j_atk._single_run(variables, sf, key)
        finally:
            jax.lax.fori_loop = orig
        return tex, record[0]

    tex, state = jax.jit(run)(key)
    return np.asarray(tex), state


def _apgd_draws(j_atk, k_opt, k_final):
    z, a = j_atk._pinned_za(zc.B)
    fz, fa = j_atk._final_za(k_final, zc.B)
    return APGDDraws(
        t=zc.t(jax.random.uniform(k_opt, j_atk.obj_img.shape, minval=-1.0,
                                  maxval=1.0)),
        z0s=zc.t(z), alphas=zc.t(a), final_z0s=zc.t(fz),
        final_alphas=zc.t(fa))


def _check_apgd_state(atk, state, tex, j_tex, tex_atol):
    st = atk.last_state
    assert (st["k"], st["counter3"]) == (int(state["k"]),
                                         int(state["counter3"]))
    assert float(st["step_size"]) == float(state["step_size"])
    assert bool(st["reduced_last_check"]) == bool(
        state["reduced_last_check"])
    np.testing.assert_allclose(st["loss_best"].numpy(),
                               np.asarray(state["loss_best"]), rtol=1e-6)
    np.testing.assert_allclose(tex, j_tex, atol=tex_atol, rtol=0)


class PixelPredictor:
    """tests/test_torch_l0.py's smooth per-pixel disparity."""

    device = torch.device("cpu")

    def __call__(self, x):
        return torch.sigmoid(2.0 * x[..., :1] - x[..., 1:2]
                             + 0.5 * x[..., 2:3])


def j_pixel_predict(variables, x):
    return jax.nn.sigmoid(2.0 * x[..., :1] - x[..., 1:2] + 0.5 * x[..., 2:3])


@pytest.mark.parametrize("steps", [10, 100])
def test_apgd_schedule_matches_jax(zoo, steps):
    """APGD's step-size control on a smooth per-pixel predictor, where
    the loss history is not at the mercy of sign splits: the schedule
    (steps_2, steps_min, size_decr), every halving and the final iterate
    against JAX's `_single_run`."""
    # the eval distances build_attack gives APGD
    kw = dict(obj_h=zc.OBJ_H, obj_w=zc.OBJ_W, scene_h=zc.H, scene_w=zc.W)
    j_atk = JAPGDObjectAttack(j_pixel_predict, zoo.obj, zoo.mask,
                              JPhysObjAttackConfig(**kw), eps=0.05,
                              steps=steps)
    atk = APGDObjectAttack(PixelPredictor(), zoo.obj, zoo.mask,
                           PhysObjAttackConfig(**kw), eps=0.05, steps=steps)
    assert (atk.steps_2, atk.steps_min, atk.size_decr) == (
        j_atk.steps_2, j_atk.steps_min, j_atk.size_decr)
    if steps == 10:
        assert (atk.steps_2, atk.steps_min, atk.size_decr) == (2, 1, 1)
    _, k_opt, k_final = zc.eval_key(3)
    j_tex, state = _j_apgd_run(j_atk, None, zoo.sf, k_opt)
    halvings = int(round(np.log2(0.1 / float(state["step_size"]))))
    assert halvings >= 1, "the schedule never halved: a weak test"
    draws = _apgd_draws(j_atk, k_opt, k_final)
    tex = atk._optimize(torch.from_numpy(zoo.scenes), draws).numpy()
    _check_apgd_state(atk, state, tex, j_tex, 1e-6)
    np.testing.assert_array_equal(
        np.isfinite(atk.last_state["loss_steps"].numpy()),
        np.isfinite(np.asarray(state["loss_steps"])))


def test_apgd_l2_with_restarts_matches_jax(zoo):
    """APGD under the L2 norm with n_restarts 2 on the smooth per-pixel
    predictor: the start on the eps-sphere, the normalised steps, the
    ball's projection and the schedule's state against JAX's; both keep
    the first restart's run (JAX's `_optimize` is one `_single_run`)."""
    kw = dict(obj_h=zc.OBJ_H, obj_w=zc.OBJ_W, scene_h=zc.H, scene_w=zc.W)
    j_atk = JAPGDObjectAttack(j_pixel_predict, zoo.obj, zoo.mask,
                              JPhysObjAttackConfig(**kw), norm="L2", eps=2.0,
                              steps=10, n_restarts=2)
    atk = APGDObjectAttack(PixelPredictor(), zoo.obj, zoo.mask,
                           PhysObjAttackConfig(**kw), norm="L2", eps=2.0,
                           steps=10, n_restarts=2)
    _, k_opt, k_final = zc.eval_key(3)
    j_tex, state = _j_apgd_run(j_atk, None, zoo.sf, k_opt)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda k: j_atk._optimize(None, zoo.sf, k))(
            k_opt)), j_tex)
    draws = _apgd_draws(j_atk, k_opt, k_final)
    tex = atk._optimize(torch.from_numpy(zoo.scenes), draws).numpy()
    _check_apgd_state(atk, state, tex, j_tex, APGD_L2_TEX_ATOL)
    assert float(state["step_size"]) < 4.0, "never halved: a weak test"
    d = np.sqrt(((tex - zoo.obj) ** 2).sum())
    assert d <= 2.0 + 1e-4 and d > 1.0
    assert tex.min() >= 0.0 and tex.max() <= 1.0
    with pytest.raises(ValueError):
        APGDObjectAttack(PixelPredictor(), zoo.obj, zoo.mask,
                         PhysObjAttackConfig(**kw), norm="L1")


@pytest.fixture(scope="module")
def apgd(zoo, l2):
    j_atk, t_atk, cfg = _attacks(zoo, norm_type="APGD", epsilon=0.05)
    _, k_opt, k_final = zc.eval_key()
    return dict(j_atk=j_atk, t_atk=t_atk, cfg=cfg, k_final=k_final,
                draws=_apgd_draws(j_atk, k_opt, k_final),
                grad=jax.grad(zoo.objective(l2["j_atk"])))


def test_apgd_matches_jax_on_the_model(zoo, apgd):
    """APGD-2 on the golden model from JAX's start and pinned sample: the
    gradient of its first evaluation (JAX's, of the L2 test's program:
    the texture repeated for each sample, the gradient summed over them),
    the schedule's state after the loop, and evaluate_attacks' metrics
    against JAX's finals and metrics of the port's texture. The later
    iterates are not held to JAX's: they sit on kinks of the
    random-weight model (see the module docstring)."""
    atk, d = apgd["t_atk"], apgd["draws"]
    scenes = torch.from_numpy(zoo.scenes)
    x = torch.clamp(atk.obj_img + 0.05 * d.t / d.t.abs().max(), 0.0, 1.0)
    _, g = atk.objective_and_grad(scenes, x, d.z0s, d.alphas)
    xb = np.repeat(x.numpy(), zc.B, axis=0)
    g_j = np.asarray(apgd["grad"](jnp.asarray(xb), jnp.asarray(d.z0s),
                                  jnp.asarray(d.alphas))).sum(0, keepdims=True)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(g_j).max())
    res, tex = zc.evaluate_with_texture(zoo.t_pred, atk, zoo.scenes,
                                        apgd["cfg"], d)
    assert float((tex - atk.obj_img).abs().max()) <= 0.05 + 1e-6
    st = atk.last_state
    # steps 2: a checkpoint after every step (steps_2 = steps_min = 1)
    assert (atk.steps_2, st["k"], st["counter3"]) == (1, 1, 0)
    zc.assert_metrics(res, zoo.finals_metrics(apgd["j_atk"], tex.numpy(),
                                              apgd["k_final"]), "APGD")


def test_apgd_pinned_geometry_equals_the_per_query_one(zoo, apgd):
    """The pinned sample's warp parameters, computed once a call, give
    the objective the per-call geometry gives, bit for bit."""
    atk, d = apgd["t_atk"], apgd["draws"]
    scenes = torch.from_numpy(zoo.scenes)
    x = torch.clamp(atk.obj_img + 0.05 * d.t, 0.0, 1.0)
    geom = atk.view_geometry(d.z0s, d.alphas)
    with torch.no_grad():
        a = atk._objective(scenes, x, d.z0s, d.alphas)
        b = atk._objective(scenes, x, d.z0s, d.alphas, geometry=geom)
    assert torch.equal(a, b)


# -- whole-image PGD -----------------------------------------------------------
@pytest.fixture(scope="module")
def image(zoo):
    j_atk, t_atk, cfg = _attacks(zoo, norm_type="image", epsilon=0.01,
                                 alpha=0.002)
    j_atk.predict_fn = zoo.fwd
    grads = []
    orig = jax.grad

    def recording_grad(fn):
        g = orig(fn)

        def run(a):
            out = g(a)
            grads.append((np.asarray(a), np.asarray(out)))
            return out
        return run

    key, _, _ = zc.eval_key()
    jax.grad = recording_grad
    try:
        with zc.eager_loops():
            adv, ben = j_atk._run(zoo.vars, zoo.sf, key)
    finally:
        jax.grad = orig
    noise = jax.random.uniform(key, ben.shape, minval=-0.01, maxval=0.01)
    masks = jnp.ones(adv.shape[:3] + (1,), adv.dtype)
    return dict(t_atk=t_atk, cfg=cfg, adv=np.asarray(adv),
                ben=np.asarray(ben), grads=grads,
                draws=ImageDraws(zc.t(noise)),
                metrics=zoo.metrics(adv, ben, masks))


@pytest.mark.parametrize("step", range(STEPS))
def test_image_pgd_step_gradient_matches_jax(zoo, image, step):
    """The port's image gradient at JAX's iterate of each step."""
    x, g_j = image["grads"][step]
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.mean(zoo.t_pred(xt) ** 2), xt)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=GRAD_RTOL,
                               atol=IMAGE_GRAD_ATOL * np.abs(g_j).max())


def test_image_pgd_matches_jax(zoo, image):
    """Whole-image PGD (eps 0.01, alpha 0.002, targeted): the resized
    benign images; one step from JAX's start lands on JAX's first
    iterate (the split rule); evaluate_attacks' metrics over the whole
    frame after two."""
    atk, d = image["t_atk"], image["draws"]
    atk.steps = 1
    try:
        adv, ben = atk(torch.from_numpy(zoo.scenes), draws=d)
    finally:
        atk.steps = STEPS
    assert adv.shape == ben.shape == (zc.B, zc.H, zc.W, 3)
    # the resize's weights: float32 here, float64 in JAX (ROADMAP Queue 3,
    # <= 6.9e-5 at 1242 -> 320; 1.9e-5 measured)
    np.testing.assert_allclose(ben.numpy(), image["ben"], atol=1e-4, rtol=0)
    assert np.abs(adv.numpy() - ben.numpy()).max() <= 0.01 + 1e-6
    # a split moves a pixel by 2 alpha = 4e-3; the resized images' own
    # rounding reaches adv through the projection
    assert _settled_split(adv.numpy(), image["grads"][1][0],
                          [image["grads"][0][1]], same=1e-4) <= int(
        1e-3 * adv.numel())
    res = evaluate_attacks(zoo.t_pred, atk, [zoo.scenes], image["cfg"],
                           draws=[d])
    got = np.asarray([res["mean"][n] for n in METRIC_NAMES])
    np.testing.assert_allclose(got, image["metrics"], rtol=IMAGE_METRIC_RTOL,
                               atol=zc.METRIC_ATOL)


# -- distillation with adv_type="image" ---------------------------------------
DISTILL_KW = dict(adv_type="image", batch_size=zc.B, steps=STEPS,
                  epsilon=0.01, alpha=0.002, scene_h=zc.H, scene_w=zc.W,
                  fold_bn=False)
STEP_LOSS_RTOL, PERF_RTOL = 1e-3, 1e-3


@pytest.fixture(scope="module")
def j_distill(zoo, image):
    """JAX `DistillTrainer._step` with adv_type="image" from the golden
    weights on the image PGD's key, then JAX `eval_atk_perf` of the
    stepped student on the key PRNGKey(31). The step's code is JAX's;
    its student's eval forward is the zoo's jitted disp0 program of the
    weights it is given; its state's making, `value_and_grad`, Adam
    update and `apply_updates` are each jitted (JAX's `train_step` jits
    the whole step), so the file compiles no second attack and no
    per-parameter eager op."""
    tr = JDistillTrainer(JDistillConfig(**DISTILL_KW), jax.random.PRNGKey(0),
                         zoo.obj, zoo.mask, zoo.fast_pred,
                         init_variables=zoo.vars)
    tr.attack.predict_fn = zoo.fwd
    tr.tx = optax.GradientTransformation(tr.tx.init, jax.jit(tr.tx.update))
    run, seen = tr.attack._run, []
    tr.attack._run = lambda *a: seen.append(run(*a)) or seen[-1]
    key, _, _ = zc.eval_key()
    before = jax.jit(tr.make_state)()
    orig = jax.value_and_grad, optax.apply_updates
    jax.value_and_grad = lambda fn, **kw: jax.jit(orig[0](fn, **kw))
    optax.apply_updates = jax.jit(orig[1])
    try:
        with zc.eager_loops():
            after, m = tr._step(before, zoo.sf, key)
    finally:
        jax.value_and_grad, optax.apply_updates = orig
    # the eval: the attack's loop eager, the student's forwards the same
    # jitted program
    tr.attack._jitted = run
    tr.model_d0 = types.SimpleNamespace(
        apply=lambda v, x, train: zoo.fwd(v, x))
    rng = jax.random.PRNGKey(31)
    with zc.eager_loops():
        perf = j_eval_atk_perf(tr, after, [zoo.scenes], rng)
    noise = jax.random.uniform(jax.random.fold_in(rng, 0),
                               (zc.B, zc.H, zc.W, 3), minval=-0.01,
                               maxval=0.01)
    return dict(adv=np.asarray(seen[0][0]), ben=np.asarray(seen[0][1]),
                loss=float(m["loss"]),
                before=jax.tree_util.tree_map(np.array, before),
                after=jax.tree_util.tree_map(np.array, after),
                perf=perf, eval_draws=ImageDraws(zc.t(noise)))


def _distill_trainer(zoo):
    return DistillTrainer(DistillConfig(**DISTILL_KW),
                          torch.Generator().manual_seed(0), zoo.obj,
                          zoo.mask, zoo.t_pred, device="cpu",
                          init_state_dict=zoo.sd)


def test_image_distill_step_and_eval_match_jax(zoo, image, j_distill):
    """adv_type="image" against JAX: JAX `_step`'s attack is the image PGD
    above (the same images); the port's whole `train_step` from the
    golden weights on JAX's draws against JAX `_step` (the loss, every
    parameter, the unused heads bit-unchanged); the port's training half
    on JAX's own images against the same step (loss, parameters and
    BatchNorm statistics by tests/test_torch_distill.py's rule); then
    `eval_atk_perf` of JAX's stepped student against JAX's."""
    np.testing.assert_array_equal(j_distill["adv"], image["adv"])
    tr = _distill_trainer(zoo)
    before, after = j_distill["before"], j_distill["after"]
    want = from_jax_distill_state(after)["model"]
    old = from_jax_distill_state(before)["model"]
    state, m = tr.train_step(tr.make_state(), torch.from_numpy(zoo.scenes),
                             draws=image["draws"])
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), j_distill["loss"],
                               rtol=STEP_LOSS_RTOL)
    got = state.model.state_dict()
    for name, _ in state.model.named_parameters():
        if name in HEADS:
            assert torch.equal(got[name], old[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
        assert not torch.equal(got[name], old[name]), name

    half, m = tr.distill_step(tr.make_state(),
                              torch.from_numpy(j_distill["adv"]),
                              torch.from_numpy(j_distill["ben"]))
    np.testing.assert_allclose(float(m["loss"]), j_distill["loss"],
                               rtol=1e-5)
    assert_state_matches(half.model.state_dict(), before, after, half.model)

    stepped = tr.make_state(resume=from_jax_distill_state(after))
    perf = eval_atk_perf(tr, stepped, [zoo.scenes],
                         draws=[j_distill["eval_draws"]])
    assert perf[0] > 0 and perf[1] > 0
    np.testing.assert_allclose(perf, j_distill["perf"], rtol=PERF_RTOL)


def test_image_distill_step_attacks_the_student_and_trains(zoo, image):
    """`DistillConfig(adv_type="image")` trains: the step's attack is the
    whole-image PGD on the student's detached weights (no parameter gets
    a gradient from it, and its images are the eval attack's on the same
    weights), then `distill_step` on them (against JAX:
    `test_image_distill_step_and_eval_match_jax`)."""
    cfg = DistillConfig(adv_type="image", batch_size=zc.B, steps=1,
                        epsilon=0.01, alpha=0.002, scene_h=zc.H,
                        scene_w=zc.W, fold_bn=False)
    tr = DistillTrainer(cfg, torch.Generator().manual_seed(0), zoo.obj,
                        zoo.mask, zoo.t_pred, device="cpu",
                        init_state_dict=zoo.sd)
    state = tr.make_state()
    attack = tr.attack_student(state)
    assert isinstance(attack.predictor, EvalView)
    scenes = torch.from_numpy(zoo.scenes)
    adv, ben = attack(scenes, draws=image["draws"])
    assert all(p.grad is None for p in state.model.parameters())
    assert state.model.training
    # unfolded, the student's view computes what the eval predictor does
    image["t_atk"].steps = 1
    try:
        want, _ = image["t_atk"](scenes, draws=image["draws"])
    finally:
        image["t_atk"].steps = STEPS
    assert torch.equal(adv, want)

    ref = tr.make_state()
    _, m_ref = tr.distill_step(ref, adv, ben)
    state, m = tr.train_step(state, scenes, draws=image["draws"])
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-6)
    for (name, p), q in zip(state.model.named_parameters(),
                            ref.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, err_msg=name)


def test_image_distill_takes_the_configs_scene_size(zoo):
    cfg = DistillConfig(adv_type="image", scene_h=zc.H, scene_w=zc.W,
                        attack_scale=1)
    tr = DistillTrainer(cfg, torch.Generator().manual_seed(0), zoo.obj,
                        zoo.mask, zoo.t_pred, device="cpu",
                        init_state_dict=zoo.sd)
    assert tr.attack.scene_hw == (zc.H, zc.W)
    assert tr.scale_view is None  # JAX distill.py:113: not for "image"
    d = tr.attack.draw(torch.Generator().manual_seed(1), 3)
    assert d.noise.shape == (3, zc.H, zc.W, 3)
    assert float(d.noise.abs().max()) <= cfg.epsilon


def test_l2_uses_its_step_size_not_alpha(zoo):
    """build_attack(l_2): eps and steps from the config; the step size is
    2.5 eps / steps whatever `alpha` says (JAX attack_eval.py:101-103)."""
    cfg = AttackEvalConfig(norm_type="l_2", epsilon=16.0, alpha=0.02,
                           step=10)
    atk = build_attack(cfg, zoo.t_pred, zoo.obj, zoo.mask)
    assert (atk.eps, atk.steps, atk.alpha) == (16.0, 10, 4.0)


@pytest.mark.parametrize("targeted,random_start", [
    (False, True), (True, False), (False, False)])
def test_image_pgd_modes_match_jax(zoo, targeted, random_start):
    """Whole-image PGD untargeted (away from the clean prediction) and
    without a random start, one step: the step's gradient by the
    gradient rule and the step by the split rule, against JAX's. Both
    at once is a fixed point in both packages: the clean prediction's
    squared error has a zero gradient at the images themselves."""
    kw = dict(eps=0.01, alpha=0.002, steps=1, random_start=random_start,
              targeted=targeted, scene_hw=(zc.H, zc.W))
    j_atk = JPGDImageAttack(zoo.fwd, **kw)
    key, _, _ = zc.eval_key()
    grads = []
    orig = jax.grad

    def recording_grad(fn):
        g = orig(fn)

        def run(a):
            out = g(a)
            grads.append((np.asarray(a), np.asarray(out)))
            return out
        return run

    jax.grad = recording_grad
    try:
        with zc.eager_loops():
            adv_j, ben_j = j_atk._run(zoo.vars, zoo.sf, key)
    finally:
        jax.grad = orig
    adv_j = np.asarray(adv_j)
    draws = None
    if random_start:
        draws = ImageDraws(zc.t(jax.random.uniform(
            key, ben_j.shape, minval=-0.01, maxval=0.01)))
    atk = PGDImageAttack(zoo.t_pred, **kw)
    adv, ben = atk(torch.from_numpy(zoo.scenes), draws=draws)
    np.testing.assert_allclose(ben.numpy(), np.asarray(ben_j), atol=1e-4,
                               rtol=0)
    assert np.abs(adv.numpy() - ben.numpy()).max() <= 0.01 + 1e-6
    if not (targeted or random_start):
        assert torch.equal(adv, ben) and np.array_equal(adv_j,
                                                        np.asarray(ben_j))
        return
    x_j, g_j = grads[0]
    x = torch.from_numpy(x_j.copy()).requires_grad_(True)
    with torch.no_grad():
        clean = 0.0 if targeted else zoo.t_pred(ben)
    (g,) = torch.autograd.grad(torch.mean((zoo.t_pred(x) - clean) ** 2), x)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=GRAD_RTOL,
                               atol=IMAGE_GRAD_ATOL * np.abs(g_j).max())
    share = 1e-3 if targeted else UNTARGETED_SPLIT_SHARE
    assert _settled_split(adv.numpy(), adv_j, [g_j], same=1e-4) <= int(
        share * adv.numel())
