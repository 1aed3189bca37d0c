"""The port's L0 object attack, colour jitter and EoT extrinsic against
the JAX package (`attacks/l0_object.py`, `ops/color.py`,
`physics/eot.py`), and the L0 attack factories of the eval and
distillation paths.

Sizes of the JAX package's hardening tests (`tests/test_training.py:
27-29`): the model at 64x192, 96x320 scenes, a 24x36 car, attack batch
2, steps=2 (up to 4 L0 iterations). Student weights: the golden
reference-layout weights of tests/golden_common.py. The JAX attack's
`_optimize` is jitted, its loop's final step count read from its
`lax.while_loop`; its draws are rebuilt from the keys it splits
(`l0_object.py:84`, `fold_in(k_loop, step)`) and handed to the port as
`L0Draws`. The port runs its plain CPU versions of the kernels.

Tolerances, and why:

* colour ops: 2e-6 absolute (the contrast's image mean and the hue's
  float `%` round in another order; 7.2e-7 measured);
* `_cal_l0` exactly (a count), `_mask_cost` 1e-6 relative;
* the L0 loop (on a smooth per-pixel predictor, `PixelPredictor`): the
  iteration count and the break exactly; texels within 1e-4 of JAX's
  except at most 0.1% of them (measured: none at either threshold).
  Adam's update is lr * g / (|g| + eps) with lr 0.5: where |g| is
  within a few eps of 0, rounding moves a texel by up to 0.5. On the
  golden model the
  first iteration's gradients agree to 5.8e-5 of their largest
  magnitude, yet 0.15% of the texels move apart by up to 0.05 in
  Adam's first update, and the random-weight model's response to those
  texels parts the trajectories: 16% of the texels differ after 4
  iterations. So the loop is held on the smooth predictor, and on the
  model one iteration: its cost 1e-5 relative, its (pos, neg) gradients
  within rtol 1e-3 and 1e-3 of their largest magnitude;
* the jittered objective (the `transform` path, on the per-pixel
  predictor): cost 1e-5 relative,
  the texture gradient within 1e-3 of its largest magnitude (the
  cropped-objective rule of tests/test_torch_distill.py);
* EoT corners with an extrinsic: equal (integers); the tiled pair with
  a per-item extrinsic: 2e-5 absolute (the pass-1 products summed in
  another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depthmodelhardening_tpu.ops.color as j_color
from depthmodelhardening_tpu.attacks.base import (
    PhysObjAttackConfig as JPhysObjAttackConfig,
)
from depthmodelhardening_tpu.attacks.l0_object import (
    L0ObjectAttack as JL0ObjectAttack,
)
from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu.physics.eot import (
    ANGLE_RANGE, TRAIN_DIST_RANGE, stereo_T as j_stereo_T,
)
from depthmodelhardening_tpu.training.adv_synth import (
    make_synth_compositor as j_make_synth_compositor,
)
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.l0_object import (
    L0Draws, L0ObjectAttack, default_l0_config,
)
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, build_attack,
)
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import color
from depthmodelhardening_tpu_torch.physics.eot import stereo_T
from depthmodelhardening_tpu_torch.training import distill
from depthmodelhardening_tpu_torch.training.adv_synth import (
    make_synth_compositor,
)
from depthmodelhardening_tpu_torch.training.config import DistillConfig

from golden_common import depth_decoder_state_dict, resnet18_encoder_state_dict
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

H, W = 64, 192
ORI_H, ORI_W = 96, 320
OBJ_H, OBJ_W = 24, 36
B, STEPS = 2, 2
COLOR_ATOL = 2e-6
TEX_ATOL, TEX_SPLIT_MAX = 1e-4, 1e-3
JITTER = ((2, 0, 3, 1), (1.13, 0.87, 1.16, -0.07))


# -- colour ------------------------------------------------------------------
def _img(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 16, 20, 3).astype(np.float32)
    img[0, :3] = 0.5  # grey rows: zero chroma, the hue's cr == 0 branch
    img[1, :, :2, 1] = img[1, :, :2, 0]  # r == g == max ties
    return img


@pytest.mark.parametrize("name,factor", [
    ("adjust_brightness", 1.13), ("adjust_contrast", 0.87),
    ("adjust_saturation", 1.19), ("adjust_hue", -0.07),
    ("adjust_hue", 0.09)])
def test_color_ops_match_jax(name, factor):
    img = _img()
    want = np.asarray(getattr(j_color, name)(jnp.asarray(img), factor))
    got = getattr(color, name)(torch.from_numpy(img), factor).numpy()
    np.testing.assert_allclose(got, want, atol=COLOR_ATOL, rtol=0)
    np.testing.assert_array_equal(
        color.rgb_to_grayscale(torch.from_numpy(img)).numpy(),
        np.asarray(j_color.rgb_to_grayscale(jnp.asarray(img))))


def test_color_jitter_matches_jax_in_every_order():
    """apply_color_jitter in all 24 op orders; per-item factors; the
    sampled (order, factors) from one numpy RandomState."""
    img = _img(1)
    factors = (1.1, 0.85, 1.15, 0.06)
    for order in itertools.permutations(range(4)):
        want = np.asarray(j_color.apply_color_jitter(jnp.asarray(img), order,
                                                     factors))
        got = color.apply_color_jitter(torch.from_numpy(img), order,
                                       factors).numpy()
        np.testing.assert_allclose(got, want, atol=COLOR_ATOL, rtol=0,
                                   err_msg=str(order))
    rng = np.random.RandomState(3)
    fc = rng.uniform(0.8, 1.2, (2, 1, 1, 1)).astype(np.float32)
    fh = rng.uniform(-0.1, 0.1, (2, 1, 1)).astype(np.float32)
    want = j_color.adjust_hue(j_color.adjust_contrast(jnp.asarray(img),
                                                      jnp.asarray(fc)),
                              jnp.asarray(fh))
    got = color.adjust_hue(color.adjust_contrast(torch.from_numpy(img),
                                                 torch.from_numpy(fc)),
                           torch.from_numpy(fh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=COLOR_ATOL, rtol=0)
    assert color.sample_color_jitter(np.random.RandomState(5)) == \
        j_color.sample_color_jitter(np.random.RandomState(5))


# -- the L0 attack -----------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """The JAX model's variables and the port's predictor, both from the
    golden weights."""
    enc_sd = resnet18_encoder_state_dict(seed=0)
    dec_sd = depth_decoder_state_dict(seed=0)
    ev, _ = convert_resnet_encoder(enc_sd)
    dv = convert_depth_decoder(dec_sd)
    j_vars = {"params": {"encoder": ev["params"], "decoder": dv["params"]},
              "batch_stats": {"encoder": ev["batch_stats"]}}
    model = make_monodepth2()
    model.load_state_dict(load_reference_state_dict(enc_sd, dec_sd))
    return j_vars, predictor_from(model)


class PixelPredictor:
    """A smooth per-pixel disparity, sigmoid(2 r - g + b / 2): the L0
    loop's test predictor (see the module docstring)."""

    device = torch.device("cpu")

    def __call__(self, x):
        return torch.sigmoid(2.0 * x[..., :1] - x[..., 1:2]
                             + 0.5 * x[..., 2:3])


def j_pixel_predict(variables, x):
    return jax.nn.sigmoid(2.0 * x[..., :1] - x[..., 1:2] + 0.5 * x[..., 2:3])


def _atk_kw():
    return dict(obj_h=OBJ_H, obj_w=OBJ_W, scene_h=H, scene_w=W, ori_h=ORI_H,
                ori_w=ORI_W,
                dist_range=tuple(float(x) for x in TRAIN_DIST_RANGE))


def _attacks(models=None, **kw):
    """The JAX and the port's L0 attacks on the golden model (`models`),
    or on the per-pixel predictor."""
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    if models is None:
        j_fn, predictor = j_pixel_predict, PixelPredictor()
    else:
        jm = j_make_monodepth2().clone(scales=(0,))
        j_fn, predictor = (lambda v, x: jm.apply(v, x, train=False),
                           models[1])
    j_atk = JL0ObjectAttack(j_fn, obj, mask,
                            JPhysObjAttackConfig(**_atk_kw()), steps=STEPS,
                            mask_wt=0.05, **kw)
    atk = L0ObjectAttack(predictor, obj, mask,
                         PhysObjAttackConfig(**_atk_kw()), steps=STEPS,
                         mask_wt=0.05, **kw)
    return j_atk, atk


def l0_draws(j_atk, key, batch, steps, jitter=None) -> L0Draws:
    """The draws of JAX `L0ObjectAttack._optimize(..., key)` (its
    `split(key, 3)` and `fold_in(k_loop, step)`), and of the finals from
    `k_final`, as L0Draws."""
    k_pos, k_neg, k_loop = jax.random.split(key, 3)
    shape = j_atk.obj_img.shape
    za = [j_atk._sample_za(jax.random.fold_in(k_loop, s), batch)
          for s in range(2 * steps)]
    fz, fa = j_atk._sample_za(jax.random.fold_in(key, 99), batch)
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    return L0Draws(pos=t(jax.random.uniform(k_pos, shape)),
                   neg=t(jax.random.uniform(k_neg, shape)),
                   z0s=t(np.stack([np.asarray(z) for z, _ in za])),
                   alphas=t(np.stack([np.asarray(a) for _, a in za])),
                   final_z0s=t(fz), final_alphas=t(fa), jitter=jitter)


def jax_optimize_with_count(j_atk):
    """jit of JAX `_optimize` that also returns its loop's final step
    (the `lax.while_loop` carry's first element, taken while tracing)."""
    def run(variables, scenes, key):
        steps = []
        orig = jax.lax.while_loop

        def while_loop(cond, body, init):
            out = orig(cond, body, init)
            steps.append(out[0])
            return out

        jax.lax.while_loop = while_loop
        try:
            tex = j_atk._optimize(variables, scenes, key)
        finally:
            jax.lax.while_loop = orig
        return tex, steps[0]

    return jax.jit(run)


def test_cal_l0_and_mask_cost_match_jax():
    j_atk, atk = _attacks()
    rng = np.random.RandomState(4)
    pos = rng.uniform(-0.3, 1.3, (1, OBJ_H, OBJ_W, 3)).astype(np.float32)
    neg = rng.uniform(-0.3, 1.3, (1, OBJ_H, OBJ_W, 3)).astype(np.float32)
    pos[0, :4] = 0.5 / 255  # below the 1/255 threshold
    neg[0, 4:8] = 0.5 / 255
    pos[0, 8:10], neg[0, 8:10] = 0.5 / 255, -0.1  # both zeroed
    jp, jn = jnp.asarray(pos), jnp.asarray(neg)
    tp, tn = torch.from_numpy(pos), torch.from_numpy(neg)
    want = float(j_atk._cal_l0(jp, jn))
    assert float(atk._cal_l0(tp, tn)) == want
    assert 0 < want < OBJ_H * OBJ_W
    assert float(atk._mask_cost(tp, tn)) == pytest.approx(
        float(j_atk._mask_cost(jp, jn)), rel=1e-6)


@pytest.mark.parametrize("thresh,iterations,early_break", [
    (0.1, 2 * STEPS, False),  # the ratio stays near 1: no break
    (1.0, STEPS, True),       # ratio <= 1 always: break at `steps`
])
def test_l0_loop_matches_jax(thresh, iterations, early_break):
    """JAX's jitted `_optimize` and the port's under the same draws, on
    the per-pixel predictor: the iteration count, whether the break
    fired, and the texture (all but TEX_SPLIT_MAX of the texels within
    TEX_ATOL)."""
    j_atk, atk = _attacks(l0_thresh=thresh)
    scenes = make_scene(1, ORI_H, ORI_W, seed=2)
    scenes_b = np.broadcast_to(scenes, (B,) + scenes.shape[1:])
    key = jax.random.PRNGKey(11)
    tex_j, n_j = jax_optimize_with_count(j_atk)(None, jnp.asarray(scenes_b),
                                               key)
    draws = l0_draws(j_atk, key, B, STEPS)
    tex = atk._optimize(torch.from_numpy(scenes_b.copy()), draws)
    assert int(n_j) == iterations
    assert atk.last_iterations == iterations
    assert atk.last_early_break is early_break
    split = np.abs(tex.numpy() - np.asarray(tex_j)) > TEX_ATOL
    assert split.mean() <= TEX_SPLIT_MAX, split.mean()
    # the patterns moved the texture
    assert float((tex - atk.obj_img).abs().max()) > 0.1


def test_l0_iteration_gradient_on_the_model_matches_jax(models):
    """On the golden model: the first iteration's cost and gradients with
    respect to (pos, neg), mask weight on, against `jax.grad` of JAX's
    cost at the same draws (rtol 1e-3, atol 1e-3 of the largest
    magnitude; 5.8e-5 of it measured)."""
    j_vars, _ = models
    j_atk, atk = _attacks(models)
    scenes = make_scene(1, ORI_H, ORI_W, seed=2)
    scenes_b = np.broadcast_to(scenes, (B,) + scenes.shape[1:]).copy()
    d = l0_draws(j_atk, jax.random.PRNGKey(11), B, STEPS)

    def cost(params, z0s, alphas):
        pp, pn = j_atk._patterns(*params)
        adv = jnp.clip(j_atk.obj_img + pp + pn, 0.0, 1.0)
        return (j_atk._objective(j_vars, jnp.asarray(scenes_b), adv, z0s,
                                 alphas)
                + 0.05 * j_atk._mask_cost(*params))

    want = jax.jit(jax.value_and_grad(cost))(
        (jnp.asarray(d.pos.numpy()), jnp.asarray(d.neg.numpy())),
        jnp.asarray(d.z0s[0].numpy()), jnp.asarray(d.alphas[0].numpy()))
    got = atk.cost_and_grads(torch.from_numpy(scenes_b), d.pos, d.neg,
                             d.z0s[0], d.alphas[0], 0.05)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    for g, w in zip(got[1], want[1]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


def test_jittered_objective_matches_jax():
    """The `transform` path (the L0 attack's colour jitter on the
    full-frame composites, even with a crop configured), on the per-pixel
    predictor: cost and its texture gradient against JAX's
    `_objective(..., transform=...)`."""
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    kw = dict(_atk_kw(), attack_crop_w=128, tile_w=128, tile_h=64)
    j_atk = JL0ObjectAttack(j_pixel_predict, obj, mask,
                            JPhysObjAttackConfig(**kw))
    atk = L0ObjectAttack(PixelPredictor(), obj, mask,
                         PhysObjAttackConfig(**kw))
    scenes = make_scene(B, ORI_H, ORI_W, seed=6)
    z0s, alphas = np.array([5.4, 7.8], np.float32), np.array([-10.0, 15.0],
                                                             np.float32)
    tex = np.clip(obj + 0.2, 0.0, 1.0).astype(np.float32)
    fn = lambda s: j_color.apply_color_jitter(s, *JITTER)
    cost_j, g_j = jax.value_and_grad(lambda t: j_atk._objective(
        None, jnp.asarray(scenes), t, jnp.asarray(z0s), jnp.asarray(alphas),
        transform=fn))(jnp.asarray(tex))
    with torch.enable_grad():
        t = torch.from_numpy(tex).requires_grad_(True)
        cost = atk._objective(torch.from_numpy(scenes), t, z0s, alphas,
                              transform=lambda s: color.apply_color_jitter(
                                  s, *JITTER))
        (g,) = torch.autograd.grad(cost, t)
    assert float(cost.detach()) == pytest.approx(float(cost_j), rel=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    plain = atk._objective(torch.from_numpy(scenes), torch.from_numpy(tex),
                           z0s, alphas)
    assert float(plain) != pytest.approx(float(cost), rel=1e-3)


def test_l0_draws_and_eval_pin():
    """`draw` gives 2 * steps EoT samples and the construction's jitter;
    the eval pin is 6.1 (a 7.0 pin is rewritten, as in JAX)."""
    _, atk = _attacks(color_jit=True, jitter_seed=3)
    d = atk.draw(torch.Generator().manual_seed(0), B)
    assert d.z0s.shape == (2 * STEPS, B) and d.alphas.shape == (2 * STEPS, B)
    assert d.pos.shape == (1, OBJ_H, OBJ_W, 3) and 0 <= float(d.pos.min())
    assert d.jitter == color.sample_color_jitter(np.random.RandomState(3))
    assert atk.cfg.eval_pin_z0 == 6.1
    assert default_l0_config(OBJ_H, OBJ_W).eval_pin_z0 == 6.1


def test_l0_attack_factories(models):
    """`build_attack`'s l_0 (AttackEvalConfig's adam_lr, mask_wt,
    l0_thresh) and the distillation's adv_type "object_l0", each as the
    JAX package builds it."""
    from depthmodelhardening_tpu.evaluation.attack_eval import (
        AttackEvalConfig as JAttackEvalConfig, build_attack as j_build_attack,
    )
    from depthmodelhardening_tpu.training.config import (
        DistillConfig as JDistillConfig,
    )
    from depthmodelhardening_tpu.training.distill import (
        build_attack as j_distill_attack,
    )

    _, predictor = models
    obj, mask = make_car_object(60, 40)
    kw = dict(norm_type="l_0", step=3, adam_lr=0.3, mask_wt=0.02,
              l0_thresh=0.2)
    built = (
        (build_attack(AttackEvalConfig(**kw), predictor, obj, mask),
         j_build_attack(JAttackEvalConfig(**kw), None, obj, mask)),
        (distill.build_attack(DistillConfig(
            adv_type="object_l0", steps=3, adam_lr=0.3, mask_wt=0.02,
            l0_thresh=0.2), predictor, obj, mask),
         j_distill_attack(JDistillConfig(
             adv_type="object_l0", steps=3, adam_lr=0.3, mask_wt=0.02,
             l0_thresh=0.2), None, obj, mask)))
    for got, want in built:
        assert isinstance(got, L0ObjectAttack)
        for name in ("adam_lr", "steps", "mask_wt", "l0_thresh"):
            assert getattr(got, name) == getattr(want, name), name
        for name in ("eval_pin_z0", "dist_range", "scene_h", "ori_w"):
            assert getattr(got.cfg, name) == getattr(want.cfg, name), name
        assert got.cfg.eval_pin_z0 == 6.1


# -- EoT with an extrinsic ---------------------------------------------------
@pytest.mark.parametrize("ori", [(ORI_H, ORI_W), (375, 1242)])
def test_corners_with_extrinsic_match_jax(ori):
    """The synthesis compositor's corners for both eyes (stereo_T of
    either side, and none) and a per-item extrinsic, over the training
    distances and yaws: equal to JAX's (`P4 @ T` summed as XLA:CPU
    sums it; a corner is truncated to an integer)."""
    oh, ow = ori
    j_eot = j_make_synth_compositor(OBJ_H, OBJ_W, oh, ow)
    eot = make_synth_compositor(OBJ_H, OBJ_W, oh, ow)
    z, a = (v.ravel().astype(np.float32)
            for v in np.meshgrid(TRAIN_DIST_RANGE, ANGLE_RANGE))
    for side in ("l", "r"):
        np.testing.assert_array_equal(stereo_T(0.54, side),
                                      j_stereo_T(0.54, side))
    per_item = np.stack([j_stereo_T(0.54, "l") if i % 3 else
                         (j_stereo_T(0.54, "r") if i % 2 else np.eye(4))
                         for i in range(z.size)]).astype(np.float32)
    for T in (None, j_stereo_T(0.54, "l"), j_stereo_T(0.54, "r"), per_item):
        if T is None or T.ndim == 2:
            want = jax.vmap(lambda zz, aa: j_eot.corners(
                zz, aa, None if T is None else jnp.asarray(T)))(
                jnp.asarray(z), jnp.asarray(a))
        else:
            want = jax.vmap(j_eot.corners)(jnp.asarray(z), jnp.asarray(a),
                                           jnp.asarray(T))
        got = eot.corners(torch.from_numpy(z), torch.from_numpy(a),
                          None if T is None else torch.from_numpy(T))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiled_pair_with_per_item_extrinsic_matches_jax():
    """composite_tiled_pair at native resolution with a (B, 4, 4)
    extrinsic (the synthesis' current eye), against JAX's."""
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    j_eot = j_make_synth_compositor(OBJ_H, OBJ_W, ORI_H, ORI_W)
    eot = make_synth_compositor(OBJ_H, OBJ_W, ORI_H, ORI_W)
    scenes = make_scene(3, ORI_H, ORI_W, seed=8)
    adv = np.clip(obj + 0.3, 0.0, 1.0).astype(np.float32)
    z0s = np.array([5.0, 6.6, 9.8], np.float32)
    alphas = np.array([-30.0, 5.0, 25.0], np.float32)
    T = np.stack([np.eye(4), j_stereo_T(0.54, "l"),
                  j_stereo_T(0.54, "l")]).astype(np.float32)
    kw = dict(model_h=ORI_H, model_w=ORI_W, tile_h=96, tile_w=296)
    want = j_eot.composite_tiled_pair(
        jnp.asarray(scenes), jnp.asarray(adv), jnp.asarray(obj),
        jnp.asarray(mask), jnp.asarray(z0s), jnp.asarray(alphas),
        T=jnp.asarray(T), **kw)
    got = eot.composite_tiled_pair(
        torch.from_numpy(scenes), torch.from_numpy(adv),
        torch.from_numpy(obj), torch.from_numpy(mask), z0s, alphas,
        T=torch.from_numpy(T), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)
    assert float(got[2].sum()) > 0
    # the other eye's quad sits elsewhere than the current eye's
    no_T = eot.composite_tiled_pair(
        torch.from_numpy(scenes), torch.from_numpy(adv),
        torch.from_numpy(obj), torch.from_numpy(mask), z0s, alphas, **kw)
    assert torch.equal(no_T[2][0], got[2][0])
    assert not torch.equal(no_T[2][1], got[2][1])
