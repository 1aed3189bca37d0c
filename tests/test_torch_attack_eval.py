"""The port's attack-eval slice against the JAX package, end to end.

Monodepth2-18 with the deterministic reference-layout weights of
tests/golden_common.py at 96x320, batch 2, L-inf PGD (eps 0.1, alpha
0.005), synthetic 375x1242 scenes and a 40x60 car. The JAX draws (random
start, per-step EoT samples, finals) are rebuilt with the JAX package's
own calls and handed to the port, so both sides see the same numbers.
The port runs its plain CPU versions of the kernels here.

Tolerances: the texture gradient of each step to rtol 1e-3 with an
atol of 1e-3 of its max (float32 convolutions summed in another order;
measured 1.2e-4 of the max). A sign step splits where a JAX gradient is
below 1e-6 of its max: there the sign is decided by rounding (e.g. a
mask tile that is 1e-7 on one side and 0 on the other gives a gradient
of 1e-12 against 0; ROADMAP Queue 3). One step from the same start
matches everywhere else. After a split, the next step's gradient sees
two textures that differ by alpha at that texel, and a few texels the
network makes sensitive to it flip too (5 of 7200 on this fixture), so
two steps may differ at up to 0.1% of the texels outside the floor.
Eval metrics: rtol 1e-3, atol 1e-3 (a1..a3 are fractions of about a
thousand mask pixels; one pixel moves them by about 8e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.evaluation.attack_eval import (
    AttackEvalConfig as JAttackEvalConfig, build_attack as j_build_attack,
    evaluate_attacks as j_evaluate_attacks,
)
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2, predictor_from as j_predictor_from,
)
from depthmodelhardening_tpu_torch.attacks.pgd_object import PGDDraws
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)

from golden_common import depth_decoder_state_dict, resnet18_encoder_state_dict
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, OBJ_H, OBJ_W, STEPS = 2, 40, 60, 2
EVAL_KW = dict(norm_type="l_inf", epsilon=0.1, alpha=0.005, step=STEPS,
               batch_size=B, eval_count=1, scene_h=96, scene_w=320,
               ori_h=375, ori_w=1242)
SIGN_FLOOR = 1e-6


def _make_setup():
    enc_sd = resnet18_encoder_state_dict(seed=0)
    dec_sd = depth_decoder_state_dict(seed=0)
    ev, _ = convert_resnet_encoder(enc_sd)
    dv = convert_depth_decoder(dec_sd)
    j_vars = {"params": {"encoder": ev["params"],
                         "decoder": dv["params"]},
              "batch_stats": {"encoder": ev["batch_stats"]}}
    j_pred = j_predictor_from(j_make_monodepth2(), j_vars)
    model = make_monodepth2()
    model.load_state_dict(load_reference_state_dict(enc_sd, dec_sd))
    t_pred = predictor_from(model)

    obj, mask = make_car_object(width=OBJ_W, height=OBJ_H)
    scenes = make_scene(B, 375, 1242, seed=1)
    j_cfg = JAttackEvalConfig(**EVAL_KW)
    j_atk = j_build_attack(j_cfg, j_pred.apply_fn, jnp.asarray(obj),
                           jnp.asarray(mask))
    t_cfg = AttackEvalConfig(**EVAL_KW)
    t_atk = build_attack(t_cfg, t_pred, obj, mask)

    # the draws of batch 0 exactly as the JAX evaluate_attacks makes them
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    k_opt, k_final = jax.random.split(key)
    k_init, k_loop = jax.random.split(k_opt)
    noise = jax.random.uniform(k_init, obj.shape, minval=-0.1, maxval=0.1)
    za = [j_atk._sample_za(jax.random.fold_in(k_loop, s), B)
          for s in range(STEPS)]
    fz, fa = j_atk._final_za(k_final, B)
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    draws = PGDDraws(noise=t(noise),
                     z0s=t(np.stack([np.asarray(z) for z, _ in za])),
                     alphas=t(np.stack([np.asarray(a) for _, a in za])),
                     final_z0s=t(fz), final_alphas=t(fa))

    # JAX trajectory with its gradient at every step (the same update as
    # PGDObjectAttack._optimize)
    scenes_full = jnp.asarray(scenes)
    grad_fn = jax.jit(jax.grad(lambda o, z, a: j_atk._objective(
        j_vars, scenes_full, o, z, a)))
    obj_j = jnp.clip(jnp.asarray(obj) + noise, 0.0, 1.0)
    starts, grads = [], []
    for s in range(STEPS):
        starts.append(np.asarray(obj_j))
        g = grad_fn(obj_j, *za[s])
        grads.append(np.asarray(g))
        obj_j = obj_j - 0.005 * jnp.sign(g)
        obj_j = jnp.clip(jnp.asarray(obj)
                         + jnp.clip(obj_j - jnp.asarray(obj), -0.1, 0.1),
                         0.0, 1.0)
    return dict(j_pred=j_pred, j_atk=j_atk, j_cfg=j_cfg, t_pred=t_pred,
                t_atk=t_atk, t_cfg=t_cfg, scenes=scenes, draws=draws,
                starts=starts, grads=grads, obj=obj, j_final=obj_j)


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


@pytest.mark.parametrize("step", range(STEPS))
def test_texture_gradient_matches_jax(setup, step):
    """The port's texture gradient from the JAX trajectory's texture at
    each step, under the same EoT draw."""
    s, d = setup, setup["draws"]
    scenes = torch.from_numpy(s["scenes"])
    _, g = s["t_atk"].objective_and_grad(
        scenes, torch.from_numpy(s["starts"][step].copy()), d.z0s[step],
        d.alphas[step])
    g_j = s["grads"][step]
    scale = float(np.abs(g_j).max())
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * scale)


@pytest.mark.parametrize("steps", [1, 2])
def test_final_texture_matches_jax(setup, steps):
    """`steps` sign steps of the port from the same random start and
    EoT draws land on JAX's texture, except where a JAX gradient was
    too small for its sign to be decided by more than rounding (and,
    after the first step, downstream of such a split)."""
    s, d = setup, setup["draws"]
    atk = s["t_atk"]
    atk.steps = steps
    try:
        scenes = torch.from_numpy(s["scenes"])
        obj_t = atk._optimize(atk._replicate(scenes, B), d).numpy()
    finally:
        atk.steps = STEPS
    if steps == STEPS:
        obj_j = np.asarray(s["j_final"])
    else:
        obj_j = s["starts"][steps]
    settled = np.ones(obj_j.shape, bool)
    for g in s["grads"][:steps]:
        settled &= np.abs(g) >= SIGN_FLOOR * np.abs(g).max()
    assert settled.mean() > 0.5
    obj = s["obj"]
    assert np.abs(obj_t - obj).max() <= 0.1 + 1e-6
    assert obj_t.min() >= 0.0 and obj_t.max() <= 1.0
    split = settled & (np.abs(obj_t - obj_j) > 1e-6)
    allowed = 0 if steps == 1 else int(1e-3 * obj_j.size)
    assert split.sum() <= allowed, np.argwhere(split)


def test_evaluate_attacks_matches_jax(setup):
    """The 8 masked metrics of one eval batch, port vs JAX
    evaluate_attacks (JAX draws its own keys; the port gets them)."""
    s = setup
    res_j = j_evaluate_attacks(s["j_pred"], s["j_atk"], [s["scenes"]],
                               s["j_cfg"], rng=jax.random.PRNGKey(17))
    res_t = evaluate_attacks(s["t_pred"], s["t_atk"], [s["scenes"]],
                             s["t_cfg"], draws=[s["draws"]])
    for agg in ("mean", "max"):
        for name, v in res_j[agg].items():
            assert np.isfinite(res_t[agg][name])
            np.testing.assert_allclose(res_t[agg][name], v, rtol=1e-3,
                                       atol=1e-3, err_msg=f"{agg} {name}")
