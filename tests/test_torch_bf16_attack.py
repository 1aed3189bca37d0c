"""The bf16 tests of the attack against the JAX package: the bf16 view
of the cropped objective, the coarse-scale objective and the
coarse-to-fine texture. Weights, inputs and tolerances:
tests/bf16_common.py's docstring and each test's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bf16_common import (
    B, CROP, H, KW, SCALE_COST_RTOL, SCALE_GRAD_L2, SIGN_FLOOR, SPLIT_MAX,
    W, _draws, _f32, _jax_trainer, _port_trainer, _rl2, _ulp, scene,
    student_weights, weights,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


def test_bf16_view_matches_jax(weights, student_weights, scene):
    """The cropped objective's bf16 view (pass 1 and the composite in
    bf16, warp A in float32): the port's paste-then-crop against JAX
    `_model_view_cropped` under the same draw. Elements within one bf16
    ulp and at most 1e-4 of them apart (2e-5 measured), masks and the
    crop's rescale equal; most elements of the float32 view differ."""
    args = [scene[k] for k in ("scenes", "start", "z0s", "alphas")]
    out = {}
    for dt in ("float32", "bfloat16"):
        kw = dict(**KW, **CROP, attack_view_dtype=dt)
        j_atk = _jax_trainer(weights, student_weights, scene, **kw).attack
        adv_j, m_j, s_j = j_atk._model_view_cropped(
            *(jnp.asarray(a) for a in args), 128, 64)
        tr = _port_trainer(weights, student_weights, scene, **kw)
        adv_t, m_t, s_t = tr.attack_student(tr.make_state()) \
            ._model_view_cropped(*(torch.from_numpy(a) for a in args), 128,
                                 64)
        assert adv_t.dtype == m_t.dtype == getattr(torch, dt)
        assert adv_j.dtype == jnp.dtype(dt)
        assert s_t == s_j
        np.testing.assert_array_equal(m_t.float().numpy(), _f32(m_j))
        out[dt] = (adv_t.float().numpy(), _f32(adv_j))
    got, want = out["bfloat16"]
    err = np.abs(got - want)
    assert (err <= _ulp(want)).all()
    assert (err > 0).mean() <= 1e-4
    f32_view = out["float32"][1]
    assert (want != f32_view).mean() > 0.5  # the bf16 view rounds


@pytest.mark.parametrize("crop", [False, True])
def test_coarse_objective_matches_jax(weights, student_weights, scene, crop):
    """attack_scale=1 (float32): the objective read from the student's
    disp1 against the mask resized to its resolution, and its texture
    gradient, against JAX `_objective` with the trainer's
    `predict_scale_fn` (`_cost_tail`); fine=True reads disp0. Cost
    within 5e-5 relative (1.7e-5 measured, cropped), gradient relative
    L2 2e-2 and max error 2e-2 of its max (6.7e-3 and 9.2e-3 full frame,
    1.1e-4 and 1.7e-4 cropped)."""
    kw = dict(**KW, **(CROP if crop else {}), attack_scale=1)
    j_atk = _jax_trainer(weights, student_weights, scene, **kw).attack
    assert j_atk.predict_scale_fn is not None
    student = {k: student_weights["jv"][k] for k in ("params",
                                                     "batch_stats")}
    args = [scene[k] for k in ("scenes", "start", "z0s", "alphas")]
    tr = _port_trainer(weights, student_weights, scene, **kw)
    atk = tr.attack_student(tr.make_state())
    for fine in (False, True):
        cost_j, g_j = jax.jit(jax.value_and_grad(
            lambda o, s, z, a: j_atk._objective(student, s, o, z, a,
                                                fine=fine)))(
            jnp.asarray(args[1]), jnp.asarray(args[0]), jnp.asarray(args[2]),
            jnp.asarray(args[3]))
        cost_t, g_t = atk.objective_and_grad(
            *(torch.from_numpy(a) for a in args), fine=fine)
        assert float(cost_t) == pytest.approx(float(cost_j),
                                              rel=SCALE_COST_RTOL), fine
        g_j = np.asarray(g_j)
        print(f"coarse objective crop={crop} fine={fine}: cost rel "
              f"{abs(float(cost_t) / float(cost_j) - 1):.2e}, gradient "
              f"rel L2 {_rl2(g_t.numpy(), g_j):.2e}, max "
              f"{np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max():.2e}")
        assert _rl2(g_t.numpy(), g_j) <= SCALE_GRAD_L2, fine
        assert np.abs(g_t.numpy() - g_j).max() <= \
            SCALE_GRAD_L2 * np.abs(g_j).max(), fine
        if not fine:
            coarse = float(cost_t)
    assert coarse != float(cost_t)  # the two heads differ


def test_coarse_to_fine_texture_matches_jax(weights, student_weights, scene):
    """PGD-3 with attack_scale=1 and one fine step (float32), under JAX's
    draws: two steps on disp1, the last on disp0.

    Sign-PGD trajectories part here after the first split: 9 texels
    split at step 0 change the sign of the next gradient on 147 more
    (measured), so each step is held from JAX's own trajectory point
    (from its eager gradients; its jitted ones lie a few percent of the
    max from them at the model's kinks, test_torch_distill.py): the
    port's texture gradient within 2e-2 relative L2 of JAX's (5.5e-3,
    2.0e-3, 6.1e-3 measured) and its sign split on at most 0.3% of the
    texels whose JAX gradient is above 1e-6 of the max (0.13% measured),
    and the step taken from it equal to JAX's elsewhere. The port's
    attack call then takes exactly those steps: its texture equals the
    same three steps taken by hand with the coarse objective twice and
    the fine once, and the scale-1 head is read twice."""
    kw = dict(KW, steps=3, attack_scale=1, attack_scale_fine_steps=1)
    j_atk = _jax_trainer(weights, student_weights, scene, **kw).attack
    student = {k: student_weights["jv"][k] for k in ("params",
                                                     "batch_stats")}
    d = _draws(j_atk, jax.random.PRNGKey(23), 3)
    scenes_j = jnp.asarray(scene["scenes"])
    scenes = torch.from_numpy(scene["scenes"])
    tr = _port_trainer(weights, student_weights, scene, **kw)
    atk = tr.attack_student(tr.make_state())

    def step(o, g):
        o = o - 0.005 * np.sign(g)
        return np.clip(scene["obj"] + np.clip(o - scene["obj"], -0.1, 0.1),
                       0.0, 1.0)

    o = np.clip(scene["obj"] + d.noise.numpy(), 0.0, 1.0)
    o_port = torch.from_numpy(o)
    for s in range(3):
        fine = s == 2
        z, a = d.z0s[s], d.alphas[s]
        g_j = np.asarray(jax.grad(lambda oo: j_atk._objective(
            student, scenes_j, oo, jnp.asarray(z.numpy()),
            jnp.asarray(a.numpy()), fine=fine))(jnp.asarray(o)))
        _, g_t = atk.objective_and_grad(scenes, torch.from_numpy(o), z, a,
                                        fine=fine)
        g_t = g_t.numpy()
        assert _rl2(g_t, g_j) <= SCALE_GRAD_L2, s
        settled = np.abs(g_j) >= SIGN_FLOOR * np.abs(g_j).max()
        split = settled & (np.sign(g_t) != np.sign(g_j))
        assert split.sum() <= int(3 * SPLIT_MAX * split.size), (s,
                                                                split.sum())
        same = ~split & settled
        np.testing.assert_array_equal(step(o, g_t)[same], step(o, g_j)[same])
        _, g_p = atk.objective_and_grad(scenes, o_port, z, a, fine=fine)
        o_port = torch.from_numpy(step(o_port.numpy(), g_p.numpy()))
        o = step(o, g_j)

    calls = []
    coarse_view = atk.predict_scale
    atk.predict_scale = lambda x: calls.append(x.shape) or coarse_view(x)
    *_, obj_adv = atk(scenes, B, eval_mode=False, draws=d)
    assert calls == [(B, H, W, 3)] * 2  # the two coarse steps
    assert torch.equal(obj_adv, o_port.float())
