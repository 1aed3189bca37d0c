"""The L0 attack on a ManyDepth student against the JAX package's, for
its early break (ROADMAP Queue 3: on the card ManyDepth's L0 loop broke
at `steps` iterations, phases 14b and 14c, while Monodepth2's ran all
2 * steps).

JAX's jitted `_optimize` (tests/test_torch_l0.py's `jax_optimize_with_count`)
and the port's, on the ManyDepth train model's eval-mode disp0 in its
single-frame mode (4 depth bins, the model at 64x192, 96x320 scenes, a
24x36 car, attack batch 2, the trainer's mask weight 0.1 and threshold
0.1), from the same weights (flax's initialisation, BatchNorm perturbed
as tests/families_common.py does) and the draws JAX's keys make
(`l0_draws`). Held: the iteration at which the loop stops and whether
the break fired, exactly; the L0 ratio at every check within RATIO_ATOL
(Adam's sign-like steps part the trajectories by a few texels: 2.3e-3,
two texels of 864, measured at worst; tests/test_torch_l0.py's rule on
the model, so the texture is not held); the first iteration's (pos, neg)
gradients (JAX's read inside its loop, at the optimiser's first update)
within rtol 1e-3 and 1e-3 of their largest magnitude. Measured:
both loops break at iteration 10 = steps, the ratio falling 1.0, 0.999,
0.80, 0.29, 0.05 over the first iterations: where the disparity's
gradient is weaker than the mask cost's, Adam's first steps (about lr
0.5 each) take the patterns to zero. So the early break belongs to the
model, as the card showed for ManyDepth (phases 14b and 14c).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthmodelhardening_tpu.attacks.base import (
    PhysObjAttackConfig as JPhysObjAttackConfig,
)
from depthmodelhardening_tpu.attacks.l0_object import (
    L0ObjectAttack as JL0ObjectAttack,
)
from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.models.wrappers import (
    ManyDepthTrainModel as JManyDepth,
)
from depthmodelhardening_tpu.physics.eot import TRAIN_DIST_RANGE
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.attacks.l0_object import L0ObjectAttack
from depthmodelhardening_tpu_torch.models.convert import from_jax_variables
from depthmodelhardening_tpu_torch.models.wrappers import (
    ManyDepthTrainModel, predictor_from,
)

from families_common import _np, _perturbed
from test_torch_l0 import jax_optimize_with_count, l0_draws
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

H, W = 64, 192
ORI_H, ORI_W = 96, 320
OBJ_H, OBJ_W = 24, 36
B, STEPS, BINS = 2, 10, 4
MASK_WT, THRESH = 0.1, 0.1  # AdvSynthConfig's
RATIO_ATOL = 5e-3


@pytest.fixture(scope="module")
def runs():
    """Both loops' checked ratios, iterations, and first gradients."""
    jm = JManyDepth(input_height=H, input_width=W, num_depth_bins=BINS)
    x = jnp.zeros((1, H, W, 3))
    v = _perturbed(_np(jax.jit(lambda k: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0))), 2)
    port = ManyDepthTrainModel(input_height=H, input_width=W,
                               num_depth_bins=BINS)
    port.load_state_dict(from_jax_variables(v))
    jm0 = jm.clone(scales=(0,))
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    kw = dict(obj_h=OBJ_H, obj_w=OBJ_W, scene_h=H, scene_w=W, ori_h=ORI_H,
              ori_w=ORI_W, dist_range=tuple(float(d)
                                            for d in TRAIN_DIST_RANGE))
    atk_kw = dict(steps=STEPS, mask_wt=MASK_WT, l0_thresh=THRESH)
    j_atk = JL0ObjectAttack(lambda vv, im: jm0.apply(vv, im, train=False),
                            obj, mask, JPhysObjAttackConfig(**kw), **atk_kw)
    atk = L0ObjectAttack(predictor_from(port), obj, mask,
                         PhysObjAttackConfig(**kw), **atk_kw)
    scenes = np.broadcast_to(make_scene(1, ORI_H, ORI_W, seed=2),
                             (B, ORI_H, ORI_W, 3)).copy()
    key = jax.random.PRNGKey(11)

    j_counts, counts = [], []
    j_cal, cal = j_atk._cal_l0, atk._cal_l0

    def j_recording(p, n):
        c = j_cal(p, n)
        jax.debug.callback(lambda c: j_counts.append(float(c)), c,
                           ordered=True)
        return c

    def recording(p, n):
        c = cal(p, n)
        counts.append(float(c))
        return c

    # JAX's first gradient, taken inside its loop (iteration 0: the
    # mask weight on, the draws' first z0s and alphas)
    j_grads = []
    j_opt = j_atk.optimizer

    def j_update(grads, opt_state, params=None):
        jax.debug.callback(lambda g: j_grads.append(g) if not j_grads
                           else None, grads, ordered=True)
        return j_opt.update(grads, opt_state, params)

    j_atk.optimizer = optax.GradientTransformation(j_opt.init, j_update)
    j_atk._cal_l0, atk._cal_l0 = j_recording, recording
    _, n_j = jax_optimize_with_count(j_atk)(v, jnp.asarray(scenes), key)
    jax.effects_barrier()
    draws = l0_draws(j_atk, key, B, STEPS)
    atk._optimize(torch.from_numpy(scenes), draws)
    # the port's first iteration's gradients, mask weight on
    atk._cal_l0 = cal
    _, grads = atk.cost_and_grads(torch.from_numpy(scenes), draws.pos,
                                  draws.neg, draws.z0s[0], draws.alphas[0],
                                  MASK_WT)
    # JAX checks the ratio at init, then at each cond and body; the port
    # at init and at the top of each iteration
    return dict(j_ratios=[c / j_counts[0] for c in j_counts[1::2]],
                ratios=[c / counts[0] for c in counts[1:]],
                j_iterations=int(n_j), iterations=atk.last_iterations,
                early_break=atk.last_early_break,
                grads=[g.numpy() for g in grads],
                j_grads=[np.asarray(g) for g in j_grads[0]])


def test_l0_ratios_and_break_match_jax(runs):
    """The ratio at every check and where the loop stops, as JAX's: the
    early break belongs to the model, not to the port."""
    n = runs["iterations"]
    assert n == runs["j_iterations"]
    assert runs["early_break"] == (n < 2 * STEPS)
    assert n < 2 * STEPS  # the break fires here, as on the card
    np.testing.assert_allclose(runs["ratios"],
                               runs["j_ratios"][:len(runs["ratios"])],
                               rtol=0, atol=RATIO_ATOL)


def test_first_l0_gradients_match_jax(runs):
    for g, j in zip(runs["grads"], runs["j_grads"]):
        np.testing.assert_allclose(g, j, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(j).max()))

