"""Shared pieces of the attack-zoo parity tests
(tests/test_torch_attacks_whitebox.py, tests/test_torch_attacks_search.py).

The JAX package's attacks run their own code, eagerly: `lax.fori_loop`
becomes a Python loop (`eager_loops`) and the attack's `_objective` is
swapped for one jitted program of the same objective (`JaxZoo.
objective`), which every attack of one object size shares, and which
`jax.grad` differentiates into one more program. So a file pays a few
compiles however many attacks it runs (and the second of the two files
none of these, when both run in one process: `shared_zoo`), and every
loop body, schedule and best-so-far update is the JAX package's own. The draws the JAX
attack makes from its keys are rebuilt with the same calls and handed
to the port.

Setup of tests/test_torch_attack_eval.py: Monodepth2-18 with the golden
reference-layout weights of tests/golden_common.py, the model at
96x320, batch 2, synthetic 375x1242 scenes, a 40x60 car (a 200x300 one
where the attack paints rows 90:170 x cols 100:200, which a 40x60 car
does not have).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.evaluation import attack_eval as j_attack_eval
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2, predictor_from as j_predictor_from,
)
from depthmodelhardening_tpu.physics.eot import EoTCompositor
from depthmodelhardening_tpu_torch.evaluation import attack_eval
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)

from golden_common import depth_decoder_state_dict, resnet18_encoder_state_dict
from torch_threads import few_torch_threads  # noqa: F401 (re-exported)

B, OBJ_H, OBJ_W, H, W = 2, 40, 60, 96, 320
BIG_H, BIG_W = 200, 300
EVAL_KW = dict(batch_size=B, eval_count=1, scene_h=H, scene_w=W)
# evaluate_attacks' metrics: tests/test_torch_attack_eval.py's rule (a1..a3
# are fractions of about a thousand mask pixels; one pixel is 8e-4)
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def remembered_band_sweeps():
    """The JAX attacks' constructors sweep their warp geometry eagerly
    (`EoTCompositor.check_bands_fit`, a static bool of the compositor's
    configuration and the sweep's ranges) at about 0.25 s a build; a zoo
    module builds some 50. While it runs, the sweep's answer for one
    configuration and set of ranges is remembered."""
    orig = EoTCompositor.check_bands_fit
    seen = {}

    def check_bands_fit(self, *args, **kw):
        key = repr((self.cfg, args, sorted(kw.items())))
        if key not in seen:
            seen[key] = orig(self, *args, **kw)
        return seen[key]

    EoTCompositor.check_bands_fit = check_bands_fit
    yield
    EoTCompositor.check_bands_fit = orig


def evaluate_with_texture(predictor, atk, scenes, cfg, draws, **kw):
    """evaluate_attacks on one scene batch with injected draws, and the
    texture its attack optimised (None where the attack optimises
    nothing), so a test runs the attack once."""
    seen = []
    orig = atk._optimize

    def optimize(*a):
        seen.append(orig(*a))
        return seen[-1]

    atk._optimize = optimize
    try:
        res = attack_eval.evaluate_attacks(predictor, atk, [scenes], cfg,
                                           draws=[draws], **kw)
    finally:
        del atk._optimize
    return res, (seen[0] if seen else None)


def t(v) -> torch.Tensor:
    """A JAX or numpy array as a CPU float32 tensor."""
    return torch.from_numpy(np.array(v, np.float32))


def stack_za(za):
    """[(z0s, alphas)] of JAX draws -> (z0s (n, B), alphas (n, B))."""
    return (t(np.stack([np.asarray(z) for z, _ in za])),
            t(np.stack([np.asarray(a) for _, a in za])))


def eval_key(i: int = 0):
    """Batch i's key of JAX `evaluate_attacks` (rng PRNGKey(17)) and its
    split into the attack's (k_opt, k_final) (`PhysObjAttack._run`)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), i)
    k_opt, k_final = jax.random.split(key)
    return key, k_opt, k_final


@contextlib.contextmanager
def eager_loops(record=None):
    """`jax.lax.fori_loop` as a Python loop over int32 indices; the final
    carry of each loop is appended to `record`."""
    orig = jax.lax.fori_loop

    def fori_loop(lo, hi, body, init):
        v = init
        for i in range(lo, hi):
            v = body(jnp.asarray(i, jnp.int32), v)
        if record is not None:
            record.append(v)
        return v

    jax.lax.fori_loop = fori_loop
    try:
        yield
    finally:
        jax.lax.fori_loop = orig


class JaxZoo:
    """The JAX side of a zoo test: golden-weight predictor, scenes, the
    jitted objective per object size, the jitted metrics."""

    def __init__(self, scenes):
        enc_sd = resnet18_encoder_state_dict(seed=0)
        dec_sd = depth_decoder_state_dict(seed=0)
        ev, _ = convert_resnet_encoder(enc_sd)
        dv = convert_depth_decoder(dec_sd)
        self.vars = {"params": {"encoder": ev["params"],
                                "decoder": dv["params"]},
                     "batch_stats": {"encoder": ev["batch_stats"]}}
        self.pred = j_predictor_from(j_make_monodepth2(), self.vars)
        # the same predictor, its forward one jitted program (batch B)
        self.fwd = jax.jit(self.pred.apply_fn)
        self.fast_pred = self.pred.replace(apply_fn=self.fwd)
        self.sd = load_reference_state_dict(enc_sd, dec_sd)
        self.scenes = scenes
        self.sf = jnp.asarray(scenes)
        self._objectives = {}
        self._finals = {}

    def metrics(self, adv, ben, masks):
        """JAX evaluate_attacks' 8 metrics of one batch (its
        `_batch_metrics`, through the jitted forward)."""
        return np.asarray(jnp.stack(j_attack_eval._batch_metrics(
            self.fast_pred, adv, ben, masks)))

    def port_predictor(self):
        model = make_monodepth2()
        model.load_state_dict(self.sd)
        return predictor_from(model)

    def objective(self, j_atk):
        """The jitted `_objective(texture, z0s, alphas)` of j_atk's EoT
        configuration (one per object size)."""
        key = (j_atk.cfg.obj_h, j_atk.cfg.obj_w)
        if key not in self._objectives:
            # the class's method: the instance's may be swapped already
            base, fn = j_atk, type(j_atk)._objective
            self._objectives[key] = jax.jit(
                lambda o, z, a: fn(base, self.vars, self.sf, o, z, a))
        return self._objectives[key]

    def share_objective(self, j_atk):
        """Swap j_atk's `_objective` for the shared jitted program."""
        fn = self.objective(j_atk)
        j_atk._objective = lambda variables, sf, o, z, a, **kw: fn(o, z, a)
        return j_atk

    def finals_metrics(self, j_atk, tex, k_final):
        """JAX's eval-mode finals of texture `tex` (the attack's own
        `_final_outputs` on its `_final_za(k_final)` draw) and the 8
        metrics of evaluate_attacks on them. The finals are one jitted
        program per object size and eval pin, shared by the attacks alike
        in those (a texture is repeated for each sample: the warp of one
        texture a sample is the warp of the one)."""
        z, a = j_atk._final_za(k_final, B)
        tex = jnp.broadcast_to(jnp.asarray(tex), (B,) + np.shape(tex)[1:])
        key = (j_atk.cfg.obj_h, j_atk.cfg.obj_w, j_atk.cfg.eval_pin_z0)
        if key not in self._finals:
            base = j_atk

            def finals(tex, z, a):
                # the draw is given: `_final_za` hands it through
                base._final_za = lambda rng, batch: rng
                try:
                    return base._final_outputs(self.sf, tex, (z, a), True)
                finally:
                    del base._final_za

            self._finals[key] = jax.jit(finals)
        return self.metrics(*self._finals[key](tex, z, a))


@functools.lru_cache(maxsize=None)
def shared_zoo() -> JaxZoo:
    """One JaxZoo a process, with the 40x60 and 200x300 cars and the
    port's predictor, so the zoo files run in one process share its
    compiled programs (the forward, the objective of each object size,
    the finals)."""
    z = JaxZoo(scenes())
    z.obj, z.mask = objects()
    z.big, z.big_mask = objects(big=True)
    z.t_pred = z.port_predictor()
    return z


def objects(big: bool = False):
    """(obj, mask) of the 40x60 car, or of the 200x300 one."""
    return make_car_object(BIG_W, BIG_H) if big else \
        make_car_object(OBJ_W, OBJ_H)


def scenes():
    return make_scene(B, 375, 1242, seed=1)


def assert_metrics(port_result, want, label=""):
    """The port's evaluate_attacks result against JAX's 8 metrics."""
    got = np.asarray([port_result["mean"][n] for n in
                      attack_eval.METRIC_NAMES])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL,
                               atol=METRIC_ATOL, err_msg=label)
