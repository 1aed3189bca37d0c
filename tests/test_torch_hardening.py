"""The port's hardening step (BASELINE config 4) against the JAX package's
`training/hardening.py`: the stereo-consistent synthesis, SimSiam, the
state conversion and `HardeningTrainer.train_step` with the L0 attack
(the recipe's) and with L-inf PGD.

Sizes of the JAX package's hardening tests (`tests/test_training.py:
27-29`): the model at 64x192, 96x320 frames and scenes, a 24x36 car,
attack batch 2, steps=2; the step's batch is 4, not 2. At batch 2 the
SimSiam head's BatchNorm1d normalises each channel over two samples,
d / sqrt(d^2 + eps) with d half their gap, and where a channel's gap is
near sqrt(eps) its gradient is 1 / sqrt(eps) times its input's noise:
JAX's own gradient of the head moves by 65% (relative L2) when its
input moves by 1e-5, by 2.3e-4 at batch 4. Student and teacher start from the
golden reference-layout weights of tests/golden_common.py (--fine-tune);
the SimSiam head is flax's initialisation, converted.

JAX's whole `train_step` is not jitted here (120 s cold on this CPU);
its pieces are: the attack's `_optimize` (jitted, the L0 loop's final
step read from its `lax.while_loop`), and `jax.jit(jax.grad(
tr._losses, has_aux=True))` on the batch the port's step built, then
`tr.tx.update`. The draws come from the key chain JAX's `_step` splits
(`hardening.py:401`: k_atk, k_synth, k_loss; the attack's
`l0_object.py:84` or `pgd_object.py:33`; `adv_synth.py:96` and its
jitter's `fold_in(rng, 7)`; the automask noise of `k_loss`), handed to
the port as `StepDraws`. The port runs its plain CPU versions of the
kernels.

Tolerances, and why:

* synthesis: every plane 2e-5 absolute (the port resizes with float32
  weights, JAX with float64 ones, ROADMAP Queue 3; 6.3e-6 measured);
* SimSiam on converted parameters: loss 1e-6 absolute (a mean of
  cosines, near 0 at a random initialisation, where a relative error
  says nothing; 1.2e-7 measured); gradients of the
  parameters and of both feature inputs 1e-4 relative L2 per tensor
  (float32 sums in another order); running mean 1e-5, variance JAX's
  two batch updates times n / (n - 1) (torch's unbiased variance);
* the step, from a state converted from a JAX `HardeningTrainer`:
  - the texture: the L0 loop's iteration count and break equal to JAX's;
    the texture itself is not held on this model (the first L0 update is
    lr * g / (|g| + eps), and the golden model's trajectories part, see
    tests/test_torch_l0.py, where the loop is held);
  - each loss term 1e-5 relative on the port's batch, the contrastive
    term 1e-5 absolute (a mean of cosines near 0; the encoder's deep
    features differ by up to 1e-4 in rounding, ROADMAP Queue 3, and
    the head's BatchNorm over 4 samples carries it; 1.6e-6 measured);
  - the gradients of every student and SimSiam tensor and Adam's first
    moment: relative L2 per tensor and overall, as
    tests/test_torch_train_step.py holds the self-supervised step (0.1
    and 0.05; the photometric loss's gradient turns on rounding at flat
    blocks); Adam's second moment 0.2 per tensor. A tensor whose norm
    is below 1e-3 of the largest tensor's is held relative to that
    floor instead: the coarsest head's bias gradient is one value,
    -6.0e-5 against elements up to 0.43 elsewhere, a sum over the
    scale-3 pixels that cancels (the port's is -4.0e-5 on the l_0
    batch). Measured worst tensor 1.6e-2 with l_inf, overall 4.6e-3
    and 1.3e-2;
  - BatchNorm running means 1e-4 relative + 1e-6, variances JAX's
    updates times n / (n - 1), the same; the head's with 1e-5 absolute
    (its inputs carry the encoder's feature rounding; 1.6e-6 measured on
    a mean of 0.03); the encoder's and the head's statistics are
    updated twice a step (the adversarial forward and the benign
    encode; the two views of the head).
"""

import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.attacks.pgd_object import (
    PGDObjectAttack as JPGDObjectAttack,
)
from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.models.simsiam import SimSiam as JSimSiam
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2, predictor_from as j_predictor_from,
)
from depthmodelhardening_tpu.physics.eot import ANGLE_RANGE, TRAIN_DIST_RANGE
from depthmodelhardening_tpu.training import adv_synth as j_adv_synth
from depthmodelhardening_tpu.training.config import (
    AdvSynthConfig as JAdvSynthConfig, HardeningConfig as JHardeningConfig,
    SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu.training.hardening import (
    HardeningTrainer as JHardeningTrainer,
)
from depthmodelhardening_tpu_torch.attacks.pgd_object import PGDDraws
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_hardening_state, from_jax_simsiam, from_jax_variables,
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.simsiam import SimSiam, init_simsiam
from depthmodelhardening_tpu_torch.models.wrappers import (
    LECUN_TRUNC_STD, make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.training import adv_synth
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import (
    HardeningTrainer, StepDraws,
)

from golden_common import depth_decoder_state_dict, resnet18_encoder_state_dict
from test_torch_l0 import jax_optimize_with_count, l0_draws

H, W = 64, 192
ORI_H, ORI_W = 96, 320
OBJ_H, OBJ_W = 24, 36
B, STEPS = 2, 2
# the step's batch (the attack's stays B): see the module docstring
STEP_B = 4
SIDE = np.array([True, False, False, True])
FLIP = np.array([False, True, False, True])
SYNTH_ATOL = 2e-5
SIMSIAM_L2 = 1e-4
SIMSIAM_LOSS_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_L2, GRAD_L2_ALL, NU_L2 = 0.1, 0.05, 0.2
GRAD_FLOOR = 1e-3
CONTRAS_ATOL = 1e-5
BN_RTOL, BN_ATOL = 1e-4, 1e-6
HEAD_BN_ATOL = 1e-5


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _t(v):
    return torch.from_numpy(np.array(v))


def _frames(batch=STEP_B):
    f0 = make_scene(batch, ORI_H, ORI_W, seed=1)
    # the other eye: a column-shifted copy, so the warp has real signal
    return {"0": f0, "s": np.roll(f0, 6, axis=2)}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's CPU steps with 2 intra-op threads while this module
    runs: the suite runs several test processes on one machine, and each
    at the default of one thread a core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- JAX's draws ---------------------------------------------------------------
def synth_draws(key, batch, adv_cfg):
    """The draws of JAX `synthesize_adv_batch(..., rng=key)` as
    SynthDraws."""
    k_z, k_a, k_half = jax.random.split(key, 3)
    z0s = jax.random.choice(k_z, jnp.asarray(TRAIN_DIST_RANGE), (batch,))
    alphas = jax.random.choice(k_a, jnp.asarray(ANGLE_RANGE), (batch,))
    half = (_t(jax.random.bernoulli(k_half, 0.5, (batch,)))
            if adv_cfg.half_no_synthesis else None)
    jitter = jitter_draws(key, batch) if adv_cfg.color_aug else None
    return adv_synth.SynthDraws(z0s=_t(z0s), alphas=_t(alphas), half=half,
                                jitter=jitter)


def jitter_draws(key, batch):
    """The draws of JAX `_jitter_aug_planes(out, rng=key)`."""
    k_en, *ks = jax.random.split(jax.random.fold_in(key, 7), 5)
    factors = [jax.random.uniform(k, (batch,), minval=lo, maxval=hi)
               for k, (lo, hi) in zip(ks, adv_synth.JITTER_RANGES)]
    return adv_synth.JitterDraws(
        enabled=_t(jax.random.bernoulli(k_en, 0.5, (batch,))),
        factors=_t(np.stack([np.asarray(f) for f in factors], 1)))


def pgd_draws(j_atk, key, batch, steps) -> PGDDraws:
    """The draws of JAX `PGDObjectAttack._optimize(..., key)`."""
    k_init, k_loop = jax.random.split(key)
    noise = jax.random.uniform(k_init, j_atk.obj_img.shape,
                               minval=-j_atk.eps, maxval=j_atk.eps)
    za = [j_atk._sample_za(jax.random.fold_in(k_loop, s), batch)
          for s in range(steps)]
    f = lambda i: _t(np.stack([np.asarray(v[i]) for v in za]))
    return PGDDraws(noise=_t(noise), z0s=f(0), alphas=f(1),
                    final_z0s=f(0)[0], final_alphas=f(1)[0])


# -- synthesis ---------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(half_no_synthesis=True),
                                dict(color_aug=True),
                                dict(half_no_synthesis=True, color_aug=True)])
def test_synthesis_matches_jax(kw):
    """Every plane of `synthesize_adv_batch` against JAX's, on JAX's
    draws, with and without half_no_synthesis and color_aug."""
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    frames = {"0": make_scene(4, ORI_H, ORI_W, seed=0),
              "s": make_scene(4, ORI_H, ORI_W, seed=1)}
    adv = np.clip(obj + 0.2, 0.0, 1.0).astype(np.float32)
    side = np.array([True, True, False, False])
    flip = np.array([False, True, False, True])
    key = jax.random.PRNGKey(5)
    j_cfg = JAdvSynthConfig(ori_h=ORI_H, ori_w=ORI_W, **kw)
    want = j_adv_synth.synthesize_adv_batch(
        j_adv_synth.make_synth_compositor(OBJ_H, OBJ_W, ORI_H, ORI_W),
        {k: jnp.asarray(v) for k, v in frames.items()}, jnp.asarray(adv),
        jnp.asarray(obj), jnp.asarray(mask), jnp.asarray(side),
        jnp.asarray(flip), key, JSelfSupConfig(height=H, width=W), j_cfg)
    got = adv_synth.synthesize_adv_batch(
        adv_synth.make_synth_compositor(OBJ_H, OBJ_W, ORI_H, ORI_W),
        {k: torch.from_numpy(v) for k, v in frames.items()},
        torch.from_numpy(adv), torch.from_numpy(obj), torch.from_numpy(mask),
        torch.from_numpy(side), torch.from_numpy(flip),
        synth_draws(key, 4, j_cfg), SelfSupConfig(height=H, width=W),
        AdvSynthConfig(ori_h=ORI_H, ori_w=ORI_W, **kw))
    planes = [("color_ben",), ("objmask",), ("objdepth",)] + [
        (g, f) for g in ("color", "color_aug") for f in ("0", "s")]
    for path in planes:
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SYNTH_ATOL,
                                   rtol=0, err_msg=str(path))
    assert float(got["objmask"].sum()) > 0
    diff = (got["color_aug"]["0"] - got["color_ben"]).abs()
    assert float(diff.max()) > 1e-3  # the adversarial texture shows


def test_plain_batch_color_aug_matches_jax():
    """`build_plain_batch` with jitter draws against JAX's with
    color_aug=True, on JAX's jitter draws (its `_jitter_aug_planes` on
    the "color_aug" planes only)."""
    frames = _frames()
    key = jax.random.PRNGKey(12)  # items 0 and 3 jittered
    want = j_adv_synth.build_plain_batch(
        {k: jnp.asarray(v) for k, v in frames.items()}, jnp.asarray(SIDE),
        jnp.asarray(FLIP), key, JSelfSupConfig(height=H, width=W),
        color_aug=True)
    got = adv_synth.build_plain_batch(
        {k: torch.from_numpy(v) for k, v in frames.items()},
        torch.from_numpy(SIDE), torch.from_numpy(FLIP),
        SelfSupConfig(height=H, width=W), jitter=jitter_draws(key, STEP_B))
    for g in ("color", "color_aug"):
        for f in ("0", "s"):
            np.testing.assert_allclose(got[g][f].numpy(),
                                       np.asarray(want[g][f]),
                                       atol=SYNTH_ATOL, rtol=0)
    jitter = jitter_draws(key, STEP_B)
    for i, on in enumerate(jitter.enabled.tolist()):
        assert torch.equal(got["color"]["0"][i],
                           got["color_aug"]["0"][i]) is not on, i
    np.testing.assert_array_equal(got["stereo_T"].numpy(),
                                  np.asarray(want["stereo_T"]))


# -- SimSiam -----------------------------------------------------------------
def _l2(got, want, floor: float = 0.0):
    """Relative L2 error of each tensor of `got` to `want` (dicts of
    tensors), each relative to the larger of its norm and `floor` times
    the largest tensor norm, and of all of them together."""
    errs, num, den = {}, 0.0, 0.0
    big = max(float(w.double().norm()) for w in want.values())
    for name, g in got.items():
        w = want[name].double()
        e, n = float((g.double() - w).norm()), float(w.norm())
        errs[name] = e / max(n, floor * big, 1e-30)
        num, den = num + e ** 2, den + n ** 2
    return errs, (num / den) ** 0.5


def _assert_l2(what, got, want, per_tensor, overall=None, floor=0.0):
    assert set(got) == set(want), what
    errs, all_ = _l2(got, want, floor)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= per_tensor, (what, worst, errs[worst])
    if overall is not None:
        assert all_ <= overall, (what, all_)


def _twice_updated_var(old, want, n):
    """torch's running variance after two batch updates where flax's is
    `want` (both from `old`, momentum 0.1): the batch terms times n /
    (n - 1)."""
    return 0.81 * old + (want - 0.81 * old) * (n / (n - 1))


def test_simsiam_matches_jax():
    """Loss, every parameter gradient, both feature gradients and the
    running statistics against flax SimSiam in train mode, on its own
    initial parameters converted with `from_jax_simsiam`."""
    rng = np.random.RandomState(0)
    fa = [rng.randn(4, 2, 6, 512).astype(np.float32)]
    fb = [rng.randn(4, 2, 6, 512).astype(np.float32) + 0.5]
    j_head = JSimSiam()
    variables = j_head.init(jax.random.PRNGKey(2), fa, fa, train=False)
    # non-trivial running statistics
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(rng.rand(*v.shape), v.dtype),
        variables["batch_stats"])

    def loss_fn(params, a, b):
        return j_head.apply({"params": params, "batch_stats": stats}, a, b,
                            train=True, mutable=["batch_stats"])

    (loss_j, mut), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], [jnp.asarray(fa[0])], [jnp.asarray(fb[0])])

    head = SimSiam()
    old = from_jax_simsiam({"params": variables["params"],
                            "batch_stats": stats})
    head.load_state_dict(old)
    head.train()
    a = torch.from_numpy(fa[0]).permute(0, 3, 1, 2).requires_grad_(True)
    b = torch.from_numpy(fb[0]).permute(0, 3, 1, 2).requires_grad_(True)
    loss = head([a], [b])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=0,
                                                 abs=SIMSIAM_LOSS_ATOL)
    want = from_jax_simsiam({"params": grads_j[0]})
    _assert_l2("simsiam gradients",
               {n: p.grad for n, p in head.named_parameters()}, want,
               SIMSIAM_L2)
    for got_g, want_g in ((a.grad, grads_j[1][0]), (b.grad, grads_j[2][0])):
        _assert_l2("feature gradient",
                   {"x": got_g.permute(0, 2, 3, 1)},
                   {"x": _t(want_g)}, SIMSIAM_L2)
    new = from_jax_simsiam({"params": variables["params"],
                            "batch_stats": mut["batch_stats"]})
    sd = head.state_dict()
    for key in sd:
        if key.endswith("running_mean"):
            np.testing.assert_allclose(sd[key].numpy(), new[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        elif key.endswith("running_var"):
            np.testing.assert_allclose(
                sd[key].numpy(), _twice_updated_var(
                    old[key], new[key], 4).numpy(),
                rtol=1e-5, atol=1e-6, err_msg=key)


def test_simsiam_init_is_flax_default():
    """lecun-normal kernels truncated at +-2 sigma' (std 1 / sqrt(fan_in)),
    zero biases, identity BatchNorm, the last BatchNorm affine-free; the
    same seed gives the same head; the cosine is max(|a||b|, eps), not
    each norm clamped."""
    a = init_simsiam(torch.Generator().manual_seed(1))
    b = init_simsiam(torch.Generator().manual_seed(1))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for m in a.modules():
        if isinstance(m, torch.nn.Linear):
            bound = 2.0 / np.sqrt(m.in_features) / LECUN_TRUNC_STD
            assert float(m.weight.abs().max()) <= bound * (1 + 1e-6)
            assert float(m.weight.std()) * np.sqrt(m.in_features) == \
                pytest.approx(1.0, rel=0.03)
            assert m.bias is None or not m.bias.any()
    assert a.projector_7.weight is None and a.projector_7.bias is None
    assert a.predictor_3.bias is not None and a.projector_0.bias is None
    from depthmodelhardening_tpu_torch.models.simsiam import _cosine
    x = torch.tensor([[1e-5, 0.0], [3.0, 4.0]])
    y = torch.tensor([[1e-5, 0.0], [3.0, 4.0]])
    np.testing.assert_allclose(_cosine(x, y).numpy(), [1e-2, 1.0],
                               rtol=1e-6)


# -- the step ----------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    """A JAX HardeningTrainer at config 4 (l_0, supervised + contrastive +
    photometric) from the golden weights, its initial state, and the
    port's weights."""
    enc_sd = resnet18_encoder_state_dict(seed=0)
    dec_sd = depth_decoder_state_dict(seed=0)
    ev, _ = convert_resnet_encoder(enc_sd)
    dv = convert_depth_decoder(dec_sd)
    j_vars = {"params": {"encoder": ev["params"], "decoder": dv["params"]},
              "batch_stats": {"encoder": ev["batch_stats"]}}
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    cfg = JHardeningConfig(
        selfsup=JSelfSupConfig(height=H, width=W),
        adv=JAdvSynthConfig(norm_type="l_0", steps=STEPS,
                            attack_batch_size=B, ori_h=ORI_H, ori_w=ORI_W),
        batch_size=STEP_B)
    # the head's initial variables given, so the JAX trainer does not
    # initialise (eagerly) a whole model it would then replace
    feats = [jnp.zeros((1, H // 32, W // 32, 512))]
    head = jax.jit(lambda k: JSimSiam().init(k, feats, feats, train=False))(
        jax.random.PRNGKey(1))
    tr = JHardeningTrainer(cfg, jax.random.PRNGKey(0), obj, mask,
                           teacher=j_predictor_from(j_make_monodepth2(),
                                                    j_vars),
                           steps_per_epoch=10,
                           init_variables={"depth": j_vars, "simsiam": head})
    return dict(tr=tr, state=tr.make_state(), obj=obj, mask=mask,
                sd=load_reference_state_dict(enc_sd, dec_sd),
                grad=jax.jit(jax.grad(tr._losses, has_aux=True)),
                update=jax.jit(tr.tx.update))


def _port_trainer(setup, norm_type):
    teacher = make_monodepth2()
    teacher.load_state_dict(setup["sd"])
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=H, width=W),
        adv=AdvSynthConfig(norm_type=norm_type, steps=STEPS,
                           attack_batch_size=B, ori_h=ORI_H, ori_w=ORI_W),
        batch_size=STEP_B)
    return HardeningTrainer(cfg, torch.Generator().manual_seed(0),
                            setup["obj"], setup["mask"],
                            predictor_from(teacher), device="cpu",
                            steps_per_epoch=10, init_state_dict=setup["sd"])


def _bn_counts(model, head):
    """n seen by each BatchNorm in one pass at (H, W), batch STEP_B (train
    mode, on copies: in eval mode the student folds its BatchNorms)."""
    counts = {}
    model, head = copy.deepcopy(model).train(), copy.deepcopy(head).train()
    for prefix, mod in (("", model), ("simsiam.", head)):
        for name, m in mod.named_modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.register_forward_hook(
                    lambda mm, inp, out, name=prefix + name:
                    counts.__setitem__(name, inp[0].numel()
                                       // inp[0].shape[1]))
    with torch.no_grad():
        feats = model.encode(torch.zeros(STEP_B, H, W, 3))
        head(feats, feats)
    return counts


@pytest.fixture(scope="module", params=["l_0", "l_inf"])
def step(request, setup):
    """One port `train_step` from the JAX trainer's initial state
    (converted), on JAX's draws; JAX's gradients, metrics, BatchNorm
    statistics and Adam update on the batch that step built."""
    norm = request.param
    tr, state = setup["tr"], setup["state"]
    scenes = make_scene(1, ORI_H, ORI_W, seed=2)
    frames = _frames()
    key = jax.random.PRNGKey(3)
    k_atk, k_synth, k_loss = jax.random.split(key, 3)
    student = tr.student_variables(state)
    scenes_b = jnp.asarray(np.broadcast_to(scenes, (B,) + scenes.shape[1:]))
    if norm == "l_0":
        j_atk = tr.attack
        _, n_j = jax_optimize_with_count(j_atk)(student, scenes_b, k_atk)
        attack_draws = l0_draws(j_atk, k_atk, B, STEPS)
    else:
        j_atk = JPGDObjectAttack(tr._student_predict, setup["obj"],
                                 setup["mask"], tr.attack.cfg, eps=0.1,
                                 alpha=0.005, steps=STEPS)
        n_j = None
        attack_draws = pgd_draws(j_atk, k_atk, B, STEPS)
    noise = _t(jax.random.normal(k_loss, (STEP_B, H, W, 1)))
    draws = StepDraws(attack=attack_draws,
                      synth=synth_draws(k_synth, STEP_B, tr.cfg.adv),
                      identity_noise=noise)

    port = _port_trainer(setup, norm)
    resume = from_jax_hardening_state(_np_tree(state))
    p_state = port.make_state(resume=resume)
    batches = []
    update = port._update
    port._update = lambda s, batch, n: (batches.append(batch),
                                        update(s, batch, n))[1]
    p_state, metrics = port.train_step(
        p_state, {k: torch.from_numpy(v) for k, v in frames.items()},
        torch.from_numpy(SIDE), torch.from_numpy(FLIP),
        torch.from_numpy(scenes), draws=draws)
    batch = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().numpy()), batches[0])
    grads, (new_bs, j_metrics) = setup["grad"](state.params,
                                               state.batch_stats, batch,
                                               k_loss)
    updates, new_opt = setup["update"](grads, state.opt_state, state.params)
    adam = new_opt[0]
    return dict(norm=norm, n_j=n_j, port=port, state=p_state,
                metrics=metrics, resume=resume, batch=batches[0],
                j_metrics={k: float(v) for k, v in j_metrics.items()},
                grads=_np_tree(grads), new_bs=_np_tree(new_bs),
                mu=_np_tree(adam.mu), nu=_np_tree(adam.nu))


def test_step_attack_and_batch(step):
    """The texture refresh ran as JAX's does (L0: the same iteration
    count, no early break at l0_thresh 0.1), and the batch the step built
    carries every plane of the hardening batch at model resolution."""
    if step["norm"] == "l_0":
        atk = step["port"].attack
        assert atk.last_iterations == int(step["n_j"]) == 2 * STEPS
        assert atk.last_early_break is False
    batch = step["batch"]
    for g in ("color", "color_aug"):
        for f in ("0", "s"):
            assert batch[g][f].shape == (STEP_B, H, W, 3)
    assert torch.equal(batch["color"]["0"], batch["color_ben"])
    assert float((batch["color_aug"]["0"] - batch["color_ben"]).abs()
                 .max()) > 1e-3
    assert batch["objmask"].shape == (STEP_B, H, W, 1)
    assert float(batch["objmask"].sum()) > 0
    np.testing.assert_allclose(batch["stereo_T"][:, 0, 3].numpy(),
                               [-0.1, -0.1, 0.1, 0.1], atol=1e-7)


def test_step_losses_match_jax(step):
    """Every loss term of the step against JAX `_losses` on its batch."""
    got = {k: float(v) for k, v in step["metrics"].items()}
    want = step["j_metrics"]
    assert set(got) == set(want) == {"sup_loss", "contras_loss",
                                     "selfsup_loss", "loss"}
    for k in ("sup_loss", "selfsup_loss", "loss"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    assert got["contras_loss"] == pytest.approx(want["contras_loss"], rel=0,
                                                abs=CONTRAS_ATOL)
    assert step["state"].step == 1


def test_step_gradients_and_adam_match_jax(step):
    """The gradient of every student and SimSiam tensor, and Adam's
    moments after the step, against JAX's gradients and optax's mu and
    nu; the parameters moved."""
    state = step["state"]
    opt = state.optimizer.state
    for key, module, convert in (
            ("depth", state.model,
             lambda t: from_jax_variables({"params": t})),
            ("simsiam", state.simsiam,
             lambda t: from_jax_simsiam({"params": t}))):
        params = dict(module.named_parameters())
        _assert_l2(f"{key} gradient",
                   {n: p.grad for n, p in params.items()},
                   convert(step["grads"][key]), GRAD_L2, GRAD_L2_ALL,
                   GRAD_FLOOR)
        _assert_l2(f"{key} exp_avg",
                   {n: opt[p]["exp_avg"] for n, p in params.items()},
                   convert(step["mu"][key]), GRAD_L2, GRAD_L2_ALL,
                   GRAD_FLOOR)
        _assert_l2(f"{key} exp_avg_sq",
                   {n: opt[p]["exp_avg_sq"] for n, p in params.items()},
                   convert(step["nu"][key]), NU_L2, floor=GRAD_FLOOR ** 2)
        before = step["resume"]["model" if key == "depth" else key]
        for n, p in params.items():
            assert not torch.equal(p.detach(), before[n]), n


def test_step_batchnorm_statistics_match_jax(step):
    """Running means and variances of the student's 20 BatchNorms and the
    head's 4, each updated twice in the step, against JAX's."""
    state = step["state"]
    counts = _bn_counts(state.model, state.simsiam)
    assert len(counts) == 24
    got = {**state.model.state_dict(),
           **{f"simsiam.{k}": v for k, v in
              state.simsiam.state_dict().items()}}
    new = {**from_jax_variables({"params": step["grads"]["depth"],
                                 "batch_stats": step["new_bs"]["depth"]}),
           **{f"simsiam.{k}": v for k, v in from_jax_simsiam(
               {"params": step["grads"]["simsiam"],
                "batch_stats": step["new_bs"]["simsiam"]}).items()}}
    old = {**step["resume"]["model"],
           **{f"simsiam.{k}": v for k, v in
              step["resume"]["simsiam"].items()}}
    for mod, n in counts.items():
        mean, var = f"{mod}.running_mean", f"{mod}.running_var"
        atol = HEAD_BN_ATOL if mod.startswith("simsiam.") else BN_ATOL
        np.testing.assert_allclose(got[mean].numpy(), new[mean].numpy(),
                                   rtol=BN_RTOL, atol=atol, err_msg=mean)
        np.testing.assert_allclose(
            got[var].numpy(), _twice_updated_var(old[var], new[var],
                                                 n).numpy(),
            rtol=BN_RTOL, atol=atol, err_msg=var)


def test_state_converts_across_and_back(setup):
    """A JAX HardeningTrainer state through `from_jax_hardening_state`
    into the port's `make_state(resume=...)`, and each tensor of the
    port's state read back into JAX's layout equals the original: the
    student's weights and statistics, the head's (Dense kernels
    transposed, BatchNorm scale/bias/mean/var), Adam's moments and
    count, the step."""
    state = _np_tree(setup["state"])
    # a state that has stepped: non-zero moments and count
    adam = state.opt_state[0]
    rng = np.random.RandomState(3)
    noisy = lambda t: jax.tree_util.tree_map(
        lambda v: (v + rng.rand(*v.shape)).astype(v.dtype), t)
    state = state.replace(opt_state=(adam._replace(
        mu=noisy(adam.mu), nu=noisy(adam.nu), count=np.int32(4)),)
        + tuple(state.opt_state[1:]), step=np.int32(4))
    port = _port_trainer(setup, "l_0")
    p_state = port.make_state(resume=from_jax_hardening_state(state))
    assert p_state.step == 4
    head = p_state.simsiam
    for name, p in head.named_parameters():
        mod, leaf = name.split(".")
        j = state.params["simsiam"][mod]
        want = (j["kernel"].T if leaf == "weight" and "kernel" in j else
                j["scale"] if leaf == "weight" else j["bias"])
        np.testing.assert_array_equal(p.detach().numpy(), want)
        st = p_state.optimizer.state[p]
        jm = adam_leaf(state.opt_state[0].mu["simsiam"][mod], leaf)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), jm)
        assert float(st["step"]) == 4
    for name, buf in head.named_buffers():
        mod, leaf = name.split(".")
        if leaf.startswith("running_"):
            np.testing.assert_array_equal(
                buf.numpy(),
                state.batch_stats["simsiam"][mod][leaf[len("running_"):]])
    sd = from_jax_variables({"params": state.params["depth"],
                             "batch_stats": state.batch_stats["depth"]})
    for name, v in p_state.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[name]), name
    assert len(p_state.optimizer.state) == len(
        list(p_state.model.parameters())) + len(list(head.parameters()))


def adam_leaf(tree, leaf):
    """The moment of a converted parameter `leaf` in a flax module tree."""
    if leaf == "weight":
        return tree["kernel"].T if "kernel" in tree else tree["scale"]
    return tree["bias"]


# -- entry points and refusals -----------------------------------------------
def test_evaluate_attacks_runs_the_l0_eval(setup):
    """`default_eval_cfg` mirrors the training attack (l_0, its Adam lr,
    mask weight and threshold, the attack batch) and `evaluate_attacks`
    runs it on the student as it is."""
    port = _port_trainer(setup, "l_0")
    state = port.make_state()
    cfg = port.default_eval_cfg(eval_count=1)
    assert (cfg.norm_type, cfg.step, cfg.adam_lr, cfg.mask_wt,
            cfg.l0_thresh, cfg.batch_size) == ("l_0", STEPS, 0.5, 0.05, 0.1,
                                               B)
    # one L0 step (2 iterations) keeps the eval cheap; the attack's
    # hyperparameters are the ones checked above
    cfg = dataclasses.replace(cfg, step=1)
    out = port.evaluate_attacks(state, [make_scene(1, ORI_H, ORI_W, seed=4)],
                                cfg, generator=torch.Generator().manual_seed(
                                    0))
    assert set(out) == {"mean", "max"}
    assert all(np.isfinite(v) for v in out["mean"].values())
    assert port._eval_attacks[cfg][1].cfg.eval_pin_z0 == 6.1


def test_train_step_draws_its_own_draws(setup):
    """Without injected draws the step draws from the trainer's
    generator; two trainers from one seed draw the same."""
    a, b = (_port_trainer(setup, "l_inf") for _ in range(2))
    da, db = a.draw(STEP_B), b.draw(STEP_B)
    for x, y in ((da.attack.noise, db.attack.noise),
                 (da.attack.z0s, db.attack.z0s),
                 (da.synth.z0s, db.synth.z0s),
                 (da.synth.alphas, db.synth.alphas)):
        assert torch.equal(x, y)
    state, m = a.train_step(
        a.make_state(), {k: torch.from_numpy(v) for k, v in _frames().items()},
        torch.from_numpy(SIDE), torch.from_numpy(FLIP),
        torch.from_numpy(make_scene(1, ORI_H, ORI_W, seed=2)))
    assert np.isfinite(float(m["loss"])) and state.step == 1


@pytest.mark.parametrize("kw,err,match", [
    (dict(selfsup=SelfSupConfig(frame_ids=("0", "-1", "1"))),
     NotImplementedError, "ROADMAP.*slice 5b"),
    (dict(use_depth_hints=True), NotImplementedError, "ROADMAP.*slice 6"),
    (dict(model_family="manydepth"), NotImplementedError,
     "ROADMAP.*slice 6"),
    (dict(), ValueError, "requires a frozen teacher"),
])
def test_unported_and_invalid_settings_raise(kw, err, match):
    with pytest.raises(err, match=match):
        HardeningTrainer(HardeningConfig(**kw),
                         torch.Generator().manual_seed(0),
                         *make_car_object(36, 24), device="cpu")


def test_bf16_hardening_names_its_slice():
    with pytest.raises(NotImplementedError, match=re.escape("slice 5e")):
        HardeningConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="unknown norm_type"):
        HardeningTrainer(
            HardeningConfig(adv=AdvSynthConfig(norm_type="l_2"),
                            supervised_adv=False),
            torch.Generator().manual_seed(0), *make_car_object(36, 24),
            device="cpu")
    assert dataclasses.fields(HardeningConfig)
