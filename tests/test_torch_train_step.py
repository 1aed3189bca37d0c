"""The port's self-supervised stereo training step against the JAX
package's `HardeningTrainer.selfsup_frames_step`, and the trainer's
contracts.

The JAX trainer takes two steps on raw 96x320 frames at model
resolution 64x128, batch 2, frames ("0", "s"), at lr 1e-4 with one step
per "epoch", so the staircase schedule decays between the two steps.
The port takes each of the two steps from the JAX trainer's state before
it (weights and BatchNorm statistics carried across with
`from_jax_train_state`, and for the second step Adam's moments and step
count), with the JAX package's own automask noise handed in: the second
step checks the bias correction and the schedule without inheriting the
first step's rounding. Tolerances:

* loss: 1e-5 relative (the model's forward rounds in another order);
* gradients of every parameter (the JAX package's from
  `jax.grad(trainer._losses)`, converted with `from_jax_variables`)
  and Adam's first moment: relative L2 error 0.1 per tensor and 0.05
  over all parameters; Adam's second moment (g^2): 0.2 per tensor.
  Measured on the first step: 4.3e-2 on the worst tensor, 1.8e-2
  overall, 8.8e-2 for the second moment; the JAX package's own jitted
  and eager gradients differ by up to 8e-3 per tensor on this input,
  and its float32 gradients differ from a float64 evaluation by more
  than the port's do. The loss's gradient is
  discontinuous where rounding decides (a warped pixel of a flat image
  block one ulp either side of its target flips the SSIM clip's
  derivative between 0 and 1), and the weight gradients are sums that
  cancel (bias gradients, train-mode BatchNorm's mean subtraction), so
  a few flipped pixels move them by percents;
* parameters after Adam: 2.5 * lr absolute. Adam's first step moves a
  parameter by about lr * sign(g), so where both gradients are near zero
  the sign may split and the two parameters move 2 lr apart;
* BatchNorm running mean: 1e-4 relative + 1e-6; running variance: the
  JAX package's biased batch update times n / (n - 1) (torch's unbiased
  one; n = B * h * w of the layer), 1e-4 relative + 1e-6.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu.training.adv_synth import (
    build_plain_batch as j_build_plain_batch,
)
from depthmodelhardening_tpu.training.config import (
    HardeningConfig as JHardeningConfig, SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu.training.hardening import (
    HardeningTrainer as JHardeningTrainer,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_train_state, from_jax_variables,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    LECUN_TRUNC_STD, init_monodepth2,
)
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer

H, W, B = 64, 128, 2
ORI_H, ORI_W = 96, 320
LR = 1e-4
SIDE = np.array([True, False])
FLIP = np.array([False, True])
LOSS_RTOL = 1e-5
GRAD_L2, GRAD_L2_ALL, NU_L2 = 0.1, 0.05, 0.2
PARAM_ATOL = 2.5 * LR
BN_RTOL, BN_ATOL = 1e-4, 1e-6
KW = dict(supervised_adv=False, contrastive_learning=False, batch_size=B,
          learning_rate=LR, scheduler_step_size=1)


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _frames():
    f0 = make_scene(B, ORI_H, ORI_W, seed=1)
    # the other eye: a column-shifted copy, so the warp has real signal
    return {"0": f0, "s": np.roll(f0, 6, axis=2)}


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps from one initial state: the states before and after
    each step, each step's gradients and metrics, and the noise each
    step drew for the automask."""
    cfg = JHardeningConfig(selfsup=JSelfSupConfig(height=H, width=W), **KW)
    jm = j_make_monodepth2()
    variables = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, H, W, 3)), train=False))(jax.random.PRNGKey(0))
    obj, mask = make_car_object(36, 24)
    trainer = JHardeningTrainer(cfg, jax.random.PRNGKey(1), obj, mask,
                                steps_per_epoch=1,
                                init_variables={"depth": variables})
    frames = {k: jnp.asarray(v) for k, v in _frames().items()}
    side, flip = jnp.asarray(SIDE), jnp.asarray(FLIP)
    K, inv_K = trainer._K, trainer._inv_K
    grad_fn = jax.jit(jax.grad(trainer._losses, has_aux=True))

    state = trainer.make_state()
    steps = []
    for i in range(2):
        rng = jax.random.PRNGKey(10 + i)
        before = _np_tree({"params": state.params,
                           "batch_stats": state.batch_stats})
        # what _plain_frames_step computes, for its gradients
        k_b, k_loss = jax.random.split(rng)
        batch = j_build_plain_batch(frames, side, flip, k_b, cfg.selfsup,
                                    color_aug=False)
        batch["K"] = jnp.broadcast_to(K, (B, 4, 4))
        batch["inv_K"] = jnp.broadcast_to(inv_K, (B, 4, 4))
        grads, (_, metrics) = grad_fn(state.params, state.batch_stats,
                                      batch, k_loss)
        noise = np.array(jax.random.normal(k_loss, (B, H, W, 1)))
        state, step_metrics = trainer.selfsup_frames_step(
            state, frames, side, flip, rng)
        adam = state.opt_state[0]
        steps.append(dict(
            before=before, grads=_np_tree(grads["depth"]), noise=noise,
            loss=float(metrics["loss"]), step_loss=float(step_metrics["loss"]),
            after=_np_tree({"params": state.params,
                            "batch_stats": state.batch_stats}),
            mu=_np_tree(adam.mu["depth"]), nu=_np_tree(adam.nu["depth"]),
            step=int(state.step)))
    return steps


def _bn_counts(model):
    """n = B * h * w seen by each BatchNorm in one forward (train mode,
    on a copy: in eval mode the student folds its BatchNorms)."""
    counts = {}
    model = copy.deepcopy(model).train()
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    with torch.no_grad():
        model(torch.zeros(B, H, W, 3))
    return counts


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's two steps, each from the JAX trainer's state before it,
    with the JAX noise: per step the loss, the gradients and Adam's
    moments (as state dicts) and the state dict after it."""
    cfg = HardeningConfig(selfsup=SelfSupConfig(height=H, width=W), **KW)
    trainer = HardeningTrainer(
        cfg, torch.Generator().manual_seed(0), *make_car_object(36, 24),
        device="cpu",
        steps_per_epoch=1,
        init_state_dict=from_jax_train_state(jax_run[0]["before"]))
    state = trainer.make_state()
    frames = {k: torch.from_numpy(v) for k, v in _frames().items()}
    steps = []
    for i in range(2):
        if i:
            state.model.load_state_dict(
                from_jax_train_state(jax_run[i]["before"]))
            mu = from_jax_variables({"params": jax_run[i - 1]["mu"]})
            nu = from_jax_variables({"params": jax_run[i - 1]["nu"]})
            for name, p in state.model.named_parameters():
                state.optimizer.state[p] = {
                    "step": torch.tensor(float(i)), "exp_avg": mu[name],
                    "exp_avg_sq": nu[name]}
            state.step = i
        state, metrics = trainer.selfsup_frames_step(
            state, frames, torch.from_numpy(SIDE), torch.from_numpy(FLIP),
            identity_noise=torch.from_numpy(jax_run[i]["noise"]))
        names = dict(state.model.named_parameters())
        opt = state.optimizer.state
        steps.append(dict(
            loss=float(metrics["loss"]),
            grads={n: p.grad.clone() for n, p in names.items()},
            mu={n: opt[p]["exp_avg"].clone() for n, p in names.items()},
            nu={n: opt[p]["exp_avg_sq"].clone() for n, p in names.items()},
            after={k: v.clone() for k, v in state.model.state_dict().items()},
            step=state.step, lr=state.optimizer.param_groups[0]["lr"]))
    return steps, _bn_counts(state.model)


def _assert_l2(got, want, per_tensor, overall=None):
    """Relative L2 error of each tensor of `got` (a dict of tensors) to
    `want`, and of all of them together."""
    num = den = 0.0
    for name, g in got.items():
        w = want[name].double()
        err = float((g.double() - w).norm())
        assert err <= per_tensor * float(w.norm()), name
        num, den = num + err ** 2, den + float(w.norm()) ** 2
    if overall is not None:
        assert num ** 0.5 <= overall * den ** 0.5


@pytest.mark.parametrize("i", [0, 1])
def test_loss_matches_jax(jax_run, port_run, i):
    j = jax_run[i]
    assert j["loss"] == pytest.approx(j["step_loss"], rel=1e-6)
    assert port_run[0][i]["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL)


@pytest.mark.parametrize("i", [0, 1])
def test_every_gradient_matches_jax(jax_run, port_run, i):
    want = from_jax_variables({"params": jax_run[i]["grads"]})
    got = port_run[0][i]["grads"]
    assert set(got) == set(want)
    _assert_l2(got, want, GRAD_L2, GRAD_L2_ALL)


@pytest.mark.parametrize("i", [0, 1])
def test_adam_moments_and_parameters_match_jax(jax_run, port_run, i):
    """After step i: Adam's moments at the gradient tolerance, the
    parameters within 2.5 lr; step 1 runs at lr * gamma (the staircase
    schedule) with bias correction 1 - b^2."""
    port = port_run[0][i]
    assert port["step"] == jax_run[i]["step"] == i + 1
    assert port["lr"] == pytest.approx(LR * 0.1 ** i)
    _assert_l2(port["mu"], from_jax_variables({"params": jax_run[i]["mu"]}),
               GRAD_L2, GRAD_L2_ALL)
    _assert_l2(port["nu"], from_jax_variables({"params": jax_run[i]["nu"]}),
               NU_L2)
    want = from_jax_train_state(jax_run[i]["after"])
    before = from_jax_train_state(jax_run[i]["before"])
    moved = 0
    for name, p in port_run[0][i]["grads"].items():
        got = port["after"][name]
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL * 0.1 ** i, rtol=0,
                                   err_msg=name)
        moved += int((got != before[name]).any())
    assert moved == len(port_run[0][i]["grads"])


@pytest.mark.parametrize("i", [0, 1])
def test_batchnorm_running_stats_match_jax(jax_run, port_run, i):
    steps, counts = port_run
    want = from_jax_train_state(jax_run[i]["after"])
    old = from_jax_train_state(jax_run[i]["before"])
    assert len(counts) == 20
    for mod, n in counts.items():
        mean = f"{mod}.running_mean"
        var = f"{mod}.running_var"
        np.testing.assert_allclose(steps[i]["after"][mean].numpy(),
                                   want[mean].numpy(), rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=mean)
        # flax: v' = 0.9 v + 0.1 s2_biased; torch: 0.1 s2_biased n/(n-1)
        expect = 0.9 * old[var] + (want[var] - 0.9 * old[var]) \
            * (n / (n - 1))
        np.testing.assert_allclose(steps[i]["after"][var].numpy(),
                                   expect.numpy(), rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=var)
        assert not torch.equal(steps[i]["after"][var], want[var])


def test_init_is_flax_truncated_lecun_normal():
    """Kernels of a truncated normal at +-2 sigma', sigma' =
    1 / sqrt(fan_in) / 0.8796..., so the std is 1 / sqrt(fan_in) (within
    2% on every layer of >= 20000 weights); zero biases; identity BN; the
    same seed gives the same weights."""
    a = init_monodepth2(torch.Generator().manual_seed(3))
    b = init_monodepth2(torch.Generator().manual_seed(3))
    c = init_monodepth2(torch.Generator().manual_seed(4))
    checked = 0
    for (name, m), mb, mc in zip(a.named_modules(), b.modules(),
                                 c.modules()):
        if isinstance(m, torch.nn.Conv2d):
            w = m.weight.detach()
            fan_in = w[0].numel()
            bound = 2.0 / np.sqrt(fan_in) / LECUN_TRUNC_STD
            assert float(w.abs().max()) <= bound * (1 + 1e-6), name
            assert torch.equal(w, mb.weight)
            assert not torch.equal(w, mc.weight)
            if w.numel() >= 20000:
                assert float(w.std()) * np.sqrt(fan_in) == pytest.approx(
                    1.0, rel=0.02), name
                # truncated: no weight beyond 2 sigma', many close to it
                assert float(w.abs().max()) > 0.9 * bound
                checked += 1
            if m.bias is not None:
                assert not m.bias.any()
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    assert checked >= 15


def _trainer(**kw):
    cfg = HardeningConfig(**{**KW, **kw})
    return HardeningTrainer(cfg, torch.Generator().manual_seed(0),
                            *make_car_object(36, 24), device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(selfsup=SelfSupConfig(frame_ids=("0", "-1", "1"))), "slice 5"),
    (dict(use_depth_hints=True), "slice 6"),
    (dict(model_family="manydepth"), "slice 6"),
])
def test_unported_options_raise_and_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.*{re.escape(item)}"):
        _trainer(**kw)


def test_unported_entry_points_and_settings_raise():
    """The trainer needs the attacked object, as the JAX package's does;
    the bf16 trainer and the TPU layouts are refused; with color_aug the
    plain step draws its jitter and runs."""
    with pytest.raises(TypeError, match="obj_img"):
        HardeningTrainer(HardeningConfig(**KW),
                         torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="float32.*slice 5"):
        HardeningConfig(compute_dtype="bfloat16")
    with pytest.raises(TypeError):
        HardeningConfig(wpack_stem=True)
    color = _trainer(selfsup=SelfSupConfig(height=32, width=64),
                     adv=AdvSynthConfig(color_aug=True))
    frames = {f: torch.rand(1, 40, 80, 3) for f in ("0", "s")}
    _, metrics = color.selfsup_frames_step(color.make_state(), frames,
                                           torch.tensor([True]),
                                           torch.tensor([False]))
    assert torch.isfinite(metrics["loss"])
