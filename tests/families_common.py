"""Shared code of the model families' step tests
(tests/test_torch_families.py, tests/test_torch_manydepth_steps.py): one
port `HardeningTrainer.train_step` of a family from a JAX trainer's
initial state on JAX's draws, JAX's gradients on the batch it built, and
the checks; the rule and sizes are in test_torch_families.py's
docstring."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.attacks.pgd_object import (
    PGDObjectAttack as JPGDObjectAttack,
)
from depthmodelhardening_tpu.data.synthetic import make_car_object, make_scene
from depthmodelhardening_tpu.models.pose import PoseDecoder as JPoseDecoder
from depthmodelhardening_tpu.models.resnet import (
    ResnetEncoder as JResnetEncoder,
)
from depthmodelhardening_tpu.models.simsiam import SimSiam as JSimSiam
from depthmodelhardening_tpu.models.wrappers import (
    DepthPredictor as JDepthPredictor, ManyDepthTrainModel as JManyDepth,
    MonodepthModel as JMonodepthModel,
)
from depthmodelhardening_tpu.training.config import (
    AdvSynthConfig as JAdvSynthConfig, HardeningConfig as JHardeningConfig,
    SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu.training.hardening import (
    HardeningTrainer as JHardeningTrainer,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_hardening_state, from_jax_variables,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    ManyDepthTrainModel, make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import (
    HardeningTrainer, StepDraws,
)

from test_torch_hardening import (
    COLLECTIONS, CONTRAS_ATOL, GRAD_FLOOR, GRAD_L2, GRAD_L2_ALL, LOSS_RTOL,
    MONO, NU_L2, _assert_l2, pgd_draws, synth_draws,
)

H, W = 64, 192
ORI_H, ORI_W = 96, 320
OBJ_H, OBJ_W = 24, 36
B, STEP_B, BINS = 2, 4, 8
SIDE = np.array([True, False, False, True])
FLIP = np.array([False, True, False, True])
SHIFT = 6  # native columns between "0" and "s"
FAMILIES = {
    "hints50": dict(num_layers=50, use_depth_hints=True,
                    contras_loss_wt=0.1),
    "manydepth": dict(model_family="manydepth",
                      manydepth_num_depth_bins=BINS),
    "real_lookup": dict(model_family="manydepth",
                        manydepth_num_depth_bins=BINS,
                        manydepth_real_lookup=True),
}


def _np(t):
    return jax.tree_util.tree_map(np.array, t)


def _perturbed(v, seed):
    """BatchNorm scale 1 + 0.2 N, running mean 0.1 N, var 0.5 + U."""
    rng = np.random.RandomState(seed)

    def walk(t, fn):
        return {k: walk(x, fn) if isinstance(x, dict) else fn(k, x)
                for k, x in t.items()}

    return {"params": walk(v["params"], lambda k, x: (
        (1 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        if k == "scale" else x)),
        "batch_stats": walk(v["batch_stats"], lambda k, x: (
            (0.1 * rng.randn(*x.shape)).astype(np.float32) if k == "mean"
            else (0.5 + rng.rand(*x.shape)).astype(np.float32)))}


def _frames(family):
    f0 = make_scene(STEP_B, ORI_H, ORI_W, seed=1)
    frames = {"0": f0, "s": np.roll(f0, SHIFT, axis=2)}
    if family == "real_lookup":
        frames["-1"] = np.roll(f0, -4, axis=2)
        frames["1"] = np.roll(f0, 3, axis=1)
    if family == "hints50":
        # the depth of the shift at model resolution (stereo baseline 0.1
        # in the normalised frame; fx = 0.58 W)
        depth = 0.58 * W * 0.1 / (SHIFT * W / ORI_W)
        valid = (np.random.RandomState(7).rand(STEP_B, H, W, 1) > 0.2)
        frames["depth_hint"] = (depth * valid).astype(np.float32)
        frames["depth_hint_mask"] = valid.astype(np.float32)
    return frames


def _jax_setup(family):
    """The JAX trainer of `family`, its initial state, its jitted
    `_losses` gradient and Adam update, and the port's frozen teacher."""
    kw = FAMILIES[family]
    fids = MONO if family == "real_lookup" else ("0", "s")
    cfg = JHardeningConfig(
        selfsup=JSelfSupConfig(height=H, width=W, frame_ids=fids),
        adv=JAdvSynthConfig(norm_type="l_inf", steps=1, attack_batch_size=B,
                            ori_h=ORI_H, ori_w=ORI_W),
        batch_size=STEP_B, **kw)
    if "model_family" in kw:
        jm = JManyDepth(input_height=H, input_width=W, num_depth_bins=BINS)
        port_teacher = ManyDepthTrainModel(input_height=H, input_width=W,
                                           num_depth_bins=BINS)
    else:
        jm = JMonodepthModel(num_layers=50)
        port_teacher = make_monodepth2(50)
    x = jnp.zeros((1, H, W, 3))
    v = _perturbed(_np(jax.jit(lambda k: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0))), 2)
    feats = jax.jit(lambda v: jm.apply(v, x, train=False, method="encode"))(v)
    head = jax.jit(lambda k: JSimSiam().init(k, feats, feats, train=False))(
        jax.random.PRNGKey(1))
    init = {"depth": v, "simsiam": head}
    if family == "real_lookup":
        enc = JResnetEncoder(num_layers=18, num_input_images=2)
        dec = JPoseDecoder(num_input_features=1, num_frames_to_predict_for=2)
        pair = jnp.zeros((1, H, W, 6))
        init["pose_encoder"] = jax.jit(lambda k: enc.init(
            k, pair, train=False))(jax.random.PRNGKey(4))
        pf = jax.jit(lambda v: enc.apply(v, pair, train=False))(
            init["pose_encoder"])
        init["pose_decoder"] = jax.jit(lambda k: dec.init(k, [pf]))(
            jax.random.PRNGKey(5))
    teacher_model = jm.clone(scales=(0,))
    teacher = JDepthPredictor(
        apply_fn=lambda vv, im: teacher_model.apply(vv, im, train=False),
        variables=v)
    obj, mask = make_car_object(OBJ_W, OBJ_H, seed=3)
    tr = JHardeningTrainer(cfg, jax.random.PRNGKey(0), obj, mask,
                           teacher=teacher, steps_per_epoch=10,
                           init_variables=init)
    port_teacher.load_state_dict(from_jax_variables(v))
    return dict(tr=tr, state=tr.make_state(), obj=obj, mask=mask,
                teacher=predictor_from(port_teacher),
                grad=jax.jit(jax.grad(tr._losses, has_aux=True)),
                update=jax.jit(tr.tx.update))


def family_step(family):
    """The port's `train_step` of the family from the JAX trainer's initial
    state on JAX's draws; JAX's gradients, metrics and Adam update on the
    batch that step built."""
    js = _jax_setup(family)
    tr, state = js["tr"], js["state"]
    frames = _frames(family)
    scenes = make_scene(1, ORI_H, ORI_W, seed=2)
    k_atk, k_synth, k_loss = jax.random.split(jax.random.PRNGKey(3), 3)
    j_atk = JPGDObjectAttack(tr._student_predict, js["obj"], js["mask"],
                             tr.attack.cfg, eps=0.1, alpha=0.005, steps=1)
    n_noise = (1 if family == "hints50"
               else len(tr.cfg.selfsup.source_frame_ids))
    draws = StepDraws(
        attack=pgd_draws(j_atk, k_atk, B, 1),
        synth=synth_draws(k_synth, STEP_B, tr.cfg.adv),
        identity_noise=torch.from_numpy(np.array(jax.random.normal(
            k_loss, (STEP_B, H, W, n_noise)))))
    fids = MONO if family == "real_lookup" else ("0", "s")
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=H, width=W, frame_ids=fids),
        adv=AdvSynthConfig(norm_type="l_inf", steps=1, attack_batch_size=B,
                           ori_h=ORI_H, ori_w=ORI_W),
        batch_size=STEP_B, **FAMILIES[family])
    resume = from_jax_hardening_state(_np(state))
    port = HardeningTrainer(cfg, torch.Generator().manual_seed(0),
                            js["obj"], js["mask"], js["teacher"],
                            device="cpu", steps_per_epoch=10,
                            init_state_dict=resume["model"])
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
    grads, (_, j_metrics) = js["grad"](state.params, state.batch_stats,
                                       batch, k_loss)
    _, new_opt = js["update"](grads, state.opt_state, state.params)
    adam = new_opt[0]
    return dict(family=family, port=port, state=p_state, metrics=metrics,
                resume=resume, batch=batches[0],
                j_metrics={k: float(v) for k, v in j_metrics.items()},
                grads=_np(grads), mu=_np(adam.mu), nu=_np(adam.nu))


def check_model_and_batch(step):
    """The student is the family's (ResNet-50's 2048-channel features and
    head; ManyDepth's cost-volume encoder, 8 bins), the hint planes ride
    into the batch, and the real-lookup step predicts the poses once."""
    state, batch = step["state"], step["batch"]
    if step["family"] == "hints50":
        assert state.model.encoder.num_ch_enc[-1] == 2048
        assert state.simsiam.projector_0.in_features == 2048
        for k in ("depth_hint", "depth_hint_mask"):
            assert batch[k].shape == (STEP_B, H, W, 1)
        assert step["port"].identity_noise_shape(STEP_B) == (STEP_B, H, W, 1)
    else:
        assert isinstance(state.model, ManyDepthTrainModel)
        assert state.model.encoder.num_depth_bins == BINS
        assert "depth_hint" not in batch
    assert ("pose_encoder" in state.modules()) is \
        (step["family"] == "real_lookup")
    if step["family"] == "real_lookup":
        # two temporal sources, once each: the student's volume and the
        # photometric loss share the poses
        assert int(state.pose_encoder.bn1.num_batches_tracked) == 2


def check_losses(step):
    got = {k: float(v) for k, v in step["metrics"].items()}
    want = step["j_metrics"]
    assert set(got) == set(want) == {"sup_loss", "contras_loss",
                                     "selfsup_loss", "loss"}
    for k in ("sup_loss", "selfsup_loss", "loss"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    assert got["contras_loss"] == pytest.approx(want["contras_loss"], rel=0,
                                                abs=CONTRAS_ATOL)
    assert got["sup_loss"] > 0 and step["state"].step == 1


def check_gradients_and_adam(step):
    """Every trained tensor's gradient and Adam's moments against JAX's;
    every parameter moved."""
    state = step["state"]
    opt = state.optimizer.state
    for key, module in state.modules().items():
        coll, from_jax = COLLECTIONS[key]
        convert = lambda t: from_jax({"params": t})
        params = dict(module.named_parameters())
        want = convert(step["grads"][coll])
        got = {n: p.grad for n, p in params.items()}
        if key == "model":
            # heads 1-3 of the encoder's unused prematching conv and (in
            # JAX) zero gradients where the port has none
            for n in [n for n, g in got.items() if g is None]:
                assert not want[n].any(), n
                got.pop(n), want.pop(n)
        _assert_l2(f"{key} gradient", got, want, GRAD_L2, GRAD_L2_ALL,
                   GRAD_FLOOR)
        keys = set(got)
        _assert_l2(f"{key} exp_avg",
                   {n: opt[params[n]]["exp_avg"] for n in keys},
                   {n: v for n, v in convert(step["mu"][coll]).items()
                    if n in keys}, GRAD_L2, GRAD_L2_ALL, GRAD_FLOOR)
        _assert_l2(f"{key} exp_avg_sq",
                   {n: opt[params[n]]["exp_avg_sq"] for n in keys},
                   {n: v for n, v in convert(step["nu"][coll]).items()
                    if n in keys}, NU_L2, floor=GRAD_FLOOR ** 2)
        before = step["resume"][key]
        for n in keys:
            assert not torch.equal(params[n].detach(), before[n]), n
