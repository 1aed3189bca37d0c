"""Shared weights, inputs and helpers of the bf16 tests
(tests/test_torch_bf16_kernels.py, tests/test_torch_bf16_attack.py,
tests/test_torch_bf16_steps.py), which hold the port's bfloat16
distillation configuration (the JAX package's `bench.py:81-115`) against the JAX package: the BatchNorm fold, the
bf16 model, kernel D's and kernel B's bf16 plain versions, the bf16
attack view, the coarse-scale objective and the bench configuration's
training step.

Weights: the golden reference-layout state dicts of tests/golden_common.py
with their BatchNorm running statistics set to the batch statistics of
synthetic scenes (`_calibrated`). The golden statistics are random, which
drives deep features to O(100), where a bf16 ulp is 0.5 and bf16 says
little; calibrated, the features are O(10), as a trained model's are.
Inputs are made with numpy seeds; the port runs its plain CPU versions,
the JAX package its own CPU path (its Pallas pool kernel in interpret
mode, as tests/test_pallas_pool.py runs it).

XLA may keep float32 inside a fusion where PyTorch rounds after every
op, so bf16 results cannot agree bit for bit. Every bf16 comparison is
also held against the float32 result, so that a tolerance cannot hide a
wrong dtype flow: the port's bf16 must sit closer to JAX's bf16 than
either sits to float32. Tolerances, measured on the CPU and written
beside each test:

* fold, float32 (Monodepth2-18 at 96x320, batch 2): the port's folded
  eval forward within 2e-5 of its unfolded one (5.9e-6 measured) and
  within 2e-5 of JAX's `fold_bn=True` forward (3.9e-6 measured; the
  distill test's teacher holds 1e-4 unfolded);
* bf16 model: disp0 and disp1 relative L2 2e-2 to JAX's jitted bf16
  model (folded 4.5e-3 measured; unfolded 9.0e-3 and 1.0e-2, where XLA
  fuses each BatchNorm into its conv in float32 and PyTorch rounds the
  conv's output to bf16 first), max 8e-2 (4.3e-2); each 1.2e-2 to
  1.8e-2 from the float32 result, held within 3e-2 and above 3e-3 (the
  bf16 path is really taken), and the port nearer JAX's bf16 than
  either is to float32;
* D's bf16 plain version: one rounding of the float32 result (within half
  a bf16 ulp of JAX's float32 conv of the same bf16 inputs, plus 1e-6
  for the other sum order), and within one bf16 ulp of the output's
  largest magnitude of JAX's bf16 conv + bias + ELU, which rounds after
  the conv, the bias and the ELU (2^-7 measured, at outputs of 1..2);
  its input gradient within one bf16 ulp of JAX's (bit-equal at three of
  four shapes);
* the fused route (`conv3x3_reflect` in bf16, the reflect pad folded
  into D): forward one rounding of JAX's float32 `conv3x3_reflect` and
  `conv3x3_reflect_same`; input gradient one rounding of their float32
  VJPs, within one ulp of JAX's bf16 VJP inside and of its largest
  magnitude at the edge rows and columns, where JAX rounds twice (each
  with kernel D's 1e-5-of-the-max slack for cancelling sums);
* B's bf16 plain version: bit-equal to the TPU kernels B1 and B2 in bf16
  (interpret mode) on relu outputs full of ties: both give every input
  bit-equal to its window's max the window's full cotangent and sum in
  float32 (flax's autodiff picks one winner instead);
* the bf16 view, the coarse objective, the coarse-to-fine run and the
  bench configuration's step: in each test's docstring (the step's bf16
  gradients are held per tensor against JAX's bf16 gradient and,
  within a bound under 1, against its float32 one, each scaled by JAX's
  own bf16-vs-float32 error, since bf16 backward passes are that
  noisy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from depthmodelhardening_tpu.data.synthetic import make_scene
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_variables, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import make_monodepth2
from depthmodelhardening_tpu_torch.ops.resize import bilinear_resize
from golden_common import depth_decoder_state_dict, resnet18_encoder_state_dict

H, W = 96, 320


FOLD_ATOL = 2e-5


BF16_L2, BF16_MAX, BF16_F32_L2, BF16_FLOOR = 2e-2, 8e-2, 3e-2, 3e-3


def _interp(fn, *args):
    """Run fn with every pallas_call in interpret mode."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _rl2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulp(v):
    """One bf16 ulp at |v| (2^(e - 7) for 2^e <= |v| < 2^(e + 1))."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(v)) - 7)


def _calibrated(enc_sd, dec_sd, seed=7):
    """enc_sd with every BatchNorm's running statistics set to its batch
    statistics on 4 synthetic scenes at 96x320 (unbiased variance)."""
    model = make_monodepth2()
    model.load_state_dict(load_reference_state_dict(enc_sd, dec_sd))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: this one batch
    scenes = torch.from_numpy(make_scene(4, 375, 1242, seed=seed))
    with torch.no_grad():
        model.train().features_and_disps(bilinear_resize(scenes, H, W))
    sd = model.state_dict()
    return {k: (sd[k].numpy() if k.endswith(("running_mean", "running_var"))
                else v) for k, v in enc_sd.items()}


def jax_variables(enc_sd, dec_sd):
    ev, _ = convert_resnet_encoder(enc_sd)
    dv = convert_depth_decoder(dec_sd)
    return jax.tree_util.tree_map(np.asarray, {
        "params": {"encoder": ev["params"], "decoder": dv["params"]},
        "batch_stats": {"encoder": ev["batch_stats"]}})


@pytest.fixture(scope="module")
def weights():
    dec_sd = depth_decoder_state_dict(seed=0)
    enc_sd = _calibrated(resnet18_encoder_state_dict(seed=0), dec_sd)
    return dict(enc_sd=enc_sd, dec_sd=dec_sd,
                jv=jax_variables(enc_sd, dec_sd),
                sd=load_reference_state_dict(enc_sd, dec_sd))


@pytest.fixture(scope="module")
def images():
    scenes = torch.from_numpy(make_scene(2, 375, 1242, seed=3))
    return bilinear_resize(scenes, H, W).numpy()


def _port_disps(weights, images, dtype, fold, scales=(0, 1)):
    """The port's eval disps (NHWC numpy) at `scales`, its weights loaded
    from JAX's variables (models/convert.py)."""
    model = make_monodepth2(dtype=dtype, fold_bn=fold)
    model.load_state_dict(from_jax_variables(weights["jv"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.eval()
    with torch.no_grad():
        _, d = model.features_and_disps(torch.from_numpy(images), scales)
    return {s: d[("disp", s)].permute(0, 2, 3, 1).numpy() for s in scales}


def _jax_disps(weights, images, dtype, fold):
    jm = j_make_monodepth2(dtype=jnp.dtype(dtype), fold_bn=fold)
    _, d = jax.jit(lambda v, x: jm.apply(
        v, x, train=False, method=jm.features_and_disps))(
        weights["jv"], jnp.asarray(images))
    return {s: np.asarray(d[("disp", s)]) for s in (0, 1)}


@pytest.fixture(scope="module")
def jax_f32(weights, images):
    return _jax_disps(weights, images, "float32", False)


# -- the attack and the distillation step -----------------------------------
B, OBJ_H, OBJ_W = 2, 40, 60


KW = dict(batch_size=B, steps=2, scene_h=H, scene_w=W)


CROP = dict(attack_crop_w=128, attack_crop_h=64, tile_w=128, tile_h=64)


BENCH = dict(**KW, **CROP, compute_dtype="bfloat16",
             attack_view_dtype="bfloat16", fold_bn=True)


SIGN_FLOOR, SPLIT_MAX = 1e-6, 1e-3  # test_torch_distill.py's allowance


SCALE_COST_RTOL, SCALE_GRAD_L2 = 5e-5, 2e-2


STEP_LOSS_RTOL = {"half": 1e-3, "whole": 5e-3}


STEP_L2_ALL, STEP_NU_L2_ALL, NOISE_X, NOISE_ATOL = 0.15, 0.12, 3.0, 0.05


F32_X, F32_ATOL, F32_CAP = 1.5, 0.05, 0.6


def _draws(j_atk, key, steps):
    """The draws of JAX `PhysObjAttack._run(..., rng=key)` as PGDDraws."""
    from depthmodelhardening_tpu_torch.attacks.pgd_object import PGDDraws

    k_opt, k_final = jax.random.split(key)
    k_init, k_loop = jax.random.split(k_opt)
    noise = jax.random.uniform(k_init, j_atk.obj_img.shape, minval=-0.1,
                               maxval=0.1)
    za = [j_atk._sample_za(jax.random.fold_in(k_loop, s), B)
          for s in range(steps)]
    fz, fa = j_atk._final_za(k_final, B)
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    return PGDDraws(noise=t(noise),
                    z0s=t(np.stack([np.asarray(z) for z, _ in za])),
                    alphas=t(np.stack([np.asarray(a) for _, a in za])),
                    final_z0s=t(fz), final_alphas=t(fa))


@pytest.fixture(scope="module")
def scene():
    from depthmodelhardening_tpu.data.synthetic import make_car_object

    obj, mask = make_car_object(width=OBJ_W, height=OBJ_H)
    rng = np.random.RandomState(5)
    start = np.clip(obj + rng.uniform(-0.1, 0.1, obj.shape), 0.0, 1.0)
    return dict(obj=obj, mask=mask, scenes=make_scene(B, 375, 1242, seed=1),
                start=start.astype(np.float32),
                z0s=np.array([7.0, 11.0], np.float32),
                alphas=np.array([-10.0, 15.0], np.float32))


@pytest.fixture(scope="module")
def student_weights():
    """The student starts from other weights than the teacher (golden
    seed 1), so the distillation loss is not a difference of near-equal
    predictions that bf16 rounding alone decides."""
    dec_sd = depth_decoder_state_dict(seed=1)
    enc_sd = _calibrated(resnet18_encoder_state_dict(seed=1), dec_sd)
    return dict(jv=jax_variables(enc_sd, dec_sd),
                sd=load_reference_state_dict(enc_sd, dec_sd))


def _jax_trainer(weights, student, scene, **kw):
    from depthmodelhardening_tpu.models.wrappers import predictor_from
    from depthmodelhardening_tpu.training.config import DistillConfig
    from depthmodelhardening_tpu.training.distill import DistillTrainer

    teacher = predictor_from(j_make_monodepth2(
        dtype=jnp.bfloat16, scales=(0,), fold_bn=True), weights["jv"])
    return DistillTrainer(DistillConfig(**kw), jax.random.PRNGKey(0),
                          scene["obj"], scene["mask"], teacher,
                          init_variables=student["jv"])


def _port_trainer(weights, student, scene, **kw):
    """The port's DistillTrainer with bench.py's teacher: bf16, folded,
    disp0 only."""
    from depthmodelhardening_tpu_torch.models.wrappers import predictor_from
    from depthmodelhardening_tpu_torch.training.config import DistillConfig
    from depthmodelhardening_tpu_torch.training.distill import DistillTrainer

    teacher = make_monodepth2(dtype="bfloat16", fold_bn=True)
    teacher.load_state_dict(weights["sd"])
    return DistillTrainer(
        DistillConfig(**kw), torch.Generator().manual_seed(0), scene["obj"],
        scene["mask"], predictor_from(teacher, scales=(0,)),
        device="cpu", init_state_dict=student["sd"])


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def images_like(scene):
    """The scenes at the model's resolution."""
    return bilinear_resize(torch.from_numpy(scene["scenes"]), H, W).numpy()


# -- the CLI's bf16 hardening step ------------------------------------------
HARDEN_H, HARDEN_W, HARDEN_B = 64, 192, 4  # tests/test_torch_hardening.py's
