"""The port's bfloat16 distillation configuration (the JAX package's
`bench.py:81-115`) against the JAX package: the BatchNorm fold, the
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
either sits to float32. Tolerances, measured on this CPU and written
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

import depthmodelhardening_tpu.ops.pallas_conv as pc
import depthmodelhardening_tpu.ops.pallas_pool as pp
from depthmodelhardening_tpu.ops.padding import conv3x3_reflect_same
from depthmodelhardening_tpu.data.synthetic import make_scene
from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu.ops.wpack_decoder import wpack, wunpack
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_variables, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import make_monodepth2
from depthmodelhardening_tpu_torch.ops import conv, pool
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


def test_fold_matches_unfolded_and_jax(weights, images, jax_f32):
    """float32: the folded eval forward against the unfolded one, and
    against JAX's `fold_bn=True` model with the same weights."""
    plain = _port_disps(weights, images, "float32", False)
    folded = _port_disps(weights, images, "float32", True)
    want = _jax_disps(weights, images, "float32", True)
    for s in (0, 1):
        assert not np.array_equal(folded[s], plain[s])  # the fold ran
        np.testing.assert_allclose(folded[s], plain[s], atol=FOLD_ATOL,
                                   rtol=0, err_msg=f"disp{s}")
        np.testing.assert_allclose(folded[s], want[s], atol=FOLD_ATOL,
                                   rtol=0, err_msg=f"disp{s}")
        np.testing.assert_allclose(plain[s], jax_f32[s], atol=FOLD_ATOL,
                                   rtol=0, err_msg=f"disp{s}")


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_model_matches_jax(weights, images, jax_f32, fold):
    """disp0 and disp1 of the bf16 model (parameters and statistics
    float32, loaded from JAX's variables) against JAX's
    `compute_dtype=bfloat16` model, folded and not; both against the
    float32 result."""
    got = _port_disps(weights, images, "bfloat16", fold)
    want = _jax_disps(weights, images, "bfloat16", fold)
    for s in (0, 1):
        err = _rl2(got[s], want[s])
        port_f32, jax_f32_err = (_rl2(got[s], jax_f32[s]),
                                 _rl2(want[s], jax_f32[s]))
        assert err <= BF16_L2, (s, err)
        assert float(np.abs(got[s] - want[s]).max()) <= BF16_MAX, s
        for e in (port_f32, jax_f32_err):
            assert BF16_FLOOR <= e <= BF16_F32_L2, (s, e)
        assert err < min(port_f32, jax_f32_err), (s, err, port_f32)


@pytest.mark.parametrize("shape", [(2, 24, 40, 16, 16), (2, 12, 20, 64, 32),
                                   (1, 13, 21, 3, 5), (2, 24, 40, 16, 1)])
def test_bf16_conv_plain_matches_jax(shape):
    """Kernel D's bf16 plain version (bias + ELU epilogue, and the input
    gradient) against JAX's bf16 `conv3x3_reflect` + bias + ELU and the
    VJP of its VALID conv."""
    B, h, w, ci, co = shape
    r = np.random.RandomState(ci * co)
    x = r.rand(B, h, w, ci).astype(np.float32)
    k = (r.randn(3, 3, ci, co) / (3 * ci ** 0.5)).astype(np.float32)
    b = (0.1 * r.randn(co)).astype(np.float32)
    g = r.randn(B, h, w, co).astype(np.float32)
    xb, kb, bb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, k, b, g))
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    want = f32(jax.nn.elu(pc.conv3x3_reflect(xb, kb, bb)))
    exact = f32(jax.nn.elu(pc.conv3x3_reflect(
        xb.astype(jnp.float32), kb.astype(jnp.float32),
        bb.astype(jnp.float32))))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(f32(a)), -1, 1))).bfloat16()
    wt = torch.from_numpy(np.ascontiguousarray(
        f32(kb).transpose(3, 2, 0, 1))).bfloat16()
    got = conv.conv3x3_reflect(nchw(xb), wt,
                               torch.from_numpy(f32(bb)).bfloat16(), True)
    assert got.dtype == torch.bfloat16
    got = np.moveaxis(got.float().numpy(), 1, -1)
    assert (np.abs(got - exact) <= 0.5 * _ulp(exact) + 1e-6).all()
    assert np.abs(got - want).max() <= _ulp(np.abs(want).max())

    xp = jnp.pad(xb, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    _, vjp = jax.vjp(lambda t: jax.lax.conv_general_dilated(
        t, kb, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        xp)
    d_want = f32(vjp(gb)[0])
    d_got = conv.conv3x3_dgrad_plain(nchw(gb), wt)
    assert d_got.dtype == torch.bfloat16
    d_got = np.moveaxis(d_got.float().numpy(), 1, -1)
    assert (np.abs(d_got - d_want) <= _ulp(d_want)).all()


@pytest.mark.parametrize("shape", [(2, 24, 40, 16, 16), (2, 12, 20, 64, 32),
                                   (1, 13, 21, 3, 5), (2, 24, 40, 16, 1),
                                   (2, 3, 2, 16, 16), (1, 1, 5, 16, 1),
                                   (2, 2, 1, 3, 5), (2, 1, 1, 16, 16)])
def test_fused_bf16_conv_matches_jax(shape):
    """The bf16 route with the reflect pad folded in (`conv3x3_reflect` on
    bf16: `_Conv3x3Reflect`'s plain forward and its fused input gradient,
    `conv3x3_dgrad_reflect_plain`) against JAX's `pallas_conv.
    conv3x3_reflect` and `padding.conv3x3_reflect_same` and their VJPs,
    at maps down to 1 x 1. Forward + bias + ELU: one rounding of JAX's
    float32 result of the same bf16 operands (within half a bf16 ulp, plus
    1e-6), for both JAX functions, and within one bf16 ulp of the largest
    magnitude of JAX's bf16 `conv3x3_reflect` (the existing rule; JAX rounds
    after the conv, the bias and the ELU). Input gradient of the conv, each
    comparison with kernel D's slack of 1e-5 of the largest magnitude where
    a float32 sum of up to 576 products cancels (a 7.4e-6 element, 2.5 of
    its own ulps from JAX's, at (2, 12, 20, 64, 32)): one rounding of JAX's
    float32 gradient of both functions (within one ulp of it
    elementwise); within one bf16 ulp of JAX's bf16 gradient elementwise
    in the interior and, at the edge rows and columns, within one bf16 ulp
    of its largest magnitude: JAX rounds d xp to bf16 and again after
    adding its halo (the two-rounding composition the route had before
    the fold), one rounding here, so where the two summands cancel the
    edge element differs by many of its own ulps (229 measured) but never
    by more than one ulp of the gradient's scale (1.0 measured)."""
    B, h, w, ci, co = shape
    r = np.random.RandomState(ci * co + h)
    x = r.rand(B, h, w, ci).astype(np.float32)
    k = (r.randn(3, 3, ci, co) / (3 * ci ** 0.5)).astype(np.float32)
    b = (0.1 * r.randn(co)).astype(np.float32)
    g = r.randn(B, h, w, co).astype(np.float32)
    xb, kb, bb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, k, b, g))
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    up = lambda *ts: [t.astype(jnp.float32) for t in ts]
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(f32(a), -1, 1))).bfloat16()
    wt = torch.from_numpy(np.ascontiguousarray(
        f32(kb).transpose(3, 2, 0, 1))).bfloat16()

    got = conv.conv3x3_reflect(nchw(xb), wt,
                               torch.from_numpy(f32(bb)).bfloat16(), True)
    got = np.moveaxis(got.float().numpy(), 1, -1)
    for fn in (pc.conv3x3_reflect, conv3x3_reflect_same):
        exact = f32(jax.nn.elu(fn(*up(xb, kb, bb))))
        assert (np.abs(got - exact) <= 0.5 * _ulp(exact) + 1e-6).all(), fn
    want = f32(jax.nn.elu(pc.conv3x3_reflect(xb, kb, bb)))
    assert np.abs(got - want).max() <= _ulp(np.abs(want).max())

    xt = nchw(xb).requires_grad_(True)
    out = conv.conv3x3_reflect(xt, wt)
    assert type(out.grad_fn).__name__ == "_Conv3x3ReflectBackward"
    out.backward(nchw(gb))
    d_got = np.moveaxis(xt.grad.float().numpy(), 1, -1)
    d_plain = np.moveaxis(conv.conv3x3_dgrad_reflect_plain(
        nchw(gb), wt).float().numpy(), 1, -1)
    np.testing.assert_array_equal(d_got, d_plain)
    for fn in (pc.conv3x3_reflect, conv3x3_reflect_same):
        _, vjp = jax.vjp(lambda t: fn(t, kb.astype(jnp.float32)),
                         xb.astype(jnp.float32))
        exact = f32(vjp(gb.astype(jnp.float32))[0])
        slack = 1e-5 * np.abs(exact).max()
        assert (np.abs(d_got - exact) <= _ulp(exact) + slack).all(), fn
    _, vjp = jax.vjp(lambda t: pc.conv3x3_reflect(t, kb), xb)
    d_want = f32(vjp(gb)[0])
    edge = np.zeros((h, w), bool)
    edge[[min(1, h - 1), max(h - 2, 0)], :] = True
    edge[:, [min(1, w - 1), max(w - 2, 0)]] = True
    edge = np.broadcast_to(edge[None, :, :, None], d_got.shape)
    diff = np.abs(d_got - d_want)
    slack = 1e-5 * np.abs(d_want).max()
    assert (diff[~edge] <= _ulp(d_want)[~edge] + slack).all()
    assert diff[edge].max() <= _ulp(np.abs(d_want).max()) + slack


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_pool_plain_matches_tpu_kernel(seed):
    """B1 and B2 in bf16 (interpret mode, the JAX package's width-packed
    layout) against the port's bf16 plain versions, on relu outputs with
    ties at 0 and between positive values: bit-equal."""
    B, C, h, w = 2, 4, 32, 64  # B2 needs h/2 % 8 == 0 and w/4 % 8 == 0
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(B, C, h, w), 0).astype(np.float32)
    x[:, :, ::5, ::3] = 0.5
    g = rng.randn(B, C, h // 2, w // 2).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gb = jnp.asarray(g, jnp.bfloat16)
    xp4 = wpack(xb.transpose(0, 2, 3, 1), 4)
    gp2 = wpack(gb.transpose(0, 2, 3, 1), 2)

    def b2():
        y, vjp = jax.vjp(lambda t: pp.wpack4_maxpool3x3s2_pallas(t, C), xp4)
        return y, vjp(gp2)[0]

    y_j, gx_j = _interp(b2)
    assert y_j.dtype == jnp.bfloat16 and gx_j.dtype == jnp.bfloat16
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    y_j = f32(wunpack(y_j, 2)).transpose(0, 3, 1, 2)
    gx_j = f32(wunpack(gx_j, 4)).transpose(0, 3, 1, 2)

    xt = torch.from_numpy(f32(xb))
    gt = torch.from_numpy(f32(gb))
    y_t = pool.maxpool3x3s2_plain(xt.bfloat16())
    gx_t = pool.maxpool3x3s2_backward_plain(xt.bfloat16(), gt.bfloat16())
    assert y_t.dtype == gx_t.dtype == torch.bfloat16
    assert (gx_t != 0).sum() > y_t.numel() // 2
    np.testing.assert_array_equal(y_t.float().numpy(), y_j)
    np.testing.assert_array_equal(gx_t.float().numpy(), gx_j)



@pytest.mark.parametrize("shape", [(2, 4, 32, 64), (1, 2, 64, 128)])
def test_bf16_pool_decompositions_match_tpu_kernel(shape):
    """The bf16 kernels' decompositions (`maxpool3x3s2_separable_plain`,
    `maxpool3x3s2_backward_strips_plain` in POOL_BWD_STRIP strips) against B1
    and B2 in bf16 (interpret mode, the width-packed layout), on relu
    outputs with ties: bit-equal."""
    B, C, h, w = shape  # B2 needs h/2 % 8 == 0 and w/4 % 8 == 0
    rng = np.random.RandomState(h)
    x = np.maximum(rng.randn(B, C, h, w), 0).astype(np.float32)
    x[:, :, ::5, ::3] = 0.5
    g = rng.randn(B, C, h // 2, w // 2).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gb = jnp.asarray(g, jnp.bfloat16)
    xp4 = wpack(xb.transpose(0, 2, 3, 1), 4)
    gp2 = wpack(gb.transpose(0, 2, 3, 1), 2)

    def b2():
        y, vjp = jax.vjp(lambda t: pp.wpack4_maxpool3x3s2_pallas(t, C), xp4)
        return y, vjp(gp2)[0]

    y_j, gx_j = _interp(b2)
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    y_j = f32(wunpack(y_j, 2)).transpose(0, 3, 1, 2)
    gx_j = f32(wunpack(gx_j, 4)).transpose(0, 3, 1, 2)

    xt = torch.from_numpy(f32(xb)).bfloat16()
    gt = torch.from_numpy(f32(gb)).bfloat16()
    y_t = pool.maxpool3x3s2_separable_plain(xt)
    gx_t = pool.maxpool3x3s2_backward_strips_plain(xt, gt)
    assert y_t.dtype == gx_t.dtype == torch.bfloat16
    assert (gx_t != 0).sum() > y_t.numel() // 2
    np.testing.assert_array_equal(y_t.float().numpy(), y_j)
    np.testing.assert_array_equal(gx_t.float().numpy(), gx_j)


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


@pytest.mark.parametrize("scales,runs", [
    ((0,), 10), ((1,), 8), ((2,), 6), ((3, 1), 8), ((2, 0), 10)])
def test_decoder_stops_after_the_deepest_head(scales, runs):
    """The decoder's upconvs run down to the deepest requested head and
    no further: with scales=(1,) neither upconv_0_0, upconv_0_1 nor
    dispconv_0 is evaluated."""
    from depthmodelhardening_tpu_torch.models.wrappers import init_monodepth2

    model = init_monodepth2(torch.Generator().manual_seed(0)).eval()
    ran = []
    for i, m in enumerate(model.decoder.decoder):
        m.register_forward_hook(lambda *_, i=i: ran.append(i))
    with torch.no_grad():
        _, disps = model.features_and_disps(torch.rand(1, 64, 128, 3), scales)
    heads = [10 + model.decoder.scales.index(s) for s in scales]
    assert sorted(ran) == list(range(runs)) + sorted(heads)
    assert set(disps) == {("disp", s) for s in scales}


def test_init_monodepth2_carries_dtype_and_fold():
    """`init_monodepth2(dtype=, fold_bn=)` draws the same float32 weights
    from the same seed and computes in bf16 with BatchNorm folded: its
    eval disp0 (float32, from the float32 sigmoid) lies 1.1e-3 relative
    L2 from the float32 model's (measured), held within 5e-3 and above
    1e-4 (a float32 path would lie ~1e-7 from it)."""
    from depthmodelhardening_tpu_torch.models.wrappers import init_monodepth2

    ref = init_monodepth2(torch.Generator().manual_seed(5)).eval()
    model = init_monodepth2(torch.Generator().manual_seed(5),
                            dtype="bfloat16", fold_bn=True).eval()
    assert model.dtype == torch.bfloat16 and model.fold_bn
    want_sd = ref.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    x = torch.from_numpy(np.random.default_rng(5).random((2, 64, 128, 3),
                                                         np.float32))
    with torch.no_grad():
        got, want = model(x), ref(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert 1e-4 < _rl2(got, want) < 5e-3


@pytest.fixture(scope="module")
def bench_step(weights, student_weights, scene):
    """One JAX distillation step in bench.py's configuration (bf16
    student, bf16 folded teacher, bf16 view, the cropped objective,
    PGD-2), from the jitted parts of `DistillTrainer._step`; and the
    float32 gradient of the same loss on the same composites."""
    import optax

    from depthmodelhardening_tpu.training.distill import DistillState

    tr = _jax_trainer(weights, student_weights, scene, **BENCH)
    tr32 = _jax_trainer(weights, student_weights, scene,
                        **dict(BENCH, compute_dtype="float32"))

    def value_and_grad(model):
        def loss_fn(params, batch_stats, adv, disp_gt):
            pred, mut = model.apply(
                {"params": params, "batch_stats": batch_stats}, adv,
                train=True, mutable=["batch_stats"])
            return jnp.mean((disp_gt - pred) ** 2), mut["batch_stats"]
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    state = tr.make_state()
    key = jax.random.PRNGKey(21)
    adv, ben, _, _ = tr.attack(tr.student_variables(state),
                               jnp.asarray(scene["scenes"]), B, key,
                               eval_mode=False)
    disp_gt = jax.jit(tr.teacher.apply_fn)(tr.teacher.variables, ben)
    (loss, new_bs), grads = value_and_grad(tr.model_d0)(
        state.params, state.batch_stats, adv, disp_gt)
    (loss32, _), grads32 = value_and_grad(tr32.model_d0)(
        state.params, state.batch_stats, adv, disp_gt)
    updates, new_opt = tr.tx.update(grads, state.opt_state, state.params)
    after = DistillState(params=optax.apply_updates(state.params, updates),
                         batch_stats=new_bs, opt_state=new_opt,
                         step=state.step + 1)
    np_tree = lambda t: jax.tree_util.tree_map(np.array, t)
    return dict(draws=_draws(tr.attack, key, 2), adv=_f32(adv), ben=_f32(ben),
                disp_gt=_f32(disp_gt), loss=float(loss), loss32=float(loss32),
                grads=np_tree(grads), grads32=np_tree(grads32),
                after=np_tree(after))


@pytest.mark.parametrize("mode", ["half", "whole"])
def test_bench_config_step_matches_jax(weights, student_weights, scene,
                                       bench_step, mode):
    """The distillation step in bench.py's configuration against JAX's:
    "half" on JAX's own composites, "whole" the port's train_step under
    JAX's draws. bf16 backward passes are noisy (JAX's own bf16 gradient
    lies 0.10 overall, 0.27 per tensor at the median, from its float32
    one; a bias summed over every pixel up to 0.59), so each tensor's
    gradient and Adam first moment is held within 3x its JAX bf16-vs-
    float32 relative L2 plus 0.05 (the worst measured excess is -0.012),
    all of them within 0.15 overall (0.092 and 0.095 measured), Adam's
    second moment within 0.12 overall (0.065). That per-tensor bound
    passes 1 where the noise passes 0.32, so each tensor is also held
    against JAX's float32 gradient (and 0.1 of it, Adam's first moment
    after one step) within min(1.5x the noise + 0.05, 0.6): a zeroed,
    sign-flipped or doubled tensor lies 1 or more from it. Measured:
    0.50 at worst (a layer1 BatchNorm bias, noise 0.41), the worst
    excess over the bound -0.050. The decoder's bias gradients lie 7e-4
    from float32 (the port sums the bf16 cotangent in float32), while
    JAX's bf16 ones are 0.41 of its float32 ones in the same direction
    (1.45 from the port: a bf16 sum that stalls, as it seems). The loss within 1e-3
    relative on JAX's composites (1.6e-4 measured) and 5e-3 after the
    port's own attack (1.9e-3), and nearer JAX's bf16 loss than half its
    distance to the float32 one (0.08 of it measured)."""
    from depthmodelhardening_tpu_torch.models.convert import (
        from_jax_distill_state,
    )

    tr = _port_trainer(weights, student_weights, scene, **BENCH)
    np.testing.assert_allclose(
        tr.teacher_disp(torch.from_numpy(bench_step["ben"])).numpy(),
        bench_step["disp_gt"], atol=BF16_MAX)
    state = tr.make_state()
    assert state.model.dtype == torch.bfloat16
    if mode == "half":
        state, m = tr.distill_step(state, torch.from_numpy(bench_step["adv"]),
                                   torch.from_numpy(bench_step["ben"]))
    else:
        state, m = tr.train_step(state, torch.from_numpy(scene["scenes"]),
                                 draws=bench_step["draws"])
    loss, want = float(m["loss"]), bench_step["loss"]
    assert loss == pytest.approx(want, rel=STEP_LOSS_RTOL[mode])
    if mode == "half":
        assert abs(loss - want) < 0.5 * abs(want - bench_step["loss32"])

    want_g = from_jax_variables({"params": bench_step["grads"]})
    want_32 = from_jax_variables({"params": bench_step["grads32"]})
    adam = from_jax_distill_state(bench_step["after"])["adam"]
    params = {n: p for n, p in state.model.named_parameters()
              if p.grad is not None}
    assert len(params) == len(list(state.model.parameters())) - 6
    assert all(p.dtype == torch.float32 for p in params.values())
    opt = state.optimizer.state
    noise = {n: _rl2(want_g[n], want_32[n]) for n in params}
    for what, got, ref, ref32 in (
            ("gradient", {n: p.grad for n, p in params.items()}, want_g,
             want_32),
            ("exp_avg", {n: opt[p]["exp_avg"] for n, p in params.items()},
             {n: adam[n]["exp_avg"] for n in params},
             {n: 0.1 * want_32[n] for n in params})):
        for n in params:
            err = _rl2(got[n], ref[n])
            assert err <= NOISE_X * noise[n] + NOISE_ATOL, (what, n, err,
                                                            noise[n])
            err32 = _rl2(got[n], ref32[n])
            assert err32 <= min(F32_X * noise[n] + F32_ATOL, F32_CAP), (
                what, n, err32, noise[n])
        allg = lambda d: np.concatenate([d[n].numpy().ravel()
                                         for n in params])
        assert _rl2(allg(got), allg(ref)) <= STEP_L2_ALL, what
    nu = lambda d: np.concatenate([d[n].numpy().ravel() for n in params])
    assert _rl2(nu({n: opt[p]["exp_avg_sq"] for n, p in params.items()}),
                nu({n: adam[n]["exp_avg_sq"] for n in params})) \
        <= STEP_NU_L2_ALL


def images_like(scene):
    """The scenes at the model's resolution."""
    return bilinear_resize(torch.from_numpy(scene["scenes"]), H, W).numpy()


def test_fold_follows_adam_steps(weights, student_weights, scene):
    """The attack's folded bf16 view reads the student's weights and
    statistics as they are at each call: after an Adam step its output
    is the folded forward of the new weights, bit for bit, and not the
    old one."""
    from depthmodelhardening_tpu_torch.models.wrappers import DepthPredictor

    tr = _port_trainer(weights, student_weights, scene, **BENCH)
    state = tr.make_state()
    view = tr.attack_student(state).predictor
    x = torch.from_numpy(images_like(scene))

    def frozen_fold(model):
        twin = make_monodepth2(dtype="bfloat16", fold_bn=True)
        twin.load_state_dict(model.state_dict())
        return DepthPredictor(twin)(x)

    with torch.no_grad():
        before = view(x)
        assert torch.equal(before, frozen_fold(state.model))
    adv = torch.from_numpy(images_like(scene))
    tr.distill_step(state, adv, adv)
    with torch.no_grad():
        after = view(x)
    assert torch.equal(after, frozen_fold(state.model))
    assert not torch.equal(after, before)
    assert state.model.training



# -- the CLI's bf16 hardening step ------------------------------------------
HARDEN_H, HARDEN_W, HARDEN_B = 64, 192, 4  # tests/test_torch_hardening.py's


@pytest.fixture(scope="module")
def harden_bf16_step(weights, student_weights):
    """One port `train_step` of the CLI's `train-hardening --fine-tune`
    configuration in bf16 (bf16 student, float32 teacher, frames ("0",
    "s"), L0 with one step, supervised + photometric; the contrastive
    branch off, see the test) at the hardening tests' sizes, on its own
    draws with JAX's automask noise; JAX's bf16 and float32 `_losses`
    gradients on the batch it built."""
    from depthmodelhardening_tpu.models.wrappers import (
        predictor_from as j_predictor_from,
    )
    from depthmodelhardening_tpu.training import config as jc
    from depthmodelhardening_tpu.training.hardening import (
        HardeningTrainer as JHardeningTrainer,
    )
    from depthmodelhardening_tpu_torch.data.synthetic import make_car_object
    from depthmodelhardening_tpu_torch.models.convert import (
        from_jax_hardening_state,
    )
    from depthmodelhardening_tpu_torch.models.wrappers import predictor_from
    from depthmodelhardening_tpu_torch.training import config as tc
    from depthmodelhardening_tpu_torch.training.hardening import (
        HardeningTrainer,
    )

    ori_h, ori_w = 96, 320
    obj, mask = make_car_object(36, 24, seed=3)
    kw = lambda m: dict(
        selfsup=m.SelfSupConfig(height=HARDEN_H, width=HARDEN_W),
        adv=m.AdvSynthConfig(norm_type="l_0", steps=1, attack_batch_size=2,
                             ori_h=ori_h, ori_w=ori_w),
        batch_size=HARDEN_B, contrastive_learning=False)
    teacher = j_predictor_from(j_make_monodepth2(), weights["jv"])
    trs = {dt: JHardeningTrainer(
        jc.HardeningConfig(compute_dtype=dt, **kw(jc)), jax.random.PRNGKey(0),
        obj, mask, teacher=teacher, steps_per_epoch=10,
        init_variables={"depth": student_weights["jv"]})
        for dt in ("bfloat16", "float32")}
    state = trs["bfloat16"].make_state()

    t_model = make_monodepth2()
    t_model.load_state_dict(weights["sd"])
    port = HardeningTrainer(
        tc.HardeningConfig(compute_dtype="bfloat16", **kw(tc)),
        torch.Generator().manual_seed(0), obj, mask,
        predictor_from(t_model), device="cpu", steps_per_epoch=10)
    p_state = port.make_state(resume=from_jax_hardening_state(
        jax.tree_util.tree_map(np.array, state)))
    f0 = make_scene(HARDEN_B, ori_h, ori_w, seed=1)
    frames = {"0": torch.from_numpy(f0),
              "s": torch.from_numpy(np.roll(f0, 6, axis=2))}
    k_loss = jax.random.PRNGKey(7)
    draws = port.draw(HARDEN_B, torch.Generator().manual_seed(8))
    draws.identity_noise = torch.from_numpy(np.array(jax.random.normal(
        k_loss, (HARDEN_B, HARDEN_H, HARDEN_W, 1))))
    batches = []
    update = port._update
    port._update = lambda s, batch, n: (batches.append(batch),
                                        update(s, batch, n))[1]
    p_state, metrics = port.train_step(
        p_state, frames, torch.tensor([True, False, False, True]),
        torch.tensor([False, True, False, True]),
        torch.from_numpy(make_scene(1, ori_h, ori_w, seed=2)), draws=draws)
    batch = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                   batches[0])
    out = {}
    for dt, tr in trs.items():
        grads, (_, m) = jax.jit(jax.grad(tr._losses, has_aux=True))(
            state.params, state.batch_stats, batch, k_loss)
        out[dt] = (from_jax_variables({"params": jax.tree_util.tree_map(
            np.array, grads["depth"])}), {k: float(v) for k, v in m.items()})
    return dict(state=p_state, metrics=metrics, jax=out)


def test_bf16_hardening_step_matches_jax(harden_bf16_step):
    """The CLI's bf16 hardening step against JAX's bf16 `_losses` on the
    port's batch, under the bench step's rule
    (`test_bench_config_step_matches_jax`): each student tensor's gradient
    within NOISE_X times its JAX bf16-vs-float32 relative L2 (its noise)
    plus NOISE_ATOL of JAX's bf16 gradient, and within min(F32_X times
    the noise + F32_ATOL, F32_CAP) of JAX's float32 one (a zeroed or
    sign-flipped tensor lies 1 or more from it); all of them within
    STEP_L2_ALL of JAX's bf16 overall. Two cases the bench step's
    distillation loss did not meet, each with the bound a fault would
    still fail:
    - where the port lies nearer JAX's float32 gradient than JAX's bf16
      one does (err32 <= noise), the first bound is not asked: JAX sums
      the bias gradients in bf16 and stalls (dispconv_1's bias: the port
      0.28 from float32, JAX's bf16 0.73 from it and 3.7 from the port,
      relative to its smaller norm), as the bench step's docstring found;
    - where JAX's own noise reaches F32_CAP, a tensor is held no farther
      from float32 than JAX's bf16 (err32 <= noise) in place of the cap:
      the scale-2 and scale-3 heads (dispconv_2, _3), whose gradients are
      1-2% of the largest tensor's and cancel, lie 1.22 and 1.39 (weights)
      from float32 in JAX's bf16, 0.92 and 0.87 in the port's; there no
      rule tells a fault from bf16's rounding.
    Measured: overall 0.118 from JAX's bf16 (whose own distance to
    float32 is 0.120).

    Each loss term within STEP_LOSS_RTOL["whole"] of JAX's bf16 one
    (sup 1.6e-3, photometric 1.4e-4 measured; JAX's bf16 sup loss lies
    3.6e-3 from its float32 one). The student is bf16, its parameters
    float32.

    The contrastive branch is off here: at batch 4 SimSiam's BatchNorm1d
    over four samples turns bf16's rounding of the deep features into
    its whole gradient (JAX's own bf16 gradient lies 1.06 overall from
    its float32 one with the branch on, 0.36 at batch 8), so no rule can
    tell a fault from the noise; the branch is in float32 either way
    (the head casts the features, as JAX's does), and
    `chip_smoke.py` phase 12 runs the full CLI configuration at batch
    32."""
    st = harden_bf16_step
    state = st["state"]
    assert state.model.dtype == torch.bfloat16
    (g16, m16), (g32, _) = st["jax"]["bfloat16"], st["jax"]["float32"]
    got_m = {k: float(v) for k, v in st["metrics"].items()}
    assert set(got_m) == set(m16) == {"sup_loss", "selfsup_loss", "loss"}
    for k in got_m:
        assert got_m[k] == pytest.approx(m16[k], rel=STEP_LOSS_RTOL["whole"])
    params = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    got = {n: p.grad for n, p in params.items() if p.grad is not None}
    assert len(got) == len(params)
    for n in got:
        noise = _rl2(g16[n], g32[n])
        err, err32 = _rl2(got[n], g16[n]), _rl2(got[n], g32[n])
        assert err <= NOISE_X * noise + NOISE_ATOL or err32 <= noise, (
            n, err, err32, noise)
        if noise < F32_CAP:
            assert err32 <= min(F32_X * noise + F32_ATOL, F32_CAP), (
                n, err32, noise)
        else:
            assert err32 <= noise, (n, err32, noise)
    allg = lambda d: np.concatenate([d[n].numpy().ravel() for n in got])
    assert _rl2(allg(got), allg(g16)) <= STEP_L2_ALL
