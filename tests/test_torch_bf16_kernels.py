"""The bf16 tests of the BatchNorm fold, the bf16 model and kernels D's
and B's bf16 plain versions against the JAX package, the decoder's
early stop and `init_monodepth2`'s dtype and fold. Weights, inputs and
tolerances: tests/bf16_common.py's docstring and each test's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import depthmodelhardening_tpu.ops.pallas_conv as pc
import depthmodelhardening_tpu.ops.pallas_pool as pp
from depthmodelhardening_tpu.ops.padding import conv3x3_reflect_same
from depthmodelhardening_tpu.ops.wpack_decoder import wpack, wunpack
from depthmodelhardening_tpu_torch.ops import conv, pool

from bf16_common import (
    B, BF16_F32_L2, BF16_FLOOR, BF16_L2, BF16_MAX, FOLD_ATOL, _interp,
    _jax_disps, _port_disps, _rl2, _ulp, images, jax_f32, weights,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


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
