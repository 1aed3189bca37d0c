"""The port's stem max pool (3x3 / stride 2 / pad 1) against the JAX
package.

* tie-free inputs: forward and VJP against flax `nn.max_pool` (the pool
  of `models/resnet.py:406`), exactly;
* inputs with ties (relu zeros): the port's equality-routed backward
  against the TPU kernel B2 (`ops/pallas_pool.py:_bwd_kernel`) in
  interpret mode, on the JAX package's width-packed layout;
* relu -> pool: the same input gradient either way, because relu's
  backward zeroes the cotangent of every tied zero;
* the bf16 kernels' decompositions (`maxpool3x3s2_separable_plain`,
  `maxpool3x3s2_backward_strips_plain`) against the plain versions, bit
  for bit, in float32 and bf16 at ragged shapes.

Cotangents are small integers so that every sum of window
contributions is exact in float32 in any order: the comparisons are
exact (atol 0).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import depthmodelhardening_tpu.ops.pallas_pool as pp
from depthmodelhardening_tpu.ops.wpack_decoder import wpack, wunpack
from depthmodelhardening_tpu_torch.ops import pool
from depthmodelhardening_tpu_torch.ops.pool import (
    maxpool3x3s2, maxpool3x3s2_backward_plain, maxpool3x3s2_plain,
)


def _interp(fn, *args):
    """Run fn with every pallas_call in interpret mode (as
    tests/test_pallas_pool.py does)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _flax_pool(x_nhwc):
    return nn.max_pool(x_nhwc, (3, 3), strides=(2, 2),
                       padding=((1, 1), (1, 1)))


def _int_cotangent(rng, shape):
    return rng.randint(-4, 5, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 3, 16, 20), (1, 4, 15, 17),
                                   (2, 2, 2, 3)])
def test_pool_matches_flax_on_tie_free_inputs(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)  # continuous: no ties
    x_nhwc = np.transpose(x, (0, 2, 3, 1))
    y_j, vjp = jax.vjp(_flax_pool, jnp.asarray(x_nhwc))
    g = _int_cotangent(rng, np.asarray(y_j).shape)
    (gx_j,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = maxpool3x3s2(xt)
    (gx_t,) = torch.autograd.grad(
        y_t, xt, torch.from_numpy(np.transpose(g, (0, 3, 1, 2)).copy()))

    np.testing.assert_array_equal(
        y_t.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y_j))
    np.testing.assert_array_equal(gx_t.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(gx_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_backward_matches_tpu_kernel_on_ties(seed):
    """relu outputs tie at 0 all over; B2 and the port both give every
    tied maximum the full cotangent."""
    B, C, H, W = 2, 4, 32, 64  # B2 needs H/2 % 8 == 0 and W/4 % 8 == 0
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(B, C, H, W), 0).astype(np.float32)
    x[:, :, ::5, ::3] = 0.5  # ties between positive values too
    g = _int_cotangent(rng, (B, C, H // 2, W // 2))

    xp4 = wpack(jnp.asarray(x.transpose(0, 2, 3, 1)), 4)
    gp2 = wpack(jnp.asarray(g.transpose(0, 2, 3, 1)), 2)

    def b2():
        y, vjp = jax.vjp(lambda t: pp.wpack4_maxpool3x3s2_pallas(t, C), xp4)
        return y, vjp(gp2)[0]

    y_j, gx_j = _interp(b2)
    y_j = np.asarray(wunpack(y_j, 2)).transpose(0, 3, 1, 2)
    gx_j = np.asarray(wunpack(gx_j, 4)).transpose(0, 3, 1, 2)

    xt = torch.from_numpy(x)
    y_t = maxpool3x3s2_plain(xt)
    gx_t = maxpool3x3s2_backward_plain(xt, torch.from_numpy(g))
    assert (gx_t.numpy() != 0).sum() > (y_t.numel() // 2)
    np.testing.assert_array_equal(y_t.numpy(), y_j)
    np.testing.assert_array_equal(gx_t.numpy(), gx_j)


def test_relu_pool_input_gradient_matches_flax():
    """Behind a relu the tie rule cannot show: flax autodiff (one
    winner per window) and the port (every tied input) give the same
    input gradient."""
    rng = np.random.RandomState(5)
    pre = rng.randn(2, 3, 18, 22).astype(np.float32)
    pre_nhwc = jnp.asarray(pre.transpose(0, 2, 3, 1))
    y_j, vjp = jax.vjp(lambda t: _flax_pool(jax.nn.relu(t)), pre_nhwc)
    g = _int_cotangent(rng, np.asarray(y_j).shape)
    (gx_j,) = vjp(jnp.asarray(g))

    pt = torch.from_numpy(pre).requires_grad_(True)
    y_t = maxpool3x3s2(torch.relu(pt))
    (gx_t,) = torch.autograd.grad(
        y_t, pt, torch.from_numpy(np.transpose(g, (0, 3, 1, 2)).copy()))
    assert (np.asarray(y_j) == 0).any()  # windows of tied zeros exist
    np.testing.assert_array_equal(gx_t.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(gx_j))


# -- the bf16 kernels' decompositions ----------------------------------------
SIZES = (1, 2, 3, 17, 23, 66, 67, 130, 160)


def _relu_with_ties(rng, shape, dtype):
    """relu outputs (ties at 0) with ties between positive values too."""
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    x.reshape(-1)[::7] = 0.5
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", SIZES)
def test_separable_forward_equals_plain(h, dtype):
    """B1-bf16's decomposition (a column max over each window's 3 rows,
    then a max of 3 columns at stride 2) is the plain forward, bit for
    bit, at H = h and every W of SIZES."""
    rng = np.random.RandomState(h)
    for w in SIZES:
        x = _relu_with_ties(rng, (2, 3, h, w), dtype)
        got = pool.maxpool3x3s2_separable_plain(x)
        assert got.dtype == dtype
        assert torch.equal(got, maxpool3x3s2_plain(x)), (h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", SIZES)
def test_strips_backward_equals_plain(h, dtype):
    """B2-bf16's decomposition (strips of POOL_BWD_STRIP windows, each
    window's max from the strip's slab, cotangent 0 outside the map, the
    float32 sum in the kernel's order, rounded once) is the plain
    backward, bit for bit, at H = h and every W of SIZES."""
    rng = np.random.RandomState(100 + h)
    for w in SIZES:
        x = _relu_with_ties(rng, (2, 3, h, w), dtype)
        g = torch.from_numpy(rng.randn(2, 3, pool.pooled_size(h),
                                       pool.pooled_size(w)).astype(
            np.float32)).to(dtype)
        got = pool.maxpool3x3s2_backward_strips_plain(x, g)
        assert got.dtype == dtype
        assert torch.equal(got, maxpool3x3s2_backward_plain(x, g)), (h, w)


@pytest.mark.parametrize("strip", [(2, 4), (1, 4), (2, 8), (1, 16), (16, 16),
                                   (3, 12)])
def test_strips_backward_does_not_depend_on_the_strip(strip):
    """The strips kernel_variants.py B sweeps (1 or 2 window rows of 4, 8,
    12 or 16 windows a thread) and others give the same bits: a strip
    changes which thread routes an input, not its sum."""
    rng = np.random.RandomState(7)
    for h, w in ((66, 130), (67, 23), (160, 160), (3, 17)):
        x = _relu_with_ties(rng, (1, 2, h, w), torch.bfloat16)
        g = torch.from_numpy(rng.randn(1, 2, pool.pooled_size(h),
                                       pool.pooled_size(w)).astype(
            np.float32)).bfloat16()
        assert torch.equal(pool.maxpool3x3s2_backward_strips_plain(x, g,
                                                                  strip),
                           maxpool3x3s2_backward_plain(x, g)), (h, w)


def _backward_rows_swapped(x, g):
    """`maxpool3x3s2_backward_plain` with the two covering window rows
    added in the other order."""
    x, g = x.float(), g.float()
    H, W = x.shape[2:]
    Ho, Wo = g.shape[2:]
    m = maxpool3x3s2_plain(x)
    ylo, yhi, y2 = pool._cover(H, Ho, x.device)
    xlo, xhi, x2 = pool._cover(W, Wo, x.device)
    dx = torch.zeros_like(x)
    for oy, vy in ((yhi, y2), (ylo, None)):
        for ox, vx in ((xlo, None), (xhi, x2)):
            hit = x == m[:, :, oy][:, :, :, ox]
            if vy is not None:
                hit = hit & vy[:, None]
            if vx is not None:
                hit = hit & vx[None, :]
            dx = dx + torch.where(hit, g[:, :, oy][:, :, :, ox], 0.0)
    return dx.bfloat16()


def test_strips_backward_keeps_the_sum_order():
    """On sparse inputs (most windows all zero, so an input often ties
    with all four covering windows) and cotangents of +-1 and +-2^25 (1 +
    2^25 rounds to 2^25 in float32, so a sum of four absorbs or cancels
    by its order), the order shows in the bits: the decomposition
    matches the plain version, and the same sum with the window rows
    swapped does not."""
    rng = np.random.RandomState(11)
    x = torch.relu(torch.from_numpy(rng.randn(2, 3, 66, 130).astype(
        np.float32)) - 1.5).bfloat16()
    g = torch.from_numpy((rng.choice([-1.0, 1.0], (2, 3, 33, 65)) * np.exp2(
        25.0 * rng.randint(0, 2, (2, 3, 33, 65)))).astype(
        np.float32)).bfloat16()
    want = maxpool3x3s2_backward_plain(x, g)
    assert torch.equal(pool.maxpool3x3s2_backward_strips_plain(x, g), want)
    assert not torch.equal(_backward_rows_swapped(x, g), want)


# -- NaN ---------------------------------------------------------------------
def _with_nans(rng, B, C, H, W):
    """relu outputs with ties, and NaN in three places of each plane: inside
    a window (an even row and column, covered by one window), on a
    window's edge (an odd row and column, covered by four windows), and a
    whole 3x3 window (rows and columns 2 oy - 1 .. 2 oy + 1)."""
    x = _relu_with_ties(rng, (B, C, H, W), torch.float32).numpy().copy()
    x[:, :, 4, 6] = np.nan
    x[:, :, 9, 13] = np.nan
    x[:, :, 15:18, 21:24] = np.nan  # window (8, 11), all NaN
    return x


def test_pool_keeps_nan_as_the_tpu_kernel_does():
    """NaN inside a window, on a window's edge and filling a window: the
    plain forward and backward and both decompositions against the TPU
    kernels B1 and B2 in interpret mode, bit for bit (NaN where theirs
    is NaN): each window that holds a NaN pools to NaN and routes its
    cotangent nowhere."""
    B, C, H, W = 2, 4, 32, 64  # B2 needs H/2 % 8 == 0 and W/4 % 8 == 0
    rng = np.random.RandomState(21)
    x = _with_nans(rng, B, C, H, W)
    g = _int_cotangent(rng, (B, C, H // 2, W // 2))
    xp4 = wpack(jnp.asarray(x.transpose(0, 2, 3, 1)), 4)
    gp2 = wpack(jnp.asarray(g.transpose(0, 2, 3, 1)), 2)

    def b2():
        y, vjp = jax.vjp(lambda t: pp.wpack4_maxpool3x3s2_pallas(t, C), xp4)
        return y, vjp(gp2)[0]

    y_j, gx_j = _interp(b2)
    y_j = np.asarray(wunpack(y_j, 2)).transpose(0, 3, 1, 2)
    gx_j = np.asarray(wunpack(gx_j, 4)).transpose(0, 3, 1, 2)
    assert np.isnan(y_j[:, :, 8, 11]).all()
    # a plane's NaN windows: 1 (inside), 4 (edge), 3 x 3 (the NaN window
    # and its neighbours, which share its border rows and columns)
    assert np.isnan(y_j).sum() == B * C * (1 + 4 + 9)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    for name, got in (("plain", maxpool3x3s2_plain(xt)),
                      ("separable", pool.maxpool3x3s2_separable_plain(xt))):
        np.testing.assert_array_equal(got.numpy(), y_j, err_msg=name)
    for name, got in (
            ("plain", maxpool3x3s2_backward_plain(xt, gt)),
            ("strips", pool.maxpool3x3s2_backward_strips_plain(xt, gt))):
        np.testing.assert_array_equal(got.numpy(), gx_j, err_msg=name)
    assert not np.isnan(gx_j).any()
    assert (gx_j[:, :, 14:19, 20:25] == 0).all()  # the NaN window's rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_decompositions_keep_nan(dtype):
    """At ragged shapes, in float32 and bf16: the decompositions equal the
    plain versions with NaN inside, on the edge of and filling a window
    (NaN where theirs is NaN, every other element bit for bit)."""
    rng = np.random.RandomState(22)
    for h, w in ((23, 67), (24, 26), (66, 130)):
        x = torch.from_numpy(_with_nans(rng, 2, 3, h, w)).to(dtype)
        g = torch.from_numpy(rng.randn(2, 3, pool.pooled_size(h),
                                       pool.pooled_size(w)).astype(
            np.float32)).to(dtype)
        y = maxpool3x3s2_plain(x)
        assert torch.isnan(y).any()
        np.testing.assert_array_equal(
            pool.maxpool3x3s2_separable_plain(x).float().numpy(),
            y.float().numpy(), err_msg=str((h, w)))
        dx = maxpool3x3s2_backward_plain(x, g)
        assert not torch.isnan(dx).any()
        np.testing.assert_array_equal(
            pool.maxpool3x3s2_backward_strips_plain(x, g).float().numpy(),
            dx.float().numpy(), err_msg=str((h, w)))
