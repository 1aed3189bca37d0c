"""The port's stem max pool (3x3 / stride 2 / pad 1) against the JAX
package.

* tie-free inputs: forward and VJP against flax `nn.max_pool` (the pool
  of `models/resnet.py:406`), exactly;
* inputs with ties (relu zeros): the port's equality-routed backward
  against the TPU kernel B2 (`ops/pallas_pool.py:_bwd_kernel`) in
  interpret mode, on the JAX package's width-packed layout;
* relu -> pool: the same input gradient either way, because relu's
  backward zeroes the cotangent of every tied zero.

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
