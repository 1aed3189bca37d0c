"""The ops the port replaced so that its steps repeat bit for bit on the
card: the reflect pad's backward (`ops/padding.py:ReflectPad1`, whose
backward is `reflect_pad1_adjoint`, replacing F.pad's atomic adds) and
the bilinear resize's (`ops/resize.py:BilinearResize`, replacing
F.interpolate's). CUDA tensors take them; CPU tensors take PyTorch's own
backward, which sums in one order there. Each forward is the PyTorch op
it replaces, bit for bit; each backward equals autograd's up to float32
summation order (in bf16 within one bf16 ulp of autograd's float32
gradient, rounded), and the pad's equals the JAX package's VJP
(`padding.py:_bwd`, which fixes the order) bit for bit. Small shapes, H
or W in {1, 2, 3} among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depthmodelhardening_tpu.ops.padding import reflect_pad1 as j_reflect_pad1
from depthmodelhardening_tpu.ops.resize import (
    bilinear_resize as j_bilinear_resize,
)
from depthmodelhardening_tpu_torch.ops.padding import (
    ReflectPad1, reflect_pad1,
)
from depthmodelhardening_tpu_torch.ops.resize import (
    BilinearResize, bilinear_resize,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PAD_HW = ((1, 1), (1, 5), (2, 2), (3, 1), (2, 3), (3, 7), (17, 24))
RESIZES = (((1, 1), (2, 3)), ((2, 3), (3, 1)), ((3, 2), (5, 7)),
           ((1, 5), (4, 5)), ((40, 128), (320, 1024)),
           ((375, 1242), (96, 320)))


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    return x


def _pad(t):
    return ReflectPad1.apply(t)


def _resize(dst):
    return lambda t: BilinearResize.apply(
        t.permute(0, 3, 1, 2), *dst).permute(0, 2, 3, 1)


def _grad(fn, x, g):
    x = x.clone().requires_grad_(True)
    (d,) = torch.autograd.grad(fn(x), x, g)
    return d


def _within_one_bf16_ulp(got, want):
    """|got - want| at most one bf16 ulp of the larger magnitude."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((got - want).abs() <= ulp).all())


def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        return _within_one_bf16_ulp(got, want)
    scale = float(want.abs().max())
    return bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6 * scale))


@pytest.mark.parametrize("hw", PAD_HW)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reflect_pad1_forward_is_f_pad(hw, dtype):
    """F.pad's reflect mode where it applies (H, W >= 2), numpy's reflect
    (a size-1 axis is its own reflection) elsewhere."""
    x = _inputs((2, 3) + hw, DTYPES[dtype][0], 1)
    got = _pad(x.clone().requires_grad_(True)).detach()
    assert torch.equal(got, reflect_pad1(x))
    if min(hw) >= 2:
        assert torch.equal(got, F.pad(x, (1, 1, 1, 1), mode="reflect"))
    want = np.pad(x.float().numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)),
                  mode="reflect")
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("hw", PAD_HW)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reflect_pad1_backward_equals_jax(hw, dtype):
    """The pad's adjoint sums in the JAX package's order in float32:
    bit-equal to its custom VJP in float32, and in bf16 to that VJP of
    the cotangent in float32 rounded once to bf16 (JAX's bf16 VJP rounds
    after each add, where the port rounds once)."""
    t_dtype = DTYPES[dtype][0]
    x = _inputs((2, 3) + hw, t_dtype, 2)
    g = _inputs((2, 3, hw[0] + 2, hw[1] + 2), t_dtype, 3)
    got = _grad(_pad, x, g)
    nhwc = lambda t: jnp.asarray(t.float().numpy().transpose(0, 2, 3, 1))
    _, vjp = jax.vjp(j_reflect_pad1, nhwc(x))
    (want,) = vjp(nhwc(g))
    want = torch.from_numpy(np.asarray(want).transpose(0, 3, 1, 2).copy())
    assert torch.equal(got, want.to(t_dtype))


@pytest.mark.parametrize("hw", [hw for hw in PAD_HW if min(hw) >= 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reflect_pad1_backward_matches_autograd(hw, dtype):
    """Against autograd of F.pad's reflect mode: float32 summation order
    (the corners' diagonal neighbours take four addends); in bf16 within
    one bf16 ulp of autograd's float32 gradient rounded to bf16 (autograd
    in bf16 rounds after each addend, up to two ulps from it)."""
    t_dtype = DTYPES[dtype][0]
    x = _inputs((2, 3) + hw, t_dtype, 4)
    g = _inputs((2, 3, hw[0] + 2, hw[1] + 2), t_dtype, 5)
    got = _grad(_pad, x, g)
    f_pad = lambda t: F.pad(t, (1, 1, 1, 1), mode="reflect")
    want = _grad(f_pad, x.float(), g.float()).to(t_dtype)
    assert got.dtype == t_dtype
    assert _close(got, want, t_dtype)
    # a CPU tensor takes F.pad's own backward
    assert torch.equal(_grad(reflect_pad1, x, g), _grad(f_pad, x, g))


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bilinear_resize_forward_is_interpolate(src, dst, dtype):
    """The resize's autograd Function's forward is F.interpolate's, bit
    for bit, as is `bilinear_resize`'s."""
    x = _inputs((2,) + src + (3,), DTYPES[dtype][0], 6)
    got = _resize(dst)(x.clone().requires_grad_(True)).detach()
    want = F.interpolate(x.permute(0, 3, 1, 2), size=dst, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert torch.equal(bilinear_resize(x, *dst), x if src == dst else want)


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bilinear_resize_backward_matches_autograd(src, dst, dtype):
    """R_h^T g R_w against autograd of F.interpolate: float32 summation
    order; in bf16 (computed in float32, rounded once) within one bf16
    ulp of autograd's float32 gradient of the same input rounded to
    bf16."""
    t_dtype = DTYPES[dtype][0]
    x = _inputs((2,) + src + (3,), t_dtype, 7)
    g = _inputs((2,) + dst + (3,), t_dtype, 8)
    got = _grad(_resize(dst), x, g)
    resize = lambda t: F.interpolate(
        t.permute(0, 3, 1, 2), size=dst, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    want = _grad(resize, x.float(), g.float()).to(t_dtype)
    assert got.dtype == t_dtype
    assert _close(got, want, t_dtype)
    # a CPU tensor takes F.interpolate's own backward
    if src != dst:
        assert torch.equal(_grad(lambda t: bilinear_resize(t, *dst), x, g),
                           _grad(resize, x, g))


@pytest.mark.parametrize("src,dst", RESIZES[2:])
def test_bilinear_resize_backward_matches_jax(src, dst):
    """The JAX package's resize is R_h x R_w^T with float64-made weights,
    its VJP R_h^T g R_w: the port's gradient within the weights' float32
    rounding (`test_torch_ops.py:test_bilinear_resize_matches_jax`'s
    atol 1e-4, times the largest |g|)."""
    x = _inputs((2,) + src + (3,), torch.float32, 9)
    g = _inputs((2,) + dst + (3,), torch.float32, 10)
    got = _grad(_resize(dst), x, g)
    _, vjp = jax.vjp(lambda t: j_bilinear_resize(t, *dst),
                     jnp.asarray(x.numpy()))
    (want,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * float(g.abs().max()))
