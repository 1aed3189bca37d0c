"""Kernel D's plain versions and autograd against the JAX package.

The port's `ops/conv.py` on CPU tensors (the plain versions the CUDA
kernels are held to on the card) against `depthmodelhardening_tpu/ops/
pallas_conv.py`'s Pallas kernel run in interpret mode, as
tests/test_pallas_conv.py runs it, and against its XLA reference; the
prototypes P1 and P2 of `scripts/bench_pallas_conv2.py` in interpret mode
too. Inputs are made with jax.random at the JAX tests' scales and handed
over as numpy. Tolerances are those of tests/test_pallas_conv.py:
forward 3e-6, input gradient 1e-5, weight gradient 1e-4 (float32 sums
of 72-144 products in another order).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from jax.experimental import pallas as pl

import depthmodelhardening_tpu.ops.pallas_conv as pc
from depthmodelhardening_tpu.ops.padding import conv3x3_reflect_same
from depthmodelhardening_tpu_torch.ops import conv
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_ATOL, DX_ATOL, DW_ATOL = 3e-6, 1e-5, 1e-4
CONV_RTOL = 1e-5  # chip_smoke.py's hold on kernel D: of the plain max


def _interp(fn, *args):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _hwio(t):
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def _inputs(shape, cin_co, seed=0):
    x = jax.random.uniform(jax.random.PRNGKey(seed), shape)
    k = jax.random.normal(jax.random.PRNGKey(seed + 1), (3, 3) + cin_co) * 0.1
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    return x, k, xp


@pytest.mark.parametrize("shape,cin_co", [((2, 32, 128, 16), (16, 8)),
                                          ((1, 13, 21, 3), (3, 5))])
def test_plain_matches_the_interpreted_kernel(shape, cin_co):
    """The plain forward (and `conv3x3_valid` on the CPU) against kernel
    D interpreted and against its XLA reference."""
    _, k, xp = _inputs(shape, cin_co)
    want = np.asarray(_interp(pc._pallas_conv3x3_valid, xp, k))
    ref = np.asarray(pc._conv3x3_valid_ref(xp, k))
    for got in (conv.conv3x3_valid_plain(_nchw(xp), _oihw(k)),
                conv.conv3x3_valid(_nchw(xp), _oihw(k))):
        np.testing.assert_allclose(_nhwc(got), want, atol=FWD_ATOL)
        np.testing.assert_allclose(_nhwc(got), ref, atol=FWD_ATOL)


def test_gradients_match_jax():
    """Input and weight gradients of `_Conv3x3Valid` (the flipped,
    transposed conv of the 2-padded cotangent; the weight conv) against
    jax.grad of the interpreted `conv3x3_valid`."""
    _, k, xp = _inputs((1, 16, 128, 8), (8, 8))
    g = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 128, 8))
    gx = _interp(jax.grad(lambda a: jnp.sum(pc.conv3x3_valid(a, k) * g)), xp)
    gk = _interp(jax.grad(lambda kk: jnp.sum(pc.conv3x3_valid(xp, kk) * g)),
                 k)

    xp_t = _nchw(xp).requires_grad_(True)
    w_t = _oihw(k).requires_grad_(True)
    out = conv.conv3x3_valid(xp_t, w_t)
    assert type(out.grad_fn).__name__ == "_Conv3x3ValidBackward"
    (out * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xp_t.grad), np.asarray(gx),
                               atol=DX_ATOL)
    np.testing.assert_allclose(_hwio(w_t.grad), np.asarray(gk), atol=DW_ATOL)
    np.testing.assert_allclose(
        _nhwc(conv.conv3x3_dgrad_plain(_nchw(g), _oihw(k))), np.asarray(gx),
        atol=DX_ATOL)


@pytest.mark.parametrize("cin_co", [(16, 16), (16, 1), (32, 16)])
def test_bias_and_elu_epilogue_matches_jax(cin_co):
    """`conv3x3_reflect(x, w, b, elu=True)` (kernel D's fused epilogue,
    the decoder's ConvBlock) and the bias-only head against
    nn.elu(pallas_conv.conv3x3_reflect(x, k, b)): values, and the
    gradients of x, w and b."""
    x, k, _ = _inputs((2, 12, 40) + cin_co[:1], cin_co, seed=3)
    b = jax.random.normal(jax.random.PRNGKey(7), cin_co[1:]) * 0.5
    g = jax.random.normal(jax.random.PRNGKey(8), (2, 12, 40, cin_co[1]))
    for elu in (True, False):
        act = nn.elu if elu else (lambda v: v)

        def f(xx, kk, bb):
            return act(pc.conv3x3_reflect(xx, kk, bb))

        want = f(x, k, b)
        gx, gk, gb = jax.grad(lambda *a: jnp.sum(f(*a) * g),
                              argnums=(0, 1, 2))(x, k, b)
        xt, wt = _nchw(x).requires_grad_(True), _oihw(k).requires_grad_(True)
        bt = torch.from_numpy(np.array(b)).requires_grad_(True)
        out = conv.conv3x3_reflect(xt, wt, bt, elu=elu)
        (out * _nchw(g)).sum().backward()
        np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=1e-5)
        np.testing.assert_allclose(_hwio(wt.grad), np.asarray(gk), atol=1e-4)
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb),
                                   atol=1e-4)


@pytest.mark.parametrize("cin,co,kernel", [(64, 64, True), (16, 1, True),
                                           (1, 16, True), (96, 32, False),
                                           (64, 128, False), (65, 8, False)])
def test_dispatch_by_shape(cin, co, kernel):
    """Kernel D takes a conv with Cin <= 64 and Co <= 64 (pallas_conv.py
    :175), at any map size; any other takes F.conv2d. Both compute the
    same function."""
    assert conv.takes_kernel(cin, co) is kernel
    gen = torch.Generator().manual_seed(cin + co)
    x = torch.rand((1, cin, 5, 7), generator=gen)
    w = torch.randn((co, cin, 3, 3), generator=gen).requires_grad_(True)
    out = conv.conv3x3_reflect(x, w, elu=True)
    name = type(out.grad_fn).__name__
    assert (name == "_Conv3x3ValidBackward") is kernel, name
    want = torch.nn.functional.elu(torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect"), w))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(1, 6), (5, 1), (1, 1), (2, 3)])
def test_size_one_axes_reflect_as_numpy(hw):
    """A size-1 axis is its own reflection (numpy's rule), as JAX's
    `conv3x3_reflect_same`, on both routes of the dispatch. rtol 1e-5:
    the JAX function adds the border as separate correction terms, whose
    rounding grows with the 864 products of a 96-channel tap."""
    for cin, co in ((4, 3), (96, 2)):
        x, k, _ = _inputs((2,) + hw + (cin,), (cin, co), seed=11)
        want = np.asarray(conv3x3_reflect_same(x, k))
        got = conv.conv3x3_reflect(_nchw(x), _oihw(k))
        np.testing.assert_allclose(_nhwc(got), want, atol=FWD_ATOL,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def p1_script():
    """scripts/bench_pallas_conv2.py, imported with the JAX cache
    directory it sets at import put back at once."""
    cache_dir = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module("bench_pallas_conv2")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
        jax.config.update("jax_compilation_cache_dir", cache_dir)


@pytest.mark.parametrize("name", ["conv_pallas", "conv_pallas_whole"])
def test_prototypes_p1_p2_compute_the_same_function(p1_script, name):
    """P1 (one K = 9 Cin dot per row tile) and P2 (the whole image in
    VMEM), interpreted at float32, equal the port's reflect conv."""
    x, k, _ = _inputs((1, 16, 40, 8), (8, 4), seed=5)
    got = _interp(getattr(p1_script, name), x, k)
    want = conv.conv3x3_reflect(_nchw(x), _oihw(k))
    np.testing.assert_allclose(np.asarray(got), _nhwc(want), atol=FWD_ATOL)


def _tf32(t):
    """float32 rounded to TF32 as cvt.rna.tf32.f32 (and kernel D's
    `to_tf32`) rounds: half a TF32 ulp added to the magnitude, the 13 low
    bits dropped (to nearest, ties away from zero)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _conv_tf32(xp, w, three_products: bool):
    """Kernel D's tensor-core arithmetic on the CPU: each operand split
    into big = tf32(a) and small = tf32(a - big), products summed in
    float32 as small*big + big*small + big*big, or big*big alone."""
    xb, wb = _tf32(xp), _tf32(w)
    out = F.conv2d(xb, wb)
    if three_products:
        out = F.conv2d(_tf32(xp - xb), wb) + F.conv2d(xb, _tf32(w - wb)) + out
    return out


@pytest.mark.parametrize("direction", ["fwd", "dgrad"])
@pytest.mark.parametrize("cin,co", [(16, 16), (32, 16), (64, 32)])
def test_3xtf32_split_holds_float32_accuracy(direction, cin, co):
    """Emulated 3xTF32 holds the float64 conv within CONV_RTOL of its
    largest magnitude, at decoder-like channels (relu'd input, the
    decoder's weight scale; the input gradient on the 2-padded cotangent
    with `dgrad_weights`); TF32 alone (big*big) does not, which is why
    kernel D splits."""
    rng = np.random.default_rng(cin + co)
    w = torch.from_numpy((rng.standard_normal((co, cin, 3, 3))
                          / (3.0 * cin ** 0.5)).astype(np.float32))
    if direction == "fwd":
        inp = torch.from_numpy(rng.random((2, cin, 12, 26), np.float32))
    else:
        g = torch.from_numpy(rng.standard_normal((2, co, 10, 24))
                             .astype(np.float32))
        inp, w = F.pad(g, (2, 2, 2, 2)), conv.dgrad_weights(w)
    want = F.conv2d(inp.double(), w.double())
    tol = CONV_RTOL * float(want.abs().max())
    err3 = float((_conv_tf32(inp, w, True).double() - want).abs().max())
    err1 = float((_conv_tf32(inp, w, False).double() - want).abs().max())
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)


@pytest.mark.parametrize("cin,co", [(16, 16), (16, 1), (64, 32), (3, 13)])
def test_dgrad_weights_give_the_input_gradient(cin, co):
    """The flipped, transposed weights that the wrapper hands kernel D
    (`dgrad_weights`), in the forward's VALID conv of the cotangent
    zero-padded by 2, are `conv3x3_dgrad_plain`."""
    rng = np.random.default_rng(cin * co)
    w = torch.from_numpy(rng.standard_normal((co, cin, 3, 3))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, co, 7, 11))
                         .astype(np.float32))
    wt = conv.dgrad_weights(w)
    assert wt.shape == (cin, co, 3, 3) and wt.is_contiguous()
    got = conv.conv3x3_valid_plain(F.pad(g, (2, 2, 2, 2)), wt)
    torch.testing.assert_close(got, conv.conv3x3_dgrad_plain(g, w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("co,tensor_cores", [(1, False), (2, True),
                                             (13, True), (16, True),
                                             (64, True)])
def test_route_by_output_channels(co, tensor_cores):
    """Inside kernel D a launch's output channels alone choose the
    route: the 16 -> 1 head's forward runs on the CUDA cores, every other
    launch (its input gradient, 1 -> 16, included) on the tensor cores."""
    assert conv.uses_tensor_cores(co) is tensor_cores


@pytest.mark.parametrize("hw", [(h, w) for h in (1, 2, 3, 5) for w in (1, 2, 3, 5)]
                         + [(37, 53)])
def test_reflect_dgrad_halo_matches_pad_autograd(hw):
    """The fused input gradient's closed form (`conv3x3_dgrad_reflect_plain`:
    the conv of g zero-padded by 1, then d xp's halo rows, columns and
    corners, each g's edge line through one tap row or column, added onto
    the row or column they reflect to) equals autograd of `reflect_pad1`
    applied to `conv3x3_dgrad_plain`'s d xp, in float32, at 1 and 2 pixel
    axes (which reflect onto themselves) and larger ones, for 1, 3, 16 and
    64 channels in and out. Within CONV_RTOL of the largest magnitude (the
    same sums in another order; 3.4e-7 measured)."""
    H, W = hw
    for cin in (1, 3, 16, 64):
        for co in (1, 3, 16, 64):
            rng = np.random.default_rng(H * 1000 + W * 100 + cin + co)
            g = torch.from_numpy(rng.standard_normal((2, co, H, W))
                                 .astype(np.float32))
            w = torch.from_numpy((rng.standard_normal((co, cin, 3, 3)) / 3.0)
                                 .astype(np.float32))
            x = torch.zeros((2, cin, H, W), requires_grad=True)
            want, = torch.autograd.grad(conv.reflect_pad1(x), x,
                                        conv.conv3x3_dgrad_plain(g, w))
            got = conv.conv3x3_dgrad_reflect_plain(g, w)
            tol = CONV_RTOL * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("weights_need_grad", [False, True])
def test_bf16_conv_pads_only_for_the_weight_gradient(monkeypatch,
                                                     weights_need_grad):
    """A bf16 conv on kernel D's route reads the pad in its staging:
    forward and input gradient make no padded copy. Only the weight
    gradient needs one, made from the saved x in the backward, so a conv
    on detached weights (the attack's passes) calls `reflect_pad1` never
    and the student's once. (On the CPU the plain forward, the kernel's
    statement, pads x itself; it keeps the unpatched pad, so only the
    Function's own calls count.)"""
    calls = []
    orig = conv.reflect_pad1
    monkeypatch.setattr(conv, "reflect_pad1",
                        lambda t: calls.append(t.shape) or orig(t))
    monkeypatch.setattr(conv, "conv3x3_reflect_plain",
                        lambda x, w, bias=None, elu=False:
                        conv.conv3x3_valid_plain(orig(x), w, bias, elu))
    gen = torch.Generator().manual_seed(9)
    x = torch.rand((2, 16, 6, 9), generator=gen).bfloat16()
    x.requires_grad_(True)
    w = torch.randn((16, 16, 3, 3), generator=gen).bfloat16()
    w.requires_grad_(weights_need_grad)
    out = conv.conv3x3_reflect(x, w, elu=True)
    assert type(out.grad_fn).__name__ == "_Conv3x3ReflectBackward"
    out.float().sum().backward()
    assert x.grad is not None
    assert calls == ([(2, 16, 6, 9)] if weights_need_grad else [])
    assert (w.grad is not None) is weights_need_grad


@pytest.mark.parametrize("cin,co,kernel", [(64, 64, True), (16, 1, True),
                                           (1, 16, True), (96, 32, False),
                                           (64, 128, False)])
def test_bf16_dispatch_by_shape(cin, co, kernel):
    """In bf16 kernel D's route is the reflect-mode Function (the pad
    folded in); any other conv pads and takes F.conv2d. Both compute one
    rounding of the float32 conv + ELU of the bf16 operands."""
    gen = torch.Generator().manual_seed(cin + co)
    x = torch.rand((1, cin, 5, 7), generator=gen).bfloat16()
    w = torch.randn((co, cin, 3, 3), generator=gen).bfloat16()
    w.requires_grad_(True)
    out = conv.conv3x3_reflect(x, w, elu=True)
    name = type(out.grad_fn).__name__
    assert (name == "_Conv3x3ReflectBackward") is kernel, name
    want = F.elu(F.conv2d(F.pad(x.float(), (1, 1, 1, 1), mode="reflect"),
                          w.float())).bfloat16()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp(min=2.0 ** -126))) - 7)
    assert ((out.float() - want.float()).abs() <= ulp).all()
