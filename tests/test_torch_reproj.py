"""The port's fused reprojection loss (kernel C's plain versions) against
the JAX package's `ops/pallas_reproj.py` and `ops/losses.py`.

* forward: the plain version against `_jnp_forward` and against the
  Pallas kernel `_pallas_forward` run in interpret mode (as
  tests/test_pallas_reproj.py runs it), atol 2e-6 (that file's
  interpret-vs-jnp tolerance);
* backward: the plain analytic VJP against `_analytic_bwd` (atol 5e-6;
  the same formulas added in the same order, but the port's means
  multiply by the rounded 1/9 where JAX's divide by 9: measured 2.5e-6)
  and against
  jax.vjp of `_jnp_forward`, the JAX package's gradient on the CPU
  (atol 1e-5, the JAX package's own analytic-vs-autodiff tolerance,
  tests/test_pallas_reproj.py:55), on unit-scale cotangents and inputs
  with identical x/y regions and equal pixels, where the clip's 0.5 and
  |.|''s +1 rules decide; and against torch autograd of the plain
  forward on tie-free inputs (1e-5: autograd rounds another chain);
* `reprojection_loss` with and without SSIM against `ops/losses.py`;
* the halo of the `reproj_loss_bwd_grad` kernel's tiles: q outside a
  tile widened by one row and column does not reach dx, dy on the tile;
* the halo of the `reproj_loss_fwd` kernel's tiles: x and y outside a
  tile widened by one row and column do not reach the loss on the tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import depthmodelhardening_tpu.ops.pallas_reproj as pr
from depthmodelhardening_tpu.ops.losses import (
    reprojection_loss as j_reprojection_loss,
)
from depthmodelhardening_tpu.ops.ssim import ssim as j_ssim
from depthmodelhardening_tpu_torch.ops.losses import reprojection_loss
from depthmodelhardening_tpu_torch.ops.reproj import (
    reproj_loss, reproj_loss_backward_plain, reproj_loss_bwd_q_plain,
    reproj_loss_grad_from_q_plain, reproj_loss_plain,
)
from depthmodelhardening_tpu_torch.ops.ssim import ssim
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

FWD_ATOL = 2e-6
BWD_ATOL = 5e-6
AUTODIFF_ATOL = 1e-5
SHAPES = [(2, 64, 128, 3), (1, 40, 256, 3), (3, 37, 53, 3)]
EDGE_SHAPES = [(2, 2, 9, 3), (1, 7, 2, 3), (1, 1, 5, 2)]


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


def _inputs(shape, seed, ties: bool):
    """x, y NHWC in [0, 1]; with ties, y equals x on a block of rows and
    on scattered single pixels, so whole SSIM windows see x == y."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.rand(*shape).astype(np.float32)
    if ties:
        H = shape[1]
        y[:, H // 4: H // 4 + max(3, H // 3)] = \
            x[:, H // 4: H // 4 + max(3, H // 3)]
        eq = rng.rand(*shape) < 0.05
        y[eq] = x[eq]
    return x, y


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jnp_and_the_pallas_kernel(shape):
    x, y = _inputs(shape, 0, ties=True)
    got = reproj_loss_plain(_planar(x), _planar(y)).numpy()
    want = np.asarray(pr._jnp_forward(jnp.asarray(x), jnp.asarray(y)))
    kernel = np.asarray(_interp(pr._pallas_forward, jnp.asarray(x),
                                jnp.asarray(y)))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got, kernel, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_ssim_matches_jax_at_reflect_edges(shape):
    """Axes of size 1 and 2: numpy's reflect rule at both ends."""
    x, y = _inputs(shape, 1, ties=False)
    got = ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(j_ssim(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES[::2] + EDGE_SHAPES)
def test_analytic_backward_matches_jax_with_ties(shape):
    x, y = _inputs(shape, 2, ties=True)
    g = np.random.RandomState(3).randn(*shape[:3]).astype(np.float32)
    dx, dy = reproj_loss_backward_plain(_planar(x), _planar(y),
                                        torch.from_numpy(g))
    jx, jy = pr._analytic_bwd((jnp.asarray(x), jnp.asarray(y)),
                              jnp.asarray(g))
    _, vjp = jax.vjp(pr._jnp_forward, jnp.asarray(x), jnp.asarray(y))
    ax, ay = vjp(jnp.asarray(g))
    for got, analytic, autodiff in ((dx, jx, ax), (dy, jy, ay)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(analytic),
                                   atol=BWD_ATOL, rtol=0)
        np.testing.assert_allclose(_nhwc(got), np.asarray(autodiff),
                                   atol=AUTODIFF_ATOL, rtol=0)


def test_tie_rules_are_jax_autodiffs():
    """x == y everywhere: the SSIM term sits exactly at the clip's 0 and
    the L1 term at |.|'s kink; JAX passes 0.5 and +1 there, so the
    gradient is not torch autograd's (clamp passes 1, abs gives 0)."""
    x, _ = _inputs((1, 12, 16, 3), 4, ties=False)
    g = np.ones((1, 12, 16), np.float32)
    dx, dy = reproj_loss_backward_plain(_planar(x), _planar(x),
                                        torch.from_numpy(g))
    jx, jy = jax.vjp(pr._jnp_forward, jnp.asarray(x),
                     jnp.asarray(x))[1](jnp.asarray(g))
    np.testing.assert_allclose(_nhwc(dx), np.asarray(jx),
                               atol=AUTODIFF_ATOL)
    np.testing.assert_allclose(_nhwc(dy), np.asarray(jy),
                               atol=AUTODIFF_ATOL)
    # the L1 term alone, 0.15 / C per pixel with sign +1 / -1
    assert np.abs(_nhwc(dx) - 0.05).max() < 1e-2
    xt = _planar(x).requires_grad_(True)
    (tx,) = torch.autograd.grad(reproj_loss_plain(xt, _planar(x)).sum(), xt)
    assert not np.allclose(tx.numpy(), dx.numpy(), atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 5, 7, 3)])
def test_analytic_backward_matches_torch_autograd_away_from_ties(shape):
    x, y = _inputs(shape, 5, ties=False)
    g = torch.from_numpy(
        np.random.RandomState(6).randn(*shape[:3]).astype(np.float32))
    xt = _planar(x).requires_grad_(True)
    yt = _planar(y).requires_grad_(True)
    ax, ay = torch.autograd.grad((reproj_loss_plain(xt, yt) * g).sum(),
                                 (xt, yt))
    dx, dy = reproj_loss_backward_plain(_planar(x), _planar(y), g)
    torch.testing.assert_close(dx, ax, atol=AUTODIFF_ATOL, rtol=0)
    torch.testing.assert_close(dy, ay, atol=AUTODIFF_ATOL, rtol=0)


def test_function_routes_cpu_tensors_through_the_plain_versions():
    x, y = _inputs((2, 9, 11, 3), 7, ties=True)
    xt = _planar(x).requires_grad_(True)
    out = reproj_loss(xt, _planar(y))
    torch.testing.assert_close(out, reproj_loss_plain(_planar(x),
                                                      _planar(y)),
                               atol=0, rtol=0)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(0))
    (dx,) = torch.autograd.grad(out, xt, g)
    want, _ = reproj_loss_backward_plain(_planar(x), _planar(y), g,
                                         need_dy=False)
    torch.testing.assert_close(dx, want, atol=0, rtol=0)


@pytest.mark.parametrize("use_ssim", [True, False])
def test_reprojection_loss_matches_jax(use_ssim):
    x, y = _inputs((2, 16, 20, 3), 8, ties=True)
    g = np.random.RandomState(9).randn(2, 16, 20, 1).astype(np.float32)
    pt = torch.from_numpy(x).requires_grad_(True)
    out = reprojection_loss(pt, torch.from_numpy(y), use_ssim=use_ssim)
    (dp,) = torch.autograd.grad(out, pt, torch.from_numpy(g))
    want, vjp = jax.vjp(
        lambda p: j_reprojection_loss(p, jnp.asarray(y), use_ssim=use_ssim),
        jnp.asarray(x))
    (jdp,) = vjp(jnp.asarray(g))
    assert out.shape == want.shape == (2, 16, 20, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp),
                               atol=AUTODIFF_ATOL, rtol=0)


def _tiles(n):
    """Row (or column) ranges of tiles at both edges and inside."""
    t = max(1, n // 4)
    mid = min(max(0, n // 2 - t // 2), n - t)
    return sorted({(0, t), (n - t, n), (mid, mid + t), (0, n)})


@pytest.mark.parametrize("H", [1, 2, 3, 37])
@pytest.mark.parametrize("W", [1, 2, 3, 37])
def test_gradient_on_a_tile_reads_q_only_within_one_of_it(H, W):
    """Zeroing q outside a tile widened by one row and column (the
    window the kernel stages) leaves dx and dy on the tile bit-unchanged,
    reflected edges and corners included."""
    x, y = _inputs((2, H, W, 3), 10, ties=True)
    x, y = _planar(x), _planar(y)
    g = torch.from_numpy(
        np.random.RandomState(11).randn(2, H, W).astype(np.float32))
    q = reproj_loss_bwd_q_plain(x, y, g)
    dx, dy = reproj_loss_grad_from_q_plain(x, y, g, q)
    want_dx, want_dy = reproj_loss_backward_plain(x, y, g)
    assert torch.equal(dx, want_dx) and torch.equal(dy, want_dy)
    for r0, r1 in _tiles(H):
        for c0, c1 in _tiles(W):
            qt = torch.zeros_like(q)
            win = (slice(None), slice(None), slice(max(r0 - 1, 0), r1 + 1),
                   slice(max(c0 - 1, 0), c1 + 1))
            qt[win] = q[win]
            tx, ty = reproj_loss_grad_from_q_plain(x, y, g, qt)
            tile = (slice(None), slice(None), slice(r0, r1), slice(c0, c1))
            assert torch.equal(tx[tile], dx[tile]), (r0, r1, c0, c1)
            assert torch.equal(ty[tile], dy[tile]), (r0, r1, c0, c1)


@pytest.mark.parametrize("H", [1, 2, 3, 37])
@pytest.mark.parametrize("W", [1, 2, 3, 37])
def test_loss_on_a_tile_reads_x_and_y_only_within_one_of_it(H, W):
    """Perturbing x and y outside a tile widened by one row and column
    (the window the forward kernel stages, whose halo holds the
    reflected pixels) leaves the loss on the tile bit-unchanged,
    reflected edges and corners included."""
    x, y = _inputs((2, H, W, 3), 12, ties=True)
    x, y = _planar(x), _planar(y)
    out = reproj_loss_plain(x, y)
    rng = np.random.RandomState(13)
    for r0, r1 in _tiles(H):
        for c0, c1 in _tiles(W):
            win = (slice(None), slice(None), slice(max(r0 - 1, 0), r1 + 1),
                   slice(max(c0 - 1, 0), c1 + 1))
            xt = torch.from_numpy(rng.rand(*x.shape).astype(np.float32))
            yt = torch.from_numpy(rng.rand(*y.shape).astype(np.float32))
            xt[win], yt[win] = x[win], y[win]
            got = reproj_loss_plain(xt, yt)
            tile = (slice(None), slice(r0, r1), slice(c0, c1))
            assert torch.equal(got[tile], out[tile]), (r0, r1, c0, c1)
