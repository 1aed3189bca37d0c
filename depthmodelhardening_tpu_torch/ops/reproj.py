"""The fused photometric reprojection loss (SSIM + L1) and its backward.

Counterpart of `depthmodelhardening_tpu/ops/pallas_reproj.py`: the
forward is kernel C (`_make_kernel` :68 / `_compute_chunk` :31 behind
`_pallas_forward` :114), the backward is its analytic VJP
`_analytic_bwd` (:172-237). Per pixel,

    0.85 * mean_c clip((1 - SSIM(x, y)) / 2, 0, 1) + 0.15 * mean_c |x - y|

with reflect padding 1 and 3x3 mean pools (reference
monodepth2/trainer.py:525-537, layers.py:223-253).

On CUDA tensors both directions launch the kernels of
`csrc/reproj_loss.cu`; on CPU tensors they run the plain versions below,
which add and multiply in the kernels' order. The backward is the
analytic one, not autograd of the plain forward, because it keeps JAX
autodiff's tie rules: the clip passes 0.5 at exactly 0 or 1 (identical
x and y windows give exactly 0) and |.|' is +1 at 0, where torch's
autograd gives 1 and 0.

Layout: the kernels and the plain versions take planar (B, C, H, W)
float32 and return (B, H, W); `ops/losses.py:reprojection_loss` takes
the package's NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import op_span
from ._build import (
    INT, POINTER, check_cuda_tensor, on_cuda, register, stream_handle,
)
from .padding import reflect_pad1, reflect_pad1_adjoint
from .ssim import C1, C2, moments, ssim_planar, sum_taps

FWD = register(
    "reproj_loss_fwd", "reproj_loss.cu",
    [POINTER, POINTER, POINTER, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_reproj.py:68")
BWD_Q = register(
    "reproj_loss_bwd_q", "reproj_loss.cu",
    [POINTER, POINTER, POINTER, POINTER, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_reproj.py:172")
BWD_GRAD = register(
    "reproj_loss_bwd_grad", "reproj_loss.cu",
    [POINTER, POINTER, POINTER, POINTER, POINTER, POINTER, INT, INT, INT,
     INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_reproj.py:172")


# -- plain PyTorch versions --------------------------------------------------
def _channel_mean(t):
    """Mean over dim 1, summed channel by channel and times 1/C (the
    kernels' order and rounding)."""
    acc = t[:, 0]
    for c in range(1, t.shape[1]):
        acc = acc + t[:, c]
    return acc * (1.0 / t.shape[1])


def reproj_loss_plain(x, y):
    """(B, C, H, W), (B, C, H, W) -> (B, H, W) loss map."""
    return (0.85 * _channel_mean(ssim_planar(x, y))
            + 0.15 * _channel_mean((x - y).abs()))


def reproj_loss_bwd_q_plain(x, y, g):
    """The SSIM term's cotangents of the five moments, as the
    `reproj_loss_bwd_q` kernel writes them: (B, 4C, H, W), q0 (mu_x), q1
    (mu_y), q23 (E[x^2] and E[y^2]), q4 (E[xy]), each times 1/9. The
    formulas and their order are `_analytic_bwd`'s."""
    C = x.shape[1]
    p0, p1, p2, p3, p4 = moments(x, y)
    A = p0 * p0 + p1 * p1 + C1
    Bn = 2 * p0 * p1 + C1
    T = (p2 - p0 * p0) + (p3 - p1 * p1) + C2
    S = 2 * (p4 - p0 * p1) + C2
    d = A * T
    r = (Bn * S) / d
    v = (1 - r) / 2
    # clip's derivative under JAX autodiff: 1 inside, 0.5 at exactly 0 or 1
    mask = (((v > 0) & (v < 1)).to(x.dtype)
            + torch.where((v == 0) | (v == 1), 0.5, 0.0))
    gm = (0.85 / C) * g[:, None] * (-0.5) * mask
    rd = r / d
    q0 = gm * (2 * p1 * (S - Bn) / d - rd * 2 * p0 * (T - A))
    q1 = gm * (2 * p0 * (S - Bn) / d - rd * 2 * p1 * (T - A))
    q23 = gm * (-rd * A)
    q4 = gm * (2 * Bn / d)
    return torch.cat([q0, q1, q23, q4], dim=1) * (1.0 / 9.0)


def reproj_loss_grad_from_q_plain(x, y, g, q, need_dy: bool = True):
    """(dx, dy) from `reproj_loss_bwd_q_plain`'s q, as the
    `reproj_loss_bwd_grad` kernel computes them; dy None unless
    `need_dy`."""
    C = x.shape[1]
    H, W = x.shape[-2:]
    # the mean pool's adjoint: a full 3x3 correlation with ones on the
    # padded grid (q padded by 2 zeros)
    u0, u1, u2, u4 = sum_taps(F.pad(q, (2, 2, 2, 2)), H + 2,
                              W + 2).split(C, dim=1)
    xp, yp = reflect_pad1(x), reflect_pad1(y)
    # |.|' = +1 at 0 (JAX's convention)
    l1 = (0.15 / C) * g[:, None] * torch.where(x >= y, 1.0, -1.0)
    dx = reflect_pad1_adjoint(u0 + 2 * xp * u2 + yp * u4) + l1
    if not need_dy:
        return dx, None
    dy = reflect_pad1_adjoint(u1 + 2 * yp * u2 + xp * u4) - l1
    return dx, dy


def reproj_loss_backward_plain(x, y, g, need_dy: bool = True):
    """Analytic VJP of `reproj_loss_plain` at (x, y) for the cotangent g
    (B, H, W): (dx, dy), dy None unless `need_dy`."""
    return reproj_loss_grad_from_q_plain(
        x, y, g, reproj_loss_bwd_q_plain(x, y, g), need_dy)


# -- CUDA kernels ------------------------------------------------------------
def _check_pair(x, y):
    check_cuda_tensor("x", x, 4)
    check_cuda_tensor("y", y, 4, x.device)
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} "
                         "differ in shape")


@op_span("op:reproj.fwd")
def reproj_loss_fwd_cuda(x, y):
    _check_pair(x, y)
    B, C, H, W = x.shape
    out = torch.empty((B, H, W), dtype=x.dtype, device=x.device)
    FWD.launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, C, H, W,
               stream_handle(x))
    return out


@op_span("op:reproj.bwd")
def reproj_loss_bwd_cuda(x, y, g, need_dy: bool = True):
    _check_pair(x, y)
    check_cuda_tensor("g", g, 3, x.device)
    B, C, H, W = x.shape
    if tuple(g.shape) != (B, H, W):
        raise ValueError(f"g must be {(B, H, W)}, got {tuple(g.shape)}")
    q = torch.empty((B, 4 * C, H, W), dtype=x.dtype, device=x.device)
    stream = stream_handle(x)
    BWD_Q.launch(x.data_ptr(), y.data_ptr(), g.data_ptr(), q.data_ptr(), B,
                 C, H, W, stream)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y) if need_dy else None
    BWD_GRAD.launch(x.data_ptr(), y.data_ptr(), g.data_ptr(), q.data_ptr(),
                    dx.data_ptr(), 0 if dy is None else dy.data_ptr(), B, C,
                    H, W, stream)
    return dx, dy


# -- dispatch ----------------------------------------------------------------
class _ReprojLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        if on_cuda(x, "reproj_loss"):
            return reproj_loss_fwd_cuda(x, y)
        return reproj_loss_plain(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        need_dx, need_dy = ctx.needs_input_grad
        g = g.contiguous()
        if on_cuda(g, "reproj_loss"):
            dx, dy = reproj_loss_bwd_cuda(x, y, g, need_dy)
        else:
            dx, dy = reproj_loss_backward_plain(x, y, g, need_dy)
        return (dx if need_dx else None), dy


def reproj_loss(x, y):
    """Loss map (B, H, W) of planar (B, C, H, W) float32 x and y."""
    return _ReprojLoss.apply(x.contiguous(), y.contiguous())
