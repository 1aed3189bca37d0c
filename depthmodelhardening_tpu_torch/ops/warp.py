"""Separable EoT tile warp, pass 2: per-column vertical resample.

Counterpart of `depthmodelhardening_tpu/ops/pallas_warp.py`. For output
row y of column x the source row is `sy = A[b, x] * y + B[b, x]`, read
with 2-tap bilinear weights and zero fill outside [0, OH):

    out[b, c, y, x] = (1 - w1) * inter[b, c, k0, x] + w1 * inter[b, c, k0 + 1, x]
    k0 = floor(sy), w1 = sy - k0

The backward is the exact transpose with respect to `inter`; A and B get
no gradient (they are functions of the EoT draw, not of the texture).

On a CUDA tensor both directions launch the hand-written kernels of
`csrc/vertical_resample.cu`; on a CPU tensor they run the plain PyTorch
version below (`_vert_jnp`'s gather and its adjoint). Any other device
raises.
"""

from __future__ import annotations

import torch

from ..utils.profiling import op_span
from ._build import (
    INT, POINTER, check_cuda_tensor, on_cuda, register, stream_handle,
)

FWD = register(
    "vertical_resample_fwd", "vertical_resample.cu",
    [POINTER, POINTER, POINTER, POINTER, INT, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_warp.py:39")
BWD = register(
    "vertical_resample_bwd", "vertical_resample.cu",
    [POINTER, POINTER, POINTER, POINTER, INT, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_warp.py:63")

MAX_CHANNELS = 8  # kMaxChannels of the kernel's per-thread accumulator


# -- plain PyTorch version ---------------------------------------------------
def _taps(A, B, th: int, oh: int):
    """(k0, k1) clamped row indices, their in-range masks and w1, each
    (B, 1, th, TW)."""
    ys = torch.arange(th, dtype=torch.float32, device=A.device)
    sy = A[:, None, :] * ys[None, :, None] + B[:, None, :]
    k0f = torch.floor(sy)
    w1 = (sy - k0f)[:, None]
    k0 = k0f.to(torch.int64)
    ok0 = ((k0 >= 0) & (k0 < oh)).to(torch.float32)[:, None]
    ok1 = ((k0 + 1 >= 0) & (k0 + 1 < oh)).to(torch.float32)[:, None]
    idx0 = k0.clamp(0, oh - 1)[:, None]
    idx1 = (k0 + 1).clamp(0, oh - 1)[:, None]
    return idx0, idx1, ok0, ok1, w1


def vertical_resample_plain(inter, A, B, th: int):
    """The gather formulation (`pallas_warp.py:_vert_jnp`)."""
    Bn, C, OH, TW = inter.shape
    idx0, idx1, ok0, ok1, w1 = _taps(A, B, th, OH)
    shape = (Bn, C, th, TW)
    v0 = torch.gather(inter, 2, idx0.expand(shape))
    v1 = torch.gather(inter, 2, idx1.expand(shape))
    return v0 * (1.0 - w1) * ok0 + v1 * w1 * ok1


def vertical_resample_adjoint_plain(g, A, B, oh: int):
    """Exact adjoint of `vertical_resample_plain` w.r.t. `inter`: the
    gather's autograd adjoint, a scatter-add of the weighted cotangent."""
    Bn, C, th, TW = g.shape
    idx0, idx1, ok0, ok1, w1 = _taps(A, B, th, oh)
    shape = (Bn, C, th, TW)
    d = torch.zeros((Bn, C, oh, TW), dtype=g.dtype, device=g.device)
    d.scatter_add_(2, idx0.expand(shape), g * (1.0 - w1) * ok0)
    d.scatter_add_(2, idx1.expand(shape), g * w1 * ok1)
    return d


# -- CUDA kernels ------------------------------------------------------------
def _check_args(t, A, B, what: str):
    check_cuda_tensor(what, t, 4)
    Bn, C, _, TW = t.shape
    check_cuda_tensor("A", A, 2, t.device)
    check_cuda_tensor("B", B, 2, t.device)
    if tuple(A.shape) != (Bn, TW) or tuple(B.shape) != (Bn, TW):
        raise ValueError(f"A and B must be {(Bn, TW)}, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{what}: {C} channels, the kernel takes 1.."
                         f"{MAX_CHANNELS}")


@op_span("op:warp.fwd")
def vertical_resample_fwd_cuda(inter, A, B, th: int):
    """Kernel forward: (B, C, OH, TW) -> (B, C, th, TW)."""
    _check_args(inter, A, B, "inter")
    Bn, C, OH, TW = inter.shape
    out = torch.empty((Bn, C, th, TW), dtype=inter.dtype,
                      device=inter.device)
    FWD.launch(inter.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(),
               Bn, C, OH, th, TW, stream_handle(inter))
    return out


@op_span("op:warp.bwd")
def vertical_resample_bwd_cuda(g, A, B, oh: int):
    """Kernel adjoint: (B, C, th, TW) -> (B, C, oh, TW)."""
    _check_args(g, A, B, "g")
    Bn, C, TH, TW = g.shape
    d = torch.empty((Bn, C, oh, TW), dtype=g.dtype, device=g.device)
    BWD.launch(g.data_ptr(), A.data_ptr(), B.data_ptr(), d.data_ptr(),
               Bn, C, oh, TH, TW, stream_handle(g))
    return d


# -- dispatch ----------------------------------------------------------------
class _VerticalResample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inter, A, B, th: int):
        ctx.save_for_backward(A, B)
        ctx.oh = inter.shape[2]
        if on_cuda(inter, "vertical_resample"):
            return vertical_resample_fwd_cuda(inter, A, B, th)
        return vertical_resample_plain(inter, A, B, th)

    @staticmethod
    def backward(ctx, g):
        A, B = ctx.saved_tensors
        g = g.contiguous()
        if on_cuda(g, "vertical_resample"):
            d = vertical_resample_bwd_cuda(g, A, B, ctx.oh)
        else:
            d = vertical_resample_adjoint_plain(g, A, B, ctx.oh)
        return d, None, None, None


def vertical_resample(inter, A, B, th: int):
    """Per-column vertical 1-D bilinear resample (pass 2 of the EoT warp).

    inter: (B, C, OH, TW) float32, channel-major pass-1 output.
    A, B: (B, TW) float32 per-column affine row maps.
    Returns (B, C, th, TW); differentiable w.r.t. `inter` only.
    """
    return _VerticalResample.apply(inter.contiguous(), A.contiguous(),
                                   B.contiguous(), th)
