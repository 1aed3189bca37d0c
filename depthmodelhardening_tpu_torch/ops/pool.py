"""The ResNet stem's 3x3 / stride 2 / pad 1 max pool, NCHW.

Counterpart of `depthmodelhardening_tpu/ops/pallas_pool.py` on the
plain layout (the JAX package runs it on its width-packed stem; the
function is the same as flax `nn.max_pool` at `models/resnet.py:406`
and torch `MaxPool2d(3, 2, 1)`). Padding is -inf.

The backward routes the cotangent by equality, as the TPU kernel does:
every input bit-equal to the max of a window covering it receives that
window's full cotangent, so ties duplicate it (autograd of a max picks
one winner instead). Behind a relu every tied zero has zero cotangent,
so the model's input gradient is the same under either rule.

On a CUDA tensor both directions launch the kernels of
`csrc/maxpool3x3s2.cu`; on a CPU tensor they run the plain version
below (unfold-and-max forward, the same equality-routed backward,
adding the windows in the kernel's order so the two agree bit for bit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import (
    INT, POINTER, check_cuda_tensor, on_cuda, register, stream_handle,
)

FWD = register(
    "maxpool3x3s2_fwd", "maxpool3x3s2.cu",
    [POINTER, POINTER, INT, INT, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_pool.py:63")
BWD = register(
    "maxpool3x3s2_bwd", "maxpool3x3s2.cu",
    [POINTER, POINTER, POINTER, INT, INT, INT, INT, INT, INT, POINTER],
    replaces="depthmodelhardening_tpu/ops/pallas_pool.py:77")


def pooled_size(n: int) -> int:
    return (n - 1) // 2 + 1


# -- plain PyTorch version ---------------------------------------------------
def maxpool3x3s2_plain(x):
    """(B, C, H, W) -> (B, C, Ho, Wo): pad with -inf, unfold, max."""
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    return xp.unfold(2, 3, 2).unfold(3, 3, 2).amax(dim=(-2, -1))


def _cover(n: int, n_out: int, device):
    """For each input index i (length n): the two window indices
    (lo, hi) = (i >> 1, (i + 1) >> 1) that may cover it, hi clamped,
    and whether hi is a second window (i odd and hi < n_out)."""
    i = torch.arange(n, device=device)
    lo = i >> 1
    hi = (i + 1) >> 1
    has_hi = (i % 2 == 1) & (hi < n_out)
    return lo, hi.clamp(max=n_out - 1), has_hi


def maxpool3x3s2_backward_plain(x, g):
    """Equality-routed cotangent (B, C, H, W) of the pooled `g`."""
    H, W = x.shape[2:]
    Ho, Wo = g.shape[2:]
    m = maxpool3x3s2_plain(x)
    ylo, yhi, y2 = _cover(H, Ho, x.device)
    xlo, xhi, x2 = _cover(W, Wo, x.device)
    dx = torch.zeros_like(x)
    for oy, vy in ((ylo, None), (yhi, y2)):
        for ox, vx in ((xlo, None), (xhi, x2)):
            hit = x == m[:, :, oy][:, :, :, ox]
            if vy is not None:
                hit = hit & vy[:, None]
            if vx is not None:
                hit = hit & vx[None, :]
            dx = dx + torch.where(hit, g[:, :, oy][:, :, :, ox], 0.0)
    return dx


# -- CUDA kernels ------------------------------------------------------------
def maxpool3x3s2_fwd_cuda(x):
    check_cuda_tensor("x", x, 4)
    B, C, H, W = x.shape
    Ho, Wo = pooled_size(H), pooled_size(W)
    y = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    FWD.launch(x.data_ptr(), y.data_ptr(), B, C, H, W, Ho, Wo,
               stream_handle(x))
    return y


def maxpool3x3s2_bwd_cuda(x, g):
    check_cuda_tensor("x", x, 4)
    check_cuda_tensor("g", g, 4, x.device)
    B, C, H, W = x.shape
    Ho, Wo = pooled_size(H), pooled_size(W)
    if tuple(g.shape) != (B, C, Ho, Wo):
        raise ValueError(f"g must be {(B, C, Ho, Wo)}, got "
                         f"{tuple(g.shape)}")
    dx = torch.empty_like(x)
    BWD.launch(x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, C, H, W, Ho,
               Wo, stream_handle(x))
    return dx


# -- dispatch ----------------------------------------------------------------
class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if on_cuda(x, "maxpool3x3s2"):
            return maxpool3x3s2_fwd_cuda(x)
        return maxpool3x3s2_plain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        if on_cuda(g, "maxpool3x3s2"):
            return maxpool3x3s2_bwd_cuda(x, g)
        return maxpool3x3s2_backward_plain(x, g)


def maxpool3x3s2(x):
    """3x3 / stride 2 / pad 1 max pool of (B, C, H, W) float32, with the
    equality-routed backward."""
    return _MaxPool3x3s2.apply(x.contiguous())
