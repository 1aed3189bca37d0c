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

A NaN is kept, as `jnp.maximum` keeps it: a window that holds one has a
NaN max, no input equals it, so the backward routes that window's
cotangent nowhere (and a NaN input receives nothing). The kernels do the
same.

On a CUDA tensor both directions launch the kernels of
`csrc/maxpool3x3s2.cu`; on a CPU tensor they run the plain version
below (unfold-and-max forward, the same equality-routed backward,
adding the windows in the kernel's order so the two agree bit for bit).

float32 and bfloat16 have kernels of their own, with their own launch
counts (the JAX package runs its pool kernels in bf16 under the bf16
compute dtype). In bf16 the forward's max is exact; the backward adds a
window's cotangents in float32 and rounds the sum to bf16 once, in both
the kernel and the plain version. Any other dtype raises. The bf16
kernels work on bf16 pairs in row strips, with 16-byte loads and
stores: the forward 8 output columns of one row a thread (a column max
over each window's 3 rows, then a max of 3 columns at stride 2:
`maxpool3x3s2_separable_plain` states it), the backward `POOL_BWD_STRIP`
windows a thread (their maxima from the rows in the thread's registers,
packed bf16 equality tests, a float32 sum:
`maxpool3x3s2_backward_strips_plain` states it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import op_span
from ._build import (
    INT, POINTER, check_cuda_tensor, check_dtype, on_cuda, register,
    stream_handle,
)

DTYPES = (torch.float32, torch.bfloat16)
_FWD_ARGS = [POINTER, POINTER, INT, INT, INT, INT, INT, INT, POINTER]
_BWD_ARGS = [POINTER, POINTER, POINTER, INT, INT, INT, INT, INT, INT,
             POINTER]
_FWD_AT = "depthmodelhardening_tpu/ops/pallas_pool.py:63"
_BWD_AT = "depthmodelhardening_tpu/ops/pallas_pool.py:77"
FWD = register("maxpool3x3s2_fwd", "maxpool3x3s2.cu", _FWD_ARGS, _FWD_AT)
BWD = register("maxpool3x3s2_bwd", "maxpool3x3s2.cu", _BWD_ARGS, _BWD_AT)
FWD_BF16 = register("maxpool3x3s2_fwd_bf16", "maxpool3x3s2.cu", _FWD_ARGS,
                    _FWD_AT)
BWD_BF16 = register("maxpool3x3s2_bwd_bf16", "maxpool3x3s2.cu", _BWD_ARGS,
                    _BWD_AT)
_KERNELS = {torch.float32: (FWD, BWD), torch.bfloat16: (FWD_BF16, BWD_BF16)}
# windows (rows, columns) a thread of the bf16 backward owns: kBwdRows x
# kBwdCols / 2 (16 input columns) in csrc/maxpool3x3s2.cu
POOL_BWD_STRIP = (1, 8)


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
    """Equality-routed cotangent (B, C, H, W) of the pooled `g`; in
    bf16 summed in float32 and rounded once."""
    if x.dtype == torch.bfloat16:
        return maxpool3x3s2_backward_plain(x.float(), g.float()).to(
            torch.bfloat16)
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


def _window_max(xp, n_rows: int, n_cols: int):
    """Windows (n_rows, n_cols) of the -inf padded map `xp` (its last two
    dims; row 0 and column 0 are the pad): the max over each window's 3
    rows at stride 2 (a column max), then over 3 columns at stride 2."""
    c = torch.maximum(torch.maximum(xp[..., 0:2 * n_rows - 1:2, :],
                                    xp[..., 1:2 * n_rows:2, :]),
                      xp[..., 2:2 * n_rows + 1:2, :])
    return torch.maximum(torch.maximum(c[..., 0:2 * n_cols - 1:2],
                                       c[..., 1:2 * n_cols:2]),
                         c[..., 2:2 * n_cols + 1:2])


def _pad_neg_inf(x, rows: int, cols: int):
    """x with one -inf row and column in front and -inf after, to
    `rows` x `cols` in all."""
    H, W = x.shape[2:]
    return F.pad(x, (1, cols - W - 1, 1, rows - H - 1), value=float("-inf"))


def maxpool3x3s2_separable_plain(x):
    """The forward as the bf16 kernel decomposes it: a column max over
    each window's 3 rows, then the max of columns 2 ox - 1 .. 2 ox + 1 of
    it. The same function as `maxpool3x3s2_plain` (a max is exact)."""
    H, W = x.shape[2:]
    Ho, Wo = pooled_size(H), pooled_size(W)
    return _window_max(_pad_neg_inf(x, 2 * Ho + 1, 2 * Wo + 1), Ho, Wo)


def maxpool3x3s2_backward_strips_plain(x, g, strip=POOL_BWD_STRIP):
    """The backward as the bf16 kernel decomposes it, in strips of (BY,
    BX) windows (a thread's; all strips at once): for each, the x slab
    under the strip's windows and the next strips' first row and column
    (-inf outside the map), those windows' maxima from it, their
    cotangents (0 outside the map: such a window adds +0, which leaves a
    float32 sum from +0 unchanged), then each input of the strip's rows 2
    oy0 .. 2 (oy0 + BY) - 1 and columns 2 ox0 .. 2 (ox0 + BX) - 1 gets the
    cotangent of each covering window whose max it equals, added in
    float32 in the order (wy, wx), (wy, wx + 1), (wy + 1, wx), (wy + 1, wx
    + 1); bf16 rounds the sum once."""
    if x.dtype == torch.bfloat16:
        return maxpool3x3s2_backward_strips_plain(x.float(), g.float(),
                                                  strip).to(torch.bfloat16)
    BY, BX = strip
    B, C, H, W = x.shape
    Ho, Wo = g.shape[2:]
    n_ty, n_tx = -(-Ho // BY), -(-Wo // BX)
    # (B, C, n_ty, n_tx, ...): each strip's x slab and its windows' g
    slab = _pad_neg_inf(x, 2 * n_ty * BY + 3, 2 * n_tx * BX + 3).unfold(
        2, 2 * BY + 3, 2 * BY).unfold(3, 2 * BX + 3, 2 * BX)
    gt = F.pad(g, (0, n_tx * BX + 1 - Wo, 0, n_ty * BY + 1 - Ho)).unfold(
        2, BY + 1, BY).unfold(3, BX + 1, BX)
    m = _window_max(slab, BY + 1, BX + 1)
    v = slab[..., 1:2 * BY + 1, 1:2 * BX + 1]
    r = torch.arange(2 * BY, device=x.device)
    c = torch.arange(2 * BX, device=x.device)
    acc = torch.zeros_like(v)
    for dy in (0, 1):
        for dx in (0, 1):
            wy = (r >> 1) + dy * (r & 1)
            wx = (c >> 1) + dx * (c & 1)
            covers = ((dy == 0) | (r & 1 == 1))[:, None] & \
                ((dx == 0) | (c & 1 == 1))[None, :]
            hit = (v == m[..., wy, :][..., wx]) & covers
            acc = acc + torch.where(hit, gt[..., wy, :][..., wx], 0.0)
    dx = acc.permute(0, 1, 2, 4, 3, 5).reshape(B, C, 2 * n_ty * BY,
                                               2 * n_tx * BX)
    return dx[:, :, :H, :W]


# -- CUDA kernels ------------------------------------------------------------
@op_span("op:pool.fwd")
def maxpool3x3s2_fwd_cuda(x):
    check_cuda_tensor("x", x, 4, dtypes=DTYPES)
    B, C, H, W = x.shape
    Ho, Wo = pooled_size(H), pooled_size(W)
    y = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    _KERNELS[x.dtype][0].launch(x.data_ptr(), y.data_ptr(), B, C, H, W, Ho,
                                Wo, stream_handle(x))
    return y


@op_span("op:pool.bwd")
def maxpool3x3s2_bwd_cuda(x, g):
    check_cuda_tensor("x", x, 4, dtypes=DTYPES)
    check_cuda_tensor("g", g, 4, x.device, (x.dtype,))
    B, C, H, W = x.shape
    Ho, Wo = pooled_size(H), pooled_size(W)
    if tuple(g.shape) != (B, C, Ho, Wo):
        raise ValueError(f"g must be {(B, C, Ho, Wo)}, got "
                         f"{tuple(g.shape)}")
    dx = torch.empty_like(x)
    _KERNELS[x.dtype][1].launch(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                B, C, H, W, Ho, Wo, stream_handle(x))
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
    """3x3 / stride 2 / pad 1 max pool of (B, C, H, W) float32 or
    bfloat16, with the equality-routed backward."""
    check_dtype("maxpool3x3s2", x, DTYPES)
    return _MaxPool3x3s2.apply(x.contiguous())
