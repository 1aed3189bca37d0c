"""3x3 convolutions of the depth decoder, with kernel D for narrow layers.

Counterpart of `depthmodelhardening_tpu/ops/pallas_conv.py`:
`conv3x3_valid` (:137) is a 3x3 VALID convolution of a pre-padded
input whose forward is kernel D and whose input gradient is kernel D
again, with the weights flipped in both spatial axes and their in/out
channels transposed, on the cotangent zero-padded by 2 (:146-152). The
weight gradient is an ordinary convolution, as the JAX package leaves it
to XLA (:154-160). The bias and the ELU of the decoder's ConvBlock are
fused into D's epilogue (the function of the prototype P3,
`scripts/proto_pallas_wconv.py:40`); the ELU's backward multiplies the
cotangent by (y > 0 ? 1 : y + 1) from the saved output.

Two element types, each with its own kernel instances and launch
counts: float32 (the reference's precision) and bfloat16 (the
distillation step's `compute_dtype="bfloat16"`). The bf16 instance is
P3's function itself: bf16 in, float32 accumulation, bias and ELU in
float32, one rounding to bf16 (`proto_pallas_wconv.py:60-80`); its
plain version upcasts to float32, convolves, applies the epilogue and
rounds once. Input, weights and bias share one dtype; any other dtype
(float16, float64) raises, on the CPU too.

`conv3x3_reflect` is the dispatch (`pallas_conv.py:167-188`): a conv
with at most 64 input and 64 output channels (`small_c`, :175) runs
kernel D, any other runs `F.conv2d`. The choice is made by shape alone.
The TPU-only alignment rule (:176, H % 8 and W % 128) is dropped:
nothing on the card needs it, and it would exclude the 320-wide attack
crop. On a CUDA tensor D's wrappers launch the kernels of
`csrc/conv3x3.cu` or raise; on a CPU tensor they run the plain versions
below.

float32: `reflect_pad1` then `conv3x3_valid`, the kernel's VALID conv of
the padded map. Inside D the output channels of a launch alone choose
the route (`uses_tensor_cores`): the tensor-core kernel (3xTF32), or the
CUDA-core one for a single output channel. The input gradient's
flipped, transposed weights are made here (`dgrad_weights`).

bfloat16: the reflect pad is folded into D (`_Conv3x3Reflect`). The
forward stages the unpadded x at reflected indices; the input gradient
reads the forward's weights flipped and transposed in its staging and
writes dx itself, the pad's adjoint included, so neither the padded map
nor its gradient exists. Only the weight gradient still needs the padded
map, which the autograd Function makes from the saved x when the
weights need a gradient (the student's backward; never in the attack's
passes, which run on detached weights). In D, the head's forward (one
output channel) and its input gradient (one input channel to the
gradient) run on the CUDA cores, every other launch on the tensor cores;
`csrc/conv3x3.cu:launch_bf16` chooses by shape. `conv3x3_valid` in bf16
keeps the same kernel's zero-border mode.
Layout: NCHW / OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import op_span
from ._build import (
    INT, POINTER, check_cuda_tensor, check_dtype, on_cuda, register,
    stream_handle,
)
from .padding import reflect_pad1

SMALL_C = 64  # pallas_conv.py:175
DTYPES = (torch.float32, torch.bfloat16)

_FWD_ARGS = [POINTER, POINTER, POINTER, POINTER, INT, INT, INT, INT, INT,
             INT, INT, POINTER]
_DGRAD_ARGS = [POINTER, POINTER, POINTER, INT, INT, INT, INT, INT, INT,
               POINTER]
FWD = register("conv3x3_fwd", "conv3x3.cu", _FWD_ARGS,
               replaces="depthmodelhardening_tpu/ops/pallas_conv.py:42")
DGRAD = register("conv3x3_dgrad", "conv3x3.cu", _DGRAD_ARGS,
                 replaces="depthmodelhardening_tpu/ops/pallas_conv.py:42")
# the bf16 entry points take a reflect flag where the float32 ones take
# the route: the C side routes bf16 launches itself
FWD_BF16 = register("conv3x3_fwd_bf16", "conv3x3.cu", _FWD_ARGS,
                    replaces="scripts/proto_pallas_wconv.py:40")
DGRAD_BF16 = register(
    "conv3x3_dgrad_bf16", "conv3x3.cu", _DGRAD_ARGS,
    replaces="depthmodelhardening_tpu/ops/pallas_conv.py:42")
_KERNELS = {torch.float32: (FWD, DGRAD), torch.bfloat16: (FWD_BF16,
                                                           DGRAD_BF16)}


def takes_kernel(cin: int, co: int) -> bool:
    """Whether `conv3x3_reflect` routes a Cin -> Co conv to kernel D."""
    return cin <= SMALL_C and co <= SMALL_C


def uses_tensor_cores(co: int) -> bool:
    """Kernel D's route for a launch with `co` output channels: the
    tensor-core kernel for Co >= 2; the CUDA-core kernel for Co = 1 (the
    16 -> 1 disparity head forward, bound by bytes)."""
    return co >= 2


def dgrad_weights(w):
    """The input gradient's weights (Cin, Co, 3, 3): w flipped in both
    spatial axes, in and out channels transposed (`pallas_conv.py:149`)."""
    return w.flip((2, 3)).transpose(0, 1).contiguous()


def _epilogue(out, elu: bool):
    return F.elu(out) if elu else out


# -- plain PyTorch versions --------------------------------------------------
def conv3x3_valid_plain(xp, w, bias=None, elu: bool = False):
    """(B, Cin, H + 2, W + 2), (Co, Cin, 3, 3) -> (B, Co, H, W). In
    bf16: computed in float32 from the upcast operands, rounded once."""
    if xp.dtype == torch.bfloat16:
        return conv3x3_valid_plain(
            xp.float(), w.float(), None if bias is None else bias.float(),
            elu).to(torch.bfloat16)
    return _epilogue(F.conv2d(xp, w, bias), elu)


def conv3x3_dgrad_plain(g, w):
    """Gradient with respect to xp of `conv3x3_valid_plain(xp, w)` for the
    cotangent g (B, Co, H, W): the VALID conv of g zero-padded by 2 with
    the flipped, transposed weights -> (B, Cin, H + 2, W + 2). In bf16:
    computed in float32, rounded once."""
    if g.dtype == torch.bfloat16:
        return conv3x3_dgrad_plain(g.float(), w.float()).to(torch.bfloat16)
    return F.conv2d(F.pad(g, (2, 2, 2, 2)), w.flip((2, 3)).transpose(0, 1))


def conv3x3_reflect_plain(x, w, bias=None, elu: bool = False):
    """Reflect-pad(1) + 3x3 conv (+ bias, + ELU) of (B, Cin, H, W) ->
    (B, Co, H, W). In bf16: computed in float32 from the upcast operands,
    rounded once."""
    return conv3x3_valid_plain(reflect_pad1(x), w, bias, elu)


def _edge_conv(line, taps):
    """A 1-D 3-tap conv along a (B, Co, 1, n) or (B, Co, n, 1) line of g
    zero-padded by 1, with the (Cin, Co, 1, 3) or (Cin, Co, 3, 1) taps."""
    pad = (1, 1, 0, 0) if taps.shape[2] == 1 else (0, 0, 1, 1)
    return F.conv2d(F.pad(line, pad), taps)


def conv3x3_dgrad_reflect_plain(g, w):
    """Gradient with respect to x of `conv3x3_reflect_plain(x, w)` for
    the cotangent g (B, Co, H, W) -> (B, Cin, H, W), as the bf16 kernel
    decomposes it: the conv of g zero-padded by 1 with the flipped,
    transposed weights wt (the interior of d xp), then the halo of d xp
    added onto the rows and columns it reflects to, in the order of the
    pad's adjoint (`ops/padding.py:reflect_pad1_adjoint`): top and bottom
    rows, left and right columns, then the four corners. Each halo line
    meets g through one tap row or column: d xp[0, j + 1] = sum_b g[0, j
    + b - 1] wt[2, b], d xp[H + 1, .] through wt[0, .] on g's last row,
    d xp[i + 1, 0] through wt[., 2] on g's column 0, d xp[., W + 1]
    through wt[., 0] on its last column, the corners through one tap
    each. In bf16:
    computed in float32, rounded once."""
    if g.dtype == torch.bfloat16:
        return conv3x3_dgrad_reflect_plain(g.float(), w.float()).to(
            torch.bfloat16)
    H, W = g.shape[2:]
    wt = dgrad_weights(w)
    r1, rm = min(1, H - 1), max(H - 2, 0)
    c1, cm = min(1, W - 1), max(W - 2, 0)
    d = F.conv2d(F.pad(g, (1, 1, 1, 1)), wt)
    d[:, :, r1, :] += _edge_conv(g[:, :, :1, :], wt[:, :, 2:, :])[:, :, 0]
    d[:, :, rm, :] += _edge_conv(g[:, :, -1:, :], wt[:, :, :1, :])[:, :, 0]
    d[:, :, :, c1] += _edge_conv(g[:, :, :, :1], wt[:, :, :, 2:])[..., 0]
    d[:, :, :, cm] += _edge_conv(g[:, :, :, -1:], wt[:, :, :, :1])[..., 0]
    for (gy, gx, ty, tx), (y, x) in zip(
            ((0, 0, 2, 2), (0, -1, 2, 0), (-1, 0, 0, 2), (-1, -1, 0, 0)),
            ((r1, c1), (r1, cm), (rm, c1), (rm, cm))):
        d[:, :, y, x] += g[:, :, gy, gx] @ wt[:, :, ty, tx].T
    return d


def weight_grad(xp, w, g):
    """Gradient with respect to w (an ordinary convolution)."""
    return torch.nn.grad.conv2d_weight(xp, w.shape, g)


# -- CUDA kernels ------------------------------------------------------------
def _check_weight(w, cin: int, like):
    check_cuda_tensor("w", w, 4, like.device, (like.dtype,))
    if w.shape[1:] != (cin, 3, 3):
        raise ValueError(f"w must be (Co, {cin}, 3, 3), got {tuple(w.shape)}")


@op_span("op:conv3x3.fwd")
def conv3x3_valid_cuda(xp, w, bias=None, elu: bool = False):
    check_cuda_tensor("xp", xp, 4, dtypes=DTYPES)
    B, Cin, Hp, Wp = xp.shape
    _check_weight(w, Cin, xp)
    Co = w.shape[0]
    if bias is not None:
        check_cuda_tensor("bias", bias, 1, xp.device, (xp.dtype,))
        if bias.shape[0] != Co:
            raise ValueError(f"bias must be ({Co},), got {tuple(bias.shape)}")
    out = torch.empty((B, Co, Hp - 2, Wp - 2), dtype=xp.dtype,
                      device=xp.device)
    # bf16: the zero-border mode of the reflect kernel (reflect = 0)
    route = int(uses_tensor_cores(Co)) if xp.dtype == torch.float32 else 0
    _KERNELS[xp.dtype][0].launch(
        xp.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, Cin,
        Hp, Wp, Co, int(elu), route, stream_handle(xp))
    return out


def _check_cotangent(g, w):
    check_cuda_tensor("g", g, 4, dtypes=DTYPES)
    check_cuda_tensor("w", w, 4, g.device, (g.dtype,))
    if w.shape[0] != g.shape[1] or w.shape[2:] != (3, 3):
        raise ValueError(f"w must be ({g.shape[1]}, Cin, 3, 3), got "
                         f"{tuple(w.shape)}")


@op_span("op:conv3x3.dgrad")
def conv3x3_dgrad_cuda(g, w):
    """d xp (B, Cin, H + 2, W + 2) of the VALID conv. float32 hands the
    kernel `dgrad_weights(w)`; bf16 reads w flipped in its staging."""
    _check_cotangent(g, w)
    B, Co, H, W = g.shape
    Cin = w.shape[1]
    dxp = torch.empty((B, Cin, H + 2, W + 2), dtype=g.dtype, device=g.device)
    if g.dtype == torch.float32:
        wt, route = dgrad_weights(w), int(uses_tensor_cores(Cin))
    else:
        wt, route = w, 0
    _KERNELS[g.dtype][1].launch(
        g.data_ptr(), wt.data_ptr(), dxp.data_ptr(), B, Co, H, W, Cin,
        route, stream_handle(g))
    return dxp


@op_span("op:conv3x3.fwd_reflect")
def conv3x3_reflect_cuda(x, w, bias=None, elu: bool = False):
    """bf16 only: reflect-pad(1) + 3x3 conv (+ bias, + ELU) of x (B, Cin,
    H, W) -> (B, Co, H, W) in one launch, the pad read in the staging."""
    check_cuda_tensor("x", x, 4, dtypes=(torch.bfloat16,))
    B, Cin, H, W = x.shape
    _check_weight(w, Cin, x)
    Co = w.shape[0]
    if bias is not None:
        check_cuda_tensor("bias", bias, 1, x.device, (x.dtype,))
        if bias.shape[0] != Co:
            raise ValueError(f"bias must be ({Co},), got {tuple(bias.shape)}")
    out = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    FWD_BF16.launch(x.data_ptr(), w.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), B, Cin, H, W, Co, int(elu), 1,
                    stream_handle(x))
    return out


@op_span("op:conv3x3.dgrad_reflect")
def conv3x3_dgrad_reflect_cuda(g, w):
    """bf16 only: dx (B, Cin, H, W) of `conv3x3_reflect_cuda` for the
    cotangent g, the pad's adjoint folded in (one launch)."""
    check_cuda_tensor("g", g, 4, dtypes=(torch.bfloat16,))
    _check_cotangent(g, w)
    B, Co, H, W = g.shape
    Cin = w.shape[1]
    dx = torch.empty((B, Cin, H, W), dtype=g.dtype, device=g.device)
    DGRAD_BF16.launch(g.data_ptr(), w.data_ptr(), dx.data_ptr(), B, Co, H, W,
                      Cin, 1, stream_handle(g))
    return dx


# -- autograd ----------------------------------------------------------------
class _Conv3x3Valid(torch.autograd.Function):
    """Kernel D forward and input gradient; the weight gradient by
    `weight_grad`. Saves xp only when the weights need a gradient, and
    the output only for the ELU's backward."""

    @staticmethod
    def forward(ctx, xp, w, bias, elu):
        if on_cuda(xp, "conv3x3_valid"):
            out = conv3x3_valid_cuda(xp, w, bias, elu)
        else:
            out = conv3x3_valid_plain(xp, w, bias, elu)
        ctx.elu = elu
        ctx.save_for_backward(xp if ctx.needs_input_grad[1] else None, w,
                              out if elu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        xp, w, out = ctx.saved_tensors
        if ctx.elu:
            # d elu(z) / dz = 1 above 0, exp(z) = y + 1 at or below it
            g = torch.addcmul(g, g, out.clamp(max=0.0))
        g = g.contiguous()
        dxp = dw = db = None
        if ctx.needs_input_grad[0]:
            if on_cuda(g, "conv3x3_valid"):
                dxp = conv3x3_dgrad_cuda(g, w)
            else:
                dxp = conv3x3_dgrad_plain(g, w)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(xp, w, g)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dxp, dw, db, None


def conv3x3_valid(xp, w, bias=None, elu: bool = False):
    """3x3 VALID conv of a pre-padded (B, Cin, H + 2, W + 2) float32 or
    bfloat16 map with (Co, Cin, 3, 3) weights of the same dtype, plus an
    optional bias and ELU."""
    check_dtype("conv3x3_valid", xp, DTYPES)
    return _Conv3x3Valid.apply(xp.contiguous(), w.contiguous(), bias, elu)


class _Conv3x3Reflect(torch.autograd.Function):
    """bf16 kernel D with the reflect pad folded in: forward and input
    gradient in one launch each; the weight gradient by `weight_grad` on
    `reflect_pad1(x)`, made only when the weights need a gradient. Saves
    x only then, and the output only for the ELU's backward."""

    @staticmethod
    def forward(ctx, x, w, bias, elu):
        if on_cuda(x, "conv3x3_reflect"):
            out = conv3x3_reflect_cuda(x, w, bias, elu)
        else:
            out = conv3x3_reflect_plain(x, w, bias, elu)
        ctx.elu = elu
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                              out if elu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if ctx.elu:
            g = torch.addcmul(g, g, out.clamp(max=0.0))
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if on_cuda(g, "conv3x3_reflect"):
                dx = conv3x3_dgrad_reflect_cuda(g, w)
            else:
                dx = conv3x3_dgrad_reflect_plain(g, w)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(reflect_pad1(x), w, g)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db, None


def conv3x3_reflect(x, w, bias=None, elu: bool = False):
    """Reflect-pad(1) + 3x3 conv (+ bias, + ELU), NCHW / OIHW: kernel D
    when `takes_kernel(Cin, Co)` (bf16 with the pad folded in, float32
    on `reflect_pad1(x)`), else `F.conv2d`."""
    if takes_kernel(x.shape[1], w.shape[0]):
        if x.dtype == torch.bfloat16:
            return _Conv3x3Reflect.apply(x.contiguous(), w.contiguous(),
                                         bias, elu)
        return conv3x3_valid(reflect_pad1(x), w, bias, elu)
    return _epilogue(F.conv2d(reflect_pad1(x), w, bias), elu)
