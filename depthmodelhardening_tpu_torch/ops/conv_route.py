"""The backend of each bf16 convolution pass that no hand-written kernel
runs: cuDNN on its deterministic algorithms, or PyTorch's im2col + GEMM.

The JAX package leaves these convolutions to XLA (`lax.conv`), which
lowers them to cuDNN on a GPU. The port calls `F.conv2d`, whose backend
is a process-wide choice: `device.use_f32_numerics` turns cuDNN off for
the float32 reference's sake (with TF32 off, cuDNN's algorithms were
10-250x slower than im2col at Monodepth2's shapes), which leaves every
convolution on ATen's `slow_conv2d`: a loop over the batch, one im2col
and GEMM a sample forward, one GEMM and col2im a sample for the input
gradient. In bf16 cuDNN is 2-19x faster than that at every shape of the
ResNet-18 and ResNet-50 encoders and the depth decoder, in every pass
but the image stem's forward (PERF.md §6), and its input gradient lies
nearer the float32 result (it sums in float32 and rounds once; im2col
rounds each sample's columns before col2im sums them).

`route(dtype, pass_, kernel, stride, cin, co)` decides, from what a call
can observe, which backend runs one pass ("fwd", "dgrad", "wgrad"):

- float32 (and any dtype but bf16) always takes im2col: the process-wide
  choice stands;
- a bf16 forward on fewer than `IMAGE_CHANNELS` input channels (an
  image: the encoders' 7x7 stems, 3 or 6 channels) takes im2col, 4-7%
  faster than cuDNN there;
- every other bf16 pass takes cuDNN.

Kernel D's forward and input gradient (`ops/conv.py:takes_kernel`) never
reach the route; its weight gradient does (`weight_grad`).

`conv2d(x, w, bias, stride, padding)` is `F.conv2d` routed: the forward
runs under the flags of its route, and its autograd node's backward
under those of the node's, turned on by a pre-hook on the output's
`grad_fn` and off by a hook, so each call site stays one `F.conv2d` in
the autograd graph (and in what the benchmark's FLOP count patches). A
node computes its input and weight gradient together, so it runs on
cuDNN only where every gradient it computes routes there. cuDNN is on
only inside a routed call, never process-wide: `CudnnOn` sets
`enabled`, `deterministic` (phase 18's bit-equal repeat: no atomic
algorithm), no `benchmark` (no timing search) and no TF32, and puts the
previous flags back. On the card x is made contiguous first: cuDNN
returns its output in the input's memory format, and an image permuted
from NHWC is channels-last, whose output the stem's pool would copy
(640 MiB more at a hardening step's peak); im2col's output is NCHW.

Each bf16 pass is counted by route (`passes()`, `reset_passes()`: plain
integers, as `_build`'s launch counters are): the forward at the call,
each gradient in the node's hook when the backward computed it. CPU
tensors take the same logic; the flags change nothing there.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

CUDNN, IM2COL = "cudnn", "im2col"
ROUTES = (CUDNN, IM2COL)
PASSES = ("fwd", "dgrad", "wgrad")
IMAGE_CHANNELS = 8  # below it, a bf16 forward stays on im2col

_passes: collections.Counter = collections.Counter()


def route(dtype: torch.dtype, pass_: str, kernel, stride: int, cin: int,
          co: int) -> str:
    """The backend of one convolution pass: CUDNN or IM2COL. `kernel` is
    (kh, kw); `cin` counts the input channels of one group."""
    if pass_ not in PASSES:
        raise ValueError(f"pass must be one of {PASSES}, got {pass_!r}")
    if dtype != torch.bfloat16:
        return IM2COL
    if pass_ == "fwd" and cin < IMAGE_CHANNELS:
        return IM2COL
    return CUDNN


def passes() -> dict:
    """bf16 convolution passes run since the last reset, by
    "<route>.<pass>"."""
    return {f"{r}.{p}": _passes[f"{r}.{p}"] for r in ROUTES for p in PASSES}


def reset_passes() -> None:
    _passes.clear()


_get = (torch._C._get_cudnn_enabled, torch._C._get_cudnn_benchmark,
        torch._C._get_cudnn_deterministic, torch._C._get_cudnn_allow_tf32)
_set = (torch._C._set_cudnn_enabled, torch._C._set_cudnn_benchmark,
        torch._C._set_cudnn_deterministic, torch._C._set_cudnn_allow_tf32)
_ON = (True, False, True, False)  # enabled, benchmark, deterministic, TF32


class CudnnOn:
    """cuDNN on its deterministic algorithms (no benchmark, no TF32)
    until `off()` or the end of a `with`, then the flags as they were."""

    __slots__ = ("_prev",)

    def on(self) -> None:
        self._prev = tuple(g() for g in _get)
        for s, v in zip(_set, _ON):
            s(v)

    def off(self) -> None:
        for s, v in zip(_set, self._prev):
            s(v)

    def __enter__(self):
        self.on()
        return self

    def __exit__(self, *exc) -> None:
        self.off()


def _pair(v) -> int:
    """A square stride as one int."""
    return v if isinstance(v, int) else v[0]


def _hooked(node, backend: str) -> None:
    """The node's backward under `backend`'s flags, its gradients
    counted."""
    flags = CudnnOn() if backend == CUDNN else None

    def pre(grad_outputs):
        if flags is not None:
            flags.on()

    def post(grad_inputs, grad_outputs):
        if flags is not None:
            flags.off()
        if grad_inputs[0] is not None:
            _passes[f"{backend}.dgrad"] += 1
        if grad_inputs[1] is not None:
            _passes[f"{backend}.wgrad"] += 1
    node.register_prehook(pre)
    node.register_hook(post)


def conv2d(x, w, bias=None, stride=1, padding=0):
    """`F.conv2d(x, w, bias, stride, padding)`, each pass on its route's
    backend where x is bf16 (any other dtype: the plain call)."""
    if x.dtype != torch.bfloat16:
        return F.conv2d(x, w, bias, stride, padding)
    if x.is_cuda:
        x = x.contiguous()
    kernel, s = tuple(w.shape[2:]), _pair(stride)
    cin, co = w.shape[1], w.shape[0]
    fwd = route(x.dtype, "fwd", kernel, s, cin, co)
    if fwd == CUDNN:
        with CudnnOn():
            y = F.conv2d(x, w, bias, stride, padding)
    else:
        y = F.conv2d(x, w, bias, stride, padding)
    _passes[f"{fwd}.fwd"] += 1
    if y.grad_fn is not None:
        grads = [p for p, needed in (("dgrad", x.requires_grad),
                                     ("wgrad", w.requires_grad)) if needed]
        backend = CUDNN if grads and all(
            route(x.dtype, p, kernel, s, cin, co) == CUDNN
            for p in grads) else IM2COL
        _hooked(y.grad_fn, backend)
    return y


def weight_grad(xp, w, g):
    """Gradient of a stride-1 VALID conv of xp by w for the cotangent g
    with respect to w (kernel D's weight gradient), on its route."""
    if xp.dtype != torch.bfloat16:
        return torch.nn.grad.conv2d_weight(xp, w.shape, g)
    backend = route(xp.dtype, "wgrad", tuple(w.shape[2:]), 1, w.shape[1],
                    w.shape[0])
    _passes[f"{backend}.wgrad"] += 1
    if backend == CUDNN:
        with CudnnOn():
            return torch.nn.grad.conv2d_weight(xp, w.shape, g)
    return torch.nn.grad.conv2d_weight(xp, w.shape, g)
