"""The reference's precision, and the control's one step below it.

`float32()`: plain float32, TF32 off (on this card a float32 matmul may
otherwise round through TF32). The controls, each the reference computed
in the precision just below the one a configuration states:

- `tf32()`, for a float32 configuration: TF32 on in every matmul and
  convolution;
- `fp8(model)`, for a bfloat16 one: every convolution of `model`'s
  encoder and decoder (the part the configuration computes in bf16) on
  its input and weights rounded through float8 e4m3, each tensor scaled
  by its largest magnitude to e4m3's largest (448), computed in float32;
  the gradient passes straight through the rounding.

`bf16(model)` is no control but the look behind a bfloat16 cell's
noisiest leaves: the same convolutions with their operands rounded
through bfloat16 alone, to show what that rounding does to the reference
by itself.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .plain.models import resnet
from .plain.ops import conv

E4M3_MAX = 448.0


@contextlib.contextmanager
def _tf32(on: bool):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = before


def float32():
    return _tf32(False)


def tf32():
    return _tf32(True)


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 at a per-tensor scale, with the
    gradient of the identity."""
    d = t.detach()
    scale = d.abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (d / scale).to(torch.float8_e4m3fn).to(d.dtype) * scale
    return t + (q - d)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded through bfloat16, with the gradient of the identity."""
    d = t.detach()
    return t + (d.to(torch.bfloat16).to(d.dtype) - d)


class _Functional:
    """torch.nn.functional, but conv2d rounds its operands by `rounding`
    while `on`."""

    def __init__(self, rounding):
        self.on = False
        self.rounding = rounding

    def __getattr__(self, name):
        return getattr(F, name)

    def conv2d(self, x, w, *args, **kwargs):
        if self.on:
            x, w = self.rounding(x), self.rounding(w)
        return F.conv2d(x, w, *args, **kwargs)


def fp8(model):
    """The control of a bfloat16 configuration: `model`'s encoder and
    decoder convolutions in e4m3 while active (`model` the reference's
    student; its other convolutions, the teacher's, stay float32)."""
    return _rounded(model, round_e4m3)


def bf16(model):
    """`model`'s encoder and decoder convolutions on bfloat16-rounded
    operands, computed in float32 (the look, not a control)."""
    return _rounded(model, round_bf16)


@contextlib.contextmanager
def _rounded(model, rounding):
    quant = _Functional(rounding)
    hooks = []
    for part in (model.encoder, model.decoder):
        hooks.append(part.register_forward_pre_hook(
            lambda m, a: setattr(quant, "on", True)))
        hooks.append(part.register_forward_hook(
            lambda m, a, out: setattr(quant, "on", False)))
    orig = resnet.F, conv.F
    resnet.F = conv.F = quant
    try:
        with float32():
            yield
    finally:
        resnet.F, conv.F = orig
        for h in hooks:
            h.remove()
