"""Model assembly: Monodepth2 (encoder + decoder) and the frozen predictor.

Counterpart of `depthmodelhardening_tpu/models/wrappers.py:27-124`
(reference depth_model.py:10-58). Public calls take and return NHWC
tensors, as the JAX package's do; the modules run NCHW inside.

A model carries its compute dtype (`dtype`: float32 or bfloat16;
parameters and BatchNorm statistics stay float32) and whether its
eval-mode passes fold BatchNorm into the convs (`fold_bn`, JAX
`models/resnet.py:_BNFold`), as the JAX module does; the predictors
read those of the model they wrap.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from .depth_decoder import DepthDecoder
from .resnet import ResnetEncoder

LECUN_TRUNC_STD = 0.87962566103423978
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """A compute dtype, given as a torch dtype or its name."""
    dt = DTYPES.get(dtype, dtype)
    if dt not in DTYPES.values():
        raise ValueError(f"compute dtype must be float32 or bfloat16, got "
                         f"{dtype!r}")
    return dt


def _single_head(scales: Sequence[int]) -> int:
    scales = tuple(scales)
    if len(scales) != 1:
        raise ValueError(f"a predictor reads one head, got scales {scales}")
    return scales[0]


class MonodepthModel(nn.Module):
    """encoder + depth decoder; forward(images NHWC) -> disp0 NHWC.

    dtype: the compute dtype (JAX `MonodepthModel.dtype`); fold_bn: fold
    BatchNorm into the convs in eval mode (train-mode passes never fold)."""

    def __init__(self, num_layers: int = 18,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 dtype=torch.float32, fold_bn: bool = False):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.fold_bn = fold_bn
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder(scales=scales)

    def features_and_disps(self, images, scales=None):
        """(features NCHW, {("disp", s): NCHW float32}) for images (B, H,
        W, 3), at `scales` (default: all the decoder's heads); the decoder
        stops after the deepest of them."""
        features = self.encoder(images.permute(0, 3, 1, 2), self.dtype,
                                self.fold_bn)
        return features, self.decoder(features, scales, self.dtype)

    def encode(self, images):
        """The encoder's features (NCHW, shallow to deep) of images (B, H,
        W, 3), in the model's mode: the contrastive branch's benign view
        (JAX `MonodepthModel.encode`)."""
        return self.encoder(images.permute(0, 3, 1, 2), self.dtype,
                            self.fold_bn)

    def forward(self, images, head: int = 0):
        """disp at scale `head` (B, H / 2^head, W / 2^head, 1); no other
        head is evaluated."""
        _, disps = self.features_and_disps(images, (head,))
        return disps[("disp", head)].permute(0, 2, 3, 1)


class DepthPredictor:
    """Frozen depth model: images (B, H, W, 3) -> disp (B, H, W, 1).

    The model runs in eval mode (BatchNorm running statistics), as the
    reference forces during attacks (torchattacks/attack.py:296-320),
    and its parameters do not require gradients, so a backward through
    it computes only the input gradient. It computes in the model's
    dtype and folds BatchNorm as the model says; scales: the one head it
    reads (disp0 by default).
    """

    def __init__(self, model: MonodepthModel, scales=(0,)):
        self.model = model.eval().requires_grad_(False)
        self.head = _single_head(scales)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def __call__(self, images):
        return self.model(images, self.head)


class EvalView:
    """Eval-mode predictor over a trainable model's current weights:
    images (B, H, W, 3) -> disp (B, H / 2^s, W / 2^s, 1) of the one head
    s in `scales`, BatchNorm on running statistics, as `DepthPredictor`,
    but the model stays trainable. The dtype and the fold are the
    model's; the fold is computed from the weights as they are at each
    call, so nothing folded outlives an optimizer step.

    Each call runs the model through `torch.func.functional_call` with
    its parameters detached, so a backward through it computes only the
    input gradient and leaves the parameters' `.grad` alone. (A custom
    `autograd.Function` such as kernel D's fixes `needs_input_grad` when
    its forward runs: with trainable weights every attack pass would
    compute a weight gradient for nothing.) The model's train/eval mode
    is restored after the call. `model` may be rebound: the distillation
    trainer points it at the student of the state it steps.
    """

    def __init__(self, device, model: MonodepthModel = None, scales=(0,)):
        self.device = torch.device(device)
        self.model = model
        self.head = _single_head(scales)

    def __call__(self, images):
        model = self.model
        was_training = model.training
        model.eval()
        try:
            params = {n: p.detach() for n, p in model.named_parameters()}
            return torch.func.functional_call(model, params,
                                              (images, self.head))
        finally:
            model.train(was_training)


def make_monodepth2(num_layers: int = 18,
                    scales: Sequence[int] = (0, 1, 2, 3),
                    dtype=torch.float32, fold_bn: bool = False
                    ) -> MonodepthModel:
    return MonodepthModel(num_layers=num_layers, scales=scales, dtype=dtype,
                          fold_bn=fold_bn)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `module` in place as flax's defaults do, drawing from
    `generator` in `module.modules()` order: lecun-normal conv and dense
    kernels (`nn.initializers.lecun_normal()`: a normal truncated at +-2
    std, its std raised so the variance stays 1 / fan_in), zero biases,
    identity BatchNorm (scale 1, bias 0, running mean 0, running var 1).
    Returns the module."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # the std of a unit normal truncated at +-2 is 0.87962566...
            std = 1.0 / math.sqrt(fan_in) / LECUN_TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


def init_monodepth2(generator: torch.Generator, num_layers: int = 18,
                    scales: Sequence[int] = (0, 1, 2, 3),
                    dtype=torch.float32, fold_bn: bool = False
                    ) -> MonodepthModel:
    """A MonodepthModel with flax's default initialisation drawn from
    `generator` (`flax_init_`)."""
    return flax_init_(make_monodepth2(num_layers, scales, dtype, fold_bn),
                      generator)


def predictor_from(model: MonodepthModel, **kw) -> DepthPredictor:
    """A `DepthPredictor` of `model`; kw: its scales."""
    return DepthPredictor(model, **kw)
