"""Model assembly: Monodepth2 (encoder + decoder) and the frozen predictor.

Counterpart of `depthmodelhardening_tpu/models/wrappers.py:27-124`
(reference depth_model.py:10-58). Public calls take and return NHWC
tensors, as the JAX package's do; the modules run NCHW inside.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from .depth_decoder import DepthDecoder
from .resnet import ResnetEncoder

LECUN_TRUNC_STD = 0.87962566103423978


class MonodepthModel(nn.Module):
    """encoder + depth decoder; forward(images NHWC) -> disp0 NHWC."""

    def __init__(self, num_layers: int = 18,
                 scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder(scales=scales)

    def features_and_disps(self, images, scales=None):
        """(features NCHW, {("disp", s): NCHW}) for images (B, H, W, 3),
        at `scales` (default: all the decoder's heads)."""
        features = self.encoder(images.permute(0, 3, 1, 2))
        return features, self.decoder(features, scales)

    def forward(self, images):
        """disp0 (B, H, W, 1); the other heads are not evaluated."""
        _, disps = self.features_and_disps(images, scales=(0,))
        return disps[("disp", 0)].permute(0, 2, 3, 1)


class DepthPredictor:
    """Frozen depth model: images (B, H, W, 3) -> disp (B, H, W, 1).

    The model runs in eval mode (BatchNorm running statistics), as the
    reference forces during attacks (torchattacks/attack.py:296-320),
    and its parameters do not require gradients, so a backward through
    it computes only the input gradient.
    """

    def __init__(self, model: MonodepthModel):
        self.model = model.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def __call__(self, images):
        return self.model(images)


class EvalView:
    """Eval-mode predictor over a trainable model's current weights:
    images (B, H, W, 3) -> disp0 (B, H, W, 1), BatchNorm on running
    statistics, as `DepthPredictor`, but the model stays trainable.

    Each call runs the model through `torch.func.functional_call` with
    its parameters detached, so a backward through it computes only the
    input gradient and leaves the parameters' `.grad` alone. (A custom
    `autograd.Function` such as kernel D's fixes `needs_input_grad` when
    its forward runs: with trainable weights every attack pass would
    compute a weight gradient for nothing.) The model's train/eval mode
    is restored after the call. `model` may be rebound: the distillation
    trainer points it at the student of the state it steps.
    """

    def __init__(self, device, model: MonodepthModel = None):
        self.device = torch.device(device)
        self.model = model

    def __call__(self, images):
        model = self.model
        was_training = model.training
        model.eval()
        try:
            params = {n: p.detach() for n, p in model.named_parameters()}
            return torch.func.functional_call(model, params, (images,))
        finally:
            model.train(was_training)


def make_monodepth2(num_layers: int = 18,
                    scales: Sequence[int] = (0, 1, 2, 3)) -> MonodepthModel:
    return MonodepthModel(num_layers=num_layers, scales=scales)


@torch.no_grad()
def init_monodepth2(generator: torch.Generator, num_layers: int = 18,
                    scales: Sequence[int] = (0, 1, 2, 3)) -> MonodepthModel:
    """A MonodepthModel with flax's default initialisation drawn from
    `generator`: lecun-normal conv kernels (`nn.initializers.
    lecun_normal()`: a normal truncated at +-2 std, its std raised so the
    variance stays 1 / fan_in), zero biases, identity BatchNorm (scale 1,
    bias 0, running mean 0, running var 1)."""
    model = make_monodepth2(num_layers, scales)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            # the std of a unit normal truncated at +-2 is 0.87962566...
            std = 1.0 / math.sqrt(fan_in) / LECUN_TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def predictor_from(model: MonodepthModel) -> DepthPredictor:
    return DepthPredictor(model)
