"""Model assembly: Monodepth2 (encoder + decoder), ManyDepth's training
model (the cost-volume encoder + decoder) and the frozen predictor.

Counterpart of `depthmodelhardening_tpu/models/wrappers.py:27-302`
(reference depth_model.py:10-134). Public calls take and return NHWC
tensors, as the JAX package's do; the modules run NCHW inside.

A model carries its compute dtype (`dtype`: float32 or bfloat16;
parameters and BatchNorm statistics stay float32) and whether its
eval-mode passes fold BatchNorm into the convs (`fold_bn`, JAX
`models/resnet.py:_BNFold`), as the JAX module does; the predictors
read those of the model they wrap.

Departures from the program's module: no `ManyDepthModel` (the
evaluation wrapper of a reference checkpoint) and no `init_monodepth2`,
which no cell drives.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .depth_decoder import DepthDecoder
from .matching_encoder import (
    MAX_DEPTH_BIN, MIN_DEPTH_BIN, ResnetEncoderMatching,
)
from .resnet import ResnetEncoder, encoder_channels

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
        self.decoder = DepthDecoder(scales=scales,
                                    num_ch_enc=encoder_channels(num_layers))

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


MANYDEPTH_SCALE = 8.6437


def manydepth_rescale(disp):
    """ManyDepth's output rescale (depth_model.py:58)."""
    return disp / MANYDEPTH_SCALE


def _stack_nchw(frames):
    """(B, F, H, W, 3) -> (B, F, 3, H, W)."""
    return frames.permute(0, 1, 4, 2, 3)


class ManyDepthTrainModel(nn.Module):
    """ManyDepth with the hardening trainer's interface (JAX :192-290;
    `MonodepthModel`'s calls): the cost-volume encoder with fixed bins in
    the reference's single-frame mode (zero lookups, through
    `skip_cost_volume`: manydepth2/trainer.py:345-386), the bins fixed at
    min_depth_bin .. max_depth_bin (a checkpoint's; by default the
    reference's MIN_DEPTH_BIN .. MAX_DEPTH_BIN), every disparity
    divided by 8.6437; `encode_multi` / `features_and_disps_multi` build
    the volume from real lookup frames and poses
    (`manydepth_real_lookup`). The intrinsics are Monodepth2's at a
    quarter of the static input size. No BatchNorm fold (the JAX matching
    encoder has none)."""

    def __init__(self, num_layers: int = 18,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 input_height: int = 320, input_width: int = 1024,
                 num_depth_bins: int = 96, dtype=torch.float32,
                 min_depth_bin: float = MIN_DEPTH_BIN,
                 max_depth_bin: float = MAX_DEPTH_BIN):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.encoder = ResnetEncoderMatching(
            num_layers=num_layers, input_height=input_height,
            input_width=input_width, num_depth_bins=num_depth_bins,
            adaptive_bins=False, min_depth_bin=min_depth_bin,
            max_depth_bin=max_depth_bin)
        self.decoder = DepthDecoder(scales=scales,
                                    num_ch_enc=encoder_channels(num_layers))
        K, invK = quarter_intrinsics(MONODEPTH2_K, input_height, input_width,
                                     np.float32)
        self.register_buffer("K", K, persistent=False)
        self.register_buffer("invK", invK, persistent=False)

    def _K(self, B: int):
        return self.K.expand(B, 4, 4), self.invK.expand(B, 4, 4)

    def encode(self, images):
        """The features (NCHW) of images (B, H, W, 3) in the single-frame
        mode."""
        K, invK = self._K(images.shape[0])
        return self.encoder(images.permute(0, 3, 1, 2), None, None, K, invK,
                            dtype=self.dtype, skip_cost_volume=True)[0]

    def encode_multi(self, images, lookup_frames, rel_poses):
        """The features with the volume built from lookup frames (B, F, H,
        W, 3) and current -> lookup transforms rel_poses (B, F, 4, 4)."""
        K, invK = self._K(images.shape[0])
        return self.encoder(images.permute(0, 3, 1, 2),
                            _stack_nchw(lookup_frames), rel_poses, K, invK,
                            dtype=self.dtype)[0]

    def _disps(self, features, scales):
        outs = self.decoder(features, scales, self.dtype)
        return features, {k: manydepth_rescale(v) for k, v in outs.items()}

    def features_and_disps(self, images, scales=None):
        """(features, {("disp", s): NCHW float32 / 8.6437}), single-frame."""
        return self._disps(self.encode(images), scales)

    def features_and_disps_multi(self, images, lookup_frames, rel_poses,
                                 scales=None):
        return self._disps(self.encode_multi(images, lookup_frames,
                                             rel_poses), scales)

    def forward(self, images, head: int = 0):
        """disp at scale `head` (B, H / 2^head, W / 2^head, 1)."""
        _, disps = self.features_and_disps(images, (head,))
        return disps[("disp", head)].permute(0, 2, 3, 1)


# Monodepth2's normalised KITTI intrinsics (kitti_dataset.py:27-30)
MONODEPTH2_K = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def quarter_intrinsics(K_norm, height: int, width: int, dtype=np.float64):
    """Normalised 4x4 intrinsics -> the 1/4-size unnormalised (K, invK),
    float32, scaled and pseudo-inverted in `dtype`: float64 as the
    reference's evaluation loads them (depth_model.py:60-75
    load_and_preprocess_intrinsics), float32 as JAX
    `ManyDepthTrainModel._quarter_K` computes them."""
    K = np.asarray(K_norm, dtype).copy()
    K[0, :] *= width // 4
    K[1, :] *= height // 4
    return (torch.from_numpy(K.astype(np.float32)),
            torch.from_numpy(np.linalg.pinv(K).astype(np.float32)))


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


def predictor_from(model: MonodepthModel, **kw) -> DepthPredictor:
    """A `DepthPredictor` of `model`; kw: its scales."""
    return DepthPredictor(model, **kw)
