"""ResNet-18/34/50/101/152 feature encoder (NCHW inside).

Counterpart of the plain branch of `depthmodelhardening_tpu/models/
resnet.py` (BasicBlock :73-120, Bottleneck :123-178, stages :181-222,
ResnetEncoder :341-414); reference DepthNetworks/monodepth2/networks/
resnet_encoder.py. ResNet-50 and deeper use torchvision's Bottleneck
(1x1 -> 3x3 with the stride -> 1x1, 4x expansion), so their features
have `encoder_channels(num_layers)` = (64, 256, 512, 1024, 2048)
channels.
Returns the five feature maps [relu(bn1(conv1)), layer1..layer4] with the
(x - 0.45) / 0.225 input normalisation inside the module. Module and
parameter names are torchvision's, so the reference `encoder.pth` keys
load with their "encoder." prefix removed (models/convert.py).

The stem's 3x3 / stride 2 max pool is the hand-written kernel of
ops/pool.py (equality-routed backward).

Compute dtype (JAX :28-121, :368-412): parameters, BatchNorm statistics
and running averages stay float32; the normalised input is cast to the
compute dtype (`dtype`, float32 or bfloat16) and every activation stays
in it, each conv's weights cast to it at the call. BatchNorm takes the
low-precision activations with its float32 parameters (statistics in
float32, as flax computes them).

`fold_bn` (eval mode only, JAX `_BNFold` :32-61): each BatchNorm is
folded into the conv before it, bn_eval(conv(x, W)) = conv(x, W mul) +
add with mul = scale / sqrt(var + eps) and add = bias - mean mul, both in
float32; W mul is computed in float32 and cast to the compute dtype
(`_folded_conv` :64-70), add is cast to it and added after the conv. The
fold is computed from the parameters and statistics at each forward, so
it follows every optimizer step. Train mode never folds.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pool import maxpool3x3s2
from ..utils.profiling import count_conv

ENCODER_CHANNELS = (64, 64, 128, 256, 512)


def _bn(c: int) -> nn.BatchNorm2d:
    # flax momentum 0.9 == torch momentum 0.1, eps 1e-5
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv(conv: nn.Conv2d, x):
    """`conv` (no bias) in x's dtype: its float32 weights cast to it."""
    w = conv.weight.to(x.dtype)
    y = F.conv2d(x, w, None, conv.stride, conv.padding)
    count_conv(x, w, y)
    return y


def _folded_conv(conv: nn.Conv2d, bn: nn.BatchNorm2d, x):
    """bn_eval(conv(x)) as conv(x, W mul) + add, mul and add in float32
    (JAX `_BNFold`, `_folded_conv`)."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    add = bn.bias - bn.running_mean * mul
    w = (conv.weight * mul[:, None, None, None]).to(x.dtype)
    y = F.conv2d(x, w, None, conv.stride, conv.padding)
    count_conv(x, w, y)
    return y + add.to(x.dtype)[:, None, None]


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 -> 3x3 with identity/projection skip."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))

    def forward(self, x, fold: bool = False):
        """x in the compute dtype; `fold`: BatchNorm folded (eval)."""
        identity = x
        if fold:
            y = F.relu(_folded_conv(self.conv1, self.bn1, x))
            y = _folded_conv(self.conv2, self.bn2, y)
            if self.downsample is not None:
                identity = _folded_conv(self.downsample[0],
                                        self.downsample[1], x)
            return F.relu(y + identity)
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = self.bn2(_conv(self.conv2, y))
        if self.downsample is not None:
            identity = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (the stride) -> 1x1, the last
    conv 4x wider, with identity/projection skip (JAX :123-178)."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, cout, 1, 1, bias=False)
        self.bn3 = _bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))

    def forward(self, x, fold: bool = False):
        """x in the compute dtype; `fold`: BatchNorm folded (eval)."""
        identity = x
        if fold:
            y = F.relu(_folded_conv(self.conv1, self.bn1, x))
            y = F.relu(_folded_conv(self.conv2, self.bn2, y))
            y = _folded_conv(self.conv3, self.bn3, y)
            if self.downsample is not None:
                identity = _folded_conv(self.downsample[0],
                                        self.downsample[1], x)
            return F.relu(y + identity)
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        if self.downsample is not None:
            identity = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + identity)


# blocks a stage and the block (JAX `_STAGES` :181-187)
STAGES = {18: ((2, 2, 2, 2), BasicBlock), 34: ((3, 4, 6, 3), BasicBlock),
          50: ((3, 4, 6, 3), Bottleneck), 101: ((3, 4, 23, 3), Bottleneck),
          152: ((3, 8, 36, 3), Bottleneck)}


def encoder_channels(num_layers: int):
    """The five feature maps' channels: (64, 64, 128, 256, 512), 4x after
    the stem for Bottleneck ResNets (resnet_encoder.py:68, 84-85)."""
    if num_layers not in STAGES:
        raise ValueError(f"ResNet-{num_layers}: num_layers must be one of "
                         f"{sorted(STAGES)}")
    if STAGES[num_layers][1] is BasicBlock:
        return ENCODER_CHANNELS
    return (64,) + tuple(4 * c for c in ENCODER_CHANNELS[1:])


def make_stage(num_layers: int, stage: int, cin: int = None
               ) -> nn.Sequential:
    """ResNet stage `stage` (0 -> layer1, ..., 3 -> layer4; JAX
    `run_stage` :205-222) on `cin` input channels (default: the
    previous stage's): its first block takes the stride and, where the
    channels change, the projection."""
    blocks, block = STAGES[num_layers]
    width = (64, 128, 256, 512)[stage]
    stride = 1 if stage == 0 else 2
    if cin is None:
        cin = encoder_channels(num_layers)[stage]
    cout = width * getattr(block, "expansion", 1)
    layer = [block(cin, width, stride)]
    layer += [block(cout, width, 1) for _ in range(blocks[stage] - 1)]
    return nn.Sequential(*layer)


def run_stage(layer: nn.Sequential, x, fold: bool):
    for block in layer:
        x = block(x, fold)
    return x


class ResnetEncoder(nn.Module):
    """ResNet trunk returning the 5 multi-scale feature maps (NCHW).

    Input: (B, 3 * num_input_images, H, W) in [0, 1], H and W multiples
    of 32: `num_input_images` frames stacked on the channels (2: the pose
    encoder's pair, JAX :341-350). The features come out in the compute
    dtype, with `encoder_channels(num_layers)` channels.
    """

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.num_layers = num_layers
        self.num_input_images = num_input_images
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3,
                               bias=False)
        self.bn1 = _bn(64)
        for i in range(4):
            setattr(self, f"layer{i + 1}", make_stage(num_layers, i))

    def forward(self, x, dtype: torch.dtype = torch.float32,
                fold_bn: bool = False):
        """`dtype`: the compute dtype; `fold_bn`: fold the BatchNorms
        into the convs, in eval mode only."""
        fold = fold_bn and not self.training
        x = ((x - 0.45) / 0.225).to(dtype)
        if fold:
            x = _folded_conv(self.conv1, self.bn1, x)
        else:
            x = self.bn1(_conv(self.conv1, x))
        f0 = F.relu(x)
        x = maxpool3x3s2(f0)
        features = [f0]
        for i in range(1, 5):
            x = run_stage(getattr(self, f"layer{i}"), x, fold)
            features.append(x)
        return features
