"""ResNet-18/34 feature encoder (NCHW inside).

Counterpart of the plain branch of `depthmodelhardening_tpu/models/
resnet.py` (BasicBlock :73-120, stages :181-230, ResnetEncoder
:341-414); reference DepthNetworks/monodepth2/networks/resnet_encoder.py.
Returns the five feature maps [relu(bn1(conv1)), layer1..layer4] with the
(x - 0.45) / 0.225 input normalisation inside the module. Module and
parameter names are torchvision's, so the reference `encoder.pth` keys
load with their "encoder." prefix removed (models/convert.py).

The stem's 3x3 / stride 2 max pool is the hand-written kernel of
ops/pool.py (equality-routed backward).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pool import maxpool3x3s2

_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
ENCODER_CHANNELS = (64, 64, 128, 256, 512)


def _bn(c: int) -> nn.BatchNorm2d:
    # flax momentum 0.9 == torch momentum 0.1, eps 1e-5
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


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

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResnetEncoder(nn.Module):
    """ResNet trunk returning the 5 multi-scale feature maps (NCHW).

    Input: (B, 3, H, W) in [0, 1], H and W multiples of 32.
    """

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in _STAGES:
            raise NotImplementedError(
                f"ResNet-{num_layers}: only BasicBlock encoders (18, 34) "
                "are ported; Bottleneck ResNets are a later slice")
        self.num_layers = num_layers
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (blocks, width) in enumerate(
                zip(_STAGES[num_layers], (64, 128, 256, 512))):
            stride = 1 if i == 0 else 2
            layer = [BasicBlock(cin, width, stride)]
            layer += [BasicBlock(width, width, 1) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            cin = width

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        x = maxpool3x3s2(f0)
        features = [f0]
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            features.append(x)
        return features
