"""UNet-style Monodepth2 depth decoder (NCHW inside).

Counterpart of the plain branch of `depthmodelhardening_tpu/models/
depth_decoder.py` (Conv3x3/ConvBlock :34-63, DepthDecoder :110-173);
reference DepthNetworks/monodepth2/networks/depth_decoder.py:17-65.
Top-down ConvBlocks (reflect-pad 3x3 conv + ELU), nearest x2 upsample,
encoder skips and float32 sigmoid disparity heads at the requested
scales. The `decoder` ModuleList follows the reference's construction
order (upconv 4..0 x {0, 1}, then dispconv per scale), so a reference
`depth.pth` loads key for key.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.padding import conv3x3_reflect
from ..ops.resize import nearest_upsample2
from .resnet import ENCODER_CHANNELS

NUM_CH_DEC = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv (layers.py:121-136)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return conv3x3_reflect(x, self.conv.weight, self.conv.bias)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (layers.py:106-118)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


def decoder_module_names(scales: Sequence[int]) -> Tuple[str, ...]:
    """ModuleList index -> JAX module name (`depth_decoder.py:374`)."""
    names = []
    for i in range(4, -1, -1):
        names += [f"upconv_{i}_0", f"upconv_{i}_1"]
    return tuple(names) + tuple(f"dispconv_{s}" for s in scales)


class DepthDecoder(nn.Module):
    """forward(features) -> {("disp", s): (B, 1, H/2^s, W/2^s)}."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 1,
                 num_ch_enc: Sequence[int] = ENCODER_CHANNELS):
        super().__init__()
        self.scales = tuple(scales)
        layers = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            layers.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            layers.append(ConvBlock(cin, NUM_CH_DEC[i]))
        for s in self.scales:
            layers.append(Conv3x3(NUM_CH_DEC[s], num_output_channels))
        self.decoder = nn.ModuleList(layers)

    def forward(self, features) -> Dict[Tuple[str, int], torch.Tensor]:
        outputs = {}
        x = features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * n](x)
            x = nearest_upsample2(x)
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[2 * n + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                outputs[("disp", i)] = torch.sigmoid(head(x).float())
        return outputs
