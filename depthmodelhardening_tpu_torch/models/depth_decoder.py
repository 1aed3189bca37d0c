"""UNet-style Monodepth2 depth decoder (NCHW inside).

Counterpart of the plain branch of `depthmodelhardening_tpu/models/
depth_decoder.py` (Conv3x3/ConvBlock :34-63, DepthDecoder :110-173);
reference DepthNetworks/monodepth2/networks/depth_decoder.py:17-65.
Top-down ConvBlocks (reflect-pad 3x3 conv + ELU), nearest x2 upsample,
encoder skips and float32 sigmoid disparity heads at the requested
scales. The `decoder` ModuleList follows the reference's construction
order (upconv 4..0 x {0, 1}, then dispconv per scale), so a reference
`depth.pth` loads key for key.

The convolutions go through `ops/conv.py`'s dispatch: those with at
most 64 input and output channels (upconv_2..0's narrow ones and the
scale-0..2 heads) run kernel D on the card, with the ConvBlock's bias
and ELU in its epilogue. `forward(features, scales=(0,))` evaluates only
the requested heads (the JAX package's `scales=(0,)` twin,
`training/distill.py:98-111`): the others are skipped, so they get no
gradient and an optimizer step leaves them as they were. The forward
stops after the deepest requested head: a stage above it is not
evaluated (the JAX package gets this from XLA's dead-code elimination,
docs/FIDELITY.md N+0.6), so `scales=(1,)` runs neither upconv_0_0,
upconv_0_1 nor dispconv_0.

Compute dtype (JAX :126-172): the features are cast to `dtype` on the
way in, each conv's float32 weights and bias are cast to it at the call,
and the heads' sigmoid runs in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.conv import conv3x3_reflect
from ..ops.resize import nearest_upsample2
from ..utils.profiling import count_conv
from .resnet import ENCODER_CHANNELS

NUM_CH_DEC = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv (layers.py:121-136)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x, elu: bool = False):
        w = self.conv.weight.to(x.dtype)
        out = conv3x3_reflect(x, w, self.conv.bias.to(x.dtype), elu)
        count_conv(x, w, out, "conv3x3")
        return out


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (layers.py:106-118), the ELU fused into the conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return self.conv(x, elu=True)


def decoder_module_names(scales: Sequence[int]) -> Tuple[str, ...]:
    """ModuleList index -> JAX module name (`depth_decoder.py:374`)."""
    names = []
    for i in range(4, -1, -1):
        names += [f"upconv_{i}_0", f"upconv_{i}_1"]
    return tuple(names) + tuple(f"dispconv_{s}" for s in scales)


class DepthDecoder(nn.Module):
    """forward(features, scales=None, dtype=float32) -> {("disp", s):
    (B, 1, H/2^s, W/2^s) float32} for every s of `scales` (default: all
    the decoder's), computed in `dtype`."""

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

    def forward(self, features, scales: Optional[Sequence[int]] = None,
                dtype: torch.dtype = torch.float32
                ) -> Dict[Tuple[str, int], torch.Tensor]:
        heads = self.scales if scales is None else tuple(scales)
        if not heads or not set(heads) <= set(self.scales):
            raise ValueError(f"scales {heads} not among the decoder's "
                             f"{self.scales}")
        outputs = {}
        x = features[-1].to(dtype)
        for n, i in enumerate(range(4, min(heads) - 1, -1)):
            x = self.decoder[2 * n](x)
            x = nearest_upsample2(x)
            if i > 0:
                x = torch.cat([x, features[i - 1].to(dtype)], dim=1)
            x = self.decoder[2 * n + 1](x)
            if i in heads:
                head = self.decoder[10 + self.scales.index(i)]
                outputs[("disp", i)] = torch.sigmoid(head(x).float())
        return outputs
