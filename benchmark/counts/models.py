"""The model family's FLOPs: Monodepth2's ResNet encoders (18: basic
blocks; 50: torchvision bottlenecks) and its depth decoder, at a shape;
and the least time of the convolutions and dense layers a step ran.

`forward_convs` lists each convolution of one forward pass at batch 1
(name, Cin, Co, kernel, output H, output W) from the published
architecture (Godard et al. 2019, `networks/resnet_encoder.py`,
`networks/depth_decoder.py`; torchvision's ResNets), so a test can hold
it to a hand count and a chip run to the shapes the program recorded.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from .peaks import matmul_peak

STAGES = {18: ((2, 2, 2, 2), "basic"), 50: ((3, 4, 6, 3), "bottleneck")}
NUM_CH_DEC = (16, 32, 64, 128, 256)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def encoder_channels(num_layers: int) -> Tuple[int, ...]:
    mult = 1 if STAGES[num_layers][1] == "basic" else 4
    return (64,) + tuple(64 * 2 ** i * mult for i in range(4))


def encoder_convs(num_layers: int, h: int, w: int) -> List[tuple]:
    blocks, kind = STAGES[num_layers]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    convs = [("conv1", 3, 64, 7, h, w)]
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the stem's max pool
    cin = 64
    for stage, n in enumerate(blocks):
        width = 64 * 2 ** stage
        cout = width if kind == "basic" else 4 * width
        for b in range(n):
            s = 2 if stage > 0 and b == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            tag = f"layer{stage + 1}.{b}"
            if kind == "basic":
                convs += [(f"{tag}.conv1", cin, cout, 3, ho, wo),
                          (f"{tag}.conv2", cout, cout, 3, ho, wo)]
            else:
                convs += [(f"{tag}.conv1", cin, width, 1, h, w),
                          (f"{tag}.conv2", width, width, 3, ho, wo),
                          (f"{tag}.conv3", width, cout, 1, ho, wo)]
            if s != 1 or cin != cout:
                convs.append((f"{tag}.downsample", cin, cout, 1, ho, wo))
            cin, h, w = cout, ho, wo
    return convs


def decoder_convs(num_layers: int, h: int, w: int,
                  heads: Sequence[int] = (0, 1, 2, 3)) -> List[tuple]:
    """The decoder's convolutions down to the finest head of `heads`."""
    enc = encoder_channels(num_layers)
    convs = []
    for i in range(4, min(heads) - 1, -1):
        cin = enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
        ch, cw = h >> (i + 1), w >> (i + 1)
        convs.append((f"upconv_{i}_0", cin, NUM_CH_DEC[i], 3, ch, cw))
        cin = NUM_CH_DEC[i] + (enc[i - 1] if i > 0 else 0)
        convs.append((f"upconv_{i}_1", cin, NUM_CH_DEC[i], 3, 2 * ch,
                      2 * cw))
        if i in heads:
            convs.append((f"dispconv_{i}", NUM_CH_DEC[i], 1, 3, 2 * ch,
                          2 * cw))
    return convs


def forward_convs(num_layers: int, h: int, w: int, heads=(0, 1, 2, 3)):
    return encoder_convs(num_layers, h, w) + decoder_convs(num_layers, h, w,
                                                           heads)


def conv_flops(convs: Iterable[tuple], batch: int = 1) -> float:
    """2 operations a multiply-add, over `batch` images."""
    return float(sum(2 * cin * co * k * k * ho * wo
                     for _, cin, co, k, ho, wo in convs)) * batch


def least_seconds(records: Iterable[Tuple[str, str, float, int]]) -> float:
    """The least time of recorded convolutions and dense layers (kind,
    dtype, FLOPs of one pass, passes): each pass's FLOPs at its dtype's
    matrix peak (a backward pass runs in its forward's dtype)."""
    return sum(flops * passes / matmul_peak(dtype)
               for _, dtype, flops, passes in records)
