"""Pose networks (NCHW), in float32.

Counterpart of `depthmodelhardening_tpu/models/pose.py:19-64`
(reference DepthNetworks/monodepth2/networks/pose_decoder.py:14-54 and
pose_cnn.py:13-50). Both emit (axisangle, translation), each of shape
(B, n, 1, 3), scaled by 0.01. The pose encoder is the ResNet trunk with
two frames stacked on its input channels (`models/resnet.py:
ResnetEncoder(num_input_images=2)`).

Module names follow the flax ones (`squeeze`, `pose_0` .. `pose_2`;
`convs_0` .. `convs_6`, `pose_conv`), so `models/convert.py` maps a JAX
state onto these by name; the reference files' `net.<i>` layouts map
onto them there too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import ENCODER_CHANNELS, ResnetEncoder
from .wrappers import flax_init_

POSE_CNN_SPECS = ((16, 7, 2, 3), (32, 5, 2, 2), (64, 3, 2, 1),
                  (128, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1),
                  (256, 3, 2, 1))  # (channels, kernel, stride, padding)


class PoseDecoder(nn.Module):
    """The deepest encoder feature of each input -> (axisangle,
    translation) of `num_frames_to_predict_for` frames (default
    num_input_features - 1)."""

    def __init__(self, num_input_features: int = 1,
                 num_frames_to_predict_for: Optional[int] = 2,
                 stride: int = 1):
        super().__init__()
        if num_frames_to_predict_for is None:
            num_frames_to_predict_for = num_input_features - 1
        self.n_pred = num_frames_to_predict_for
        self.squeeze = nn.Conv2d(ENCODER_CHANNELS[-1], 256, 1)
        self.pose_0 = nn.Conv2d(num_input_features * 256, 256, 3, stride, 1)
        self.pose_1 = nn.Conv2d(256, 256, 3, stride, 1)
        self.pose_2 = nn.Conv2d(256, 6 * self.n_pred, 1)

    def forward(self, input_features):
        """input_features: a list of encoder feature lists (NCHW); only
        the last feature of each is read."""
        cat = torch.cat([F.relu(self.squeeze(f[-1]))
                         for f in input_features], dim=1)
        out = F.relu(self.pose_0(cat))
        out = F.relu(self.pose_1(out))
        out = self.pose_2(out).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.n_pred, 1, 6)
        return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    """The stacked frames (B, 3 * num_input_frames, H, W) -> (axisangle,
    translation) of num_input_frames - 1 frames."""

    def __init__(self, num_input_frames: int = 2):
        super().__init__()
        self.num_input_frames = num_input_frames
        cin = 3 * num_input_frames
        for i, (ch, k, s, p) in enumerate(POSE_CNN_SPECS):
            setattr(self, f"convs_{i}", nn.Conv2d(cin, ch, k, s, p))
            cin = ch
        self.pose_conv = nn.Conv2d(cin, 6 * (num_input_frames - 1), 1)

    def forward(self, x):
        for i in range(len(POSE_CNN_SPECS)):
            x = F.relu(getattr(self, f"convs_{i}")(x))
        x = self.pose_conv(x).mean(dim=(2, 3))
        x = 0.01 * x.reshape(-1, self.num_input_frames - 1, 1, 6)
        return x[..., :3], x[..., 3:]


def make_pose_nets():
    """The trainer's separate-ResNet pose pair (trainer.py:98-116): a
    ResNet-18 encoder of two stacked frames and a decoder of one frame
    pair's transform (JAX `PoseDecoder(num_input_features=1,
    num_frames_to_predict_for=2)`, of which the trainer reads the
    first)."""
    return (ResnetEncoder(18, num_input_images=2),
            PoseDecoder(num_input_features=1, num_frames_to_predict_for=2))


def init_pose_nets(generator: torch.Generator):
    """`make_pose_nets` with flax's default initialisation drawn from
    `generator`, the encoder's first."""
    return tuple(flax_init_(m, generator) for m in make_pose_nets())
