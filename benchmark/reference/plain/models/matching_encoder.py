"""ManyDepth's cost-volume encoder (NCHW inside).

Counterpart of `depthmodelhardening_tpu/models/matching_encoder.py`
(reference DepthNetworks/manydepth2/networks/resnet_encoder.py:112-331).
ResNet stem and layer1 give 1/4-resolution features of the current and
the lookup frames; a plane sweep over `num_depth_bins` depth hypotheses
(linear or inverse binning, :133-155) warps the lookup features through
each hypothesis with the relative pose, takes the channel-mean L1 difference
to the current features, masks 2 pixels at the edges and averages over
the frames that see a pixel (a frame with an all-zero pose is missing).
The confidence-masked volume joins layer1's features, a 3x3 `reduce_conv`
(+ ReLU) brings them back to 64 channels, and layers 2-4 finish the
pyramid. Returns (the five features, lowest_cost (B, h, w): 1 / the depth
of the cheapest bin, confidence (B, h, w)).

As the JAX package computes it:

* The general path stems the current frame and the lookups in one pass,
  so in train mode BatchNorm's statistics span (1 + F) B images;
  `skip_cost_volume` (the zero-lookup hardening path) stems the current
  frame alone and emits the all-missing volume's constants (zero cost
  and confidence, lowest_cost 1 / bins[0]). The two agree in eval mode
  only; each is kept as JAX has it.
* The sweep runs at the features' runtime shape, so an attack's crop
  sweeps at the crop's quarter resolution.
* No gradient reaches the volume (the reference's torch.no_grad, JAX's
  stop_gradient): it is computed under `torch.no_grad`, in float32, and
  joins the trunk in the compute dtype.
* The depth bins round as XLA:CPU's jitted program rounds them:
  linspace(0, 1, D) is iota times the rounded reciprocal of D - 1 (the
  last exactly 1), and a + b t is fused (one rounding, computed here in
  float64). Inverse binning spaces the inverse depths so, from 1 / max
  to 1 / min, reversed, then inverts them; JAX's jitted forward fuses
  that reciprocal with lowest_cost's, which then lies up to an ulp from
  1 / bins here.
* A missing bin (no frame sees it) takes the pixel's largest cost with
  `set_missing_to_max` (the default), else it stays 0.
* Fixed bins (`adaptive_bins=False`, or no endpoints given) run from the
  constructor's `min_depth_bin` to `max_depth_bin` (the reference's
  MIN_DEPTH_BIN .. MAX_DEPTH_BIN by default; a checkpoint's bins for
  JAX's `ManyDepthTrainModel`, `models/wrappers.py:209-224`).
* `prematching_conv` is declared and never applied, as in the
  reference, so checkpoints stay interchangeable.

Departures from the program's module: `reduce_conv` is a plain
`F.conv2d` (the program's goes through its per-call convolution route
and its FLOP record), and the stem's max pool is `ops/pool.py`'s plain
version on every device.

The sweep samples with zero padding (`ops/sampling.py:
bilinear_sample_pixels`), one item's lookup features at every bin's
points, in chunks of bins sized to `SWEEP_ELEMS` sampled values: the
lookup features are never broadcast over the bins.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import reproject_coords
from ..ops.pool import maxpool3x3s2
from ..ops.sampling import bilinear_sample_pixels
from .resnet import _bn, _conv, encoder_channels, make_stage, run_stage

# sampled values (items x bins x pixels x channels) per chunk of the sweep
SWEEP_ELEMS = 2 ** 27
# the fixed bins' endpoints (resnet_encoder.py:121-122), and the adaptive
# bins' before the caller gives its own
MIN_DEPTH_BIN, MAX_DEPTH_BIN = 0.1, 20.0


def linspace01(n: int, device=None) -> torch.Tensor:
    """linspace(0, 1, n) in float32 as XLA:CPU rounds it."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    if n > 1:
        t = t * (torch.tensor(1.0) / torch.tensor(float(n - 1))).item()
        t[-1] = 1.0
    return t


class ResnetEncoderMatching(nn.Module):
    """forward(current (B, 3, H, W), lookup (B, F, 3, H, W), poses (B, F,
    4, 4), K, invK (B, 4, 4) at 1/4 resolution, ...) -> ([f0..f4] NCHW,
    lowest_cost (B, h, w), confidence (B, h, w)); images in [0, 1]."""

    def __init__(self, num_layers: int = 18, input_height: int = 192,
                 input_width: int = 640, num_depth_bins: int = 96,
                 adaptive_bins: bool = False,
                 min_depth_bin: float = MIN_DEPTH_BIN,
                 max_depth_bin: float = MAX_DEPTH_BIN,
                 depth_binning: str = "linear",
                 set_missing_to_max: bool = True):
        super().__init__()
        if depth_binning not in ("linear", "inverse"):
            raise NotImplementedError(depth_binning)
        self.num_layers = num_layers
        self.input_height, self.input_width = input_height, input_width
        self.num_depth_bins = num_depth_bins
        self.adaptive_bins = adaptive_bins
        self.min_depth_bin, self.max_depth_bin = min_depth_bin, max_depth_bin
        self.depth_binning = depth_binning
        self.set_missing_to_max = set_missing_to_max
        ch = encoder_channels(num_layers)
        self.num_ch_enc = ch
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.layer1 = make_stage(num_layers, 0)
        self.prematching_conv = nn.Conv2d(ch[1], 16, 1)
        # JAX's reduce_conv has 64 outputs whatever the depth (:215)
        self.reduce_conv = nn.Conv2d(ch[1] + num_depth_bins, 64, 3, 1, 1)
        self.layer2 = make_stage(num_layers, 1, cin=64)
        self.layer3 = make_stage(num_layers, 2)
        self.layer4 = make_stage(num_layers, 3)

    # -- pieces ---------------------------------------------------------------
    def _stem(self, x, dtype):
        """conv1, bn1, ReLU, the pool and layer1 (resnet_encoder.py:
        104-105, 238-247)."""
        x = ((x - 0.45) / 0.225).to(dtype)
        f0 = F.relu(self.bn1(_conv(self.conv1, x)))
        return f0, run_stage(self.layer1, maxpool3x3s2(f0), False)

    def depth_bins(self, min_bin=None, max_bin=None, device=None):
        """The D hypotheses (resnet_encoder.py:133-155), linearly spaced
        or with linearly spaced inverses: from the constructor's
        endpoints unless `adaptive_bins` and given."""
        if min_bin is None or not self.adaptive_bins:
            min_bin = self.min_depth_bin
        if max_bin is None or not self.adaptive_bins:
            max_bin = self.max_depth_bin
        lo = torch.as_tensor(min_bin, dtype=torch.float32, device=device)
        hi = torch.as_tensor(max_bin, dtype=torch.float32, device=device)
        if self.depth_binning == "inverse":
            lo, hi = 1.0 / hi, 1.0 / lo
        t = linspace01(self.num_depth_bins, device).double()
        spaced = (lo.double() + (hi - lo).double() * t).float()
        if self.depth_binning == "inverse":
            return 1.0 / spaced.flip(0)
        return spaced

    @torch.no_grad()
    def cost_volume(self, cur, lookup, poses, K, invK, bins):
        """The plane-sweep L1 volume (resnet_encoder.py:157-236; JAX
        `_cost_volume`): cur (B, h, w, C), lookup (B, F, h, w, C) float32,
        poses (B, F, 4, 4), K / invK (B, 4, 4), bins (D,). Returns
        (cost (B, D, h, w), missing (B, D, h, w))."""
        B, h, w, C = cur.shape
        D = bins.shape[0]
        dev = cur.device
        total = torch.zeros(B, D, h, w, device=dev)
        seen = torch.zeros(B, D, h, w, device=dev)
        cur_mask = torch.zeros(h, w, device=dev)
        cur_mask[2:-2, 2:-2] = 1.0
        step = max(1, SWEEP_ELEMS // (B * h * w * C))
        for f in range(lookup.shape[1]):
            T = poses[:, f]
            # a frame with an all-zero pose is missing (:190-191)
            present = (T.abs().sum(dim=(1, 2)) > 0).float()
            for d0 in range(0, D, step):
                n = min(step, D - d0)
                depth = bins[d0:d0 + n].view(1, n, 1, 1, 1).expand(
                    B, n, h, w, 1).reshape(B * n, h, w, 1)
                rep = lambda m: m.repeat_interleave(n, dim=0)
                grid = reproject_coords(depth, rep(invK), rep(K), rep(T))
                gx = grid[..., 0].reshape(B, n * h, w)
                gy = grid[..., 1].reshape(B, n * h, w)
                warped = bilinear_sample_pixels(
                    lookup[:, f], (gx + 1.0) * 0.5 * (w - 1),
                    (gy + 1.0) * 0.5 * (h - 1), padding_mode="zeros")
                xs = (gx / 2 + 0.5) * (w - 1)
                ys = (gy / 2 + 0.5) * (h - 1)
                edge = ((xs >= 2.0) & (xs <= w - 2) & (ys >= 2.0)
                        & (ys <= h - 2)).float().view(B, n, h, w)
                diffs = (warped.view(B, n, h, w, C) - cur[:, None]).abs()
                diffs = diffs.mean(dim=-1) * (edge * cur_mask)
                diffs = diffs * present.view(B, 1, 1, 1)
                total[:, d0:d0 + n] += diffs
                seen[:, d0:d0 + n] += (diffs > 0).float()
        cost = total / (seen + 1e-7)
        missing = (cost == 0).float()
        if self.set_missing_to_max:
            cost = cost * (1 - missing) + cost.amax(dim=1,
                                                    keepdim=True) * missing
        return cost, missing

    # -- forward ---------------------------------------------------------------
    def forward(self, current, lookup, poses, K, invK,
                min_depth_bin=None, max_depth_bin=None,
                dtype: torch.dtype = torch.float32,
                skip_cost_volume: bool = False):
        """`skip_cost_volume`: the zero-lookup path, which reads neither
        `lookup` nor `poses` (JAX :129-147)."""
        B = current.shape[0]
        if skip_cost_volume:
            f0, f1 = self._stem(current, dtype)
        else:
            Fn = lookup.shape[1]
            all_f0, all_f1 = self._stem(
                torch.cat([current, lookup.flatten(0, 1)]), dtype)
            f0, f1 = all_f0[:B], all_f1[:B]
        bins = self.depth_bins(min_depth_bin, max_depth_bin, current.device)
        h, w = f1.shape[-2:]
        D = self.num_depth_bins
        if skip_cost_volume:
            cost = torch.zeros(B, D, h, w, device=current.device)
            confidence = torch.zeros(B, h, w, device=current.device)
            lowest_cost = (1.0 / bins[0]).expand(B, h, w)
        else:
            with torch.no_grad():
                nhwc = lambda t: t.float().permute(0, 2, 3, 1)
                lf = nhwc(all_f1[B:]).reshape(B, Fn, h, w, -1)
                cost, missing = self.cost_volume(nhwc(f1), lf, poses, K,
                                                 invK, bins)
                confidence = ((cost * (1 - missing) > 0).float().sum(dim=1)
                              == D).float()
                viz = torch.where(cost == 0, 100.0, cost)
                lowest_cost = 1.0 / bins[viz.argmin(dim=1)]
        masked = (cost * confidence[:, None]).to(dtype)
        fused = torch.cat([f1, masked], dim=1)
        post = F.relu(F.conv2d(fused, self.reduce_conv.weight.to(dtype),
                               self.reduce_conv.bias.to(dtype), padding=1))
        f2 = run_stage(self.layer2, post, False)
        f3 = run_stage(self.layer3, f2, False)
        f4 = run_stage(self.layer4, f3, False)
        return [f0, f1, f2, f3, f4], lowest_cost, confidence
