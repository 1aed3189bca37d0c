"""The general generator: every input and weight of a run, from the seed.

All of it is made on the run's device from `torch.Generator`s seeded by
the run's seed, in a few large calls: KITTI-like 375x1242 scenes (the
recipe of the program's `data/synthetic.py:make_scene`: a sky gradient,
a road wedge and an 8x8-block texture), the 300x200 car (the recipe of
`make_car_object`), seeded flax-style weights with BatchNorm statistics
calibrated on seeded scenes, and the attack's and the synthesis' draws.
The frames around a scene are made from it with no draw of their own:
the stereo frame by a column shift, the temporal frames by a zoom about
the centre (the camera's forward motion). The same inputs go to the
program and to the reference.
"""

from __future__ import annotations

import math

import torch

LECUN_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2
SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of the run's draws:
    the seed and the stream mixed into 63 bits, so any whole seed (also
    one above 2**32) gives its own streams."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9)
    return torch.Generator(device=device).manual_seed(mixed & SEED_MASK)


def scenes(gen: torch.Generator, n: int, height: int, width: int,
           device) -> torch.Tensor:
    """(n, height, width, 3) float32 road scenes in [0, 1], one texture
    draw for all of them."""
    yn = torch.arange(height, device=device, dtype=torch.float32)[:, None] \
        / height
    xn = torch.arange(width, device=device, dtype=torch.float32)[None, :] \
        / width
    yn, xn = torch.broadcast_tensors(yn, xn)
    sky = torch.stack([0.55 + 0.2 * (1 - yn), 0.65 + 0.2 * (1 - yn),
                       0.8 + 0.15 * (1 - yn)], dim=-1)
    road_mask = (yn > 0.55) & ((xn - 0.5).abs() < 0.05 + 0.8 * (yn - 0.55))
    road = (0.35 + 0.1 * yn)[..., None].expand(height, width, 3)
    base = torch.where(road_mask[..., None], road, sky)
    tex = torch.rand((n, height // 8 + 1, width // 8 + 1, 3), generator=gen,
                     device=device)
    tex = tex.repeat_interleave(8, 1).repeat_interleave(8, 2)
    tex = tex[:, :height, :width]
    return torch.clamp(base * (0.85 + 0.3 * tex), 0.0, 1.0).contiguous()


def car(gen: torch.Generator, width: int, height: int, device):
    """(obj (1, h, w, 3) float32 in [0, 1], mask (1, h, w, 1) binary): a
    car-like silhouette with a smooth texture and seeded noise."""
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    yn, xn = torch.broadcast_tensors(ys / height, xs / width)
    body = (yn > 0.35) & (yn < 0.85) & (xn > 0.05) & (xn < 0.95)
    cabin = (yn > 0.12) & (yn <= 0.35) & (xn > 0.25) & (xn < 0.72)
    wy = (yn - 0.85) * height / width
    wheel1 = (xn - 0.22) ** 2 + wy ** 2 < 0.006
    wheel2 = (xn - 0.78) ** 2 + wy ** 2 < 0.006
    mask = (body | cabin | wheel1 | wheel2).to(torch.float32)
    tau = 6.283
    base = torch.stack([0.55 + 0.25 * torch.sin(tau * (xn + yn)),
                        0.35 + 0.25 * torch.sin(tau * (2 * xn - yn) + 1.3),
                        0.45 + 0.25 * torch.sin(tau * (xn - 2 * yn) + 2.1)],
                       dim=-1)
    noise = torch.rand((height, width, 3), generator=gen, device=device)
    rgb = torch.clamp(base + 0.05 * noise, 0.0, 1.0) * mask[..., None]
    return rgb[None].contiguous(), mask[None, ..., None].contiguous()


@torch.no_grad()
def seeded_init_(module: torch.nn.Module, gen: torch.Generator):
    """flax's default initialisation of `module` (on gen's device), drawn
    in one call: lecun-normal conv and dense kernels (a unit normal cut at
    +-2 std, scaled to variance 1 / fan_in), zero biases, identity
    BatchNorm. Returns the module."""
    convs = [m for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    flat = torch.empty(sum(m.weight.numel() for m in convs),
                       device=convs[0].weight.device)
    torch.nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0, generator=gen)
    at = 0
    for m in convs:
        n = m.weight.numel()
        std = 1.0 / math.sqrt(m.weight[0].numel()) / LECUN_TRUNC_STD
        m.weight.copy_(flat[at:at + n].view_as(m.weight) * std)
        at += n
        if m.bias is not None:
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


@torch.no_grad()
def calibrate_(model, images, forward=None) -> None:
    """Every BatchNorm2d's running statistics set to its batch statistics
    on `images` (B, H, W, 3) at the model's size, in one train-mode
    forward, as a trained model's match its data (the recipe of
    `chip_smoke.py:calibrated_teacher`: identity statistics drive deep
    features to O(100), where bf16 keeps no digit after the point).
    `forward(images)`: that pass, where it is not
    `model.features_and_disps` (the statistics then average over the
    batches of each BatchNorm's calls in it)."""
    was = model.training
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: this one batch
    (forward or model.features_and_disps)(images)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1
    model.train(was)


def stereo_frames(f0: torch.Tensor, shift: int):
    """Frames {"0", "s"}: "s" is "0" shifted by `shift` columns, so the
    stereo warp has real signal."""
    return {"0": f0, "s": torch.roll(f0, shift, dims=2)}


def zoom(f0: torch.Tensor, scale: float) -> torch.Tensor:
    """f0 (B, H, W, 3) magnified by `scale` about the image centre, as a
    camera moving along its axis sees a scene: each output pixel
    bilinearly resampled from the centre plus its offset over `scale`,
    rows then columns, at the border's value outside the image."""
    def taps(n: int):
        c = (n - 1) / 2.0
        x = ((torch.arange(n, device=f0.device, dtype=torch.float64) - c)
             / scale + c).clamp(0.0, n - 1.0)
        lo = x.floor().to(torch.int64)
        hi = (lo + 1).clamp(max=n - 1)
        return lo, hi, (x - lo).to(torch.float32)

    lo, hi, w = taps(f0.shape[1])
    rows = (f0[:, lo] * (1.0 - w)[None, :, None, None]
            + f0[:, hi] * w[None, :, None, None])
    lo, hi, w = taps(f0.shape[2])
    return (rows[:, :, lo] * (1.0 - w)[None, None, :, None]
            + rows[:, :, hi] * w[None, None, :, None]).contiguous()


def temporal_frames(f0: torch.Tensor, fids, zoom_step: float):
    """The temporal frames `fids` ("-1", "1", ...) around "0": frame k is
    "0" zoomed by 1 + k * `zoom_step` (a steady forward ego-motion, so
    the previous frame sees the scene smaller and the next larger); no
    random draw."""
    return {fid: zoom(f0, 1.0 + int(fid) * zoom_step) for fid in fids}


def sides_and_flips(batch: int, device):
    """Sides and flips mixed over the batch (half left, a quarter of
    each side flipped)."""
    idx = torch.arange(batch, device=device)
    return idx % 2 == 0, idx % 4 < 2


def depth_hints(gen: torch.Generator, batch: int, height: int, width: int,
                ori_w: int, shift: int, device):
    """("depth_hint", "depth_hint_mask") (B, H, W, 1): the depth of a
    `shift`-column stereo shift at model resolution, invalid on a seeded
    fifth of the pixels."""
    depth = 0.58 * width * 0.1 / (shift * width / ori_w)
    valid = (torch.rand((batch, height, width, 1), generator=gen,
                        device=device) > 0.2).to(torch.float32)
    return depth * valid, valid
