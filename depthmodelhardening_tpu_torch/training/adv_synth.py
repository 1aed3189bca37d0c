"""Training batches built on the device from raw frames.

Counterpart of `depthmodelhardening_tpu/training/adv_synth.py:48-230`:
the reference's item pipeline (mono_dataset.py:186-373) on a whole
batch. Two functions build them:

* `build_plain_batch`: the vanilla Monodepth2 batch (resized, flipped
  per item, optional colour jitter on the augmented planes);
* `synthesize_adv_batch`: the hardening batch (MonoDataset.prep_adv_data,
  mono_dataset.py:186-265), per item one (z0, alpha) EoT sample:
  - the current eye's adversarial and benign composites in one tiled
    pair warp; the other eye's benign composite through the 0.54 m
    extrinsic (side "l": identity for frame "0", `stereo_T` for "s";
    side "r" swaps them);
  - "color_ben" is the current eye's benign composite, and so is the
    photometric target ("color", "0"); ("color", "s") is the other eye's
    composite; the model's input ("color_aug", "0") is the adversarial
    one;
  - `half_no_synthesis` keeps a drawn half of the items raw;
  - compositing commutes with a horizontal flip, so the composites are
    flipped after compositing; then everything is resized to the model's
    resolution, with "objmask" and "objdepth" for the `gt_depth` variant
    and the temporal frames passed through.
  The synthesis warps at native resolution (Monodepth2's normalised K,
  not the KITTI calib the attack uses) in a tile of min(248, ...) x
  min(296, ...) pixels around the quad.

Random draws come from a CPU `torch.Generator` or are injected
(`SynthDraws`, `JitterDraws`): the JAX package's draws from its keys can
be handed in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.color import (
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
)
from ..ops.resize import bilinear_resize
from ..physics.eot import (
    ANGLE_RANGE, ORI_H, ORI_W, TRAIN_DIST_RANGE, EoTCompositor, EoTConfig,
    monodepth2_K, stereo_T,
)
from ..utils import profiling as prof
from .config import AdvSynthConfig, SelfSupConfig

JITTER_RANGES = ((0.8, 1.2), (0.8, 1.2), (0.8, 1.2), (-0.1, 0.1))


@dataclasses.dataclass
class JitterDraws:
    """The per-item colour jitter (mono_dataset.py:296-297, 344-350).

    enabled: (B,) bool, each item jittered with p = 0.5
    factors: (B, 4) float32 brightness, contrast, saturation, hue
    """

    enabled: torch.Tensor
    factors: torch.Tensor

    def rows(self, sl: slice) -> "JitterDraws":
        return JitterDraws(self.enabled[sl], self.factors[sl])


@dataclasses.dataclass
class SynthDraws:
    """Every random draw of one `synthesize_adv_batch`.

    z0s, alphas: (B,) float32 EoT samples, one per item (CPU)
    half: (B,) bool, the items synthesised under half_no_synthesis (None
      when it is off)
    jitter: the colour jitter's draws (None without color_aug)
    """

    z0s: torch.Tensor
    alphas: torch.Tensor
    half: Optional[torch.Tensor] = None
    jitter: Optional[JitterDraws] = None

    def rows(self, sl: slice) -> "SynthDraws":
        """The draws of the items `sl` of the batch."""
        return SynthDraws(
            self.z0s[sl], self.alphas[sl],
            None if self.half is None else self.half[sl],
            None if self.jitter is None else self.jitter.rows(sl))


def draw_jitter(generator: torch.Generator, batch: int) -> JitterDraws:
    enabled = torch.rand(batch, generator=generator) < 0.5
    lo = torch.tensor([r[0] for r in JITTER_RANGES])
    hi = torch.tensor([r[1] for r in JITTER_RANGES])
    u = torch.rand(batch, 4, generator=generator)
    return JitterDraws(enabled=enabled, factors=lo + (hi - lo) * u)


def draw_synth(generator: torch.Generator, batch: int,
               adv_cfg: AdvSynthConfig) -> SynthDraws:
    """The draws of one synthesis: (z0, alpha) per item with replacement
    (JAX `jax.random.choice`) from the training ranges, the half mask and
    the jitter as the configuration asks."""
    out = []
    for values in (TRAIN_DIST_RANGE, ANGLE_RANGE):
        vals = torch.as_tensor(np.asarray(values, np.float32))
        out.append(vals[torch.randint(vals.shape[0], (batch,),
                                      generator=generator)])
    half = (torch.rand(batch, generator=generator) < 0.5
            if adv_cfg.half_no_synthesis else None)
    jitter = draw_jitter(generator, batch) if adv_cfg.color_aug else None
    return SynthDraws(z0s=out[0], alphas=out[1], half=half, jitter=jitter)


def make_synth_compositor(obj_h: int, obj_w: int, ori_h: int = ORI_H,
                          ori_w: int = ORI_W) -> EoTCompositor:
    """The dataset side's compositor: projects through Monodepth2's
    normalised intrinsics (mono_dataset.py:169-175), not the KITTI calib
    the attack uses."""
    return EoTCompositor(EoTConfig(
        obj_h=obj_h, obj_w=obj_w, scene_h=ori_h, scene_w=ori_w,
        projection=monodepth2_K(ori_w, ori_h)[:3, :], proj_eps=1e-7))


def _item_where(cond, a, b):
    """a's items where cond (B,) is set, else b's."""
    return torch.where(cond[:, None, None, None], a, b)


def _flip_where(img, do_flip):
    """Flip the W axis of the items of img (B, H, W, C) where do_flip
    (B,) is set."""
    return _item_where(do_flip, img.flip(2), img)


def synth_tile(scene_h: int, scene_w: int):
    """The synthesis' tile (JAX `adv_synth.py:110-111`): sized for the
    closest training distance (the quad spans <= ~230 x 270 pixels at
    z0 >= 5 m at native resolution), clamped to the scene."""
    th = min(248, scene_h - scene_h % 8 if scene_h % 8 else scene_h)
    tw = min(296, scene_w - scene_w % 8 if scene_w % 8 else scene_w)
    return th, tw


def synthesize_adv_batch(eot: EoTCompositor, frames: Dict[str, torch.Tensor],
                         obj_adv, obj_ben, obj_mask, side_is_l, do_flip,
                         draws: SynthDraws, selfsup_cfg: SelfSupConfig,
                         adv_cfg: AdvSynthConfig):
    """The hardening batch's colour planes on the frames' device.

    frames: {fid: (B, ori_h, ori_w, 3)} raw, unflipped, side-resolved
      ("0" the current eye, "s" the other, temporal ids as they are).
    obj_adv, obj_ben: (1, oh, ow, 3); obj_mask: (1, oh, ow, 1).
    side_is_l, do_flip: (B,) bool on the frames' device.
    Returns {"color", "color_aug"} (per fid, model resolution),
    "color_ben", "objmask" and "objdepth" (the z0s, (B,))."""
    H, W = selfsup_cfg.height, selfsup_cfg.width
    B = frames["0"].shape[0]
    dev = frames["0"].device
    z0s, alphas = draws.z0s, draws.alphas

    T_st = torch.from_numpy(stereo_T(adv_cfg.baseline, side="l"))
    with prof.span(prof.SYNC_READ, {"site": "synth.sides"}):
        sel = side_is_l.cpu()[:, None, None]
    T_id = torch.eye(4).expand(B, 4, 4)
    T_cur = torch.where(sel, T_id, T_st)
    T_oth = torch.where(sel, T_st, T_id)

    sh, sw = eot.cfg.scene_h, eot.cfg.scene_w
    th, tw = synth_tile(sh, sw)
    kw = dict(model_h=sh, model_w=sw, tile_h=th, tile_w=tw)
    # the current frame's adversarial and benign composites share the
    # scene and extrinsic: one stacked warp does both
    cur_adv, cur_ben, mask_cur = eot.composite_tiled_pair(
        frames["0"], obj_adv, obj_ben, obj_mask, z0s, alphas, T=T_cur, **kw)
    oth_ben, _ = eot.composite_tiled_model(
        frames["s"], obj_ben, obj_mask, z0s, alphas, T=T_oth, **kw)

    if adv_cfg.half_no_synthesis:
        with prof.host_copy(draws.half, "synth.draws"):
            synth = draws.half.to(dev)
        cur_adv = _item_where(synth, cur_adv, frames["0"])
        cur_ben = _item_where(synth, cur_ben, frames["0"])
        oth_ben = _item_where(synth, oth_ben, frames["s"])
        mask_cur = _item_where(synth, mask_cur, torch.zeros_like(mask_cur))

    resize = lambda t: bilinear_resize(_flip_where(t, do_flip), H, W)
    out = {
        "color": {"0": resize(cur_ben), "s": resize(oth_ben)},
        "color_aug": {"0": resize(cur_adv)},
        "objmask": resize(mask_cur),
    }
    with prof.host_copy(z0s, "synth.draws"):
        out["objdepth"] = z0s.to(device=dev, dtype=torch.float32)
    out["color_ben"] = out["color"]["0"]
    out["color_aug"]["s"] = out["color"]["s"]
    for fid in selfsup_cfg.temporal_source_ids:
        col = resize(frames[fid])
        out["color"][fid] = col
        out["color_aug"][fid] = col
    if adv_cfg.color_aug:
        out = _jitter_aug_planes(out, draws.jitter)
    return out


def _jitter_aug_planes(out, jitter: JitterDraws):
    """Per-item colour jitter of the augmented planes and "color_ben"
    (mono_dataset.py:296-297, 344-350: with p = 0.5 an item, the same
    factors for every frame of the item; "color" is never jittered), in
    the canonical brightness, contrast, saturation, hue order, as the JAX
    package's on-device variant (the reference permutes the order per
    item)."""
    dev = out["color_ben"].device
    with prof.host_copy(jitter.enabled, "synth.draws"):
        enabled = jitter.enabled.to(dev)
    with prof.host_copy(jitter.factors, "synth.draws"):
        f = jitter.factors.to(device=dev, dtype=torch.float32)
    fb, fc, fs = (f[:, i, None, None, None] for i in range(3))
    fh = f[:, 3, None, None]

    def jit_img(img):
        j = adjust_brightness(img, fb)
        j = adjust_contrast(j, fc)
        j = adjust_saturation(j, fs)
        j = adjust_hue(j, fh)
        return _item_where(enabled, j, img)

    out["color_ben"] = jit_img(out["color_ben"])
    out["color_aug"] = {fid: jit_img(img)
                        for fid, img in out["color_aug"].items()}
    return out


def build_plain_batch(frames: Dict[str, torch.Tensor], side_is_l, do_flip,
                      selfsup_cfg: SelfSupConfig,
                      jitter: Optional[JitterDraws] = None):
    """Non-adversarial batch from raw frames {fid: (B, ori_h, ori_w, 3)}:
    each flipped per item and resized to the model's resolution, as both
    "color" and "color_aug" (with `jitter` draws, the colour jitter
    applied to "color_aug": JAX's color_aug=True), plus the per-item
    "stereo_T"."""
    H, W = selfsup_cfg.height, selfsup_cfg.width
    out = {"color": {}, "color_aug": {}}
    for fid in selfsup_cfg.frame_ids:
        col = bilinear_resize(_flip_where(frames[fid], do_flip), H, W)
        out["color"][fid] = col
        out["color_aug"][fid] = col
    if jitter is not None:
        out["color_ben"] = out["color"]["0"]
        out = _jitter_aug_planes(out, jitter)
        out.pop("color_ben")
    out["stereo_T"] = stereo_T_batch(side_is_l, do_flip)
    return out


def stereo_T_batch(side_is_l, do_flip) -> torch.Tensor:
    """Per-item normalised stereo extrinsic (B, 4, 4) for the photometric
    warp (mono_dataset.py:367-373): x-translation 0.1, its sign flipped
    by the side and by a horizontal flip."""
    side_sign = torch.where(side_is_l, -1.0, 1.0)
    baseline_sign = torch.where(do_flip, -1.0, 1.0)
    T = torch.eye(4, device=side_is_l.device).repeat(side_is_l.shape[0], 1, 1)
    T[:, 0, 3] = side_sign * baseline_sign * 0.1
    return T
