"""The DepthHints family's self-supervised loss (proxy-supervised hints).

Counterpart of `depthmodelhardening_tpu/training/depth_hints.py` (the
reference depth-hints trainer, DepthNetworks/depth-hints/trainer.py:
505-741):

* the stereo frame is warped into the target view through the
  precomputed hint depth (:513-524), as JAX does it: the general 2-D
  sampler with border padding (`ops/sampling.py:grid_sample`); nothing
  in it needs a gradient;
* its reprojection loss (the fused SSIM + L1 kernel C), +1000 where the
  hint is invalid (:634-635), competes in a per-pixel argmin with the
  min-reprojection loss and the min-identity (automask) loss; the hint
  supervises only where it wins (compute_loss_masks :556-591);
* the identity loss is the minimum over the source frames taken as it
  goes, before the tie-break noise (:670-672), so the noise has one
  channel: (B, H, W, 1);
* the reprojection loss is the mean over the pixels the automask keeps,
  and the proxy loss log(|depth - hint| + 1) over valid pixels the hint
  wins is normalised by the number of winners (:706-723);
* contras_loss_wt is 0.1 in this family (trainer.py:617): the caller
  sets it in HardeningConfig, as in JAX;
* `use_depth_hints=False` drops the hint: no warp through it, no third
  candidate in the argmin, no proxy term, what is left being this
  family's reprojection (per-frame minima, the automask's masked mean)
  and smoothness (JAX :47-59). As in JAX, `HardeningConfig(
  use_depth_hints=False)` takes `training/selfsup.py`'s loss instead.

The batch is `training/selfsup.py`'s plus batch["depth_hint"] (B, H, W,
1), the fused SGBM depth (0 where invalid), and batch["depth_hint_mask"]
(B, H, W, 1), its validity.
"""

from __future__ import annotations

import torch

from ..ops.geometry import reproject_coords
from ..ops.losses import abs_jax, reprojection_loss, smooth_loss
from ..ops.resize import bilinear_resize
from ..ops.sampling import grid_sample
from .config import SelfSupConfig
from .selfsup import generate_images_pred


def identity_noise_shape(cfg: SelfSupConfig, batch_size: int):
    """Shape of the automask tie-break draw: the identity minimum's."""
    return (batch_size, cfg.height, cfg.width, 1)


def depth_hint_warp(batch) -> torch.Tensor:
    """The stereo frame warped through the hint depth (trainer.py:
    513-524): (B, H, W, 3)."""
    grid = reproject_coords(batch["depth_hint"], batch["inv_K"], batch["K"],
                            batch["stereo_T"])
    return grid_sample(batch["color"]["s"], grid)


def compute_depth_hints_losses(disps, batch, poses, identity_noise,
                               cfg: SelfSupConfig, mesh=None,
                               use_depth_hints: bool = True):
    """The self-supervised loss with the proxy hint, averaged over scales.

    disps: {scale: (B, h_s, w_s, 1)} sigmoid disparities; poses: {fid:
    (B, 4, 4)} for the temporal frames; identity_noise: a standard normal
    draw of `identity_noise_shape`, or None with disable_automasking.
    mesh: the data-parallel mesh, whose ranks each hold their rows: the
    masked means are then the global batch's (as under JAX's mesh).
    use_depth_hints: False leaves the hint out (the batch then needs no
    depth_hint keys). Returns (total, aux) as `compute_selfsup_losses`
    does."""
    preds, depths = generate_images_pred(disps, batch, poses, cfg)
    target = batch["color"]["0"]
    use_ssim = not cfg.no_ssim

    hint_reproj = None
    if use_depth_hints:
        hint_reproj = reprojection_loss(depth_hint_warp(batch), target,
                                        use_ssim=use_ssim)
        hint_reproj = hint_reproj + 1000.0 * (1.0
                                              - batch["depth_hint_mask"])

    identity = None
    if not cfg.disable_automasking:
        identity = torch.cat([reprojection_loss(batch["color"][fid], target,
                                                use_ssim=use_ssim)
                              for fid in cfg.source_frame_ids], dim=-1)
        # min as it goes (trainer.py:670-672), then the tie-break noise
        identity = torch.amin(identity, dim=-1, keepdim=True)
        if identity_noise is None or identity_noise.shape != identity.shape:
            raise ValueError(
                f"identity_noise must have shape {tuple(identity.shape)}")
        identity = identity + identity_noise * 1e-5

    def denominator(mask):
        """mask's sum + 1e-7; under a mesh the global batch's over the
        world size, so the ranks' mean of sum / denominator is the
        global ratio."""
        if mesh is None:
            return mask.sum() + 1e-7
        return (mesh.all_sum(mask.sum()) + 1e-7) / mesh.world_size

    aux = {"depth": depths[cfg.scales[0]]}
    total = 0.0
    for scale in cfg.scales:
        reproj = torch.amin(torch.cat(
            [reprojection_loss(preds[(fid, scale)], target,
                               use_ssim=use_ssim)
             for fid in cfg.source_frame_ids], dim=-1), dim=-1, keepdim=True)

        # the 3-way argmin masks (compute_loss_masks, trainer.py:556-591):
        # reprojection, identity (where automasking), hint (where used)
        stack = [reproj] + [t for t in (identity, hint_reproj)
                            if t is not None]
        reproj_mask = torch.ones_like(reproj)
        if len(stack) > 1:
            idxs = torch.argmin(torch.cat(stack, dim=-1).detach(), dim=-1,
                                keepdim=True)
            if identity is not None:
                reproj_mask = (idxs != 1).to(reproj.dtype)

        loss = (reproj * reproj_mask).sum() / denominator(reproj_mask)
        if hint_reproj is not None:
            hint_mask = (idxs == len(stack) - 1).to(reproj.dtype)
            hint_loss = torch.log(
                abs_jax(batch["depth_hint"] - depths[scale]) + 1.0) \
                * batch["depth_hint_mask"] * hint_mask
            loss = loss + hint_loss.sum() / denominator(hint_mask)

        disp = disps[scale]
        color = (bilinear_resize(target, disp.shape[1], disp.shape[2])
                 if disp.shape[1:3] != target.shape[1:3] else target)
        mean_disp = disp.mean(dim=(1, 2), keepdim=True)
        loss = loss + cfg.disparity_smoothness * smooth_loss(
            disp / (mean_disp + 1e-7), color) / (2 ** scale)

        aux[f"loss/{scale}"] = loss
        total = total + loss

    total = total / len(cfg.scales)
    aux["selfsup_loss"] = total
    return total, aux
