"""Self-supervised monodepth loss assembly (counterpart of
`depthmodelhardening_tpu/training/selfsup.py:35-181`; reference
monodepth2/trainer.py:472-673).

Batch layout (NHWC tensors, frame ids are strings so "s" can join
"-1"/"1"):
  batch["color"][fid], batch["color_aug"][fid]: (B, H, W, 3)
  batch["K"], batch["inv_K"]: (B, 4, 4) intrinsics at scale 0
  batch["stereo_T"]: (B, 4, 4) when "s" is in frame_ids
  poses[fid]: (B, 4, 4) for each temporal frame id, the pose networks'
    transform (`training/hardening.py:HardeningTrainer.predict_poses`);
    those frames warp through the general 2-D sampler, whose gradient
    reaches the poses through the sampling coordinates

The identity automask's tie-break noise is an input here (a standard
normal draw of the identity loss's shape, scaled by 1e-5 inside), so a
test can hand in the JAX package's draw; the trainer draws it from its
own generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.geometry import disp_to_depth, reproject_coords
from ..ops.losses import reprojection_loss, smooth_loss
from ..ops.resize import bilinear_resize
from ..ops.sampling import bilinear_sample_rows, grid_sample
from ..utils import profiling as prof
from .config import SelfSupConfig


def _stereo_is_pure_x(T) -> bool:
    """Whether every stereo_T (B, 4, 4) is a rectified pure x-translation
    (identity rotation, zero y/z translation), the condition under which
    the row-resample warp is exact. Eager tensors are always concrete, so
    the check always runs (it reads T back to the host)."""
    with prof.span(prof.SYNC_READ, {"site": "selfsup.stereo_T"}):
        Tn = T.detach().to("cpu", torch.float64).reshape(-1, 4, 4)
    eye = torch.eye(3, dtype=torch.float64)
    return bool(torch.allclose(Tn[:, :3, :3], eye.expand_as(Tn[:, :3, :3]),
                               rtol=1e-5, atol=1e-6)
                and torch.allclose(Tn[:, 1:3, 3],
                                   torch.zeros_like(Tn[:, 1:3, 3]),
                                   rtol=1e-5, atol=1e-6))


def generate_images_pred(disps, batch, poses, cfg: SelfSupConfig):
    """Warp each source frame into the target view at every scale
    (trainer.py:472-523). disps {scale: (B, h_s, w_s, 1)}; returns
    ({(fid, scale): pred (B, H, W, 3)}, {scale: depth (B, H, W, 1)})."""
    if cfg.v1_multiscale:
        raise NotImplementedError(
            "v1_multiscale: the reference's loss compares full-resolution "
            "targets with scale-resolution warps and fails on shapes "
            "(ROADMAP Queue 3)")
    H, W = cfg.height, cfg.width
    row_path = ("s" in cfg.source_frame_ids and cfg.rectified_stereo
                and _stereo_is_pure_x(batch["stereo_T"]))
    preds, depths = {}, {}
    for scale in cfg.scales:
        disp = bilinear_resize(disps[scale], H, W)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        depths[scale] = depth
        for fid in cfg.source_frame_ids:
            T = batch["stereo_T"] if fid == "s" else poses[fid]
            if fid == "s" and row_path:
                # rectified stereo: R = I and t = (tx, 0, 0), so the
                # sample row is the pixel's own and backproject ->
                # transform -> project collapses to the column
                #   sx = (x * depth + K[0, 0] * tx) / (depth + eps)
                d = depth[..., 0]
                xs = torch.arange(W, dtype=d.dtype, device=d.device)
                fxtx = (batch["K"][:, 0, 0] * T[:, 0, 3])[:, None, None]
                sx = (xs * d + fxtx.to(d.dtype)) / (d + 1e-7)
                preds[(fid, scale)] = bilinear_sample_rows(
                    batch["color"][fid], sx)
            else:
                grid = reproject_coords(depth, batch["inv_K"], batch["K"],
                                        T)
                preds[(fid, scale)] = grid_sample(batch["color"][fid], grid)
    return preds, depths


def compute_selfsup_losses(disps, batch, poses,
                           identity_noise: Optional[torch.Tensor],
                           cfg: SelfSupConfig):
    """Min-reprojection + automask + smoothness loss (trainer.py:588-673).

    disps: {scale: (B, h_s, w_s, 1)} raw sigmoid disparities.
    identity_noise: standard normal draw of the identity loss's shape
      (B, H, W, n_source or 1), or None with disable_automasking.
    Returns (total, aux) with the per-scale losses ("loss/<s>"), the
    scale-0 depth and "selfsup_loss".
    """
    preds, depths = generate_images_pred(disps, batch, poses, cfg)
    target = batch["color"]["0"]
    use_ssim = not cfg.no_ssim

    identity = None
    if not cfg.disable_automasking:
        identity = torch.cat([reprojection_loss(batch["color"][fid], target,
                                                use_ssim=use_ssim)
                              for fid in cfg.source_frame_ids], dim=-1)
        if cfg.avg_reprojection:
            identity = identity.mean(dim=-1, keepdim=True)
        if identity_noise is None or identity_noise.shape != identity.shape:
            raise ValueError(
                f"identity_noise must have shape {tuple(identity.shape)}")
        # break ties against the warped losses (trainer.py:646-648)
        identity = identity + identity_noise * 1e-5

    aux: Dict[str, torch.Tensor] = {"depth": depths[cfg.scales[0]]}
    total = 0.0
    for scale in cfg.scales:
        reproj = torch.cat([reprojection_loss(preds[(fid, scale)], target,
                                              use_ssim=use_ssim)
                            for fid in cfg.source_frame_ids], dim=-1)
        if cfg.avg_reprojection:
            reproj = reproj.mean(dim=-1, keepdim=True)
        combined = reproj if identity is None else torch.cat(
            [identity, reproj], dim=-1)
        # amin splits the gradient evenly among ties, as jnp.min does
        loss = torch.amin(combined, dim=-1).mean()

        disp = disps[scale]
        color = bilinear_resize(target, disp.shape[1], disp.shape[2])
        mean_disp = disp.mean(dim=(1, 2), keepdim=True)
        norm_disp = disp / (mean_disp + 1e-7)
        loss = loss + cfg.disparity_smoothness * \
            smooth_loss(norm_disp, color) / (2 ** scale)

        aux[f"loss/{scale}"] = loss
        total = total + loss

    total = total / len(cfg.scales)
    aux["selfsup_loss"] = total
    return total, aux


def identity_noise_shape(cfg: SelfSupConfig, batch_size: int):
    """Shape of the automask tie-break draw for a batch."""
    n = 1 if cfg.avg_reprojection else len(cfg.source_frame_ids)
    return (batch_size, cfg.height, cfg.width, n)
