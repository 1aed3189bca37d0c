"""The hardening trainer; so far its non-adversarial self-supervised step.

Counterpart of `depthmodelhardening_tpu/training/hardening.py:55-258,
392-472` (reference monodepth2/trainer.py). One step of plain
self-supervised stereo training (the CLI's `train-hardening
--no-adv-train`, BASELINE config 2):

  1. the batch, on the device: raw frames flipped per item and resized
     to the model's resolution, with the per-item stereo extrinsic
     (`training/adv_synth.py:build_plain_batch`);
  2. Monodepth2 forward in train mode (BatchNorm on batch statistics,
     running statistics updated);
  3. min-reprojection + automask + smoothness over 4 scales
     (`training/selfsup.py`, the fused SSIM + L1 kernel);
  4. backward, then Adam with the StepLR-equivalent staircase schedule
     (trainer.py:140-142).

The state is a model and its optimizer, updated in place; the step
methods also return it, as the JAX package's do. The adversarial step
and the other branches of `_losses` raise NotImplementedError and name
their ROADMAP item.

BatchNorm: torch's BatchNorm2d (the reference's) updates the running
variance with the unbiased batch variance, flax with the biased one, so
after a step the running variances differ by the factor n / (n - 1) of
the batch update (n = B * H * W of the layer). Normalisation, loss and
gradients are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.wrappers import (
    MonodepthModel, init_monodepth2, make_monodepth2,
)
from ..physics.eot import monodepth2_K
from .adv_synth import build_plain_batch
from .config import HardeningConfig
from .selfsup import compute_selfsup_losses, identity_noise_shape

_LATER = {
    "adversarial": "ROADMAP Queue 1, slice 5 (full hardening, config 4)",
    "model_family": "ROADMAP Queue 1, slice 6 (ManyDepth)",
    "depth_hints": "ROADMAP Queue 1, slice 6 (DepthHints)",
}


@dataclasses.dataclass
class TrainState:
    """The student (train mode), its Adam optimizer, and the number of
    steps taken."""

    model: MonodepthModel
    optimizer: torch.optim.Adam
    step: int = 0


def _scaled_K(height: int, width: int):
    """Normalized Monodepth2 K scaled to model resolution, and its
    pseudo-inverse (mono_dataset.py:332-342)."""
    K = monodepth2_K(width=width, height=height)
    return K, np.linalg.pinv(K).astype(np.float32)


def _refuse_unported(cfg: HardeningConfig) -> None:
    checks = (
        (cfg.supervised_adv, "supervised_adv=True (the teacher's MSE)",
         "adversarial"),
        (cfg.contrastive_learning, "contrastive_learning=True (SimSiam)",
         "adversarial"),
        (cfg.no_original_train, "no_original_train=True", "adversarial"),
        (cfg.selfsup.use_pose_net,
         f"temporal frame ids {cfg.selfsup.temporal_source_ids} (pose "
         "networks)", "adversarial"),
        (cfg.use_depth_hints, "use_depth_hints=True", "depth_hints"),
        (cfg.model_family != "monodepth2" or cfg.manydepth_real_lookup,
         f"model_family={cfg.model_family!r}", "model_family"),
    )
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet ({_LATER[item]})")


class HardeningTrainer:
    """The hardening recipe's trainer on one device.

    generator: CPU `torch.Generator` for the from-scratch initialisation
      (flax's: truncated lecun-normal kernels, identity BatchNorm) and the
      seed of the device generator that draws the automask tie-break
      noise.
    device: where the state lives and the step runs; default the current
      CUDA card (`device.require_cuda`, which raises without one). Tests
      pass "cpu" to run the plain versions of the kernels.
    init_state_dict: the student's weights instead (e.g. converted with
      `models/convert.py`), as --fine-tune does.
    """

    def __init__(self, cfg: HardeningConfig, generator: torch.Generator,
                 device=None, steps_per_epoch: int = 1000,
                 init_state_dict: Optional[Mapping] = None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        ss = cfg.selfsup
        if init_state_dict is None:
            model = init_monodepth2(generator, cfg.num_layers, ss.scales)
            init_state_dict = model.state_dict()
        self._init_state_dict = {k: v.detach().cpu().clone()
                                 for k, v in init_state_dict.items()}
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self.noise_generator = torch.Generator(self.device).manual_seed(seed)
        K, inv_K = _scaled_K(ss.height, ss.width)
        self._K = torch.from_numpy(K).to(self.device)
        self._inv_K = torch.from_numpy(inv_K).to(self.device)
        # StepLR(step_size, gamma) per epoch == optax.exponential_decay
        # with staircase=True over optimizer steps (trainer.py:141-142)
        self.transition_steps = steps_per_epoch * cfg.scheduler_step_size

    # -- state ----------------------------------------------------------------
    def make_state(self) -> TrainState:
        """A fresh student from the initial weights, in train mode, with
        a new Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root:
        optax.adam's)."""
        model = make_monodepth2(self.cfg.num_layers, self.cfg.selfsup.scales)
        model.load_state_dict(self._init_state_dict)
        model = model.to(self.device).train()
        opt = torch.optim.Adam(model.parameters(), lr=self.learning_rate(0),
                               betas=(0.9, 0.999), eps=1e-8)
        return TrainState(model=model, optimizer=opt, step=0)

    def student_variables(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The student's weights and BatchNorm statistics (a state dict)."""
        return state.model.state_dict()

    def learning_rate(self, step: int) -> float:
        return self.cfg.learning_rate * self.cfg.scheduler_gamma ** (
            step // self.transition_steps)

    # -- batch and loss -------------------------------------------------------
    def plain_batch(self, frames, side_is_l, do_flip):
        """The non-adversarial batch of raw frames {fid: (B, ori_h, ori_w,
        3)} on the trainer's device, with K and inv_K."""
        batch = build_plain_batch(frames, side_is_l, do_flip,
                                  self.cfg.selfsup,
                                  color_aug=self.cfg.adv.color_aug)
        B = frames["0"].shape[0]
        batch["K"] = self._K.expand(B, 4, 4)
        batch["inv_K"] = self._inv_K.expand(B, 4, 4)
        return batch

    def draw_identity_noise(self, batch_size: int) -> torch.Tensor:
        return torch.randn(identity_noise_shape(self.cfg.selfsup,
                                                batch_size),
                           generator=self.noise_generator,
                           device=self.device)

    def disparities(self, model, batch) -> Dict[int, torch.Tensor]:
        """The student's sigmoid disparities {scale: (B, h_s, w_s, 1)} of
        batch["color_aug"]["0"]."""
        _, outs = model.features_and_disps(batch["color_aug"]["0"])
        return {s: outs[("disp", s)].permute(0, 2, 3, 1)
                for s in self.cfg.selfsup.scales}

    def _losses(self, model, batch, identity_noise
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        disps = self.disparities(model, batch)
        selfsup, _ = compute_selfsup_losses(disps, batch, {}, identity_noise,
                                            self.cfg.selfsup)
        return selfsup, {"selfsup_loss": selfsup, "loss": selfsup}

    # -- steps ----------------------------------------------------------------
    def _apply_grads(self, state: TrainState) -> None:
        for group in state.optimizer.param_groups:
            group["lr"] = self.learning_rate(state.step)
        state.optimizer.step()
        state.step += 1

    def selfsup_step(self, state: TrainState, batch,
                     identity_noise: Optional[torch.Tensor] = None):
        """One non-adversarial self-supervised step on a built batch
        (color / color_aug / K / inv_K / stereo_T). identity_noise: the
        automask's standard normal tie-break draw, drawn from the
        trainer's generator when None. Returns (state, metrics)."""
        if identity_noise is None:
            identity_noise = self.draw_identity_noise(
                batch["color"]["0"].shape[0])
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = self._losses(state.model, batch, identity_noise)
        total.backward()
        self._apply_grads(state)
        return state, {k: v.detach() for k, v in metrics.items()}

    def selfsup_frames_step(self, state: TrainState, frames, side_is_l,
                            do_flip,
                            identity_noise: Optional[torch.Tensor] = None):
        """The plain self-supervised step straight from raw frames
        {fid: (B, ori_h, ori_w, 3)} with per-item side_is_l / do_flip
        (B,) bool: batch building on the device, then `selfsup_step`."""
        return self.selfsup_step(
            state, self.plain_batch(frames, side_is_l, do_flip),
            identity_noise)

    def train_step(self, *args, **kwargs):
        raise NotImplementedError(
            f"the adversarial hardening step is not ported yet "
            f"({_LATER['adversarial']})")

    def evaluate_attacks(self, *args, **kwargs):
        raise NotImplementedError(
            f"the in-training robustness eval is not ported yet "
            f"({_LATER['adversarial']})")
