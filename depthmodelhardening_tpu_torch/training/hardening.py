"""The ICLR'23 hardening trainer (BASELINE config 4) and its plain
self-supervised step (config 2).

Counterpart of `depthmodelhardening_tpu/training/hardening.py:55-517`
(reference monodepth2/trainer.py:45-812). One hardening step
(`train_step`; JAX `_step` :399-423):

  1. texture refresh: the attack (`cfg.adv.norm_type` "l_0", the
     recipe's, or "l_inf") re-optimises the shared adversarial texture
     against the student as it is now, in eval mode on detached weights
     (`EvalView`, disp0 only, BatchNorm folded when `cfg.fold_bn`), on
     `attack_batch_size` replicated scenes (trainer.py:300-307);
  2. synthesis: the stereo-consistent adversarial / benign batch at
     native resolution, resized to the model's
     (`training/adv_synth.py:synthesize_adv_batch`), with K, inv_K and
     the per-item stereo_T;
  3. losses (`_losses`; trainer.py:525-673), each branch as configured:
       sup    = MSE(the frozen teacher's disp0 of "color_ben", the
                student's disp0) [or the --gt_depth pseudo-depth form];
       contra = SimSiam between the encoder features of the adversarial
                view (the student's forward) and of "color_ben" (a
                second train-mode encode, its BatchNorm statistics
                updated after the forward's, in JAX's order);
       photo  = min-reprojection + automask + smoothness over 4 scales
                (`training/selfsup.py`, the fused SSIM + L1 kernel);
     with temporal frame ids (mono or mono+stereo, e.g. ("0", "-1", "1",
     "s")), the pose networks in train mode give each temporal source's
     transform (`predict_poses`; trainer.py:377-433, "separate_resnet"),
     and its warp's gradient reaches them through the sampling
     coordinates;
  4. backward, then Adam over the student, the SimSiam head and the pose
     networks with the StepLR-equivalent staircase (trainer.py:140-142).

The non-adversarial step (`selfsup_step`, `selfsup_frames_step`, the
CLI's --no-adv-train) is steps 2-4 on a plain batch.

The model families (BASELINE config 5; JAX hardening.py:85-148):
`num_layers` 50/101/152 builds Bottleneck ResNets; `use_depth_hints`
takes the DepthHints loss (`training/depth_hints.py`: the hint's planes
"depth_hint" and "depth_hint_mask", (B, H, W, 1) at model resolution
and already flipped with their items, ride in the frames and join the
batch; the automask noise has one channel); `model_family="manydepth"`
trains `ManyDepthTrainModel` in the reference's single-frame mode, and
with `manydepth_real_lookup` builds its cost volume from the first
temporal source frame and the pose networks' transform (poses first,
then the student's forward and the benign encode on that lookup). The
ManyDepth student's attack view folds nothing (the JAX matching encoder
has no fold).

The state is a model, the SimSiam head, the pose networks and their
optimizer, updated in place; the step methods also return it, as the JAX
package's do (`training/checkpoints.py` saves and restores it). Random
draws come from the trainer's CPU generator (the automask noise from a
device generator seeded from it), or are injected (`StepDraws`).

Compute dtype (`cfg.compute_dtype`, JAX hardening.py:88-115): the
student computes in it, and so does its attack view; parameters and
statistics stay float32, the disparities come out of the heads in
float32 (so kernels C and A see float32), SimSiam casts the features to
float32, and the pose networks are float32, as the JAX trainer builds
them. The teacher is whatever the caller built.

BatchNorm: torch's BatchNorm2d / 1d (the reference's) update the running
variance with the unbiased batch variance, flax with the biased one, so
after a step the running variances differ by the factor n / (n - 1) of
the batch updates (n = the values per channel of the layer's batch).
Normalisation, loss and gradients are the same.

Data parallelism (`mesh=`, JAX hardening.py:80-82, 256-257, 455-471): a
step under a mesh is the one-process step on the global batch. Each
process passes its rows of the frames and its share of the attack
scenes; the draws are the global batch's (drawn alike on every rank, or
injected whole) and each rank keeps its rows. The state is replicated
from rank 0, its BatchNorms normalise over the global batch
(`parallel/batchnorm.py`), the attack averages its texture gradient over
the ranks at every iteration (so every rank holds the same texture, and
the L0 break fires on all of them at once), and `_update` averages the
gradients and the metrics. DistributedDataParallel is not used: a step
calls the student several times, and the unused heads get no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..attacks.base import PhysObjAttackConfig
from ..attacks.l0_object import L0Draws, L0ObjectAttack
from ..attacks.pgd_object import PGDDraws, PGDObjectAttack
from ..device import resolve_device
from ..models.pose import PoseDecoder, init_pose_nets, make_pose_nets
from ..models.resnet import ResnetEncoder, encoder_channels
from ..models.simsiam import SimSiam, init_simsiam
from ..models.wrappers import (
    EvalView, ManyDepthTrainModel, MonodepthModel, flax_init_,
    make_monodepth2,
)
from ..ops.geometry import disp_to_depth, transformation_from_parameters
from ..parallel.batchnorm import global_batchnorm
from ..parallel.mesh import Mesh, replicate
from ..physics.eot import TRAIN_DIST_RANGE, monodepth2_K
from .adv_synth import (
    SynthDraws, build_plain_batch, draw_jitter, draw_synth,
    make_synth_compositor, stereo_T_batch, synthesize_adv_batch,
)
from . import depth_hints
from .config import HardeningConfig
from .selfsup import compute_selfsup_losses, identity_noise_shape

FAMILIES = ("monodepth2", "manydepth")


def make_family_model(cfg: HardeningConfig, dtype="float32",
                      fold_bn: bool = False):
    """A new model of cfg's family and depth, at cfg's size (ManyDepth's
    intrinsics) and scales, in `dtype`: a ManyDepthTrainModel or a
    Monodepth2 (folding its eval-mode BatchNorm when `fold_bn`). The
    student and, in the caller's hands, the teacher."""
    ss = cfg.selfsup
    if cfg.model_family == "manydepth":
        return ManyDepthTrainModel(
            num_layers=cfg.num_layers, scales=ss.scales,
            input_height=ss.height, input_width=ss.width,
            num_depth_bins=cfg.manydepth_num_depth_bins, dtype=dtype)
    return make_monodepth2(cfg.num_layers, ss.scales, dtype=dtype,
                           fold_bn=fold_bn)


@dataclasses.dataclass
class TrainState:
    """The student (train mode), the SimSiam head (with the contrastive
    branch), the pose encoder and decoder (with temporal frame ids), their
    one Adam optimizer, and the number of steps taken."""

    model: Union[MonodepthModel, ManyDepthTrainModel]
    optimizer: torch.optim.Adam
    step: int = 0
    simsiam: Optional[SimSiam] = None
    pose_encoder: Optional[ResnetEncoder] = None
    pose_decoder: Optional[PoseDecoder] = None

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The trained modules present, by name, in the optimizer's
        parameter order: "model", "simsiam", "pose_encoder",
        "pose_decoder"."""
        named = {"model": self.model, "simsiam": self.simsiam,
                 "pose_encoder": self.pose_encoder,
                 "pose_decoder": self.pose_decoder}
        return {k: m for k, m in named.items() if m is not None}


@dataclasses.dataclass
class StepDraws:
    """Every random draw of one `train_step`: the attack's (`L0Draws` or
    `PGDDraws`), the synthesis' and the automask's standard normal
    tie-break noise (None: drawn from the trainer's device generator)."""

    attack: Union[L0Draws, PGDDraws]
    synth: SynthDraws
    identity_noise: Optional[torch.Tensor] = None


def _scaled_K(height: int, width: int):
    """Normalized Monodepth2 K scaled to model resolution, and its
    pseudo-inverse (mono_dataset.py:332-342)."""
    K = monodepth2_K(width=width, height=height)
    return K, np.linalg.pinv(K).astype(np.float32)


def _check_family(cfg: HardeningConfig) -> None:
    """JAX's refusals (hardening.py:89-97), and an unknown family."""
    if cfg.model_family not in FAMILIES:
        raise ValueError(f"model_family must be one of {FAMILIES}, got "
                         f"{cfg.model_family!r}")
    if cfg.manydepth_real_lookup:
        if cfg.model_family != "manydepth":
            raise ValueError("manydepth_real_lookup requires "
                             "model_family='manydepth'")
        if not cfg.selfsup.use_pose_net:
            raise ValueError(
                "manydepth_real_lookup needs monocular frame_ids (a "
                "previous frame + pose net supply the lookup)")


class HardeningTrainer:
    """The hardening recipe's trainer on one device.

    generator: CPU `torch.Generator` of the from-scratch initialisation
      (flax's: truncated lecun-normal kernels, identity BatchNorm), of the
      SimSiam head's and the pose networks', of the host draws (attack,
      synthesis, jitter) and of the seed of the device generator that
      draws the automask noise.
    obj_img (1, h, w, 3), obj_mask (1, h, w, 1): the attacked texture.
    teacher: the frozen `DepthPredictor` of the supervised branch
      (trainer.py:93-95 gt_model); required when cfg.supervised_adv.
    device: where the state lives and the step runs; default the current
      CUDA card (`device.require_cuda`, which raises without one). Tests
      pass "cpu" to run the plain versions of the kernels.
    init_state_dict: the student's weights instead (e.g. converted with
      `models/convert.py`), as --fine-tune does; the head and the pose
      networks start from the generator's draws all the same, as the
      JAX trainer's do under --fine-tune.
    mesh: the data-parallel `parallel.mesh.Mesh` (its device is the
      trainer's); cfg.batch_size and cfg.adv.attack_batch_size, the
      global batches, must divide by its world size. Every rank builds
      its trainer from the same generator seed.
    """

    def __init__(self, cfg: HardeningConfig, generator: torch.Generator,
                 obj_img, obj_mask, teacher=None, device=None,
                 steps_per_epoch: int = 1000,
                 init_state_dict: Optional[Mapping] = None,
                 mesh: Optional[Mesh] = None):
        if cfg.supervised_adv and teacher is None:
            raise ValueError("supervised_adv requires a frozen teacher")
        _check_family(cfg)
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            mesh.rows(cfg.batch_size, "batch_size")
            mesh.rows(cfg.adv.attack_batch_size, "attack_batch_size")
            device = mesh.own_device(device)
        self.device = resolve_device(device)
        self.teacher = teacher
        self.generator = generator
        ss = cfg.selfsup
        if init_state_dict is None:
            init_state_dict = flax_init_(self.make_student(),
                                         generator).state_dict()
        self._init_state_dict = _cpu_copy(init_state_dict)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self.noise_generator = torch.Generator(self.device).manual_seed(seed)
        self._init_simsiam = None
        if cfg.contrastive_learning:
            self._init_simsiam = _cpu_copy(init_simsiam(
                generator, in_dim=self._feature_dim()).state_dict())
        self._init_pose = None
        if ss.use_pose_net:
            self._init_pose = tuple(_cpu_copy(m.state_dict())
                                    for m in init_pose_nets(generator))
        K, inv_K = _scaled_K(ss.height, ss.width)
        self._K = torch.from_numpy(K).to(self.device)
        self._inv_K = torch.from_numpy(inv_K).to(self.device)
        # StepLR(step_size, gamma) per epoch == optax.exponential_decay
        # with staircase=True over optimizer steps (trainer.py:141-142)
        self.transition_steps = steps_per_epoch * cfg.scheduler_step_size
        self._eval_attacks = {}
        self._build_attack(obj_img, obj_mask)
        if mesh is not None:
            self.attack.grad_mean = mesh.all_mean

    def _build_attack(self, obj_img, obj_mask) -> None:
        """The attack on the student (trainer.py:224), at the train-time
        distance range (mono_dataset.py:149-158), reading disp0 of an
        eval view of the student as it is at each call; and the dataset
        side's compositor."""
        cfg, ss = self.cfg, self.cfg.selfsup
        self.obj_img = torch.as_tensor(obj_img, dtype=torch.float32,
                                       device=self.device)
        self.obj_mask = torch.as_tensor(obj_mask, dtype=torch.float32,
                                        device=self.device)
        oh, ow = self.obj_img.shape[1:3]
        self.synth_eot = make_synth_compositor(oh, ow, cfg.adv.ori_h,
                                               cfg.adv.ori_w)
        self.student_view = EvalView(self.device)
        atk_cfg = PhysObjAttackConfig(
            obj_h=oh, obj_w=ow,
            dist_range=tuple(float(x) for x in TRAIN_DIST_RANGE),
            scene_h=ss.height, scene_w=ss.width,
            ori_h=cfg.adv.ori_h, ori_w=cfg.adv.ori_w,
            tile_h=cfg.adv.tile_h, tile_w=cfg.adv.tile_w,
            attack_crop_w=cfg.adv.attack_crop_w,
            attack_crop_h=cfg.adv.attack_crop_h,
            attack_scale=cfg.adv.attack_scale,
            attack_scale_fine_steps=cfg.adv.attack_scale_fine_steps,
            attack_view_dtype=cfg.adv.attack_view_dtype)
        if cfg.adv.norm_type == "l_inf":
            self.attack = PGDObjectAttack(
                self.student_view, self.obj_img, self.obj_mask, atk_cfg,
                eps=cfg.adv.epsilon, alpha=cfg.adv.alpha,
                steps=cfg.adv.steps)
        elif cfg.adv.norm_type == "l_0":
            self.attack = L0ObjectAttack(
                self.student_view, self.obj_img, self.obj_mask, atk_cfg,
                adam_lr=cfg.adv.adam_lr, steps=cfg.adv.steps,
                mask_wt=cfg.adv.mask_wt, l0_thresh=cfg.adv.l0_thresh)
        else:
            raise ValueError(f"unknown norm_type {cfg.adv.norm_type}")
        self.scale_view = None
        if cfg.adv.attack_scale:
            self.scale_view = EvalView(self.device,
                                       scales=(cfg.adv.attack_scale,))
            self.attack.predict_scale = self.scale_view

    # -- state ----------------------------------------------------------------
    def _feature_dim(self) -> int:
        """Channels of the student's deepest feature, SimSiam's input."""
        return encoder_channels(self.cfg.num_layers)[-1]

    def make_student(self):
        """A new student of the configured family, in the compute dtype
        (the Monodepth2 student folds its attack view's BatchNorm when
        cfg.fold_bn)."""
        return make_family_model(self.cfg, self.cfg.compute_dtype,
                                 self.cfg.fold_bn)

    def make_state(self, resume: Optional[Mapping] = None) -> TrainState:
        """A fresh student (and SimSiam head, and pose networks) from the
        initial weights, in train mode, with a new Adam over all of them
        (b1 0.9, b2 0.999, eps 1e-8 outside the square root: optax.adam's);
        or, with `resume` (`models/convert.py:from_jax_hardening_state`),
        those modules, the Adam state and the step. Under a mesh the
        modules are rank 0's and their BatchNorms global."""
        cfg = self.cfg
        modules = {"model": self.make_student()}
        init = {"model": self._init_state_dict}
        if self._init_simsiam is not None:
            modules["simsiam"] = SimSiam(in_dim=self._feature_dim())
            init["simsiam"] = self._init_simsiam
        if self._init_pose is not None:
            modules["pose_encoder"], modules["pose_decoder"] = \
                make_pose_nets()
            init["pose_encoder"], init["pose_decoder"] = self._init_pose
        for key, module in modules.items():
            module.load_state_dict(init[key] if resume is None
                                   else resume[key])
            modules[key] = module.to(self.device).train()
        if self.mesh is not None:
            replicate(modules.values(), self.mesh)
            modules = {k: global_batchnorm(m, self.mesh)
                       for k, m in modules.items()}
        params = [p for m in modules.values() for p in m.parameters()]
        opt = torch.optim.Adam(params, lr=self.learning_rate(0),
                               betas=(0.9, 0.999), eps=1e-8)
        state = TrainState(optimizer=opt, step=0, **modules)
        if resume is not None:
            for key, module in modules.items():
                named = dict(module.named_parameters())
                for name, st in resume["adam"][key].items():
                    opt.state[named[name]] = {
                        "step": st["step"].clone(),
                        "exp_avg": st["exp_avg"].to(self.device),
                        "exp_avg_sq": st["exp_avg_sq"].to(self.device)}
            state.step = resume["step"]
        return state

    def student_variables(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The student's weights and BatchNorm statistics (a state dict)."""
        return state.model.state_dict()

    def learning_rate(self, step: int) -> float:
        return self.cfg.learning_rate * self.cfg.scheduler_gamma ** (
            step // self.transition_steps)

    def attack_student(self, state: TrainState):
        """The attack, aimed at `state`'s student as it is now."""
        self.student_view.model = state.model
        if self.scale_view is not None:
            self.scale_view.model = state.model
        return self.attack

    # -- draws ----------------------------------------------------------------
    def _rows(self, n_local: int) -> slice:
        """This rank's rows of the global batch whose shares have
        `n_local` rows (all of them without a mesh)."""
        if self.mesh is None:
            return slice(None)
        return self.mesh.rows(n_local * self.mesh.world_size)

    def _global(self, n_local: int) -> int:
        return n_local * (1 if self.mesh is None else self.mesh.world_size)

    def draw(self, batch_size: int,
             generator: Optional[torch.Generator] = None) -> StepDraws:
        """The host draws of one `train_step` on `batch_size` frames (the
        global batch under a mesh), from `generator` (default: the
        trainer's)."""
        gen = generator or self.generator
        return StepDraws(
            attack=self.attack.draw(gen, self.cfg.adv.attack_batch_size),
            synth=draw_synth(gen, batch_size, self.cfg.adv))

    def identity_noise_shape(self, batch_size: int):
        """Shape of the automask's tie-break draw for a batch: one channel
        a source frame, one in all with DepthHints."""
        shape = (depth_hints.identity_noise_shape if self.cfg.use_depth_hints
                 else identity_noise_shape)
        return shape(self.cfg.selfsup, batch_size)

    def draw_identity_noise(self, batch_size: int) -> torch.Tensor:
        """The automask's draw for a (global) batch of `batch_size`."""
        return torch.randn(self.identity_noise_shape(batch_size),
                           generator=self.noise_generator,
                           device=self.device)

    # -- batch and loss -------------------------------------------------------
    def _K_batch(self, batch, B: int):
        batch["K"] = self._K.expand(B, 4, 4)
        batch["inv_K"] = self._inv_K.expand(B, 4, 4)
        return batch

    def plain_batch(self, frames, side_is_l, do_flip, jitter=None):
        """The non-adversarial batch of raw frames {fid: (B, ori_h, ori_w,
        3)} on the trainer's device, with K and inv_K. With
        cfg.adv.color_aug the jitter draws are `jitter`, else drawn from
        the trainer's generator (the global batch's under a mesh, as given
        `jitter` is: this rank keeps its rows)."""
        B = frames["0"].shape[0]
        if self.cfg.adv.color_aug and jitter is None:
            jitter = draw_jitter(self.generator, self._global(B))
        if jitter is not None:
            jitter = jitter.rows(self._rows(B))
        batch = build_plain_batch(frames, side_is_l, do_flip,
                                  self.cfg.selfsup, jitter=jitter)
        return self._K_batch(batch, B)

    def refresh_texture(self, state: TrainState, scene_imgs,
                        draws: StepDraws) -> torch.Tensor:
        """Step 1 of `train_step`: the texture (1, h, w, 3) the attack
        re-optimises against `state`'s student on `attack_batch_size`
        replicated scenes (under a mesh this rank's share: one scene or
        attack_batch_size / world_size of them; the texture gradient is
        the global batch's)."""
        atk = self.attack_student(state)
        n = self.cfg.adv.attack_batch_size // self._global(1)
        scenes = atk._replicate(
            torch.as_tensor(scene_imgs, dtype=torch.float32,
                            device=self.device), n)
        return atk._optimize(scenes, draws.attack.rows(self._rows(n)))

    def synth_batch(self, frames, side_is_l, do_flip, obj_adv,
                    draws: StepDraws):
        """Step 2 of `train_step`: the batch synthesised with texture
        `obj_adv`, with K, inv_K and stereo_T, and the DepthHints planes
        where the frames carry them (JAX hardening.py:414-418). Under a
        mesh, this rank's rows of the global `draws`."""
        synth = draws.synth.rows(self._rows(frames["0"].shape[0]))
        batch = synthesize_adv_batch(
            self.synth_eot, frames, obj_adv, self.obj_img, self.obj_mask,
            side_is_l, do_flip, synth, self.cfg.selfsup, self.cfg.adv)
        batch["stereo_T"] = stereo_T_batch(side_is_l, do_flip)
        for k in ("depth_hint", "depth_hint_mask"):
            if k in frames:
                batch[k] = frames[k]
        return self._K_batch(batch, frames["0"].shape[0])

    def disparities(self, model, batch) -> Dict[int, torch.Tensor]:
        """The student's sigmoid disparities {scale: (B, h_s, w_s, 1)} of
        batch["color_aug"]["0"]."""
        return self._features_and_disps(model, batch)[1]

    def _features_and_disps(self, model, batch, lookup=None):
        """The student's features and disparities {scale: NHWC} of
        batch["color_aug"]["0"]; `lookup`: (frames, poses) of a ManyDepth
        student's real-lookup volume."""
        x = batch["color_aug"]["0"]
        feats, outs = (model.features_and_disps(x) if lookup is None
                       else model.features_and_disps_multi(x, *lookup))
        return feats, {s: outs[("disp", s)].permute(0, 2, 3, 1)
                       for s in self.cfg.selfsup.scales}

    def teacher_disp(self, images) -> torch.Tensor:
        """The frozen teacher's disp0 (B, H, W, 1), with no gradient."""
        with torch.no_grad():
            return self.teacher(images)

    def predict_poses(self, state: TrainState, color_aug
                      ) -> Dict[str, torch.Tensor]:
        """{fid: (B, 4, 4)} for each temporal source frame: the pose
        networks in the modules' mode (train mode in a step, their
        encoder's statistics updated once a source, in
        `temporal_source_ids` order; JAX `_predict_poses_mutable`,
        hardening.py:367-389). The pair is [f, "0"] for f < 0 with the
        transform inverted, ["0", f] otherwise, so each maps target-frame
        points into the source camera."""
        poses = {}
        for fid in self.cfg.selfsup.temporal_source_ids:
            f = int(fid)
            pair = ((color_aug[fid], color_aug["0"]) if f < 0
                    else (color_aug["0"], color_aug[fid]))
            feats = state.pose_encoder(torch.cat(pair, dim=-1)
                                       .permute(0, 3, 1, 2))
            axisangle, translation = state.pose_decoder([feats])
            poses[fid] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f < 0)
        return poses

    def _losses(self, state: TrainState, batch, identity_noise
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted sum of the configured branches and each of them
        (JAX `_losses`, hardening.py:265-365); the train-mode passes
        update the BatchNorm statistics in JAX's order (the student's,
        the head's, then the pose encoder's; with the real lookup the
        pose encoder's first)."""
        cfg, ss = self.cfg, self.cfg.selfsup
        model = state.model
        poses = lookup = None
        if cfg.manydepth_real_lookup:
            # the poses first, so the student's volume can use them; the
            # attack stays single-frame (JAX hardening.py:275-290)
            poses = self.predict_poses(state, batch["color_aug"])
            fid = ss.temporal_source_ids[0]
            lookup = (batch["color_aug"][fid][:, None], poses[fid][:, None])
        feats_aug, disps = self._features_and_disps(model, batch, lookup)
        metrics = {}
        total = 0.0
        if cfg.supervised_adv:
            disp_gt = self.teacher_disp(batch["color_ben"])
            if cfg.gt_depth:
                # the pseudo-depth composited with the object's true
                # distance inside its mask (trainer.py:551-558)
                depth = lambda d: torch.clamp(disp_to_depth(
                    d, ss.min_depth, ss.max_depth)[1] * 5.4, 1e-3, 80.0)
                objmask = batch["objmask"]
                objdepth = batch["objdepth"].reshape(-1, 1, 1, 1)
                gt_d = objmask * objdepth + depth(disp_gt) * (1.0 - objmask)
                loss_sup = torch.mean((gt_d - depth(disps[0])) ** 2)
            else:
                loss_sup = torch.mean((disp_gt - disps[0]) ** 2)
            loss_sup = cfg.sup_loss_wt * loss_sup
            metrics["sup_loss"] = loss_sup
            total = total + loss_sup
        if cfg.contrastive_learning:
            feats_ben = (model.encode(batch["color_ben"]) if lookup is None
                         else model.encode_multi(batch["color_ben"], *lookup))
            contras = cfg.contras_loss_wt * state.simsiam(feats_aug,
                                                          feats_ben)
            metrics["contras_loss"] = contras
            total = total + contras
        if not cfg.no_original_train:
            if poses is None:
                poses = (self.predict_poses(state, batch["color_aug"])
                         if ss.use_pose_net else {})
            if cfg.use_depth_hints:
                selfsup, _ = depth_hints.compute_depth_hints_losses(
                    disps, batch, poses, identity_noise, ss, self.mesh)
            else:
                selfsup, _ = compute_selfsup_losses(disps, batch, poses,
                                                    identity_noise, ss)
            metrics["selfsup_loss"] = selfsup
            total = total + selfsup
        metrics["loss"] = total
        return total, metrics

    # -- steps ----------------------------------------------------------------
    def _update(self, state: TrainState, batch,
                identity_noise: Optional[torch.Tensor]):
        """Loss, backward and Adam on a built batch; returns (state,
        metrics). `identity_noise`: the global batch's draw (this rank
        keeps its rows). Under a mesh the gradients that exist (the same
        set on every rank) and the metrics are averaged over the ranks."""
        B = batch["color"]["0"].shape[0]
        if identity_noise is None:
            identity_noise = self.draw_identity_noise(self._global(B))
        identity_noise = identity_noise[self._rows(B)].to(self.device)
        for module in state.modules().values():
            module.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = self._losses(state, batch, identity_noise)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.mesh is not None:
            self.mesh.all_mean([p.grad for group in state.optimizer
                                .param_groups for p in group["params"]
                                if p.grad is not None])
            metrics = dict(zip(metrics, self.mesh.all_mean(
                [v.float().reshape(()) for v in metrics.values()])))
        self._apply_grads(state)
        return state, metrics

    def _apply_grads(self, state: TrainState) -> None:
        """Adam at the step's learning rate, and the step count."""
        for group in state.optimizer.param_groups:
            group["lr"] = self.learning_rate(state.step)
        state.optimizer.step()
        state.step += 1

    def selfsup_step(self, state: TrainState, batch,
                     identity_noise: Optional[torch.Tensor] = None):
        """One non-adversarial step on a built batch (color / color_aug /
        K / inv_K / stereo_T; this rank's rows under a mesh).
        identity_noise: the automask's standard normal tie-break draw of
        the global batch, drawn from the trainer's generator when None.
        Returns (state, metrics)."""
        return self._update(state, batch, identity_noise)

    def selfsup_frames_step(self, state: TrainState, frames, side_is_l,
                            do_flip,
                            identity_noise: Optional[torch.Tensor] = None):
        """The plain self-supervised step straight from raw frames
        {fid: (B, ori_h, ori_w, 3)} with per-item side_is_l / do_flip
        (B,) bool (this rank's rows under a mesh): batch building on the
        device, then `selfsup_step`."""
        return self.selfsup_step(
            state, self.plain_batch(frames, side_is_l, do_flip),
            identity_noise)

    def train_step(self, state: TrainState, frames, side_is_l, do_flip,
                   scene_imgs, draws: Optional[StepDraws] = None):
        """One hardening step: texture refresh on `attack_batch_size`
        replicated scenes (scene_imgs (1 | attack_batch_size, ori_h,
        ori_w, 3)), synthesis from the raw frames {fid: (B, ori_h, ori_w,
        3)} with per-item side_is_l / do_flip (B,) bool, then loss,
        backward and Adam. Draws from the trainer's generator unless
        `draws` are given. Under a mesh the frames, sides and flips are
        this rank's rows, the scenes one scene or this rank's share, and
        the draws the global batch's. Returns (state, metrics: "loss" and
        each branch's)."""
        frames = {k: torch.as_tensor(v, dtype=torch.float32,
                                     device=self.device)
                  for k, v in frames.items()}
        side_is_l = torch.as_tensor(side_is_l, device=self.device)
        do_flip = torch.as_tensor(do_flip, device=self.device)
        if draws is None:
            draws = self.draw(self._global(frames["0"].shape[0]))
        obj_adv = self.refresh_texture(state, scene_imgs, draws)
        batch = self.synth_batch(frames, side_is_l, do_flip, obj_adv, draws)
        return self._update(state, batch, draws.identity_noise)

    # -- robustness eval ------------------------------------------------------
    def default_eval_cfg(self, **overrides):
        """AttackEvalConfig with the training attack's own hyperparameters
        (trainer.py:455-465 val() args)."""
        from ..evaluation.attack_eval import AttackEvalConfig

        ss, adv = self.cfg.selfsup, self.cfg.adv
        return AttackEvalConfig(
            norm_type=adv.norm_type, epsilon=adv.epsilon, alpha=adv.alpha,
            step=adv.steps, adam_lr=adv.adam_lr, mask_wt=adv.mask_wt,
            l0_thresh=adv.l0_thresh, obj_name=adv.obj_name,
            batch_size=adv.attack_batch_size, scene_h=ss.height,
            scene_w=ss.width, ori_h=adv.ori_h, ori_w=adv.ori_w, **overrides)

    def evaluate_attacks(self, state: TrainState, scenes_iter, eval_cfg=None,
                         generator: Optional[torch.Generator] = None,
                         draws=None):
        """The periodic robustness check of the in-training student
        (trainer.py:435-470 val() -> `evaluation/attack_eval.py:
        evaluate_attacks`), the training attack's hyperparameters by
        default. One attack per eval config, over an eval view of the
        student as it is at each call. Returns evaluate_attacks' result."""
        from ..evaluation.attack_eval import build_attack, evaluate_attacks

        eval_cfg = eval_cfg or self.default_eval_cfg()
        if eval_cfg not in self._eval_attacks:
            view = EvalView(self.device)
            self._eval_attacks[eval_cfg] = (view, build_attack(
                eval_cfg, view, self.obj_img, self.obj_mask))
        view, attack = self._eval_attacks[eval_cfg]
        view.model = state.model
        return evaluate_attacks(view, attack, scenes_iter, eval_cfg,
                                generator=generator, draws=draws)


def _cpu_copy(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}
