"""Distillation-only adversarial hardening (simple_adv_training.py).

Counterpart of `depthmodelhardening_tpu/training/distill.py` (BASELINE
config 3, the CLI's `train-distill`). Per step (`_step` :162-187;
simple_adv_training.py:126-141):

  1. attack the student's current weights, in eval mode (BatchNorm
     running statistics) and with no weight gradients, with the L-inf
     PGD object attack (or the L0 attack, or whole-image PGD:
     `adv_type="image"`, the scene batch as given, resized to the
     model's resolution); the object attacks' finals are the
     training-time ones (`eval_mode=False`: no pinned sample, the tiled
     pair warp);
  2. the frozen teacher's disp0 on the benign composites, with no
     gradient, is the pseudo ground truth;
  3. the MSE of the train-mode student's disp0 on the adversarial
     composites (BatchNorm on batch statistics, running statistics
     updated);
  4. one Adam step, lr 1e-4 (b1 0.9, b2 0.999, eps 1e-8: optax.adam).

Every model pass reads disp0 only, so the student evaluates only that
head (`DepthDecoder.forward(..., scales=(0,))`, the JAX package's
`model_d0` twin). The other heads stay in its state and get no gradient,
so a step leaves them bit-unchanged (JAX: a zero gradient, an Adam
update of 0). With `attack_scale` s > 0 the attack's coarse steps read
the student's scale-s head instead (a second view, JAX
`student_predict_scale` :113-125), and its decoder stops at that head.

The student computes in `cfg.compute_dtype` (float32 or bfloat16; its
parameters, BatchNorm statistics and Adam's moments stay float32) and
carries `cfg.fold_bn`: the attack's views of it run in eval mode and
then fold BatchNorm into the convs from the weights as they are at each
call; its train-mode passes never fold. The
teacher is the caller's: in `bench.py`'s configuration a bf16, folded
`DepthPredictor` of disp0.

Data parallelism (`mesh=`, JAX distill.py:84, 155-156, 188-191): the
batch_size scenes of a step are split over the ranks, each rank attacking
its share with the global batch's draws (the object attacks average their
texture gradient over the ranks; "image" attacks each image alone), and
the student trains as the hardening trainer's does under a mesh: rank
0's weights, global BatchNorm, gradients and loss averaged.

The state is a model and its optimizer, updated in place; `train_step`
also returns it. Random draws come from a CPU `torch.Generator` or are
injected as `PGDDraws` (`L0Draws` for `adv_type="object_l0"`, the L0
attack: BASELINE config 3b; `ImageDraws` for "image").
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..attacks.base import PhysObjAttackConfig
from ..attacks.l0_object import L0_EVAL_PIN_Z0, L0ObjectAttack
from ..attacks.pgd_image import PGDImageAttack
from ..attacks.pgd_object import PGDObjectAttack
from ..device import resolve_device
from ..models.wrappers import EvalView, init_monodepth2, make_monodepth2
from ..ops.metrics import get_mean_depth_diff
from ..parallel.batchnorm import global_batchnorm
from ..parallel.mesh import Mesh, replicate
from ..physics.eot import EVAL_DIST_RANGE
from .config import DistillConfig
from .hardening import TrainState

# the student (train mode), its Adam and the number of steps taken
DistillState = TrainState


def build_attack(cfg: DistillConfig, predictor, obj_img, obj_mask):
    """get_atk_model (simple_adv_training.py:38-56) for adv_type
    "object" (L-inf PGD on the object texture, eval sample pinned at
    7 m), "object_l0" (the L0 attack, pinned at 6.1 m: BASELINE config
    3b) and "image" (whole-image L-inf PGD, JAX `distill.py:46-49`)."""
    if cfg.adv_type == "image":
        return PGDImageAttack(predictor, eps=cfg.epsilon, alpha=cfg.alpha,
                              steps=cfg.steps,
                              scene_hw=(cfg.scene_h, cfg.scene_w))
    if cfg.adv_type not in ("object", "object_l0"):
        raise ValueError(f"unknown adv_type {cfg.adv_type}")
    l0 = cfg.adv_type == "object_l0"
    oh, ow = np.shape(obj_img)[1:3]
    atk_cfg = PhysObjAttackConfig(
        obj_h=oh, obj_w=ow,
        dist_range=tuple(float(x) for x in EVAL_DIST_RANGE),
        scene_h=cfg.scene_h, scene_w=cfg.scene_w,
        ori_h=cfg.ori_h, ori_w=cfg.ori_w,
        eval_pin_z0=L0_EVAL_PIN_Z0 if l0 else 7.0,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        attack_crop_w=cfg.attack_crop_w, attack_crop_h=cfg.attack_crop_h,
        attack_scale=cfg.attack_scale,
        attack_scale_fine_steps=cfg.attack_scale_fine_steps,
        attack_view_dtype=cfg.attack_view_dtype)
    if l0:
        return L0ObjectAttack(predictor, obj_img, obj_mask, atk_cfg,
                              adam_lr=cfg.adam_lr, steps=cfg.steps,
                              mask_wt=cfg.mask_wt, l0_thresh=cfg.l0_thresh)
    return PGDObjectAttack(predictor, obj_img, obj_mask, atk_cfg,
                           eps=cfg.epsilon, alpha=cfg.alpha, steps=cfg.steps)


class DistillTrainer:
    """do_adv_training (simple_adv_training.py:96-156) on one device.

    generator: CPU `torch.Generator` of the attack's draws (and of the
      from-scratch initialisation when `init_state_dict` is None).
    obj_img (1, h, w, 3), obj_mask (1, h, w, 1): the attacked texture.
    teacher: the frozen `DepthPredictor` of the pseudo ground truth.
    device: default the current CUDA card (raises without one); tests
      pass "cpu".
    init_state_dict: the student's starting weights (the CLI's
      --fine-tune: usually the teacher's).
    mesh: the data-parallel `parallel.mesh.Mesh` (its device is the
      trainer's); cfg.batch_size, the global batch, must divide by its
      world size.
    """

    def __init__(self, cfg: DistillConfig, generator: torch.Generator,
                 obj_img, obj_mask, teacher, device=None,
                 num_layers: int = 18,
                 init_state_dict: Optional[Mapping] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            mesh.rows(cfg.batch_size, "batch_size")
            device = mesh.own_device(device)
        self.device = resolve_device(device)
        self.generator = generator
        self.teacher = teacher
        self.num_layers = num_layers
        if init_state_dict is None:
            init_state_dict = init_monodepth2(generator,
                                              num_layers).state_dict()
        self._init_state_dict = {k: v.detach().cpu().clone()
                                 for k, v in init_state_dict.items()}
        # the attack reads the student of the state being stepped: disp0,
        # and the scale-s head for the coarse steps
        self.student_view = EvalView(self.device)
        self.attack = build_attack(cfg, self.student_view, obj_img, obj_mask)
        self.scale_view = None
        if cfg.attack_scale and cfg.adv_type != "image":
            self.scale_view = EvalView(self.device,
                                       scales=(cfg.attack_scale,))
            self.attack.predict_scale = self.scale_view
        if mesh is not None and cfg.adv_type != "image":
            self.attack.grad_mean = mesh.all_mean

    # -- state ----------------------------------------------------------------
    def make_state(self, resume: Optional[Mapping] = None) -> DistillState:
        """A fresh student from the initial weights, in train mode, with a
        new Adam; or, with `resume` (`models/convert.py:
        from_jax_distill_state`), that student, Adam state and step. Under
        a mesh the student is rank 0's and its BatchNorms global."""
        model = make_monodepth2(self.num_layers,
                                dtype=self.cfg.compute_dtype,
                                fold_bn=self.cfg.fold_bn)
        model.load_state_dict(self._init_state_dict if resume is None
                              else resume["model"])
        model = model.to(self.device).train()
        if self.mesh is not None:
            replicate([model], self.mesh)
            model = global_batchnorm(model, self.mesh)
        opt = torch.optim.Adam(model.parameters(), lr=self.cfg.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        if resume is None:
            return DistillState(model=model, optimizer=opt, step=0)
        params = dict(model.named_parameters())
        for name, st in resume["adam"].items():
            opt.state[params[name]] = {
                "step": st["step"].clone(),
                "exp_avg": st["exp_avg"].to(self.device),
                "exp_avg_sq": st["exp_avg_sq"].to(self.device)}
        return DistillState(model=model, optimizer=opt, step=resume["step"])

    def student_variables(self, state: DistillState) -> Dict[str,
                                                             torch.Tensor]:
        """The student's weights and BatchNorm statistics (a state dict)."""
        return state.model.state_dict()

    def attack_student(self, state: DistillState):
        """The attack, aimed at `state`'s student as it is now."""
        self.student_view.model = state.model
        if self.scale_view is not None:
            self.scale_view.model = state.model
        return self.attack

    # -- the step -------------------------------------------------------------
    def teacher_disp(self, ben) -> torch.Tensor:
        """The teacher's disp0 (B, H, W, 1) of the benign composites."""
        with torch.no_grad():
            return self.teacher(ben)

    def student_disp(self, state: DistillState, images) -> torch.Tensor:
        """The train-mode student's disp0 (B, H, W, 1), the only head
        evaluated."""
        state.model.train()
        _, outs = state.model.features_and_disps(images, scales=(0,))
        return outs[("disp", 0)].permute(0, 2, 3, 1)

    def distill_step(self, state: DistillState, adv, ben):
        """The training half of a step on given composites: MSE of the
        student's disp0 on `adv` against the teacher's on `ben`, backward,
        Adam (under a mesh: this rank's rows, the gradients and the loss
        averaged over the ranks). Returns (state, {"loss"})."""
        disp_gt = self.teacher_disp(ben)
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((disp_gt - self.student_disp(state, adv)) ** 2)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            self.mesh.all_mean([p.grad for p in state.model.parameters()
                                if p.grad is not None] + [loss])
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss}

    def train_step(self, state: DistillState, scenes,
                   generator: Optional[torch.Generator] = None, draws=None):
        """One distillation step on a scene batch (batch_size, ori_h,
        ori_w, 3) (or, for the object attacks, one scene, replicated;
        "image" attacks the batch as given, JAX `distill.py:164-166`).
        The attack's draws come from `generator` (default: the
        trainer's) unless `draws` (`PGDDraws`, `L0Draws` for
        "object_l0", `ImageDraws` for "image") are given. Under a mesh the
        scenes are this rank's rows (the object attacks' one scene, or
        batch_size / world_size of them) and the draws the global
        batch's. Returns (state, {"loss"})."""
        scenes = torch.as_tensor(scenes, dtype=torch.float32,
                                 device=self.device)
        image = self.cfg.adv_type == "image"
        world = 1 if self.mesh is None else self.mesh.world_size
        B = scenes.shape[0] * world if image else self.cfg.batch_size
        if draws is None:
            draws = self.attack.draw(generator or self.generator, B)
        if self.mesh is not None:
            draws = draws.rows(self.mesh.rows(B))
            B //= world
        attack = self.attack_student(state)
        if image:
            adv, ben = attack(scenes, draws=draws)
        else:
            adv, ben, _, _ = attack(scenes, B, eval_mode=False, draws=draws)
        return self.distill_step(state, adv, ben)


def eval_atk_perf(trainer: DistillTrainer, state: DistillState, scenes_iter,
                  generator: Optional[torch.Generator] = None, logger=None,
                  epoch: int = 0, draws=None):
    """Per-epoch robustness check (simple_adv_training.py:59-94; JAX
    `training/distill.py:195-249`). For each scene batch, attack the
    student in eval mode (sample 0 pinned) and measure

      model_perf: mean |depth(student(ben)) - depth(teacher(ben))|,
      atk_perf:   the same for student(adv), inside the object mask.

    Draws come from `generator`, or batch i's from `draws[i]`. With a
    `logger` (`utils/logging.py:MetricsLogger`), the first batch's 6-panel
    comparisons go to it at step `epoch` as "eval/model_comp" (the
    student's and the teacher's disparity of the benign scene) and
    "eval/atk_comp" (the student's of the attacked scene against the
    teacher's of the benign one), the reference's TensorBoard panels
    (JAX `distill.py:229-242`). Returns (model_perf, atk_perf), averaged
    over batches."""
    attack = trainer.attack_student(state)
    view = trainer.student_view
    B = trainer.cfg.batch_size
    model_acc, atk_acc, n = 0.0, 0.0, 0
    for i, scenes in enumerate(scenes_iter):
        scenes = torch.as_tensor(scenes, dtype=torch.float32,
                                 device=trainer.device)
        d = None if draws is None else draws[i]
        if trainer.cfg.adv_type == "image":
            # JAX `distill.py:219`: no object, the whole frame measured
            adv, ben = attack(scenes, generator, draws=d)
            masks = None
        else:
            adv, ben, masks, _ = attack(scenes, B, generator,
                                        eval_mode=True, draws=d)
        with torch.no_grad():
            disp_gt = trainer.teacher(ben)
            disp_pre = view(ben)
            disp_atk = view(adv)
        if i == 0 and logger is not None:
            _log_comparisons(logger, epoch, adv, ben, disp_pre, disp_atk,
                             disp_gt)
        model_acc += float(get_mean_depth_diff(disp_pre, disp_gt, None,
                                               use_abs=True))
        atk_acc += float(get_mean_depth_diff(disp_atk, disp_gt, masks,
                                             use_abs=True))
        n += 1
    n = max(n, 1)
    return model_acc / n, atk_acc / n


def _log_comparisons(logger, epoch, adv, ben, disp_pre, disp_atk,
                     disp_gt) -> None:
    from ..utils.visualize import eval_depth_diff

    host = lambda t: t[0].float().cpu().numpy()
    ben0, adv0 = host(ben), host(adv)
    gt0 = host(disp_gt)[..., 0]
    img_model, _, _ = eval_depth_diff(ben0, ben0, disp1=host(disp_pre)[
        ..., 0], disp2=gt0)
    img_atk, _, _ = eval_depth_diff(adv0, ben0, disp1=host(disp_atk)[
        ..., 0], disp2=gt0)
    logger.log_image(epoch, "eval/model_comp", np.asarray(img_model))
    logger.log_image(epoch, "eval/atk_comp", np.asarray(img_atk))
