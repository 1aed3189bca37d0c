"""Typed training configuration (counterpart of `depthmodelhardening_tpu/
training/config.py:16-189`; reference monodepth2/options.py, the
adv-train dicts of monodepth2/trainer.py:199-223 and
simple_adv_training.py).

Same fields and defaults as the JAX package's dataclasses, less the TPU
layout rewrites (`s2d_stem`, `wpack_*`, `fuse_upconv`, `packed_decoder`):
the port runs the plain layout, so passing one of them is a TypeError.
`DistillConfig` takes `compute_dtype` "float32" or "bfloat16" (the
JAX benchmark's configuration, `bench.py:81-115`), the eval-clone
BatchNorm fold `fold_bn` (default on, as in JAX), and the attack's
`attack_scale` (0, 1 or 2), `attack_scale_fine_steps` and
`attack_view_dtype`, which the attack's own config checks
(`attacks/base.py:PhysObjAttackConfig`), and the L0 attack's `adam_lr`,
`mask_wt` and `l0_thresh` (`adv_type="object_l0"`). It leaves out
`epochs` (the CLI's `train-distill` loop takes `--epochs` itself) and
`obj_name` (nothing in the distillation step reads it, in JAX either).
`HardeningConfig` carries `fold_bn` (the attack's eval view of the
student) and `compute_dtype` "float32" or "bfloat16" (the student's,
and so its attack view's; the CLI's `train-hardening` default is
bfloat16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SelfSupConfig:
    """Self-supervised monodepth training options (monodepth2/options.py).

    frame_ids are strings so "s" (stereo) can join temporal offsets,
    e.g. ("0", "s") for stereo training or ("0", "-1", "1") for mono.
    """

    height: int = 320
    width: int = 1024
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    frame_ids: Tuple[str, ...] = ("0", "s")
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    v1_multiscale: bool = False
    # The stereo warp takes the row-resample path
    # (ops/sampling.py:bilinear_sample_rows), exact only when stereo_T is
    # a rectified pure x-translation; every stereo_T is checked
    # (training/selfsup.py:_stereo_is_pure_x). False forces the general
    # 2-D sampler.
    rectified_stereo: bool = True

    @property
    def use_stereo(self) -> bool:
        return "s" in self.frame_ids

    @property
    def source_frame_ids(self) -> Tuple[str, ...]:
        return tuple(f for f in self.frame_ids if f != "0")

    @property
    def temporal_source_ids(self) -> Tuple[str, ...]:
        return tuple(f for f in self.frame_ids if f not in ("0", "s"))

    @property
    def use_pose_net(self) -> bool:
        # monodepth2/trainer.py:64: pose net iff mono frames present
        return len(self.temporal_source_ids) > 0


@dataclasses.dataclass(frozen=True)
class AdvSynthConfig:
    """Adversarial batch-synthesis options (trainer.py:199-223 args dict
    + mono_dataset.py:147-175 set_adv_train)."""

    norm_type: str = "l_0"  # {"l_inf", "l_0"}
    epsilon: float = 0.1  # l_inf budget (trainer.py:205)
    alpha: float = 0.005  # l_inf step (trainer.py:206)
    steps: int = 10  # attack steps (trainer.py:207)
    adam_lr: float = 0.5
    mask_wt: float = 0.05
    l0_thresh: float = 0.1
    attack_batch_size: int = 16  # args['batch_size'] used by the attack
    color_aug: bool = False  # adv_args['color_aug'] (mono_dataset.py:297)
    attack_crop_w: Optional[int] = None
    attack_crop_h: Optional[int] = None
    attack_scale: int = 0
    attack_scale_fine_steps: int = 1
    attack_view_dtype: str = "float32"
    tile_h: int = 256
    tile_w: int = 256
    half_no_synthesis: bool = False
    obj_name: str = "BMW"
    baseline: float = 0.54  # stereo extrinsic (mono_dataset.py:116)
    ori_h: int = 375  # native KITTI scene size (my_utils.py:12-13)
    ori_w: int = 1242


@dataclasses.dataclass(frozen=True)
class HardeningConfig:
    """Full ICLR'23 hardening recipe (monodepth2/trainer.py)."""

    selfsup: SelfSupConfig = SelfSupConfig()
    adv: AdvSynthConfig = AdvSynthConfig()
    supervised_adv: bool = True
    contrastive_learning: bool = True
    contras_loss_wt: float = 1.0  # 0.1 for depth-hints (trainer.py:617)
    sup_loss_wt: float = 1.0
    no_original_train: bool = False
    gt_depth: bool = False
    learning_rate: float = 1e-5  # hardening recipe (README.md:87-103)
    scheduler_step_size: int = 15  # epochs (options.py:142-145)
    scheduler_gamma: float = 0.1
    num_layers: int = 18
    batch_size: int = 32
    # the student's compute dtype: "float32" or "bfloat16" (parameters
    # and BatchNorm statistics stay float32; the pose nets and the
    # SimSiam head compute in float32)
    compute_dtype: str = "float32"
    # DepthHints family (depth-hints/trainer.py:541-591)
    use_depth_hints: bool = False
    # "monodepth2" | "manydepth" (manydepth2/trainer.py:345-386)
    model_family: str = "monodepth2"
    manydepth_num_depth_bins: int = 96
    manydepth_real_lookup: bool = False
    # fold eval-mode BatchNorm into the convs of the attack's view of the
    # student (exact algebra); the student's training passes never fold
    fold_bn: bool = True

    def __post_init__(self):
        _check_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """simple_adv_training.py distillation-only hardening (BASELINE
    config 3: the L-inf object attack, batch 32)."""

    adv_type: str = "object"  # {"object", "image", "object_l0"}
    epsilon: float = 0.1
    alpha: float = 0.005
    steps: int = 10
    adam_lr: float = 0.5  # the L0 attack's (adv_type "object_l0")
    mask_wt: float = 0.05
    l0_thresh: float = 0.1
    batch_size: int = 16
    learning_rate: float = 1e-4  # simple_adv_training.py:115
    # the student's and its attack views' compute dtype: "float32" or
    # "bfloat16" (parameters and BatchNorm statistics stay float32)
    compute_dtype: str = "float32"
    attack_crop_w: Optional[int] = None
    attack_crop_h: Optional[int] = None
    attack_scale: int = 0
    attack_scale_fine_steps: int = 1
    attack_view_dtype: str = "float32"
    tile_h: int = 256
    tile_w: int = 256
    # fold eval-mode BatchNorm into the convs of the attack's views of
    # the student (exact algebra, models/resnet.py:_folded_conv); the
    # student's training passes never fold
    fold_bn: bool = True
    scene_h: int = 320
    scene_w: int = 1024
    ori_h: int = 375
    ori_w: int = 1242

    def __post_init__(self):
        _check_dtype(self.compute_dtype)


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError("compute_dtype must be 'float32' or "
                         f"'bfloat16', got {compute_dtype!r}")
