"""Adversarial robustness evaluation (the `eval-attacks` library path).

Counterpart of `depthmodelhardening_tpu/evaluation/attack_eval.py:38-211`
(reference DepthNetworks/monodepth2/evaluate_depth.py:113-214): build an
attack, run it over eval_count scene batches with eval=True (sample 0
pinned), and measure the error of the attacked prediction against the
benign prediction of the same model inside the object mask, on
stereo-scaled clamped depth (x5.4, [1e-3, 80]). Reports the mean and
max over batches of [abs_err, abs_rel, sq_rel, rmse, rmse_log, a1, a2,
a3].

    attack = build_attack(cfg, predictor, obj_img, obj_mask)
    result = evaluate_attacks(predictor, attack, scenes_iter, cfg)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..attacks.base import PhysObjAttackConfig
from ..attacks.pgd_object import PGDObjectAttack
from ..ops.metrics import compute_errors_masked, scaled_clamped_depth
from ..physics.eot import VEHICLE_SIZES

METRIC_NAMES = ("abs_err", "abs_rel", "sq_rel", "rmse", "rmse_log",
                "a1", "a2", "a3")

# norm types of the JAX package that the port does not have yet, and the
# ROADMAP item that brings each
_SLICE5 = "Queue 1, slice 5 (the other attacks and evaluations)"
_LATER = {
    "l_0": "Queue 1, slice 3 (L0 attack)",
    "image": _SLICE5,
    "l_2": _SLICE5,
    "arbi": _SLICE5,
    "guassian": _SLICE5,
    "light": _SLICE5,
    "vanila": _SLICE5,
    "physical": _SLICE5,
    "APGD": _SLICE5,
    "Square": _SLICE5,
}


@dataclasses.dataclass(frozen=True)
class AttackEvalConfig:
    """The fields of the reference's eval attack-args dicts
    (evaluate_depth.py:403-517) that the L-inf path reads."""

    norm_type: str = "l_inf"
    epsilon: float = 0.1
    alpha: float = 0.005
    step: int = 10
    batch_size: int = 12
    eval_count: int = 10
    start_idx: int = 42  # evaluate_depth.py:160
    obj_name: str = "BMW"  # metric quad size key (physicalTrans.py:35-40)
    scene_h: int = 320
    scene_w: int = 1024
    ori_h: int = 375
    ori_w: int = 1242


def build_attack(cfg: AttackEvalConfig, predictor, obj_img, obj_mask):
    """Attack factory (evaluate_depth.py:119-151). obj_img (1, h, w, 3),
    obj_mask (1, h, w, 1)."""
    nt = cfg.norm_type
    if nt in _LATER:
        raise NotImplementedError(
            f"norm_type {nt!r} is not ported yet: ROADMAP {_LATER[nt]}")
    if nt != "l_inf":
        raise ValueError(f"unknown norm_type {nt}")
    oh, ow = obj_img.shape[1:3]
    veh_h, veh_w = VEHICLE_SIZES[next(
        (k for k in VEHICLE_SIZES if cfg.obj_name.startswith(k)), "BMW")]
    base = PhysObjAttackConfig(
        obj_h=oh, obj_w=ow, scene_h=cfg.scene_h, scene_w=cfg.scene_w,
        ori_h=cfg.ori_h, ori_w=cfg.ori_w, veh_h=veh_h, veh_w=veh_w,
        eval_pin_z0=7.0)
    return PGDObjectAttack(predictor, obj_img, obj_mask, base,
                           eps=cfg.epsilon, alpha=cfg.alpha, steps=cfg.step)


def _batch_metrics(predictor, adv, ben, masks):
    d_gt = scaled_clamped_depth(predictor(ben))
    d_atk = scaled_clamped_depth(predictor(adv))
    return compute_errors_masked(d_gt, d_atk, masks)


def evaluate_attacks(predictor, attack, scenes_iter: Iterable,
                     cfg: AttackEvalConfig,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence] = None
                     ) -> Dict[str, Dict[str, float]]:
    """Run the attack over eval batches and aggregate the metrics.

    predictor: the frozen DepthPredictor the attack optimises against.
    scenes_iter: yields (B, ori_h, ori_w, 3) scene batches (numpy or
      tensors; see iter_eval_scenes).
    generator: the CPU torch.Generator of the attack's draws (default:
      seeded with 17); draws[i], when given, replaces batch i's draws.
    Returns {"mean": {...}, "max": {...}} keyed by METRIC_NAMES.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(17)
    rows = []
    for i, scenes in enumerate(scenes_iter):
        if i >= cfg.eval_count:
            break
        if not isinstance(scenes, torch.Tensor):
            scenes = torch.from_numpy(np.asarray(scenes))
        scenes = scenes.to(device=predictor.device, dtype=torch.float32)
        adv, ben, masks, _ = attack(
            scenes, cfg.batch_size, generator, eval_mode=True,
            draws=None if draws is None else draws[i])
        with torch.no_grad():
            errs = _batch_metrics(predictor, adv, ben, masks)
        rows.append(torch.stack(errs).cpu().numpy())
    if not rows:
        raise ValueError("no scene batches to evaluate")
    rows = np.stack(rows)  # (n, 8)
    return {
        "mean": dict(zip(METRIC_NAMES, rows.mean(axis=0).tolist())),
        "max": dict(zip(METRIC_NAMES, rows.max(axis=0).tolist())),
    }


def iter_eval_scenes(dataset, cfg: AttackEvalConfig,
                     batch_size: int = None, count: int = None):
    """Scene batches from a KITTI-object-style dataset starting at
    start_idx (evaluate_depth.py:154-171: sequential, no shuffle); indices
    wrap for datasets smaller than start_idx + count * batch."""
    n = len(dataset)
    bs = cfg.batch_size if batch_size is None else batch_size
    idx = cfg.start_idx % n
    for _ in range(cfg.eval_count if count is None else count):
        imgs = [dataset[(idx + j) % n][0] for j in range(bs)]
        idx += bs
        yield np.stack(imgs)
