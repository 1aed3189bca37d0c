"""Adversarial robustness evaluation (the `eval-attacks` library path).

Counterpart of `depthmodelhardening_tpu/evaluation/attack_eval.py:38-211`
(reference DepthNetworks/monodepth2/evaluate_depth.py:113-214): build an
attack of any of the reference's norm types, run it over eval_count
scene batches with eval=True (sample 0 pinned), and measure the error of
the attacked prediction against the benign prediction inside the object
mask (the whole frame for the whole-image attack), on stereo-scaled
clamped depth (x5.4, [1e-3, 80]). Reports the mean and max over batches
of [abs_err, abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3].

    attack = build_attack(cfg, predictor, obj_img, obj_mask)
    result = evaluate_attacks(predictor, attack, scenes_iter, cfg)

`evaluation/presets.py` holds the reference's 16 configurations.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..attacks.apgd_object import APGDObjectAttack
from ..attacks.base import PhysObjAttackConfig
from ..attacks.l0_object import L0_EVAL_PIN_Z0, L0ObjectAttack
from ..attacks.l2_object import L2ObjectAttack
from ..attacks.light_object import LightObjectAttack
from ..attacks.pgd_image import PGDImageAttack
from ..attacks.pgd_object import PGDObjectAttack
from ..attacks.physical import PhysicalObjectAttack
from ..attacks.random_object import (
    ArbiObjectAttack, GaussianObjectAttack, VanilaObjectAttack,
)
from ..attacks.square_object import SquareObjectAttack
from ..ops.metrics import compute_errors_masked, scaled_clamped_depth
from ..physics.eot import VEHICLE_SIZES
from ..utils import profiling as prof

METRIC_NAMES = ("abs_err", "abs_rel", "sq_rel", "rmse", "rmse_log",
                "a1", "a2", "a3")
NORM_TYPES = ("l_inf", "l_0", "image", "l_2", "arbi", "guassian", "light",
              "vanila", "physical", "APGD", "Square")


@dataclasses.dataclass(frozen=True)
class AttackEvalConfig:
    """The reference's eval attack-args dicts (evaluate_depth.py:403-517).
    norm_type: one of NORM_TYPES (the reference's spellings)."""

    norm_type: str = "l_0"
    epsilon: float = 0.1
    alpha: float = 0.005
    step: int = 10
    adam_lr: float = 0.5  # the L0 attack's (evaluate_depth.py:463-467)
    mask_wt: float = 0.05
    l0_thresh: float = 0.1
    batch_size: int = 12
    eval_count: int = 10
    start_idx: int = 42  # evaluate_depth.py:160
    n_inits: int = 200  # the light attack's
    n_neighbors: int = 20
    n_queries: int = 5000  # the Square attack's
    obj_name: str = "BMW"  # metric quad size key (physicalTrans.py:35-40)
    scene_h: int = 320
    scene_w: int = 1024
    ori_h: int = 375
    ori_w: int = 1242
    # per-batch image dumps (evaluate_depth_physical.py:124-165): the
    # attacked and benign scene 0 and their 6-panel disparity comparison
    # (PIL and matplotlib, `utils/visualize.py`)
    dump_dir: Optional[str] = None


def build_attack(cfg: AttackEvalConfig, predictor, obj_img, obj_mask,
                 adv_obj_img=None):
    """Attack factory (evaluate_depth.py:119-151). obj_img (1, h, w, 3),
    obj_mask (1, h, w, 1); adv_obj_img: the photographed texture of the
    "physical" norm type."""
    nt = cfg.norm_type
    if nt not in NORM_TYPES:
        raise ValueError(f"unknown norm_type {nt}")
    if nt == "image":
        return PGDImageAttack(predictor, eps=cfg.epsilon, alpha=cfg.alpha,
                              steps=cfg.step,
                              scene_hw=(cfg.scene_h, cfg.scene_w))
    oh, ow = np.shape(obj_img)[1:3]
    veh_h, veh_w = VEHICLE_SIZES[next(
        (k for k in VEHICLE_SIZES if cfg.obj_name.startswith(k)), "BMW")]
    base = PhysObjAttackConfig(
        obj_h=oh, obj_w=ow, scene_h=cfg.scene_h, scene_w=cfg.scene_w,
        ori_h=cfg.ori_h, ori_w=cfg.ori_w, veh_h=veh_h, veh_w=veh_w,
        eval_pin_z0=L0_EVAL_PIN_Z0 if nt == "l_0" else 7.0)
    args = (predictor, obj_img, obj_mask)
    if nt == "l_inf":
        return PGDObjectAttack(*args, base, eps=cfg.epsilon,
                               alpha=cfg.alpha, steps=cfg.step)
    if nt == "l_0":
        return L0ObjectAttack(*args, base, adam_lr=cfg.adam_lr,
                              steps=cfg.step, mask_wt=cfg.mask_wt,
                              l0_thresh=cfg.l0_thresh)
    if nt == "l_2":
        return L2ObjectAttack(*args, base, eps=cfg.epsilon, steps=cfg.step)
    if nt == "arbi":
        return ArbiObjectAttack(*args, base)
    if nt == "guassian":
        return GaussianObjectAttack(*args, base, steps=cfg.step)
    if nt == "light":
        return LightObjectAttack(*args, base, n_inits=cfg.n_inits,
                                 n_neighbors=cfg.n_neighbors)
    if nt == "vanila":
        return VanilaObjectAttack(*args, base)
    if nt == "physical":
        if adv_obj_img is None:
            raise ValueError("physical attack needs adv_obj_img")
        return PhysicalObjectAttack(*args, adv_obj_img, base)
    if nt == "APGD":
        return APGDObjectAttack(*args, base, eps=cfg.epsilon,
                                steps=cfg.step)
    return SquareObjectAttack(*args, base, eps=cfg.epsilon,
                              n_queries=cfg.n_queries)


def _batch_metrics(predictor, adv, ben, masks):
    d_gt = scaled_clamped_depth(predictor(ben))
    d_atk = scaled_clamped_depth(predictor(adv))
    return compute_errors_masked(d_gt, d_atk, masks)


def evaluate_attacks(predictor, attack, scenes_iter: Iterable,
                     cfg: AttackEvalConfig,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence] = None, vanila_obj=None,
                     metric_predictor=None) -> Dict[str, Dict[str, float]]:
    """Run the attack over eval batches and aggregate the metrics.

    predictor: the frozen DepthPredictor the attack optimises against.
    metric_predictor: the model whose predictions are measured, when it
      is another one: the transferability cross-check
      (evaluate_depth_crosscheck.py:205-215 attacks the source model and
      measures the target). Defaults to `predictor`.
    scenes_iter: yields (B, ori_h, ori_w, 3) scene batches (numpy or
      tensors; see iter_eval_scenes).
    generator: the CPU torch.Generator of the attack's draws (default:
      seeded with 17); draws[i], when given, replaces batch i's draws.
    vanila_obj: the texture the "vanila" norm type projects.
    cfg.dump_dir: where each batch's adv_%03d.png, ben_%03d.png (scene 0)
      and panel_%03d.png (`utils/visualize.py:eval_depth_diff` through
      the measured model) go.
    Returns {"mean": {...}, "max": {...}} keyed by METRIC_NAMES.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(17)
    metric_predictor = metric_predictor or predictor
    rows = []
    for i, scenes in enumerate(scenes_iter):
        if i >= cfg.eval_count:
            break
        if not isinstance(scenes, torch.Tensor):
            scenes = torch.from_numpy(np.asarray(scenes))
        with prof.host_copy(scenes, "eval.scenes"):
            scenes = scenes.to(device=predictor.device, dtype=torch.float32)
        d = None if draws is None else draws[i]
        with prof.span(prof.EVAL_ATTACK,
                       {"batch": i, "attack": cfg.norm_type}):
            if cfg.norm_type == "image":
                adv, ben = attack(scenes, generator, draws=d)
                masks = torch.ones(adv.shape[:3] + (1,), dtype=adv.dtype,
                                   device=adv.device)
            elif cfg.norm_type == "vanila":
                adv, ben, masks, _ = attack(scenes, vanila_obj,
                                            cfg.batch_size, generator,
                                            eval_mode=True, draws=d)
            else:
                adv, ben, masks, _ = attack(scenes, cfg.batch_size,
                                            generator, eval_mode=True,
                                            draws=d)
        with prof.span(prof.EVAL_METRICS, {"batch": i}):
            with torch.no_grad():
                errs = _batch_metrics(metric_predictor, adv, ben, masks)
            with prof.span(prof.SYNC_READ, {"site": "eval.metrics"}):
                rows.append(torch.stack(errs).cpu().numpy())
        if cfg.dump_dir:
            _dump(cfg.dump_dir, i, adv, ben, metric_predictor)
    if not rows:
        raise ValueError("no scene batches to evaluate")
    rows = np.stack(rows)  # (n, 8)
    return {
        "mean": dict(zip(METRIC_NAMES, rows.mean(axis=0).tolist())),
        "max": dict(zip(METRIC_NAMES, rows.max(axis=0).tolist())),
    }


def _dump(dump_dir: str, i: int, adv, ben, predictor) -> None:
    """Image dumps like evaluate_depth_physical.py:124-165 (JAX
    `evaluation/attack_eval.py:173-188`): the attacked and benign scene 0
    of batch i and their 6-panel disparity comparison."""
    from ..utils.visualize import eval_depth_diff, save_pic

    os.makedirs(dump_dir, exist_ok=True)
    adv0, ben0 = (t[0].float().cpu().numpy() for t in (adv, ben))
    save_pic(adv0, os.path.join(dump_dir, f"adv_{i:03d}.png"))
    save_pic(ben0, os.path.join(dump_dir, f"ben_{i:03d}.png"))
    panel, _, _ = eval_depth_diff(ben0, adv0, predictor=predictor)
    panel.save(os.path.join(dump_dir, f"panel_{i:03d}.png"))


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
