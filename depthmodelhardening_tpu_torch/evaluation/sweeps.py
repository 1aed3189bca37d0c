"""Robustness evaluation sweeps.

Counterpart of `depthmodelhardening_tpu/evaluation/sweeps.py:1-89`, the
reference's evaluation variants, each a loop of `build_attack` +
`evaluate_attacks`:

  * attack_steps_sweep - robustness against the attack's step count
    (evaluate_depth_atkSteps.py:194-223);
  * crosscheck_matrix - transferability between models: attack the
    source, measure the target (evaluate_depth_crosscheck.py:205-215);
  * objects_sweep - unseen objects with their metric sizes
    (evaluate_depth_objects.py:194-204);
  * physical_eval - a real photographed patch projected across scenes
    (evaluate_depth_physical.py:124-165).

Each run's draws come from a CPU generator seeded with 17, as the JAX
package re-keys every run with PRNGKey(17) (the reference's
setup_seed(17)). make_scenes() returns a fresh scene-batch iterable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from .attack_eval import AttackEvalConfig, build_attack, evaluate_attacks

SWEEP_SEED = 17


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(SWEEP_SEED)


def attack_steps_sweep(predictor, obj_img, obj_mask, make_scenes,
                       cfg: AttackEvalConfig,
                       candi_steps: Sequence[int] = tuple(range(1, 102, 10))
                       ) -> Dict[int, Dict]:
    """The same attack at each step count (evaluate_depth_atkSteps.py:
    194-223): {steps: evaluate_attacks' result}."""
    results = {}
    for steps in candi_steps:
        c = dataclasses.replace(cfg, step=steps)
        attack = build_attack(c, predictor, obj_img, obj_mask)
        results[steps] = evaluate_attacks(predictor, attack, make_scenes(),
                                          c, generator=_generator())
    return results


def crosscheck_matrix(predictors: Dict[str, object], obj_img, obj_mask,
                      make_scenes, cfg: AttackEvalConfig
                      ) -> Dict[str, Dict[str, Dict]]:
    """results[source][target]: the attack optimised on `source`, the
    metrics measured on `target` (evaluate_depth_crosscheck.py:205-215)."""
    results: Dict[str, Dict[str, Dict]] = {}
    for src_name, src in predictors.items():
        attack = build_attack(cfg, src, obj_img, obj_mask)
        results[src_name] = {
            tgt_name: evaluate_attacks(src, attack, make_scenes(), cfg,
                                       generator=_generator(),
                                       metric_predictor=tgt)
            for tgt_name, tgt in predictors.items()}
    return results


def objects_sweep(predictor, objects: Dict[str, tuple], make_scenes,
                  cfg: AttackEvalConfig) -> Dict[str, Dict]:
    """One evaluation per unseen object (evaluate_depth_objects.py:
    194-204). objects: {name: (obj (1, h, w, 3), mask (1, h, w, 1))}; the
    metric quad size comes from VEHICLE_SIZES by the name's prefix
    (physicalTrans.py:35-40)."""
    results = {}
    for name, (obj, mask) in objects.items():
        c = dataclasses.replace(cfg, obj_name=name)
        attack = build_attack(c, predictor, obj, mask)
        results[name] = evaluate_attacks(predictor, attack, make_scenes(),
                                         c, generator=_generator())
    return results


def physical_eval(predictor, obj_img, obj_mask, adv_obj_img, make_scenes,
                  cfg: AttackEvalConfig) -> Dict:
    """The depth error a real photographed adversarial object induces,
    projected across scenes (evaluate_depth_physical.py:124-165)."""
    c = dataclasses.replace(cfg, norm_type="physical")
    attack = build_attack(c, predictor, obj_img, obj_mask,
                          adv_obj_img=adv_obj_img)
    return evaluate_attacks(predictor, attack, make_scenes(), c,
                            generator=_generator())
