"""The reference's evaluation attack zoo: the 16 attack configurations of
evaluate_depth.py's __main__ (evaluate_depth.py:403-517) as
AttackEvalConfig presets, keyed by the reference's index comments.

A copy of `depthmodelhardening_tpu/evaluation/presets.py` (the port
keeps its own; tests/test_torch_attacks_search.py holds it equal).
"""

from __future__ import annotations

from typing import Dict

from .attack_eval import AttackEvalConfig

EVAL_PRESETS: Dict[str, AttackEvalConfig] = {
    # 0-3: L0 threshold sweep (evaluate_depth.py:404-435)
    "l0_thresh005": AttackEvalConfig(norm_type="l_0", step=10,
                                     adam_lr=0.5, mask_wt=0.06,
                                     l0_thresh=0.05, batch_size=8),
    "l0_thresh01": AttackEvalConfig(norm_type="l_0", step=10,
                                    adam_lr=0.5, mask_wt=0.06,
                                    l0_thresh=0.1, batch_size=8),
    "l0_thresh02": AttackEvalConfig(norm_type="l_0", step=10,
                                    adam_lr=0.5, mask_wt=0.06,
                                    l0_thresh=0.2, batch_size=8),
    "l0_thresh0333": AttackEvalConfig(norm_type="l_0", step=10,
                                      adam_lr=0.5, mask_wt=0.06,
                                      l0_thresh=0.333, batch_size=8),
    # 4-6: L-inf epsilon sweep (:436-457)
    "linf_eps005": AttackEvalConfig(norm_type="l_inf", epsilon=0.05,
                                    alpha=0.02, step=10, batch_size=12),
    "linf_eps01": AttackEvalConfig(norm_type="l_inf", epsilon=0.1,
                                   alpha=0.02, step=10, batch_size=12),
    "linf_eps02": AttackEvalConfig(norm_type="l_inf", epsilon=0.2,
                                   alpha=0.04, step=10, batch_size=12),
    # 7: whole-image PGD (:458-464)
    "image_eps001": AttackEvalConfig(norm_type="image", epsilon=0.01,
                                     alpha=0.002, step=10,
                                     batch_size=12),
    # 8-10: L2 epsilon sweep (:466-486)
    "l2_eps8": AttackEvalConfig(norm_type="l_2", epsilon=8.0,
                                alpha=0.02, step=10, batch_size=12),
    "l2_eps16": AttackEvalConfig(norm_type="l_2", epsilon=16.0,
                                 alpha=0.02, step=10, batch_size=12),
    "l2_eps24": AttackEvalConfig(norm_type="l_2", epsilon=24.0,
                                 alpha=0.04, step=10, batch_size=12),
    # 11: Auto-PGD (:488-493)
    "apgd_eps005": AttackEvalConfig(norm_type="APGD", epsilon=0.05,
                                    step=10, batch_size=12),
    # 12: Square Attack (:495-500)
    "square_eps01": AttackEvalConfig(norm_type="Square", epsilon=0.1,
                                     n_queries=5000, batch_size=12),
    # 13: arbitrary-pattern baseline (:502-505)
    "arbi": AttackEvalConfig(norm_type="arbi", batch_size=32),
    # 14: gaussian-blur baseline (:506-510)
    "gaussian": AttackEvalConfig(norm_type="guassian", step=100,
                                 batch_size=12),
    # 15: black-box light search (:511-514)
    "light": AttackEvalConfig(norm_type="light", batch_size=6),
}
