"""Determinism helpers.

Counterpart of `depthmodelhardening_tpu/utils/seeding.py` (reference
simple_adv_training.py:31-36, evaluate_depth.py:48-55, which seed
torch, cuda, numpy and random). The host RNGs and torch's default
generators (CPU and every card) are seeded here; the port's own random
draws come from explicit `torch.Generator`s that callers pass to the
trainers and attacks, so the returned CPU generator takes the place of
the JAX package's root PRNGKey.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int = 17) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs; return a CPU
    `torch.Generator` seeded with `seed`."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
