"""One `HardeningTrainer.train_step` of ManyDepth in the reference's
zero-lookup mode and with a real lookup frame against the JAX package's
trainer: `tests/test_torch_families.py`'s tests and rule (that file holds
DepthHints on ResNet-50), in a file of their own so that each file's
JAX compiles fit one test worker's share of the suite's time."""

import pytest
import torch

from families_common import (
    check_gradients_and_adam, check_losses, check_model_and_batch,
    family_step,
)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=['manydepth', 'real_lookup'])
def step(request):
    return family_step(request.param)


def test_family_step_builds_its_model_and_batch(step):
    """The student is the family's, the hint planes ride into the batch
    (DepthHints), the real-lookup step predicts the poses once."""
    check_model_and_batch(step)


def test_family_step_losses_match_jax(step):
    check_losses(step)


def test_family_step_gradients_and_adam_match_jax(step):
    check_gradients_and_adam(step)
