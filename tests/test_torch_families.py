"""One `HardeningTrainer.train_step` of each model family of BASELINE
config 5 against the JAX package's trainer: DepthHints on a Bottleneck
ResNet-50 (frames ("0", "s"), contras_loss_wt 0.1), ManyDepth in the
reference's zero-lookup mode, and ManyDepth with a real lookup frame
(frames ("0", "-1", "1", "s"), the pose networks).

As `tests/test_torch_hardening.py` holds config 4: the port's whole step
runs from the JAX trainer's initial state (`from_jax_hardening_state`)
on JAX's draws (`StepDraws` from the key chain of JAX's `_step`: L-inf
PGD with one step, the synthesis, the automask noise of `k_loss`, which
has one channel under DepthHints), and JAX's jitted `_losses` gradient
and Adam update run on the batch the port's step built. Sizes: the
model at 64x192, 96x320 frames, a 24x36 car, attack batch 2, step batch
4; ManyDepth with 8 depth bins. Weights: flax's initialisation with
BatchNorm scale and running statistics from a seeded stream (as
`tests/test_torch_bottleneck.py`); the frozen teacher is the student's
family with the student's initial weights (the CLI's --fine-tune); the
SimSiam head is initialised on the student's deepest features (2048
channels on ResNet-50: the JAX trainer's own initialisation assumes 512,
`training/hardening.py:232`, so its head is handed in). The hint is the
depth of the frames' column shift (the "s" frame is "0" shifted by 6
native columns), invalid (0, mask 0) on a seeded fifth of the pixels.

Tolerances (`test_torch_hardening.py`'s step rule): each loss term 1e-5
relative, the contrastive term 1e-5 absolute; the gradients of every
trained tensor and Adam's first moment 0.1 per tensor and 0.05 overall
(relative L2, a tensor below 1e-3 of the largest norm held relative to
that floor), Adam's second moment 0.2 per tensor; every parameter moved.
Measured: losses within 7.5e-6 relative (the contrastive term 1.0e-6
absolute); the ResNet-50 student's gradients 5.8e-2 on its worst tensor
and 4.3e-2 overall, the head's 2.7e-2 and 2.0e-2 (train-mode BatchNorm
over 4 images through 16 Bottleneck blocks: flax's one-pass variance,
`tests/test_torch_bottleneck.py`); ManyDepth 3.6e-3 and 1.4e-3; with the
real lookup 5.6e-3 and 3.4e-3, the pose encoder 3.3e-3 and 1.3e-3, the
pose decoder 2.7e-4 and 1.6e-4.
"""
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


@pytest.fixture(scope="module", params=['hints50'])
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
