"""The port's plain ops of the attack-eval path against the JAX package:
resizes, bilinear sampling, reflect padding, the depth metrics, and the
eval scene iterator. Inputs from numpy seeds; float32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.evaluation.attack_eval import (
    AttackEvalConfig as JAttackEvalConfig, iter_eval_scenes as j_iter,
)
from depthmodelhardening_tpu.ops import metrics as j_metrics
from depthmodelhardening_tpu.ops.resize import (
    bilinear_resize as j_bilinear_resize,
    nearest_upsample2 as j_nearest_upsample2,
)
from depthmodelhardening_tpu.ops.sampling import (
    bilinear_sample_pixels as j_sample,
)
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, iter_eval_scenes,
)
from depthmodelhardening_tpu_torch.ops import metrics
from depthmodelhardening_tpu_torch.ops.padding import reflect_pad1
from depthmodelhardening_tpu_torch.ops.resize import (
    bilinear_resize, nearest_upsample2,
)
from depthmodelhardening_tpu_torch.ops.sampling import bilinear_sample_pixels
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("src,dst", [((375, 1242), (96, 320)),
                                     ((40, 60), (96, 128)),
                                     ((96, 320), (96, 320))])
def test_bilinear_resize_matches_jax(src, dst):
    """The port is torch's F.interpolate, which computes each source
    coordinate in float32; the JAX package computes it in float64. At a
    source column near 1000 a float32 ulp is 6.1e-5, so the weights, and
    the outputs of images in [0, 1], differ by up to about that: atol
    1e-4."""
    img = np.random.RandomState(sum(src)).rand(2, *src, 3).astype(np.float32)
    got = bilinear_resize(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bilinear_resize(
        jnp.asarray(img), *dst)), atol=1e-4)


def test_nearest_upsample2_matches_jax():
    x = np.random.RandomState(0).rand(2, 5, 3, 7).astype(np.float32)
    got = nearest_upsample2(torch.from_numpy(x)).numpy()  # NCHW
    want = np.asarray(j_nearest_upsample2(jnp.asarray(x.transpose(0, 2, 3,
                                                                  1))))
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_bilinear_sample_pixels_matches_jax(mode):
    """Coordinates reach past every border, so both fill rules show."""
    rng = np.random.RandomState(1)
    img = rng.rand(2, 9, 13, 4).astype(np.float32)
    x = rng.uniform(-3.0, 15.0, (2, 6, 8)).astype(np.float32)
    y = rng.uniform(-3.0, 11.0, (2, 6, 8)).astype(np.float32)
    got = bilinear_sample_pixels(torch.from_numpy(img), torch.from_numpy(x),
                                 torch.from_numpy(y), padding_mode=mode)
    want = j_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                    padding_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hw", [(1, 1), (1, 4), (2, 2), (3, 5)])
def test_reflect_pad1_matches_numpy_reflect(hw):
    """A size-1 axis is its own reflection, as in numpy and jnp.pad (the
    deepest decoder map of a 32-pixel input is 1x1)."""
    x = np.random.RandomState(2).rand(1, 2, *hw).astype(np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (1, 1),
                                                (1, 1)), mode="reflect"))
    np.testing.assert_array_equal(reflect_pad1(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.fixture(scope="module")
def disps():
    rng = np.random.RandomState(3)
    ben = rng.uniform(0.01, 0.6, (2, 24, 40, 1)).astype(np.float32)
    adv = np.clip(ben * rng.uniform(0.3, 1.3, ben.shape), 0.0, 1.0
                  ).astype(np.float32)
    mask = (rng.rand(*ben.shape) > 0.6).astype(np.float32)
    return ben, adv, mask


@pytest.mark.parametrize("masked", [True, False])
def test_masked_errors_match_jax(disps, masked):
    ben, adv, mask = disps
    m = mask if masked else None
    got = metrics.compute_errors_masked(
        metrics.scaled_clamped_depth(torch.from_numpy(ben)),
        metrics.scaled_clamped_depth(torch.from_numpy(adv)),
        None if m is None else torch.from_numpy(m))
    want = j_metrics.compute_errors_masked(
        j_metrics.scaled_clamped_depth(jnp.asarray(ben)),
        j_metrics.scaled_clamped_depth(jnp.asarray(adv)),
        None if m is None else jnp.asarray(m))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5)


@pytest.mark.parametrize("use_abs", [False, True])
def test_mean_depth_diff_matches_jax(disps, use_abs):
    ben, adv, mask = disps
    got = metrics.get_mean_depth_diff(torch.from_numpy(adv),
                                      torch.from_numpy(ben),
                                      torch.from_numpy(mask), use_abs)
    want = j_metrics.get_mean_depth_diff(jnp.asarray(adv), jnp.asarray(ben),
                                         jnp.asarray(mask), use_abs)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_iter_eval_scenes_matches_jax():
    """Sequential batches from start_idx, wrapping around the dataset."""
    data = [(np.full((2, 3, 3), i, np.float32), None) for i in range(7)]
    kw = dict(batch_size=3, eval_count=4, start_idx=5)
    got = list(iter_eval_scenes(data, AttackEvalConfig(**kw)))
    want = list(j_iter(data, JAttackEvalConfig(**kw)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
