"""The port's self-supervised loss assembly against the JAX package's
`training/selfsup.py`, `ops/losses.py:smooth_loss`,
`ops/sampling.py:bilinear_sample_rows` and `training/adv_synth.py`
(plain batch, stereo extrinsics).

Model resolution 64x128, batch 2, float32; inputs from numpy seeds, the
automask's tie-break noise is the JAX package's own draw, handed in.
Tolerances:
* warped images: 1e-4 between the port and the JAX package on the same
  path: sample columns of size W round at ~W * 2^-24 per operation in
  float32, in another order in each (measured: 2.2e-5); 2e-4 between
  the row path and the general path (tests/test_training.py:53's
  tolerance: two formulas of one projection);
* losses: 2e-6 absolute; their gradients with respect to each
  disparity map: 1e-4 of the map's largest entry (measured: 1e-5), as
  the upsampled disparities and the smoothness term's resized target
  colour round differently (float32 resize weights in the port, torch's
  and the reference's, float64 ones in the JAX package: ROADMAP Queue 3);
* plain batch: 1e-4 (the same resize difference, on 375x1242-class
  frames cut to 96x320 -> 64x128).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.ops.losses import smooth_loss as j_smooth_loss
from depthmodelhardening_tpu.ops.sampling import (
    bilinear_sample_rows as j_bilinear_sample_rows,
)
from depthmodelhardening_tpu.training import selfsup as j_selfsup
from depthmodelhardening_tpu.training.adv_synth import (
    build_plain_batch as j_build_plain_batch,
    stereo_T_batch as j_stereo_T_batch,
)
from depthmodelhardening_tpu.training.config import (
    SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu.training.hardening import _scaled_K
from depthmodelhardening_tpu_torch.ops.losses import smooth_loss
from depthmodelhardening_tpu_torch.ops.sampling import bilinear_sample_rows
from depthmodelhardening_tpu_torch.training import selfsup
from depthmodelhardening_tpu_torch.training.adv_synth import (
    build_plain_batch, stereo_T_batch,
)
from depthmodelhardening_tpu_torch.training.config import SelfSupConfig

H, W, B = 64, 128, 2
SIDE = np.array([True, False])
FLIP = np.array([False, True])
WARP_ATOL, PATH_ATOL = 1e-4, 2e-4
LOSS_ATOL = 2e-6
GRAD_REL = 1e-4


def _cfgs(**kw):
    return (SelfSupConfig(height=H, width=W, **kw),
            JSelfSupConfig(height=H, width=W, **kw))


def _batch_np(seed=0, stereo_T=None):
    rng = np.random.RandomState(seed)
    target = rng.rand(B, H, W, 3).astype(np.float32)
    # the other eye: the target shifted by a few columns, plus noise
    other = np.clip(np.roll(target, 5, axis=2)
                    + 0.05 * rng.randn(B, H, W, 3), 0, 1).astype(np.float32)
    K, inv_K = _scaled_K(H, W)
    if stereo_T is None:
        stereo_T = np.array(j_stereo_T_batch(jnp.asarray(SIDE),
                                             jnp.asarray(FLIP)))
    return {"color": {"0": target, "s": other},
            "color_aug": {"0": target, "s": other},
            "K": np.broadcast_to(K, (B, 4, 4)).copy(),
            "inv_K": np.broadcast_to(inv_K, (B, 4, 4)).copy(),
            "stereo_T": stereo_T}


def _tree(batch, fn):
    return {k: ({f: fn(v) for f, v in val.items()} if isinstance(val, dict)
                else fn(val)) for k, val in batch.items()}


def _disps_np(seed=1, const=None):
    rng = np.random.RandomState(seed)
    out = {}
    for s in range(4):
        shape = (B, H // 2 ** s, W // 2 ** s, 1)
        out[s] = (np.full(shape, const, np.float32) if const is not None
                  else rng.uniform(0.05, 0.9, shape).astype(np.float32))
    return out


def _rotated_T():
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = R
    T[:, 0, 3] = [-0.1, 0.1]
    return T


@pytest.mark.parametrize("rectified", [True, False])
def test_generate_images_pred_matches_jax(rectified):
    cfg, jcfg = _cfgs(rectified_stereo=rectified)
    batch, disps = _batch_np(), _disps_np()
    got, depths = selfsup.generate_images_pred(
        {s: torch.from_numpy(d) for s, d in disps.items()},
        _tree(batch, torch.from_numpy), {}, cfg)
    want, jdepths = j_selfsup.generate_images_pred(
        {s: jnp.asarray(d) for s, d in disps.items()},
        _tree(batch, jnp.asarray), {}, jcfg)
    assert set(got) == set(want) == {("s", s) for s in range(4)}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=WARP_ATOL, rtol=0)
    for s in range(4):
        np.testing.assert_allclose(depths[s].numpy(),
                                   np.asarray(jdepths[s]), rtol=1e-5)


def test_row_path_matches_general_path():
    """The port's copy of tests/test_training.py:53: the closed-form
    column reproduces backproject -> transform -> project + 2-D
    grid_sample on a rectified extrinsic."""
    cfg, _ = _cfgs()
    batch = _tree(_batch_np(seed=3), torch.from_numpy)
    disps = {s: torch.from_numpy(d) for s, d in _disps_np(4).items()}
    row, _ = selfsup.generate_images_pred(disps, batch, {}, cfg)
    gen, _ = selfsup.generate_images_pred(
        disps, batch, {}, dataclasses.replace(cfg, rectified_stereo=False))
    for key in row:
        torch.testing.assert_close(row[key], gen[key], atol=PATH_ATOL,
                                   rtol=0)


def test_rotated_extrinsic_takes_the_general_path():
    """A stereo_T with rotation must not take the row path, even with
    rectified_stereo=True; the result equals the JAX package's."""
    cfg, jcfg = _cfgs()
    batch, disps = _batch_np(stereo_T=_rotated_T()), _disps_np(5)
    assert not selfsup._stereo_is_pure_x(torch.from_numpy(_rotated_T()))
    got, _ = selfsup.generate_images_pred(
        {s: torch.from_numpy(d) for s, d in disps.items()},
        _tree(batch, torch.from_numpy), {},
        dataclasses.replace(cfg, rectified_stereo=False))
    same, _ = selfsup.generate_images_pred(
        {s: torch.from_numpy(d) for s, d in disps.items()},
        _tree(batch, torch.from_numpy), {}, cfg)
    want, _ = j_selfsup.generate_images_pred(
        {s: jnp.asarray(d) for s, d in disps.items()},
        _tree(batch, jnp.asarray), {}, jcfg)
    for key in got:
        torch.testing.assert_close(same[key], got[key], atol=0, rtol=0)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=WARP_ATOL, rtol=0)


def test_bilinear_sample_rows_matches_jax():
    """The row warp's values and both gradients against the JAX
    package's custom VJP, with columns outside the frame and on integer
    positions (the right-derivative there); atol 1e-6."""
    rng = np.random.RandomState(13)
    img = rng.rand(2, 5, 16, 3).astype(np.float32)
    x = rng.uniform(-3, 18, (2, 5, 16)).astype(np.float32)
    x[:, :, ::4] = np.round(x[:, :, ::4])
    g = rng.randn(2, 5, 16, 3).astype(np.float32)
    it = torch.from_numpy(img).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bilinear_sample_rows(it, xt)
    d_img, d_x = torch.autograd.grad(out, (it, xt), torch.from_numpy(g))
    want, vjp = jax.vjp(j_bilinear_sample_rows, jnp.asarray(img),
                        jnp.asarray(x))
    j_img, j_x = vjp(jnp.asarray(g))
    for got, ref in ((out, want), (d_img, j_img), (d_x, j_x)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=0)


def _loss_pair(cfg, jcfg, batch, disps, key):
    """(port total, aux, grads), (JAX total, aux, grads) with the JAX
    draw of the identity noise handed to the port."""
    jd = {s: jnp.asarray(d) for s, d in disps.items()}
    jb = _tree(batch, jnp.asarray)

    def f(d):
        return j_selfsup.compute_selfsup_losses(d, jb, {}, key, jcfg)

    (jtotal, jaux), jgrads = jax.value_and_grad(f, has_aux=True)(jd)
    shape = selfsup.identity_noise_shape(cfg, B)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, shape, jnp.float32)))
    td = {s: torch.from_numpy(d).requires_grad_(True)
          for s, d in disps.items()}
    total, aux = selfsup.compute_selfsup_losses(
        td, _tree(batch, torch.from_numpy), {},
        None if cfg.disable_automasking else noise, cfg)
    grads = torch.autograd.grad(total, [td[s] for s in range(4)])
    aux = {k: v.detach() for k, v in aux.items()}
    return (total.detach(), aux, grads), (jtotal, jaux, jgrads)


def _assert_grad_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_REL * scale,
                               rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(no_ssim=True),
                                dict(avg_reprojection=True),
                                dict(disable_automasking=True)])
def test_compute_selfsup_losses_and_grads_match_jax(kw):
    cfg, jcfg = _cfgs(**kw)
    (total, aux, grads), (jtotal, jaux, jgrads) = _loss_pair(
        cfg, jcfg, _batch_np(6), _disps_np(7), jax.random.PRNGKey(8))
    np.testing.assert_allclose(float(total), float(jtotal), atol=LOSS_ATOL)
    for s in range(4):
        np.testing.assert_allclose(float(aux[f"loss/{s}"]),
                                   float(jaux[f"loss/{s}"]), atol=LOSS_ATOL)
        _assert_grad_close(grads[s], jgrads[s])


def test_identical_frames_tie_at_the_identity_loss():
    """Source == target: the identity loss is 0 up to the injected noise
    and the warped losses tie with it where the warp is the identity;
    the gradients still match JAX's (clip 0.5, |.|' +1, even min
    split)."""
    cfg, jcfg = _cfgs()
    batch = _batch_np(9)
    batch["color"]["s"] = batch["color"]["0"]
    batch["color_aug"]["s"] = batch["color"]["0"]
    (total, aux, grads), (jtotal, _, jgrads) = _loss_pair(
        cfg, jcfg, batch, _disps_np(const=0.5), jax.random.PRNGKey(10))
    np.testing.assert_allclose(float(total), float(jtotal), atol=LOSS_ATOL)
    for s in range(4):
        _assert_grad_close(grads[s], jgrads[s])


@pytest.mark.parametrize("const", [False, True])
def test_smooth_loss_matches_jax(const):
    """Constant disparity patches make every |d_i - d_j| an exact tie:
    JAX's |.|' is +1 there and the port's must be too."""
    rng = np.random.RandomState(11)
    disp = rng.uniform(0.1, 0.9, (2, 16, 24, 1)).astype(np.float32)
    if const:
        disp[:, 4:12, 6:18] = 0.5
        disp[1] = 0.3
    img = rng.rand(2, 16, 24, 3).astype(np.float32)
    dt = torch.from_numpy(disp).requires_grad_(True)
    out = smooth_loss(dt, torch.from_numpy(img))
    (g,) = torch.autograd.grad(out, dt)
    want, jg = jax.value_and_grad(
        lambda d: j_smooth_loss(d, jnp.asarray(img)))(jnp.asarray(disp))
    np.testing.assert_allclose(float(out.detach()), float(want), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-8,
                               rtol=1e-5)


def test_plain_batch_and_stereo_T_match_jax():
    rng = np.random.RandomState(12)
    frames = {f: rng.rand(B, 96, 320, 3).astype(np.float32)
              for f in ("0", "s")}
    cfg, jcfg = _cfgs()
    got = build_plain_batch({f: torch.from_numpy(v) for f, v in
                             frames.items()}, torch.from_numpy(SIDE),
                            torch.from_numpy(FLIP), cfg)
    want = j_build_plain_batch({f: jnp.asarray(v) for f, v in
                                frames.items()}, jnp.asarray(SIDE),
                               jnp.asarray(FLIP), None, jcfg,
                               color_aug=False)
    for key in ("color", "color_aug"):
        for f in ("0", "s"):
            np.testing.assert_allclose(got[key][f].numpy(),
                                       np.asarray(want[key][f]), atol=1e-4)
    # the flipped item is the mirror image of the unflipped resize
    np.testing.assert_array_equal(
        got["color"]["0"][1].numpy(),
        build_plain_batch({f: torch.from_numpy(v[1:]).flip(2)
                           for f, v in frames.items()},
                          torch.tensor([False]), torch.tensor([False]),
                          cfg)["color"]["0"][0].numpy())
    for side in (True, False):
        for flip in (True, False):
            s, fl = np.array([side, not side]), np.array([flip, flip])
            np.testing.assert_array_equal(
                stereo_T_batch(torch.from_numpy(s),
                               torch.from_numpy(fl)).numpy(),
                np.asarray(j_stereo_T_batch(jnp.asarray(s),
                                            jnp.asarray(fl))))
    # without jitter draws "color_aug" is "color" (the trainer draws the
    # jitter when cfg.adv.color_aug)
    assert all(got["color_aug"][f] is got["color"][f] for f in frames)


def test_unported_selfsup_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.*slice 5"):
        selfsup.predict_poses()
    cfg, _ = _cfgs(v1_multiscale=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        selfsup.generate_images_pred(
            {s: torch.from_numpy(d) for s, d in _disps_np().items()},
            _tree(_batch_np(), torch.from_numpy), {}, cfg)
