"""The port's DepthHints (`training/depth_hints.py`, `data/depth_hints.py`)
against the JAX package's.

The loss runs on a stereo batch at 64x192 (batch 2): the "s" frame is
the target shifted by 4 columns plus noise, the hint the depth of that
shift, invalid (0, mask 0) on a seeded fifth of the pixels, the
disparities drawn in (0.2, 0.6) at the four scales; the automask noise
is JAX's draw from the key it is given. The fusion runs on 12 candidate
depths of known column shifts (1..12 pixels) of a textured 64x160 pair
whose true shift is 5. The SGBM step (cv2) and the PNG reading (PIL) run
here as in the JAX package.

Tolerances, measured on the CPU:

* the hint warp: 1e-5 absolute (measured 6.0e-8; both sample through
  the same reprojection, its 4x4 products summed in another order);
* the loss and each scale's term: 1e-5 relative (measured 4.4e-6); the
  gradient over each scale's disparity: 1e-3 relative L2 (measured
  3.4e-4 with the hint, 1.2e-5 without it, and 1.2e-5 with
  `use_depth_hints=False`);
* the fused hint equal to JAX's wherever the best two candidates' losses
  are not within 1e-5 relative of each other: the two losses differ by
  up to 2.5e-6 absolute on values about 0.3 (the SSIM's variances
  cancel in float32), and at the left border, where the candidates
  sample the same clamped columns, several tie (counted: 185 of 10240
  pixels, held under 2% and all within the 16 border columns); the true
  shift is picked on every interior pixel;
* the SGBM candidates and the whole hint of a pair: equal to JAX's
  (the same cv2 calls; the fusion as above).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.data import depth_hints as j_data
from depthmodelhardening_tpu.training import depth_hints as j_hints
from depthmodelhardening_tpu.training.adv_synth import (
    stereo_T_batch as j_stereo_T_batch,
)
from depthmodelhardening_tpu.training.config import (
    SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu.training.hardening import (
    _scaled_K as j_scaled_K,
)
from depthmodelhardening_tpu_torch.data import depth_hints as data
from depthmodelhardening_tpu_torch.training import depth_hints as hints
from depthmodelhardening_tpu_torch.training.config import SelfSupConfig

H, W, B = 64, 192, 2
SHIFT = 4
WARP_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_L2 = 1e-3
TIE = 1e-5
VARIANTS = {"hints+automask": dict(),
            "hints": dict(disable_automasking=True)}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's CPU passes with 2 intra-op threads while this module
    runs: the suite runs several test processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(h, w, seed):
    """A smooth textured image (B, h, w, 3) in [0, 1]."""
    rs = np.random.RandomState(seed)
    x = rs.rand(B, h, w + 8, 3).astype(np.float32)
    x = (x + np.roll(x, 1, 2) + np.roll(x, 1, 1)) / 3.0
    return x


def _batch():
    """The stereo batch as numpy (NHWC), with hint planes."""
    full = _scene(H, W, 0)
    target = full[:, :, :W]
    other = full[:, :, SHIFT:SHIFT + W] + 0.02 * np.random.RandomState(
        1).rand(B, H, W, 3).astype(np.float32)
    K, inv_K = j_scaled_K(H, W)
    side = np.array([True, True])
    flip = np.array([False, False])
    depth = float(K[0, 0]) * 0.1 / SHIFT
    valid = np.random.RandomState(2).rand(B, H, W, 1) > 0.2
    return {"color": {"0": target, "s": other.astype(np.float32)},
            "color_aug": {"0": target, "s": other.astype(np.float32)},
            "K": np.broadcast_to(K, (B, 4, 4)).copy(),
            "inv_K": np.broadcast_to(inv_K, (B, 4, 4)).copy(),
            "stereo_T": np.asarray(j_stereo_T_batch(jnp.asarray(side),
                                                    jnp.asarray(flip))),
            "depth_hint": (depth * valid).astype(np.float32),
            "depth_hint_mask": valid.astype(np.float32)}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _disps():
    rs = np.random.RandomState(3)
    return {s: (0.2 + 0.4 * rs.rand(B, H >> s, W >> s, 1)).astype(np.float32)
            for s in range(4)}


def test_depth_hint_warp_matches_jax():
    batch = _batch()
    want = np.asarray(jax.jit(lambda b: j_hints.depth_hint_warp(
        b, JSelfSupConfig(height=H, width=W)))(_map(batch, jnp.asarray)))
    got = hints.depth_hint_warp(_map(batch, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    # where the hint is valid the warp recovers the target
    valid = batch["depth_hint_mask"][:, :, 8:-8, 0] > 0
    err = np.abs(want - batch["color"]["0"])[:, :, 8:-8].mean(-1)
    assert float(np.median(err[valid])) < 0.03


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_depth_hints_loss_and_gradient_match_jax(variant):
    """The loss, its per-scale terms and its gradient over every scale's
    disparity, with the hint and the automask and with the hint alone,
    on JAX's automask noise."""
    kw = VARIANTS[variant]
    batch = _batch()
    key = jax.random.PRNGKey(5)
    j_cfg = JSelfSupConfig(height=H, width=W, **kw)

    def f(d, b):
        loss, aux = j_hints.compute_depth_hints_losses(d, b, {}, key, j_cfg)
        return loss, {k: v for k, v in aux.items() if k.startswith("loss/")}

    (loss_j, aux_j), grad_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        _map(_disps(), jnp.asarray), _map(batch, jnp.asarray))
    cfg = SelfSupConfig(height=H, width=W, **kw)
    noise = None
    if not cfg.disable_automasking:
        noise = torch.from_numpy(np.array(jax.random.normal(
            key, hints.identity_noise_shape(cfg, B))))
    disps = _map(_disps(), lambda a: torch.from_numpy(a).requires_grad_(True))
    loss, aux = hints.compute_depth_hints_losses(
        disps, _map(batch, torch.from_numpy), {}, noise, cfg)
    loss.backward()
    assert float(loss) == pytest.approx(float(loss_j), rel=LOSS_RTOL)
    for k, v in aux_j.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=LOSS_RTOL), k
    for s in range(4):
        g, w = disps[s].grad.double(), torch.from_numpy(
            np.array(grad_j[s])).double()
        assert float((g - w).norm() / w.norm()) <= GRAD_L2, s
    if not cfg.disable_automasking:
        with pytest.raises(ValueError, match="identity_noise"):
            hints.compute_depth_hints_losses(
                disps, _map(batch, torch.from_numpy), {}, noise[..., :0],
                cfg)


def test_invalid_hints_never_win():
    """With the mask all 0 the +1000 penalty keeps the hint out of the
    argmin: the port's loss equals JAX's without hints
    (`use_depth_hints=False`) on the same automask noise, within
    LOSS_RTOL."""
    batch = _batch()
    batch["depth_hint_mask"] = np.zeros_like(batch["depth_hint_mask"])
    key = jax.random.PRNGKey(6)
    want, _ = jax.jit(lambda d, b: j_hints.compute_depth_hints_losses(
        d, b, {}, key, JSelfSupConfig(height=H, width=W),
        use_depth_hints=False))(_map(_disps(), jnp.asarray),
                                _map(batch, jnp.asarray))
    cfg = SelfSupConfig(height=H, width=W)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, hints.identity_noise_shape(cfg, B))))
    got, _ = hints.compute_depth_hints_losses(
        _map(_disps(), torch.from_numpy), _map(batch, torch.from_numpy), {},
        noise, cfg)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


def _pair(shift, h=64, w=160, seed=4):
    """A textured float image pair (h, w, 3): the lookup is the right eye
    of a plane at disparity `shift`, base[x] = lookup[x - shift]."""
    full = _scene(h, w + shift, seed)[0]
    return full[:, :w], full[:, shift:shift + w]


def test_fuse_depths_matches_jax_and_picks_the_shift():
    """12 candidates at shifts 1..12 px, the true one 5: the fused hint
    equals JAX's but at near ties of the best two losses (counted), and
    picks the true shift on every textured interior pixel."""
    h, w, true = 64, 160, 5
    base, lookup = _pair(true, h, w)
    K, invK = data.scaled_K(h, w)
    shifts = np.arange(1, 13, dtype=np.float32)
    depths = np.broadcast_to((K[0, 0] * data.BASELINE / shifts)[:, None,
                                                               None],
                             (12, h, w)).astype(np.float32).copy()
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -data.BASELINE
    want = j_data.fuse_depths(depths, base, lookup, T, h, w)
    got = data.fuse_depths(depths, base, lookup, T, h, w, device="cpu")
    rep = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(a, (12,) + a.shape)))
    _, losses = data.fuse_candidates(
        torch.from_numpy(depths)[..., None], rep(base), rep(lookup),
        rep(K), rep(np.asarray(invK, np.float32)), rep(T))
    best2 = losses[..., 0].sort(dim=0).values[:2]
    ties = ((best2[1] - best2[0]) <= TIE * best2[0]).numpy()
    differ = got != want
    assert not (differ & ~ties).any()
    interior = np.zeros((h, w), bool)
    interior[:, 16:] = True
    assert int(ties.sum()) < 0.02 * h * w and not (ties & interior).any()
    d_true = K[0, 0] * data.BASELINE / true
    assert np.allclose(got[interior], d_true)


def test_sgbm_hint_and_split_match_jax(tmp_path):
    """The SGBM candidates and the fused hint of a pair equal JAX's (the
    same cv2 matchers; the fusion on the CPU here), and
    `precompute_for_split` writes what JAX's does, which
    `load_depth_hint` reads back (flipped with its item)."""
    from PIL import Image

    rs = np.random.RandomState(0)
    h, w, d = 64, 256, 8
    img = rs.randint(0, 255, (h, w + d, 3), np.uint8).astype(np.float32)
    img = ((img + np.roll(img, 1, 1) + np.roll(img, 1, 0)) / 3.0).astype(
        np.uint8)
    left, right = img[:, :-d], img[:, d:]
    K, _ = data.scaled_K(h, w)
    np.testing.assert_array_equal(
        data.compute_candidate_depths(left, right, float(K[0, 0])),
        j_data.compute_candidate_depths(left, right, float(K[0, 0])))
    for side in ("l", "r"):
        np.testing.assert_array_equal(
            data.compute_depth_hint(left, right, side, h, w, device="cpu"),
            j_data.compute_depth_hint(left, right, side, h, w))
    seq = "2011_09_26/2011_09_26_drive_0001_sync"
    for cam, im in (("image_02", left), ("image_03", right)):
        folder = tmp_path / "raw" / seq / cam / "data"
        os.makedirs(folder)
        Image.fromarray(im).save(str(folder / "0000000005.png"))
    raw = str(tmp_path / "raw")
    got = data.precompute_for_split(raw, [f"{seq} 5 l"], str(
        tmp_path / "port"), height=h, width=w, device="cpu")
    want = j_data.precompute_for_split(raw, [f"{seq} 5 l"], str(
        tmp_path / "jax"), height=h, width=w)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(np.load(got[0]), np.load(want[0]))
    hint = data.load_depth_hint(str(tmp_path / "port"), seq, 5, "l")
    np.testing.assert_array_equal(hint, j_data.load_depth_hint(
        str(tmp_path / "jax"), seq, 5, "l"))
    np.testing.assert_array_equal(
        data.load_depth_hint(str(tmp_path / "port"), seq, 5, "l",
                             do_flip=True), hint[:, ::-1])
    assert data.precompute_for_split(raw, [f"{seq} 5 l"], str(
        tmp_path / "port"), height=h, width=w, device="cpu") == []


def test_missing_host_modules_raise_and_name_them(monkeypatch):
    """Where cv2 or PIL is not installed, the SGBM step and the PNG
    reading raise ImportError naming the module; the fusion needs
    neither."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="'cv2'"):
        data.make_stereo_matchers()
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="'PIL.Image'"):
        data.precompute_for_split("nowhere", ["seq 1 l"])


@pytest.mark.parametrize("automask", [True, False])
def test_depth_hints_loss_without_hints_matches_jax(automask):
    """`use_depth_hints=False` (JAX :47-59) on a batch without hint
    planes: the loss, its per-scale terms and its gradient over every
    scale's disparity, with and without the automask; it differs from
    the loss with the hint. The automask noise is the loss test's key:
    with some keys one pixel's reprojection and identity losses tie
    within float32 rounding and the automask flips there (key 7 moves
    scale 3's gradient by 3.7e-3, key 6 scale 2's by 4.3e-4; keys 5 and
    8 leave every scale within 1.2e-5)."""
    batch = _batch()
    no_hint = {k: v for k, v in batch.items() if not k.startswith("depth")}
    key = jax.random.PRNGKey(5)
    kw = {} if automask else dict(disable_automasking=True)

    def f(d, b):
        loss, aux = j_hints.compute_depth_hints_losses(
            d, b, {}, key, JSelfSupConfig(height=H, width=W, **kw),
            use_depth_hints=False)
        return loss, {k: v for k, v in aux.items() if k.startswith("loss/")}

    (loss_j, aux_j), grad_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        _map(_disps(), jnp.asarray), _map(no_hint, jnp.asarray))
    cfg = SelfSupConfig(height=H, width=W, **kw)
    noise = (torch.from_numpy(np.array(jax.random.normal(
        key, hints.identity_noise_shape(cfg, B)))) if automask else None)
    disps = _map(_disps(), lambda a: torch.from_numpy(a).requires_grad_(True))
    loss, aux = hints.compute_depth_hints_losses(
        disps, _map(no_hint, torch.from_numpy), {}, noise, cfg,
        use_depth_hints=False)
    loss.backward()
    assert float(loss) == pytest.approx(float(loss_j), rel=LOSS_RTOL)
    for k, v in aux_j.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=LOSS_RTOL), k
    for s in range(4):
        g, w = disps[s].grad.double(), torch.from_numpy(
            np.array(grad_j[s])).double()
        assert float((g - w).norm() / w.norm()) <= GRAD_L2, s
    with torch.no_grad():
        with_hint, _ = hints.compute_depth_hints_losses(
            _map(_disps(), torch.from_numpy), _map(batch, torch.from_numpy),
            {}, noise, cfg)
    assert abs(float(with_hint) - float(loss)) > 1e-4
