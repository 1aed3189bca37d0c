"""The port's EoT compositor against the JAX package's.

Two geometries:

* "monodepth2_K": the small-scene fixture of tests/test_pallas_warp.py
  (96x320 scene, Monodepth2 intrinsics, 40x60 object, 64x96 tiles,
  continuous z0 / yaw draws);
* "kitti": the attack tests' setup of tests/test_attacks.py (375x1242
  scenes through the KITTI P2 of `PhysObjAttackConfig.make_eot`, warped
  to a 96x320 model frame, 40x60 object, 96x256 tiles), at the eval
  grid's distances and yaws.

Inputs come from numpy seeds. The JAX side runs its jnp warp on the CPU
(pallas_available() is False here), the port its plain PyTorch versions.
Corners and tile offsets are integers and must be equal; the float32
homography, row maps, warps and texture gradients agree to 1e-5 (the
two sides round the same closed forms, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.attacks.base import (
    PhysObjAttackConfig as JPhysObjAttackConfig,
)
from depthmodelhardening_tpu.physics.eot import (
    EoTCompositor as JEoTCompositor, EoTConfig as JEoTConfig,
    monodepth2_K, solve_homography as j_solve_homography,
)
from depthmodelhardening_tpu_torch.attacks.base import PhysObjAttackConfig
from depthmodelhardening_tpu_torch.physics.eot import (
    EoTCompositor, EoTConfig, solve_homography,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, OH, OW = 4, 40, 60
MH, MW = 96, 320
ATOL = 1e-5


def _small_k():
    P = monodepth2_K(width=MW, height=MH)[:3, :].astype(np.float32)
    kw = dict(obj_h=OH, obj_w=OW, projection=P, proj_eps=0.0, scene_h=MH,
              scene_w=MW, veh_w=1.82, veh_h=1.6)
    rng = np.random.RandomState(0)
    z0s = rng.uniform(5, 30, B).astype(np.float32)
    alphas = rng.uniform(-30, 30, B).astype(np.float32)
    return (JEoTCompositor(JEoTConfig(**kw)), EoTCompositor(EoTConfig(**kw)),
            z0s, alphas, (64, 96), rng)


def _kitti():
    kw = dict(obj_h=OH, obj_w=OW, scene_h=MH, scene_w=MW, ori_h=375,
              ori_w=1242)
    rng = np.random.RandomState(1)
    z0s = rng.choice(np.arange(5, 31, 2), B).astype(np.float32)
    alphas = rng.choice(np.arange(-30, 31, 5), B).astype(np.float32)
    return (JPhysObjAttackConfig(**kw).make_eot(),
            PhysObjAttackConfig(**kw).make_eot(), z0s, alphas,
            (min(256, MH), min(256, MW)), rng)


@pytest.fixture(scope="module", params=["monodepth2_K", "kitti"])
def geo(request):
    eot_j, eot_t, z0s, alphas, (th, tw), rng = (
        _small_k() if request.param == "monodepth2_K" else _kitti())
    sh, sw = eot_t.cfg.scene_h, eot_t.cfg.scene_w
    return dict(
        eot_j=eot_j, eot_t=eot_t, z0s=z0s, alphas=alphas, th=th, tw=tw,
        obj=rng.rand(1, OH, OW, 3).astype(np.float32),
        mask=(rng.rand(1, OH, OW, 1) > 0.3).astype(np.float32),
        scenes_model=rng.rand(B, MH, MW, 3).astype(np.float32),
        scenes=rng.rand(B, sh, sw, 3).astype(np.float32),
        weights=rng.randn(B, MH, MW, 3).astype(np.float32))


def _j_geometry(g):
    eot = g["eot_j"]
    sx_f, sy_f = MW / eot.cfg.scene_w, MH / eot.cfg.scene_h
    return jax.vmap(lambda z, a: eot._separable_geometry(
        z, a, None, sx_f, sy_f, MH, MW, g["th"], g["tw"]))(
            jnp.asarray(g["z0s"]), jnp.asarray(g["alphas"]))


def test_corners_and_homography_match_jax(geo):
    ep_j = jax.vmap(geo["eot_j"].corners)(jnp.asarray(geo["z0s"]),
                                          jnp.asarray(geo["alphas"]))
    ep_t = geo["eot_t"].corners(torch.from_numpy(geo["z0s"]),
                                torch.from_numpy(geo["alphas"]))
    np.testing.assert_array_equal(ep_t.numpy(), np.asarray(ep_j))

    sp = geo["eot_j"].startpoints
    c_j = jax.vmap(lambda e: j_solve_homography(e, jnp.asarray(sp)))(ep_j)
    c_t = solve_homography(ep_t, geo["eot_t"].startpoints)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6,
                               atol=1e-9)
    # the quad has vertical edges: b = h = 0, the separable precondition
    assert not c_t[:, 1].any() and not c_t[:, 7].any()


def test_separable_geometry_matches_jax(geo):
    sx_j, A_j, B_j, y0_j, x0_j = _j_geometry(geo)
    sx_t, A_t, B_t, y0_t, x0_t = geo["eot_t"]._separable_geometry(
        geo["z0s"], geo["alphas"], MH, MW, geo["th"], geo["tw"])
    np.testing.assert_array_equal(y0_t.numpy(), np.asarray(y0_j))
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0_j))
    for t, j in ((sx_t, sx_j), (A_t, A_j), (B_t, B_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=ATOL)


def test_tiles_separable_matches_jax(geo):
    obj, mask = geo["obj"], geo["mask"]
    tiles_j, y0_j, x0_j = geo["eot_j"].tiles_separable(
        (jnp.asarray(obj),), jnp.asarray(mask), jnp.asarray(geo["z0s"]),
        jnp.asarray(geo["alphas"]), MH, MW, geo["th"], geo["tw"])
    tiles_t, y0_t, x0_t = geo["eot_t"].tiles_separable(
        (torch.from_numpy(obj),), torch.from_numpy(mask), geo["z0s"],
        geo["alphas"], MH, MW, geo["th"], geo["tw"])
    assert y0_t == [int(v) for v in np.asarray(y0_j)]
    assert x0_t == [int(v) for v in np.asarray(x0_j)]
    assert float(tiles_t[..., -1].sum()) > 0  # the quad is in the tile
    np.testing.assert_allclose(tiles_t.numpy(), np.asarray(tiles_j),
                               atol=ATOL)


def test_composite_tiled_model_values_and_texture_gradient(geo):
    """The attack loop's view: composite and d(sum(W * comp))/d texture."""
    obj, mask, W = geo["obj"], geo["mask"], geo["weights"]
    z, a = geo["z0s"], geo["alphas"]

    def j_view(o):
        return geo["eot_j"].composite_tiled_model(
            jnp.asarray(geo["scenes_model"]), o, jnp.asarray(mask),
            jnp.asarray(z), jnp.asarray(a), MH, MW, geo["th"], geo["tw"])

    (comp_j, mask_j), vjp = jax.vjp(j_view, jnp.asarray(obj))
    (g_j,) = vjp((jnp.asarray(W), jnp.zeros_like(mask_j)))

    o_t = torch.from_numpy(obj).requires_grad_(True)
    comp_t, mask_t = geo["eot_t"].composite_tiled_model(
        torch.from_numpy(geo["scenes_model"]), o_t, torch.from_numpy(mask),
        z, a, MH, MW, geo["th"], geo["tw"])
    (g_t,) = torch.autograd.grad((comp_t * torch.from_numpy(W)).sum(), o_t)

    np.testing.assert_allclose(comp_t.detach().numpy(), np.asarray(comp_j),
                               atol=ATOL)
    np.testing.assert_allclose(mask_t.detach().numpy(), np.asarray(mask_j),
                               atol=ATOL)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                               atol=ATOL * np.abs(g_j).max())


def test_composite_tiled_pair_matches_jax(geo):
    obj, mask = geo["obj"], geo["mask"]
    other = np.clip(obj + 0.05, 0.0, 1.0)
    outs_j = geo["eot_j"].composite_tiled_pair(
        jnp.asarray(geo["scenes_model"]), jnp.asarray(obj),
        jnp.asarray(other), jnp.asarray(mask), jnp.asarray(geo["z0s"]),
        jnp.asarray(geo["alphas"]), MH, MW, geo["th"], geo["tw"])
    outs_t = geo["eot_t"].composite_tiled_pair(
        torch.from_numpy(geo["scenes_model"]), torch.from_numpy(obj),
        torch.from_numpy(other), torch.from_numpy(mask), geo["z0s"],
        geo["alphas"], MH, MW, geo["th"], geo["tw"])
    for t, j in zip(outs_t, outs_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_warp_obj_mask_and_composite_match_jax(geo):
    """The exact warp at scene resolution that the eval finals take."""
    obj, mask, scenes = geo["obj"], geo["mask"], geo["scenes"]
    eot_j, eot_t = geo["eot_j"], geo["eot_t"]
    obj_j, m_j = eot_j.warp_obj_mask(jnp.asarray(obj), jnp.asarray(mask),
                                     jnp.asarray(geo["z0s"]),
                                     jnp.asarray(geo["alphas"]))
    comp_j = eot_j.composite(jnp.asarray(scenes), obj_j, m_j)
    obj_t, m_t = eot_t.warp_obj_mask(torch.from_numpy(obj),
                                     torch.from_numpy(mask), geo["z0s"],
                                     geo["alphas"])
    comp_t = eot_t.composite(torch.from_numpy(scenes), obj_t, m_t)
    assert float(m_t.sum()) > 0
    for t, j in ((obj_t, obj_j), (m_t, m_j), (comp_t, comp_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)

    comp2_t, mask2_t = eot_t.project_and_composite(
        torch.from_numpy(scenes), torch.from_numpy(obj),
        torch.from_numpy(mask), geo["z0s"], geo["alphas"])
    assert torch.equal(comp2_t, comp_t) and torch.equal(mask2_t, m_t)
