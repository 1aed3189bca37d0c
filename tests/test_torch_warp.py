"""The port's per-column vertical resample (pass 2 of the separable EoT
warp) against the JAX package's `vertical_resample` and its VJP.

On the CPU the JAX side runs its jnp gather (`_vert_jnp` and its
adjoint; pallas_available() is False here) and the port its plain
PyTorch version, which is what the port's CUDA kernels are held to on
the card (chip_smoke.py). float32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.ops.pallas_warp import vertical_resample as j_vr
from depthmodelhardening_tpu.physics.calibration import Calibration
from depthmodelhardening_tpu.physics.eot import EoTCompositor, EoTConfig
from depthmodelhardening_tpu_torch.ops.warp import vertical_resample


def _geometry(kind, rng, Bn, OH, TW):
    if kind == "magnify":
        A = rng.uniform(0.5, 1.5, (Bn, TW))
        B = rng.uniform(-2.0, 2.0, (Bn, TW))
    elif kind == "minify_out_of_range":
        # most columns map partly or wholly outside [0, OH)
        A = rng.uniform(2.0, 6.0, (Bn, TW))
        B = rng.uniform(-3.0 * OH, OH, (Bn, TW))
    elif kind == "flat_and_negative":
        A = rng.uniform(-2.0, 2.0, (Bn, TW))
        A[:, ::4] = 0.0
        A[:, 1::6] = 1e-7
        B = rng.uniform(-5.0, OH + 5.0, (Bn, TW))
    else:  # the attack's own row maps at 1024x320, 256x256 tiles
        eot = EoTCompositor(EoTConfig(
            obj_h=OH, obj_w=300,
            projection=Calibration.default().P.astype(np.float32),
            proj_eps=0.0))
        z = jnp.asarray(rng.choice(np.arange(5, 31, 2), Bn), jnp.float32)
        a = jnp.asarray(rng.choice(np.arange(-30, 31, 5), Bn), jnp.float32)
        _, A, B, _, _ = jax.vmap(lambda zz, aa: eot._separable_geometry(
            zz, aa, None, 1024 / 1242, 320 / 375, 320, 1024, 256, TW))(z, a)
    return np.asarray(A, np.float32), np.asarray(B, np.float32)


@pytest.mark.parametrize("kind,shape", [
    ("magnify", (2, 3, 10, 12, 16)),
    ("minify_out_of_range", (3, 4, 37, 29, 33)),
    ("flat_and_negative", (2, 7, 20, 24, 19)),
    ("eot_rows", (2, 4, 200, 256, 256)),
])
def test_vertical_resample_matches_jax(kind, shape):
    Bn, C, OH, TH, TW = shape
    rng = np.random.RandomState(sum(shape))
    inter = rng.rand(Bn, C, OH, TW).astype(np.float32)
    A, B = _geometry(kind, rng, Bn, OH, TW)
    g = rng.randn(Bn, C, TH, TW).astype(np.float32)

    out_j, vjp = jax.vjp(lambda i: j_vr(i, jnp.asarray(A), jnp.asarray(B),
                                        TH), jnp.asarray(inter))
    (d_j,) = vjp(jnp.asarray(g))

    it = torch.from_numpy(inter).requires_grad_(True)
    out_t = vertical_resample(it, torch.from_numpy(A), torch.from_numpy(B),
                              TH)
    (d_t,) = torch.autograd.grad(out_t, it, torch.from_numpy(g))

    assert out_t.shape == (Bn, C, TH, TW)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_vertical_resample_gives_no_row_map_gradient():
    """A and B are functions of the EoT draw: no gradient flows to them
    (the JAX custom VJP returns zeros)."""
    rng = np.random.RandomState(3)
    inter = torch.from_numpy(rng.rand(1, 2, 8, 5).astype(np.float32))
    A = torch.ones(1, 5, requires_grad=True)
    B = torch.zeros(1, 5, requires_grad=True)
    out = vertical_resample(inter.requires_grad_(True), A, B, 6)
    gA, gB, gi = torch.autograd.grad(out.sum(), (A, B, inter),
                                     allow_unused=True)
    assert gA is None and gB is None and gi is not None
