"""The port's per-column vertical resample (pass 2 of the separable EoT
warp) against the JAX package's `vertical_resample` and its VJP.

On the CPU the JAX side runs its jnp gather (`_vert_jnp` and its
adjoint; pallas_available() is False here) and the port its plain
PyTorch version, which is what the port's CUDA kernels are held to on
the card (chip_smoke.py). float32, atol 1e-5. The adjoint kernel's
candidate row interval is held here through its float32 mirror
(`candidate_rows` below): it must contain every row the exact test
accepts.
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
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


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


def candidate_rows(A, B, k: int, th: int):
    """The tile rows [y0, y1) that `vertical_resample_bwd`'s kernel visits
    for object row k, each (B, TW) int64: the float32 mirror of its
    `candidate_rows` (csrc/vertical_resample.cu)."""
    kf = torch.tensor(float(k), dtype=torch.float32)
    e1 = (kf - 1.0 - B) / A
    e2 = (kf + 1.0 - B) / A
    err = 2.0 ** -20 * (A.abs() * float(th) + B.abs() + kf + 2.0)
    m = 1.0 + err / A.abs()
    lo = torch.minimum(e1, e2) - m
    hi = torch.maximum(e1, e2) + m
    finite = torch.isfinite(lo) & torch.isfinite(hi)
    y0 = torch.where(finite, torch.floor(lo).clamp(0.0, th), 0.0)
    y1 = torch.where(finite, (torch.floor(hi) + 1.0).clamp(0.0, th), th)
    return y0.to(torch.int64), y1.to(torch.int64)


def _row_maps(kind, rng, Bn, OH, TW):
    """(A, B) float32 (Bn, TW) row maps for the candidate-interval test."""
    if kind == "eot_rows":
        return _geometry(kind, rng, Bn, OH, TW)
    B = rng.uniform(-OH, 2.0 * OH, (Bn, TW))
    slopes = {"zero": 0.0, "tiny": 1e-7, "minus_tiny": -1e-7, "steep": 6.5,
              "very_steep": 1e3}
    if kind in slopes:
        A = np.full((Bn, TW), slopes[kind])
        B[:, ::3] = np.round(B[:, ::3])  # rows that sit on integers
    elif kind == "negative":
        A = rng.uniform(-6.5, -0.05, (Bn, TW))
    elif kind == "far_offsets":
        A = rng.uniform(-3.0, 3.0, (Bn, TW))
        B = rng.choice([-1e6, -1e4, 1e4, 1e6], (Bn, TW)) + rng.uniform(
            -OH, OH, (Bn, TW))
    else:  # near_integers: small slopes, offsets a few ulps off an integer
        A = rng.choice([1e-2, 1e-3, 1e-4, 1e-5, 3e-6, -1e-4, -1e-5],
                       (Bn, TW))
        B = np.round(rng.uniform(-2.0, OH + 2.0, (Bn, TW))).astype(np.float32)
        steps = rng.randint(-8, 9, (Bn, TW))
        for _ in range(8):
            B = np.where(steps > 0, np.nextafter(B, np.float32(np.inf)),
                         np.where(steps < 0,
                                  np.nextafter(B, np.float32(-np.inf)), B))
            steps = steps - np.sign(steps)
    return A.astype(np.float32), B.astype(np.float32)


@pytest.mark.parametrize("kind,OH,TH", [
    ("eot_rows", 200, 256), ("zero", 40, 37), ("tiny", 40, 256),
    ("minus_tiny", 40, 256), ("negative", 40, 64), ("steep", 60, 37),
    ("very_steep", 40, 256), ("far_offsets", 40, 64),
    ("near_integers", 40, 256), ("near_integers", 40, 1),
])
def test_adjoint_candidate_rows_hold_every_hit(kind, OH, TH):
    """Every tile row y whose float32 sy = A y + B has floor(sy) in
    {k - 1, k} (the kernel's exact test) lies in the interval the
    kernel loops over; at the attack's slopes the interval is short."""
    Bn, TW = 3, 64
    rng = np.random.RandomState(OH + TH)
    A, B = (torch.from_numpy(t.copy()) for t in _row_maps(kind, rng, Bn, OH,
                                                           TW))
    ys = torch.arange(TH, dtype=torch.float32)
    k0f = torch.floor(A[:, None, :] * ys[None, :, None] + B[:, None, :])
    yy = torch.arange(TH)[None, :, None]
    hits = 0
    for k in range(OH):
        hit = (k0f == float(k)) | (k0f + 1.0 == float(k))
        y0, y1 = candidate_rows(A, B, k, TH)
        inside = (yy >= y0[:, None, :]) & (yy < y1[:, None, :])
        assert not bool((hit & ~inside).any()), (kind, k)
        assert bool(((y0 >= 0) & (y0 <= y1) & (y1 <= TH)).all())
        hits += int(hit.sum())
        steep = A.abs() >= 0.5
        assert bool(((y1 - y0)[steep] <= 2.0 / A.abs()[steep] + 4).all())
    if kind in ("eot_rows", "negative", "near_integers"):
        assert hits > 0
