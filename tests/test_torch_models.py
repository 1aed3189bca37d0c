"""The port's Monodepth2 (ResNet-18 encoder + depth decoder) against the
JAX package's flax modules, and against the frozen PyTorch-reference
outputs.

Weights: the deterministic reference-layout state dicts of
tests/golden_common.py (random BatchNorm statistics, so eval-mode BN is
exercised), converted for flax by the JAX package's own converter and
moved into the port with `from_jax_variables`. 96x320, float32, eval
mode. Tolerances are tests/test_golden_fixtures.py's: rtol 5e-4 / atol
2e-4 (deep features reach O(100) under this init).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.models.torch_import import (
    convert_depth_decoder, convert_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_variables, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    init_monodepth2, make_monodepth2,
)

from golden_common import (
    FEAT_CROP, depth_decoder_state_dict, golden_input,
    resnet18_encoder_state_dict,
)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "monodepth2_rand.npz")
RTOL, ATOL = 5e-4, 2e-4


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def outputs():
    enc_sd = resnet18_encoder_state_dict(seed=0)
    dec_sd = depth_decoder_state_dict(seed=0)
    ev, _ = convert_resnet_encoder(enc_sd)
    dv = convert_depth_decoder(dec_sd)
    j_vars = {"params": {"encoder": ev["params"],
                         "decoder": dv["params"]},
              "batch_stats": {"encoder": ev["batch_stats"]}}
    x = golden_input(seed=0)

    jm = j_make_monodepth2()
    feats_j, disps_j = jm.apply(j_vars, jnp.asarray(x), train=False,
                                method=jm.features_and_disps)
    grad_j = jax.grad(lambda t: jnp.mean(jm.apply(j_vars, t) ** 2))(
        jnp.asarray(x))

    model = make_monodepth2()
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, j_vars)))
    model.eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    feats_t, disps_t = model.features_and_disps(xt)
    (grad_t,) = torch.autograd.grad(
        (disps_t[("disp", 0)] ** 2).mean(), xt)
    return dict(
        feats_j=[np.asarray(f) for f in feats_j],
        disps_j={s: np.asarray(disps_j[("disp", s)]) for s in range(4)},
        grad_j=np.asarray(grad_j),
        feats_t=[_nhwc(f) for f in feats_t],
        disps_t={s: _nhwc(disps_t[("disp", s)]) for s in range(4)},
        grad_t=grad_t.numpy(), enc_sd=enc_sd, dec_sd=dec_sd,
        port_sd=model.state_dict())


@pytest.mark.parametrize("i", range(5))
def test_encoder_feature_matches_jax(outputs, i):
    """Full maps, not the golden crop. A value that a deep layer sums
    to near zero from terms of the map's magnitude (max |f4| ~ 960)
    carries the rounding of those terms, so the absolute tolerance
    grows by 1e-6 of the map's max (8 ulps; measured: 7.6e-4 on f4)."""
    f_t, f_j = outputs["feats_t"][i], outputs["feats_j"][i]
    assert f_t.shape == f_j.shape
    np.testing.assert_allclose(f_t, f_j, rtol=RTOL,
                               atol=ATOL + 1e-6 * float(np.abs(f_j).max()))


@pytest.mark.parametrize("s", range(4))
def test_disparity_matches_jax(outputs, s):
    d_t, d_j = outputs["disps_t"][s], outputs["disps_j"][s]
    assert d_t.shape == d_j.shape == (1, 96 >> s, 320 >> s, 1)
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)


def test_input_gradient_matches_jax(outputs):
    """d mean(disp0^2) / d image: the path every PGD step takes through
    the model (stem pool backward included)."""
    g_t, g_j = outputs["grad_t"], outputs["grad_j"]
    scale = float(np.abs(g_j).max())
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, rtol=RTOL, atol=RTOL * scale)


def test_reference_state_dict_loads_the_same_weights(outputs):
    """The reference encoder.pth/depth.pth layout and the flax tree give
    the port identical parameters and statistics."""
    sd = load_reference_state_dict(outputs["enc_sd"], outputs["dec_sd"])
    port = outputs["port_sd"]
    assert set(sd) == set(port)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(v.numpy(), port[k].numpy(),
                                      err_msg=k)


def test_golden_outputs_through_reference_layout():
    """The port alone against the frozen torch-oracle outputs."""
    data = np.load(GOLDEN)
    model = make_monodepth2()
    model.load_state_dict(load_reference_state_dict(
        resnet18_encoder_state_dict(seed=0),
        depth_decoder_state_dict(seed=0)))
    model.eval()
    x = torch.from_numpy(golden_input(seed=int(data["input_seed"])))
    with torch.no_grad():
        feats, disps = model.features_and_disps(x)
        disp0 = model(x)
    for i, f in enumerate(feats):
        np.testing.assert_allclose(_nhwc(f)[FEAT_CROP], data[f"feat{i}_crop"],
                                   rtol=RTOL, atol=ATOL, err_msg=f"feat{i}")
    for s in range(4):
        np.testing.assert_allclose(_nhwc(disps[("disp", s)]),
                                   data[f"disp{s}"], atol=ATOL,
                                   err_msg=f"disp{s}")
    np.testing.assert_array_equal(disp0.numpy(), _nhwc(disps[("disp", 0)]))


def test_init_monodepth2_is_seeded():
    a = init_monodepth2(torch.Generator().manual_seed(3))
    b = init_monodepth2(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    with torch.no_grad():
        d = a.eval()(torch.rand(1, 64, 64, 3))
    assert d.shape == (1, 64, 64, 1) and bool(torch.isfinite(d).all())
