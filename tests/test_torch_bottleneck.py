"""The port's Bottleneck ResNets (ResNet-50/101/152 encoders and the
Monodepth2 model on ResNet-50) against the JAX package's flax modules.

Weights: flax's initialisation of a JAX `MonodepthModel(num_layers=50)`
at 64x96, BatchNorm scale, bias and running statistics then drawn from a
seeded numpy stream (so eval mode and the fold are exercised), moved
into the port with `from_jax_variables`. Batch 2, float32.

Tolerances, each measured on the CPU and stated with its reading:

* features and disparities in eval mode: rtol 5e-4 with an absolute
  floor of 1e-6 of the map's largest magnitude (`test_torch_models.py`'s
  rule: a deep value summed to near zero from terms of the map's size
  carries their rounding; measured beyond the rtol: 3.6e-7 of the max);
* in train mode the floor is 1e-3 of the max: flax's one-pass batch
  variance (E[x^2] - E[x]^2, ROADMAP Queue 3) over the few values a
  channel has at batch 2 (12 in layer4) moves each of the 16 blocks'
  normalisation by its rounding (measured beyond the rtol: 4.9e-6 of
  the max on f1, 1.1e-4 on f3, 6.8e-4 on f4; disp0 5.8e-6 absolute);
* the gradients of mean(disp0^2) over the input and every weight,
  relative L2 per tensor (a tensor below 1e-3 of the largest norm held
  relative to that floor) and overall: eval mode 5e-3 and 1e-4
  (measured 1.7e-3 on layer3.0.conv1, 5.7e-4 on the input, 4.2e-5
  overall); train mode 0.1 and 0.05 (measured 7.2e-2, 6.1e-2 on the
  input, 4.0e-2 overall). Train mode at batch 2 and 64x96 is ill
  conditioned in float32: with the pool swapped for F.max_pool2d so it
  runs in float64, the encoder's input gradient in float32 lies 1.4e-2
  from its float64 value in the port and 4.7e-2 in JAX (flax's one-pass
  variance), while in eval mode both lie 6.6e-5 from it;
* the folded eval forward against the unfolded one and against JAX's
  folded one: `test_torch_bf16_kernels.py::
  test_fold_matches_unfolded_and_jax`'s 2e-5 of the map's largest
  magnitude.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.models.resnet import (
    encoder_channels as j_encoder_channels,
)
from depthmodelhardening_tpu.models.torch_import import (
    export_depth_decoder, export_resnet_encoder,
)
from depthmodelhardening_tpu.models.wrappers import (
    MonodepthModel as JMonodepthModel,
)
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_variables, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.resnet import (
    Bottleneck, ResnetEncoder, encoder_channels,
)
from depthmodelhardening_tpu_torch.models.wrappers import make_monodepth2

H, W, B = 64, 96, 2
RTOL, FLOOR, TRAIN_FLOOR = 5e-4, 1e-6, 1e-3
# train mode -> (per tensor, overall) relative L2 of the gradients
GRAD_L2 = {False: (5e-3, 1e-4), True: (0.1, 0.05)}
GRAD_FLOOR = 1e-3
FOLD_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's CPU passes with 2 intra-op threads while this module
    runs: the suite runs several test processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturbed(variables, seed):
    """BatchNorm scale / bias and running mean / var drawn from a seeded
    stream: scale 1 + 0.2 N, bias 0.1 N, mean 0.1 N, var 0.5 + U."""
    rng = np.random.RandomState(seed)

    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, v)
                for k, v in tree.items()}

    params = walk(variables["params"], lambda k, v: (
        (1 + 0.2 * rng.randn(*v.shape)).astype(np.float32) if k == "scale"
        else v))
    params = walk(params, lambda k, v: v)
    stats = walk(variables["batch_stats"], lambda k, v: (
        (0.1 * rng.randn(*v.shape)).astype(np.float32) if k == "mean"
        else (0.5 + rng.rand(*v.shape)).astype(np.float32)))
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def r50():
    jm = JMonodepthModel(num_layers=50)
    x = np.random.RandomState(1).rand(B, H, W, 3).astype(np.float32)
    v = _np(jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                      train=False))(jax.random.PRNGKey(0)))
    v = _perturbed(v, 2)
    port = make_monodepth2(50)
    port.load_state_dict(from_jax_variables(v))
    return dict(jm=jm, v=v, x=x, port=port)


def _j_features(r50, train, fold=False):
    jm = r50["jm"].clone(fold_bn=fold) if fold else r50["jm"]

    def f(v, x):
        out = jm.apply(v, x, train=train, mutable=["batch_stats"] if train
                       else False, method="features_and_disps")
        (feats, disps), _ = out if train else (out, None)
        return feats, disps[("disp", 0)]

    return _np(jax.jit(f)(r50["v"], jnp.asarray(r50["x"])))


def _assert_close(got, want, floor=FLOOR):
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=floor * float(np.abs(want).max()))


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_features_and_disparity_match_jax(r50, train):
    """The five feature maps (64, 256, 512, 1024, 2048 channels) and
    disp0 of the Monodepth2 model on ResNet-50 in eval mode (running
    statistics) and in train mode (batch statistics)."""
    feats_j, disp_j = _j_features(r50, train)
    port = copy.deepcopy(r50["port"]).train(train)
    with torch.no_grad():
        feats, disps = port.features_and_disps(torch.from_numpy(r50["x"]))
    assert [f.shape[1] for f in feats] == [64, 256, 512, 1024, 2048]
    floor = TRAIN_FLOOR if train else FLOOR
    for i, (f, fj) in enumerate(zip(feats, feats_j)):
        assert _nhwc(f).shape == fj.shape, i
        _assert_close(_nhwc(f), fj, floor)
    _assert_close(_nhwc(disps[("disp", 0)]), disp_j, floor)


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_gradients_match_jax(r50, train):
    """The gradient of mean(disp0^2) over the input image and over every
    weight of encoder and decoder, against jax.grad, in eval mode (the
    attack's pass) and in train mode (the student's step)."""
    jm, v = r50["jm"], r50["v"]

    def loss(params, x):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       x, train=train,
                       mutable=["batch_stats"] if train else False)
        return jnp.mean((out[0] if train else out) ** 2)

    g_params, g_x = _np(jax.jit(jax.grad(loss, argnums=(0, 1)))(
        v["params"], jnp.asarray(r50["x"])))
    port = copy.deepcopy(r50["port"]).train(train)
    x = torch.from_numpy(r50["x"]).requires_grad_(True)
    (port(x) ** 2).mean().backward()
    want = from_jax_variables({"params": g_params})
    got = {n: p.grad for n, p in port.named_parameters()
           if p.grad is not None}
    # heads 1-3 are not evaluated by disp0: no gradient in either
    assert len(got) == len(want) - 6
    want = {n: want[n].double() for n in got}
    want["x"], got["x"] = torch.from_numpy(np.array(g_x)).double(), x.grad
    big = max(float(w.norm()) for w in want.values())
    errs = {n: float((got[n].double() - w).norm())
            / max(float(w.norm()), GRAD_FLOOR * big)
            for n, w in want.items()}
    overall = (sum(float((got[n].double() - w).norm()) ** 2
                   for n, w in want.items())
               / sum(float(w.norm()) ** 2 for w in want.values())) ** 0.5
    worst = max(errs, key=errs.get)
    limit, limit_all = GRAD_L2[train]
    assert errs[worst] <= limit, (worst, errs[worst])
    assert errs["x"] <= limit and overall <= limit_all, (errs["x"], overall)


def test_resnet50_fold_matches_unfolded_and_jax(r50):
    """Eval mode with `fold_bn`: the Bottleneck's three BatchNorms and
    the projection's folded into their convs, against the port's
    unfolded forward and JAX's `fold_bn=True` one."""
    feats_j, disp_j = _j_features(r50, False, fold=True)
    port = copy.deepcopy(r50["port"]).eval()
    x = torch.from_numpy(r50["x"])
    with torch.no_grad():
        plain = port.features_and_disps(x)
        port.fold_bn = True
        folded = port.features_and_disps(x)
    for f, p, fj in zip(folded[0], plain[0], feats_j):
        scale = float(np.abs(fj).max())
        np.testing.assert_allclose(_nhwc(f), _nhwc(p), rtol=0,
                                   atol=FOLD_ATOL * scale)
        np.testing.assert_allclose(_nhwc(f), fj, rtol=0,
                                   atol=FOLD_ATOL * scale)
    np.testing.assert_allclose(_nhwc(folded[1][("disp", 0)]), disp_j,
                               rtol=0, atol=FOLD_ATOL)


def test_resnet50_reference_layout_loads(r50):
    """The reference `encoder.pth` (torchvision ResNet-50 names: conv3,
    bn3, downsample.0/1, the metadata keys) and `depth.pth`, as the JAX
    package exports them, load into the port as the same tensors as the
    flax tree gives."""
    v = r50["v"]
    enc = export_resnet_encoder(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, height=H, width=W)
    enc["encoder.fc.weight"] = np.zeros((1000, 2048), np.float32)
    dec = export_depth_decoder({"params": v["params"]["decoder"]})
    sd = load_reference_state_dict(enc, dec)
    port = r50["port"].state_dict()
    assert set(sd) == {k for k in port if not k.endswith(
        "num_batches_tracked")}
    for k, t in sd.items():
        assert torch.equal(t, port[k]), k
    assert "encoder.layer3.5.conv3.weight" in sd
    assert "encoder.layer4.0.downsample.1.running_var" in sd


@pytest.mark.parametrize("layers,blocks", [(50, (3, 4, 6, 3)),
                                           (101, (3, 4, 23, 3)),
                                           (152, (3, 8, 36, 3))])
def test_bottleneck_depths_build(layers, blocks):
    """ResNet-50/101/152 build with torchvision's blocks a stage, only the
    first block of each stage projecting, and the JAX package's channel
    counts; ResNet-18/34 keep theirs."""
    enc = ResnetEncoder(layers)
    for i, n in enumerate(blocks):
        layer = getattr(enc, f"layer{i + 1}")
        assert len(layer) == n
        assert all(isinstance(b, Bottleneck) for b in layer)
        assert [b.downsample is not None for b in layer] == \
            [True] + [False] * (n - 1)
    assert encoder_channels(layers) == tuple(j_encoder_channels(layers))
    assert enc.num_ch_enc == (64, 256, 512, 1024, 2048)
    for n in (18, 34):
        assert encoder_channels(n) == tuple(j_encoder_channels(n))
    with pytest.raises(ValueError, match="num_layers"):
        ResnetEncoder(26)
