"""The port's ManyDepth (the cost-volume encoder `ResnetEncoderMatching`,
`ManyDepthModel`, `ManyDepthTrainModel`, `quarter_intrinsics`, the
reference `encoder.pth` layout and `load_manydepth_reference`) against
the JAX package's.

Sizes of the JAX package's own tests (`tests/test_matching_encoder.py`):
64x96 images, 8 depth bins, batch 2, ResNet-18; the lookups are the
current frame shifted by 2 columns and darkened, the poses translations
of 0.1 along x (item 1's second frame missing: an all-zero pose), so the
sweep has signal, edges and a missing frame. Parameters are flax's
initialisation with BatchNorm scale and running statistics drawn from a
seeded stream, converted with `from_jax_encoder` / `from_jax_variables`.

Tolerances, measured on the CPU:

* the depth bins: equal (the port rounds linspace as XLA:CPU does),
  linear and inverse, fixed and adaptive; under inverse binning the
  encoder's lowest_cost within two float32 ulps (INVERSE_ULP, 1.1e-7
  relative measured): JAX's jitted forward fuses the bins' reciprocal
  with lowest_cost's own and rounds some an ulp apart;
* the cost volume: 1e-5 relative + 1e-6 absolute, `missing` equal
  (measured: 2.4e-7 at most; the channel mean sums in another order);
* the encoder's features: the rtol 5e-4 / floor 1e-6 of the map's max of
  `test_torch_models.py` in eval mode (measured beyond the rtol: 5.9e-7
  of the max); in train mode a floor of 3e-4 of the max (flax's one-pass
  batch variance over the few values a channel has at batch 2; measured
  1.3e-4 on the zero-lookup general path's f4, whose stem batch is half
  constant images, 1.4e-5 with real lookups, 6.0e-6 on the skip path);
  lowest_cost and confidence equal: the volume's argmin has no near tie
  (within 1e-5) at these inputs, counted; bn1's running mean after a
  train-mode pass 1e-4 relative + 1e-5 absolute (2.1e-6 measured);
* disparities (/ 8.6437): 1e-6 absolute;
* the gradients of the features' mean squares over every weight,
  relative L2 per tensor (a tensor below 1e-3 of the largest norm held
  relative to that floor) and overall: eval mode 1e-5 and 1e-5
  (measured 6.3e-7 and 4.3e-7); train mode 0.06 and 0.04 (measured
  3.2e-2 and 2.3e-2 on the skip path, 2.6e-2 and 1.6e-2 with real
  lookups). In train mode at batch 2 JAX's gradient is the inaccurate
  one: with the pool swapped for F.max_pool2d so the port runs in
  float64, the port's float32 gradient lies within 8.2e-6 of it on
  every tensor above the floor, JAX's 3.2e-2 away (flax's one-pass
  variance; ROADMAP Queue 3).

The stem's pool is kernel B's plain version; JAX's is flax's max pool.
The forward is the same function; a tie in the backward could route
differently (ROADMAP Queue 3), and behind the ReLU none of the random
inputs here has one that matters (the gradients agree to the above).
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.models.matching_encoder import (
    ResnetEncoderMatching as JMatching,
)
from depthmodelhardening_tpu.models.wrappers import (
    ManyDepthModel as JManyDepthModel,
    ManyDepthTrainModel as JManyDepthTrainModel,
    quarter_intrinsics as j_quarter_intrinsics,
)
from depthmodelhardening_tpu.training import checkpoints as j_checkpoints
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_encoder, from_jax_variables, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.matching_encoder import (
    ResnetEncoderMatching, linspace01,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    ManyDepthModel, ManyDepthTrainModel, flax_init_, manydepth_rescale,
    MONODEPTH2_K, quarter_intrinsics,
)
from depthmodelhardening_tpu_torch.training import checkpoints

H, W, D, B = 64, 96, 8, 2
RTOL, FLOOR, TRAIN_FLOOR = 5e-4, 1e-6, 3e-4
COST_RTOL, COST_ATOL = 1e-5, 1e-6
TIE = 1e-5
DISP_ATOL = 1e-6
BN_RTOL, BN_ATOL = 1e-4, 1e-5
# train mode -> (per tensor, overall) relative L2 of the gradients
GRAD_L2 = {False: (1e-5, 1e-5), True: (0.06, 0.04)}
GRAD_FLOOR = 1e-3
K_NORM = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                   [0, 0, 0, 1]], np.float32)


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


def _perturbed(tree, rng):
    """BatchNorm scale 1 + 0.2 N, running mean 0.1 N, var 0.5 + U."""
    def walk(t, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, v)
                for k, v in t.items()}

    out = dict(tree)
    out["params"] = walk(tree["params"], lambda k, v: (
        (1 + 0.2 * rng.randn(*v.shape)).astype(np.float32) if k == "scale"
        else v))
    out["batch_stats"] = walk(tree["batch_stats"], lambda k, v: (
        (0.1 * rng.randn(*v.shape)).astype(np.float32) if k == "mean"
        else (0.5 + rng.rand(*v.shape)).astype(np.float32)))
    return out


def _inputs():
    rng = np.random.RandomState(0)
    cur = rng.rand(B, H, W, 3).astype(np.float32)
    lookup = np.stack([0.9 * np.roll(cur, 2, axis=2),
                       0.8 * np.roll(cur, -1, axis=2)], axis=1)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32),
                            (B, 2, 4, 4)).copy()
    poses[:, 0, 0, 3] = 0.1
    poses[:, 1, 0, 3] = -0.05
    poses[1, 1] = 0.0
    K, invK = j_quarter_intrinsics(K_NORM, W, H)
    return dict(cur=cur, lookup=lookup.astype(np.float32), poses=poses,
                K=np.broadcast_to(np.asarray(K), (B, 4, 4)).copy(),
                invK=np.broadcast_to(np.asarray(invK), (B, 4, 4)).copy())


@pytest.fixture(scope="module")
def enc():
    """JAX's encoder and variables, the port's encoder with them, the
    inputs."""
    j = JMatching(num_layers=18, input_height=H, input_width=W,
                  num_depth_bins=D)
    x = _inputs()
    v = _np(jax.jit(lambda k: j.init(
        k, jnp.asarray(x["cur"]), jnp.asarray(x["lookup"]),
        jnp.asarray(x["poses"]), jnp.asarray(x["K"]),
        jnp.asarray(x["invK"]), train=False))(jax.random.PRNGKey(0)))
    v = _perturbed(v, np.random.RandomState(1))
    port = ResnetEncoderMatching(num_layers=18, input_height=H,
                                 input_width=W, num_depth_bins=D)
    port.load_state_dict(from_jax_encoder(v))
    return dict(j=j, v=v, port=port, x=x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_call(port, x, zero, train, skip=False):
    lookup, poses = x["lookup"], x["poses"]
    if zero:
        lookup, poses = np.zeros_like(lookup[:, :1]), np.zeros_like(
            poses[:, :1])
    return port.train(train)(
        _t(x["cur"]).permute(0, 3, 1, 2),
        _t(lookup).permute(0, 1, 4, 2, 3), _t(poses), _t(x["K"]),
        _t(x["invK"]), skip_cost_volume=skip)


def _jax_call(enc, zero, train, skip=False):
    x = enc["x"]
    lookup, poses = x["lookup"], x["poses"]
    if zero:
        lookup, poses = np.zeros_like(lookup[:, :1]), np.zeros_like(
            poses[:, :1])

    def f(v, *a):
        if train:
            out, mut = enc["j"].apply(v, *a, train=True, skip_cost_volume=skip,
                                      mutable=["batch_stats"])
            return out, mut["batch_stats"]
        return enc["j"].apply(v, *a, train=False,
                              skip_cost_volume=skip), v["batch_stats"]

    return _np(jax.jit(f)(enc["v"], *(jnp.asarray(a) for a in (
        x["cur"], lookup, poses, x["K"], x["invK"]))))


@pytest.mark.parametrize("n", [8, 96])
def test_depth_bins_equal_jax(n):
    """The fixed bins, and adaptive ones from the caller's endpoints."""
    j = JMatching(num_depth_bins=n)
    p = ResnetEncoderMatching(num_depth_bins=n)
    bins = jax.jit(lambda a, b: j._depth_bins(a, b))
    want = np.asarray(bins(jnp.float32(0.1), jnp.float32(20.0)))
    np.testing.assert_array_equal(p.depth_bins().numpy(), want)
    p = ResnetEncoderMatching(num_depth_bins=n, adaptive_bins=True)
    want = np.asarray(bins(jnp.float32(0.7), jnp.float32(12.5)))
    np.testing.assert_array_equal(p.depth_bins(0.7, 12.5).numpy(), want)
    assert linspace01(n)[-1] == 1.0 and linspace01(n)[0] == 0.0


def test_cost_volume_matches_jax(enc):
    """The plane-sweep volume and its missing mask of layer1-like
    features, two lookup frames with nonzero poses (item 1's second
    frame missing), against JAX `_cost_volume`."""
    x = enc["x"]
    rng = np.random.RandomState(5)
    cur = rng.rand(B, H // 4, W // 4, 16).astype(np.float32)
    look = np.stack([np.roll(cur, 1, axis=2) + 0.05 * rng.rand(
        *cur.shape).astype(np.float32), rng.rand(*cur.shape)
        .astype(np.float32)], axis=1).astype(np.float32)
    j = enc["j"]
    bins = j._depth_bins(jnp.float32(0.1), jnp.float32(20.0))
    cost_j, miss_j = _np(jax.jit(j._cost_volume)(
        *(jnp.asarray(a) for a in (cur, look, x["poses"], x["K"],
                                   x["invK"])), bins))
    cost, miss = enc["port"].cost_volume(
        _t(cur), _t(look), _t(x["poses"]), _t(x["K"]), _t(x["invK"]),
        enc["port"].depth_bins())
    np.testing.assert_array_equal(miss.numpy(), miss_j)
    np.testing.assert_allclose(cost.numpy(), cost_j, rtol=COST_RTOL,
                               atol=COST_ATOL)
    assert 0 < miss_j.mean() < 1 and cost_j.max() > 0


@pytest.mark.parametrize("path", ["skip", "zero", "real"])
@pytest.mark.parametrize("train", [False, True])
def test_matching_encoder_matches_jax(enc, path, train):
    """Features, lowest_cost and confidence of `skip_cost_volume` (zero
    lookups, the current frame stemmed alone), the general path on zero
    lookups and on the real lookups, in eval and train mode (each path
    its own BatchNorm statistics: the general path's stem sees (1 + F) B
    images), and the updated running statistics."""
    port = copy.deepcopy(enc["port"])
    zero = path != "real"
    (feats_j, low_j, conf_j), stats_j = _jax_call(enc, zero, train,
                                                  path == "skip")
    with torch.no_grad():
        feats, low, conf = _port_call(port, enc["x"], zero, train,
                                      path == "skip")
    floor = TRAIN_FLOOR if train else FLOOR
    for f, fj in zip(feats, feats_j):
        np.testing.assert_allclose(_nhwc(f), fj, rtol=RTOL,
                                   atol=floor * float(np.abs(fj).max()))
    np.testing.assert_array_equal(conf.numpy(), conf_j)
    if path == "real":
        assert 0 < conf_j.mean() < 1
    np.testing.assert_array_equal(low.numpy(), low_j)
    if train:
        got = port.state_dict()
        n = (1 if path == "skip" else 1 + (1 if zero else 2)) * B
        np.testing.assert_allclose(
            got["bn1.running_mean"].numpy(), stats_j["bn1"]["mean"],
            rtol=BN_RTOL, atol=BN_ATOL)
        assert int(got["bn1.num_batches_tracked"]) == 1
        assert feats[0].shape[0] == B and n in (2, 4, 6)


def test_lowest_cost_has_no_near_ties(enc):
    """The argmin of the volume (empty bins read 100) has a clear winner
    at every pixel of these inputs, so lowest_cost is held for
    equality."""
    x = enc["x"]
    port = enc["port"].eval()
    with torch.no_grad():
        _, f1 = port._stem(torch.cat([_t(x["cur"]), _t(x["lookup"]).flatten(
            0, 1)]).permute(0, 3, 1, 2), torch.float32)
        nhwc = f1.permute(0, 2, 3, 1)
        cost, _ = port.cost_volume(nhwc[:B], nhwc[B:].reshape(
            B, 2, H // 4, W // 4, -1), _t(x["poses"]), _t(x["K"]),
            _t(x["invK"]), port.depth_bins())
    viz = torch.where(cost == 0, 100.0, cost).sort(dim=1).values
    gap = (viz[:, 1] - viz[:, 0]) / viz[:, 0]
    # exact ties are the all-missing pixels (every bin reads 100), where
    # both take bin 0
    exact = gap == 0
    assert bool((viz[:, 0][exact] == 100.0).all())
    assert int(((gap > 0) & (gap < TIE)).sum()) == 0


@pytest.mark.parametrize("path", ["skip", "real"])
@pytest.mark.parametrize("train", [False, True])
def test_matching_encoder_gradients_match_jax(enc, path, train):
    """The gradient of the features' mean squares over every weight, on
    the single-frame path and on the real lookups (through the stem's
    batch statistics, which the lookups share in train mode; none
    through the volume), in eval and train mode, against jax.grad."""
    x = enc["x"]
    j, v = enc["j"], enc["v"]
    skip = path == "skip"

    def loss(params, *a):
        out = j.apply({"params": params, "batch_stats": v["batch_stats"]},
                      *a, train=train, skip_cost_volume=skip,
                      mutable=["batch_stats"] if train else False)
        feats = (out[0] if train else out)[0]
        return sum(jnp.mean(f ** 2) for f in feats)

    g = _np(jax.jit(jax.grad(loss))(v["params"], *(jnp.asarray(a) for a in (
        x["cur"], x["lookup"], x["poses"], x["K"], x["invK"]))))
    port = copy.deepcopy(enc["port"])
    feats, _, _ = _port_call(port, x, False, train, skip)
    sum((f ** 2).mean() for f in feats).backward()
    want = from_jax_encoder({"params": g})
    got = {n: p.grad for n, p in port.named_parameters()
           if p.grad is not None}
    assert set(want) - set(got) == {"prematching_conv.weight",
                                    "prematching_conv.bias"}
    big = max(float(want[n].norm()) for n in got)
    errs = {n: float((got[n] - want[n]).norm())
            / max(float(want[n].norm()), GRAD_FLOOR * big) for n in got}
    num = sum(float((got[n] - want[n]).norm()) ** 2 for n in got)
    den = sum(float(want[n].norm()) ** 2 for n in got)
    worst = max(errs, key=errs.get)
    limit, limit_all = GRAD_L2[train]
    assert errs[worst] <= limit, (worst, errs[worst])
    assert (num / den) ** 0.5 <= limit_all, (num / den) ** 0.5


@pytest.fixture(scope="module")
def models(enc):
    """JAX's ManyDepthModel and ManyDepthTrainModel variables (the encoder
    of `enc`, flax's decoder) and the port's models with them."""
    x = enc["x"]
    jm = JManyDepthModel(input_height=H, input_width=W, num_depth_bins=D)
    jt = JManyDepthTrainModel(input_height=H, input_width=W,
                              num_depth_bins=D)
    vm = _np(jax.jit(lambda k: jm.init(k, jnp.asarray(x["cur"]),
                                       jnp.asarray(x["K"]),
                                       jnp.asarray(x["invK"])))(
        jax.random.PRNGKey(3)))
    v = {"params": {"encoder": enc["v"]["params"],
                    "decoder": vm["params"]["decoder"]},
         "batch_stats": {"encoder": enc["v"]["batch_stats"]}}
    pm = ManyDepthModel(input_height=H, input_width=W, num_depth_bins=D)
    pt = ManyDepthTrainModel(input_height=H, input_width=W,
                             num_depth_bins=D)
    for m in (pm, pt):
        m.load_state_dict(from_jax_variables(v))
    return dict(jm=jm, jt=jt, v=v, pm=pm.eval(), pt=pt)


def test_manydepth_model_matches_jax(enc, models):
    """`ManyDepthModel` (adaptive bins, given as 0.5 and 15): the
    single-frame disparity (zero lookups through the general path) and
    `multi_frame`'s disparity, lowest_cost and confidence, in eval mode;
    the disparity is the sigmoid over 8.6437."""
    x = enc["x"]
    jm, v, pm = models["jm"], models["v"], models["pm"]
    a = [jnp.asarray(x[k]) for k in ("cur", "K", "invK")]
    d_j = np.asarray(jax.jit(lambda v: jm.apply(v, *a, 0.5, 15.0))(v))
    m_j = _np(jax.jit(lambda v: jm.apply(
        v, a[0], jnp.asarray(x["lookup"]), jnp.asarray(x["poses"]), *a[1:],
        0.5, 15.0, method="multi_frame"))(v))
    with torch.no_grad():
        d = pm(_t(x["cur"]), _t(x["K"]), _t(x["invK"]), 0.5, 15.0)
        m = pm.multi_frame(_t(x["cur"]), _t(x["lookup"]), _t(x["poses"]),
                           _t(x["K"]), _t(x["invK"]), 0.5, 15.0)
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0, atol=DISP_ATOL)
    assert float(d.max()) <= 1 / 8.6437
    np.testing.assert_allclose(m[0].numpy(), m_j[0], rtol=0,
                               atol=DISP_ATOL)
    np.testing.assert_array_equal(m[1].numpy(), m_j[1])
    np.testing.assert_array_equal(m[2].numpy(), m_j[2])
    assert float((m[0] - d).abs().max()) > 0
    np.testing.assert_allclose(
        manydepth_rescale(torch.tensor([8.6437])).numpy(), [1.0], rtol=1e-7)


@pytest.mark.parametrize("train", [False, True])
def test_manydepth_train_model_matches_jax(enc, models, train):
    """`ManyDepthTrainModel`: `features_and_disps` (the single-frame mode
    through `skip_cost_volume`, fixed bins) and `features_and_disps_multi`
    (the real lookups' volume), every scale's disparity, in eval and
    train mode."""
    x = enc["x"]
    jt, v = models["jt"], models["v"]
    look, poses = x["lookup"][:, :1], x["poses"][:, :1]

    def f(v, cur, look, poses):
        kw = dict(train=train, mutable=["batch_stats"]) if train else \
            dict(train=False)
        single = jt.apply(v, cur, method="features_and_disps", **kw)
        multi = jt.apply(v, cur, look, poses,
                         method="features_and_disps_multi", **kw)
        if train:
            single, multi = single[0], multi[0]
        return single[1], multi[1]

    want = _np(jax.jit(f)(v, *(jnp.asarray(a) for a in (x["cur"], look,
                                                          poses))))
    for name, (got_fn, w) in {
            "single": (lambda m: m.features_and_disps(_t(x["cur"])),
                       want[0]),
            "multi": (lambda m: m.features_and_disps_multi(
                _t(x["cur"]), _t(look), _t(poses)), want[1])}.items():
        pt = copy.deepcopy(models["pt"]).train(train)
        with torch.no_grad():
            _, disps = got_fn(pt)
        for s in range(4):
            np.testing.assert_allclose(
                _nhwc(disps[("disp", s)]), w[("disp", s)], rtol=0,
                atol=DISP_ATOL, err_msg=f"{name} disp {s}")
    pt = copy.deepcopy(models["pt"]).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            pt(_t(x["cur"])).numpy(),
            _nhwc(pt.features_and_disps(_t(x["cur"]))[1][("disp", 0)]))


def test_quarter_intrinsics_equal_jax():
    """In float64 as JAX `quarter_intrinsics` (the evaluation), in float32
    as JAX `ManyDepthTrainModel._quarter_K` (the trainer), bit for bit."""
    for wh in ((W, H), (640, 192), (1024, 320)):
        got = quarter_intrinsics(K_NORM, wh[1], wh[0])
        want = j_quarter_intrinsics(K_NORM, *wh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        got = quarter_intrinsics(MONODEPTH2_K, wh[1], wh[0], np.float32)
        want = JManyDepthTrainModel._quarter_K(types.SimpleNamespace(
            input_width=wh[0], input_height=wh[1]), 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


def test_load_manydepth_reference_matches_jax(tmp_path, enc):
    """A ManyDepth weights folder written by `export_manydepth_reference`
    (a seeded port model's encoder regrouped as the reference's, with its
    metadata; depth.pth) loads into the port as the tensors JAX's
    `convert_matching_encoder` gives, and the loaded `ManyDepthModel` (96
    bins, as JAX's) at the metadata's size predicts as JAX's loaded model
    with the metadata's bins."""
    seeded = flax_init_(ManyDepthModel(input_height=H, input_width=W),
                        torch.Generator().manual_seed(4))
    sd = seeded.state_dict()
    meta = {"height": H, "width": W, "min_depth_bin": 0.7,
            "max_depth_bin": 12.5, "use_stereo": False}
    folder = checkpoints.export_manydepth_reference(
        str(tmp_path), 0, sd, height=H, width=W, min_depth_bin=0.7,
        max_depth_bin=12.5)
    enc_pth = torch.load(os.path.join(folder, "encoder.pth"),
                         weights_only=True)
    dec = torch.load(os.path.join(folder, "depth.pth"), weights_only=True)
    assert "layer1.1.0.conv1.weight" in enc_pth
    assert "reduce_conv.0.bias" in enc_pth
    model, got_meta = checkpoints.load_manydepth_reference(folder,
                                                           device="cpu")
    assert got_meta == meta and not model.training
    j_model, j_vars, j_meta = j_checkpoints.load_manydepth_reference(
        folder)
    want = from_jax_variables(_np(j_vars))
    got = model.state_dict()
    assert set(got) == set(want) == set(sd)
    for k, t in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], t), k
            assert torch.equal(got[k], sd[k]), k
    assert set(load_reference_state_dict(enc_pth, dec, kind="manydepth")) \
        == {k for k in got if not k.endswith("num_batches_tracked")} | {
            k for k in got if k.endswith("num_batches_tracked")}
    x = enc["x"]
    d_j = np.asarray(jax.jit(lambda v: j_model.apply(
        v, *(jnp.asarray(x[k]) for k in ("cur", "K", "invK")),
        j_meta["min_depth_bin"], j_meta["max_depth_bin"]))(j_vars))
    with torch.no_grad():
        d = model(_t(x["cur"]), _t(x["K"]), _t(x["invK"]),
                  got_meta["min_depth_bin"], got_meta["max_depth_bin"])
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0, atol=DISP_ATOL)


# -- the options: inverse binning, missing bins at 0, fixed endpoints ---------
INVERSE_ULP = 2.4e-7  # two float32 ulps, relative (1.1e-7 measured)

@pytest.mark.parametrize("n", [8, 96])
def test_inverse_and_fixed_bins_equal_jax(n):
    """Inverse binning's fixed and adaptive bins, and linear bins between
    fixed endpoints given to the constructor, as JAX's jitted
    `_depth_bins` rounds them."""
    def bins(**kw):
        j = JMatching(num_depth_bins=n, **kw)
        return jax.jit(lambda a, b: j._depth_bins(a, b))

    inv = bins(depth_binning="inverse")
    p = ResnetEncoderMatching(num_depth_bins=n, depth_binning="inverse")
    want = np.asarray(inv(jnp.float32(0.1), jnp.float32(20.0)))
    np.testing.assert_array_equal(p.depth_bins().numpy(), want)
    assert np.all(np.diff(want) > 0) and want[0] == np.float32(0.1)
    p = ResnetEncoderMatching(num_depth_bins=n, depth_binning="inverse",
                              adaptive_bins=True)
    want = np.asarray(inv(jnp.float32(0.7), jnp.float32(12.5)))
    np.testing.assert_array_equal(p.depth_bins(0.7, 12.5).numpy(), want)
    p = ResnetEncoderMatching(num_depth_bins=n, min_depth_bin=0.5,
                              max_depth_bin=15.0)
    want = np.asarray(bins()(jnp.float32(0.5), jnp.float32(15.0)))
    np.testing.assert_array_equal(p.depth_bins(0.7, 12.5).numpy(), want)
    with pytest.raises(NotImplementedError):
        ResnetEncoderMatching(depth_binning="log")


@pytest.mark.parametrize("binning,missing_max", [
    ("inverse", True), ("linear", False), ("inverse", False)])
def test_matching_encoder_options_match_jax(enc, binning, missing_max):
    """The volume (its missing bins left at 0 without
    `set_missing_to_max`) and the encoder's features, lowest_cost and
    confidence on the real lookups, in eval mode, under each option."""
    x = enc["x"]
    kw = dict(depth_binning=binning, set_missing_to_max=missing_max)
    j = JMatching(num_layers=18, input_height=H, input_width=W,
                  num_depth_bins=D, **kw)
    port = ResnetEncoderMatching(num_layers=18, input_height=H,
                                 input_width=W, num_depth_bins=D, **kw)
    port.load_state_dict(enc["port"].state_dict())
    port.eval()
    rng = np.random.RandomState(5)
    cur = rng.rand(B, H // 4, W // 4, 16).astype(np.float32)
    look = np.stack([np.roll(cur, 1, axis=2), rng.rand(*cur.shape)
                     .astype(np.float32)], axis=1).astype(np.float32)
    bins = j._depth_bins(jnp.float32(0.1), jnp.float32(20.0))
    cost_j, miss_j = _np(jax.jit(j._cost_volume)(
        *(jnp.asarray(a) for a in (cur, look, x["poses"], x["K"],
                                   x["invK"])), bins))
    cost, miss = port.cost_volume(_t(cur), _t(look), _t(x["poses"]),
                                  _t(x["K"]), _t(x["invK"]),
                                  port.depth_bins())
    np.testing.assert_array_equal(miss.numpy(), miss_j)
    np.testing.assert_allclose(cost.numpy(), cost_j, rtol=COST_RTOL,
                               atol=COST_ATOL)
    assert miss_j.any()
    assert (cost_j[miss_j > 0] == 0).all() != missing_max
    (feats_j, low_j, conf_j) = _np(jax.jit(lambda v, *a: j.apply(
        v, *a, train=False))(enc["v"], *(jnp.asarray(x[k]) for k in (
            "cur", "lookup", "poses", "K", "invK"))))
    with torch.no_grad():
        feats, low, conf = _port_call(port, x, False, False)
    for f, fj in zip(feats, feats_j):
        np.testing.assert_allclose(_nhwc(f), fj, rtol=RTOL,
                                   atol=FLOOR * float(np.abs(fj).max()))
    np.testing.assert_array_equal(conf.numpy(), conf_j)
    _assert_lowest_cost(low, low_j, binning)


def _assert_lowest_cost(low, low_j, binning):
    """Equal under linear bins; under inverse bins within INVERSE_ULP
    relative: JAX's jitted forward fuses the bins' reciprocal with
    lowest_cost's 1 / bins[argmin], and rounds some of them an ulp
    apart (the bins alone are equal, test_inverse_and_fixed_bins_equal_jax)."""
    if binning == "linear":
        np.testing.assert_array_equal(low.numpy(), low_j)
    else:
        np.testing.assert_allclose(low.numpy(), low_j, rtol=INVERSE_ULP,
                                   atol=0)


def test_train_model_fixed_bins_match_jax(enc, models):
    """`ManyDepthTrainModel` with fixed bins 0.5 .. 15 (JAX's
    `min_depth_bin` / `max_depth_bin` fields): the real lookups'
    disparities, in eval mode."""
    x = enc["x"]
    jt = JManyDepthTrainModel(input_height=H, input_width=W,
                              num_depth_bins=D, min_depth_bin=0.5,
                              max_depth_bin=15.0)
    look, poses = x["lookup"][:, :1], x["poses"][:, :1]
    want = _np(jax.jit(lambda v, *a: jt.apply(
        v, *a, method="features_and_disps_multi", train=False)[1])(
        models["v"], *(jnp.asarray(a) for a in (x["cur"], look, poses))))
    pt = ManyDepthTrainModel(input_height=H, input_width=W,
                             num_depth_bins=D, min_depth_bin=0.5,
                             max_depth_bin=15.0)
    pt.load_state_dict(models["pt"].state_dict())
    with torch.no_grad():
        _, disps = pt.eval().features_and_disps_multi(_t(x["cur"]), _t(look),
                                                      _t(poses))
        _, base = copy.deepcopy(models["pt"]).eval().features_and_disps_multi(
            _t(x["cur"]), _t(look), _t(poses))
    for s in range(4):
        np.testing.assert_allclose(_nhwc(disps[("disp", s)]),
                                   want[("disp", s)], rtol=0, atol=DISP_ATOL)
    assert float((disps[("disp", 0)] - base[("disp", 0)]).abs().max()) > 0


class _JInverseManyDepth(JManyDepthModel):
    """JAX's ManyDepthModel with inverse binning (its own bins linearly,
    whatever a checkpoint says)."""

    def setup(self):
        from depthmodelhardening_tpu.models.depth_decoder import DepthDecoder

        self.encoder = JMatching(
            num_layers=self.num_layers, input_height=self.input_height,
            input_width=self.input_width, num_depth_bins=self.num_depth_bins,
            adaptive_bins=True, depth_binning="inverse", name="encoder")
        self.decoder = DepthDecoder(scales=tuple(self.scales), name="decoder")


def test_load_inverse_binned_manydepth_reference_matches_jax(tmp_path, enc):
    """A folder whose metadata says `depth_binning: "inverse"` loads into
    a ManyDepthModel that bins inversely: its multi-frame disparity,
    lowest_cost and confidence against JAX's encoder with inverse bins
    and the folder's weights (JAX's loader, which keeps linear bins)."""
    seeded = flax_init_(ManyDepthModel(input_height=H, input_width=W),
                        torch.Generator().manual_seed(4))
    folder = checkpoints.export_manydepth_reference(
        str(tmp_path), 0, seeded.state_dict(), height=H, width=W,
        min_depth_bin=0.7, max_depth_bin=12.5)
    path = os.path.join(folder, "encoder.pth")
    torch.save(dict(torch.load(path, weights_only=True),
                    depth_binning="inverse"), path)
    model, meta = checkpoints.load_manydepth_reference(folder, device="cpu")
    assert meta["depth_binning"] == "inverse"
    assert model.encoder.depth_binning == "inverse"
    _, j_vars, _ = j_checkpoints.load_manydepth_reference(folder)
    j_model = _JInverseManyDepth(input_height=H, input_width=W)
    x = enc["x"]
    want = _np(jax.jit(lambda v: j_model.apply(
        v, *(jnp.asarray(x[k]) for k in ("cur", "lookup", "poses", "K",
                                         "invK")), 0.7, 12.5,
        method="multi_frame"))(j_vars))
    with torch.no_grad():
        got = model.multi_frame(_t(x["cur"]), _t(x["lookup"]),
                                _t(x["poses"]), _t(x["K"]), _t(x["invK"]),
                                0.7, 12.5)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=DISP_ATOL)
    _assert_lowest_cost(got[1], want[1], "inverse")
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    linear = ManyDepthModel(input_height=H, input_width=W)
    linear.load_state_dict(model.state_dict())
    with torch.no_grad():
        low = linear.eval().multi_frame(
            _t(x["cur"]), _t(x["lookup"]), _t(x["poses"]), _t(x["K"]),
            _t(x["invK"]), 0.7, 12.5)[1]
    assert not torch.equal(low, got[1])
