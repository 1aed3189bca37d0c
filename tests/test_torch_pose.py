"""The port's pose networks and pose geometry against the JAX package:
`ops/geometry.py`'s transform from the pose network's parameters,
`ResnetEncoder(num_input_images=2)`, `PoseDecoder` and `PoseCNN`, the
reference `.pth` import of the pose nets and the SimSiam head
(`models/convert.py:load_reference_state_dict`) against the torch oracles
of tests/torch_oracles.py and JAX's `convert_*`, and
`evaluation/pose_eval.py`.

Weights are flax's initialisations (jitted `init`), converted with
`models/convert.py`, with BatchNorm running statistics set away from 0
and 1. The port runs its plain CPU versions (the stem pool's), the JAX
package its CPU path. Tolerances:

* geometry: 1e-6 absolute on the 4x4 transforms (float32 Rodrigues in
  another order of the same ops; the near-zero angles go through the
  1e-7 guard in both);
* pose nets: relative L2 1e-5 per output (features, axisangle,
  translation) in eval and train mode, but 2e-5 for the encoder's
  features in train mode, where each BatchNorm normalises over its batch
  (n = 12 values a channel at layer4 here) and so scales the rounding
  of the layers before it: 1.0e-5 measured at layer4, 5.7e-6 at layer3,
  the pose outputs within 1e-5 all the same; the encoder's running statistics
  after a train-mode pass 1e-5 relative + 1e-6 (the variance JAX's
  batch update times n / (n - 1), torch's unbiased one);
* reference import: the port's module from the oracle's state dict
  within 1e-5 of the oracle's output (torch against torch in another
  layout: the same sums) and of JAX's on `convert_*` of the same dict;
* pose eval: `trajectory_ates` equal to JAX's (the same numpy);
  `predict_pair_poses` within 1e-5 of JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.evaluation import pose_eval as j_pose_eval
from depthmodelhardening_tpu.models.pose import (
    PoseCNN as JPoseCNN, PoseDecoder as JPoseDecoder,
)
from depthmodelhardening_tpu.models.resnet import (
    ResnetEncoder as JResnetEncoder,
)
from depthmodelhardening_tpu.models.simsiam import SimSiam as JSimSiam
from depthmodelhardening_tpu.models.torch_import import (
    convert_pose_cnn, convert_pose_decoder, convert_resnet_encoder,
    convert_simsiam,
)
from depthmodelhardening_tpu.ops import geometry as j_geometry
from depthmodelhardening_tpu_torch.evaluation import pose_eval
from depthmodelhardening_tpu_torch.models.convert import (
    from_jax_convs, from_jax_encoder, load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.pose import (
    PoseCNN, PoseDecoder, init_pose_nets, make_pose_nets,
)
from depthmodelhardening_tpu_torch.models.resnet import ResnetEncoder
from depthmodelhardening_tpu_torch.models.simsiam import SimSiam
from depthmodelhardening_tpu_torch.ops import geometry

from torch_oracles import TorchPoseDecoder, TorchSimSiam
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

H, W, B = 64, 96, 2
GEOM_ATOL = 1e-6
NET_L2 = 1e-5
TRAIN_FEAT_L2 = 2e-5
BN_RTOL, BN_ATOL = 1e-5, 1e-6
IMPORT_ATOL = 1e-5
POSE_EVAL_ATOL = 1e-5


def _rl2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _perturbed_stats(stats, seed):
    """Running statistics away from flax's 0 / 1 initialisation: means
    moved by up to 0.2, variances scaled by 0.5 to 1.5."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = (v + rng.uniform(-0.2, 0.2, v.shape)).astype(
                    np.float32)
            else:
                out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(
                    np.float32)
        return out
    return walk(stats)


# -- geometry -----------------------------------------------------------------
def _axisangles():
    rng = np.random.RandomState(0)
    rand = rng.uniform(-0.3, 0.3, (6, 1, 3)).astype(np.float32)
    tiny = np.array([[[0.0, 0.0, 0.0]], [[1e-9, -2e-9, 3e-9]],
                     [[1e-7, 0.0, 0.0]], [[3e-6, -1e-6, 2e-6]]], np.float32)
    return np.concatenate([rand, tiny])


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert):
    """Rodrigues with the 1e-7 guard, the translation matrix and their
    product (T @ R, or R^T @ T(-t) inverted) on random and near-zero
    axis-angles."""
    aa = _axisangles()
    t = np.random.RandomState(1).uniform(-1, 1, aa.shape).astype(np.float32)
    want = j_geometry.transformation_from_parameters(
        jnp.asarray(aa), jnp.asarray(t), invert=invert)
    got = geometry.transformation_from_parameters(
        torch.from_numpy(aa), torch.from_numpy(t), invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GEOM_ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        geometry.rot_from_axisangle(torch.from_numpy(aa)).numpy(),
        np.asarray(j_geometry.rot_from_axisangle(jnp.asarray(aa))),
        atol=GEOM_ATOL, rtol=0)
    np.testing.assert_array_equal(
        geometry.get_translation_matrix(torch.from_numpy(t)).numpy(),
        np.asarray(j_geometry.get_translation_matrix(jnp.asarray(t))))
    # an inverted transform undoes the forward one
    fwd = geometry.transformation_from_parameters(
        torch.from_numpy(aa), torch.from_numpy(t), invert=not invert)
    np.testing.assert_allclose((got @ fwd).numpy(),
                               np.broadcast_to(np.eye(4), got.shape),
                               atol=1e-6)


def test_transform_gradient_is_finite_at_zero_angle():
    """The guard keeps the gradient finite at a zero axis-angle, where the
    pose network's first steps start."""
    aa = torch.zeros(2, 1, 3, requires_grad=True)
    t = torch.zeros(2, 1, 3, requires_grad=True)
    geometry.transformation_from_parameters(aa, t, invert=True).sum() \
        .backward()
    assert torch.isfinite(aa.grad).all() and torch.isfinite(t.grad).all()


# -- pose networks -------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_pose_nets():
    """flax's initial pose encoder (two stacked frames) and decoder, the
    encoder's statistics perturbed."""
    enc = JResnetEncoder(num_layers=18, num_input_images=2)
    dec = JPoseDecoder(num_input_features=1, num_frames_to_predict_for=2)
    pair = jnp.zeros((1, H, W, 6))
    v_enc = _np_tree(jax.jit(lambda k: enc.init(k, pair, train=False))(
        jax.random.PRNGKey(1)))
    v_enc["batch_stats"] = _perturbed_stats(v_enc["batch_stats"], 2)
    feats = jax.jit(lambda v: enc.apply(v, pair, train=False))(v_enc)
    v_dec = _np_tree(jax.jit(lambda k: dec.init(k, [feats]))(
        jax.random.PRNGKey(3)))
    x = np.random.RandomState(4).rand(B, H, W, 6).astype(np.float32)
    return dict(enc=enc, dec=dec, v_enc=v_enc, v_dec=v_dec, x=x)


def _port_pose_nets(j):
    enc, dec = make_pose_nets()
    enc.load_state_dict(from_jax_encoder(j["v_enc"]))
    dec.load_state_dict(from_jax_convs(j["v_dec"]))
    return enc, dec


@pytest.mark.parametrize("train", [False, True])
def test_pose_nets_match_jax(jax_pose_nets, train):
    """Encoder (6-channel stem) + decoder on converted flax variables, in
    eval mode (running statistics) and in train mode (batch statistics,
    the running ones updated)."""
    j = jax_pose_nets

    def run(v_enc, v_dec, x):
        if train:
            feats, mut = j["enc"].apply(v_enc, x, train=True,
                                        mutable=["batch_stats"])
        else:
            feats, mut = j["enc"].apply(v_enc, x, train=False), {}
        return feats, j["dec"].apply(v_dec, [feats]), mut

    feats_j, (aa_j, t_j), mut = jax.jit(run)(j["v_enc"], j["v_dec"],
                                             jnp.asarray(j["x"]))
    enc, dec = _port_pose_nets(j)
    enc.train(train)
    dec.train(train)
    old = {k: v.clone() for k, v in enc.state_dict().items()}
    with torch.no_grad():
        feats = enc(torch.from_numpy(j["x"]).permute(0, 3, 1, 2))
        aa, t = dec([feats])
    assert aa.shape == t.shape == (B, 2, 1, 3)
    for f, fj in zip(feats, feats_j):
        assert _rl2(f.permute(0, 2, 3, 1), fj) <= (
            TRAIN_FEAT_L2 if train else NET_L2)
    assert _rl2(aa, aa_j) <= NET_L2 and _rl2(t, t_j) <= NET_L2
    sd = enc.state_dict()
    if not train:
        assert all(torch.equal(sd[k], old[k]) for k in sd)
        return
    new = from_jax_encoder({"params": j["v_enc"]["params"],
                            "batch_stats": _np_tree(mut["batch_stats"])})
    counts = bn_counts(enc, (B, 6, H, W))
    assert len(counts) == 20
    for mod, n in counts.items():
        mean, var = f"{mod}.running_mean", f"{mod}.running_var"
        np.testing.assert_allclose(sd[mean].numpy(), new[mean].numpy(),
                                   rtol=BN_RTOL, atol=BN_ATOL, err_msg=mean)
        want = 0.9 * old[var] + (new[var] - 0.9 * old[var]) * n / (n - 1)
        np.testing.assert_allclose(sd[var].numpy(), want.numpy(),
                                   rtol=BN_RTOL, atol=BN_ATOL, err_msg=var)


def bn_counts(module, shape):
    """{BatchNorm name: the values per channel it sees} in one pass of
    `module` on zeros of `shape` (on a copy, in eval mode)."""
    counts = {}
    module = copy.deepcopy(module).eval()
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(
                lambda mm, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    with torch.no_grad():
        module(torch.zeros(shape))
    return counts


def test_pose_cnn_matches_jax():
    """PoseCNN on converted flax variables; its reference layout (`net.<i>`,
    `pose_conv`) loads into the same module."""
    net = JPoseCNN(num_input_frames=2)
    x = np.random.RandomState(5).rand(B, H, W, 6).astype(np.float32)
    v = _np_tree(jax.jit(lambda k: net.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(6)))
    aa_j, t_j = jax.jit(net.apply)(v, jnp.asarray(x))
    port = PoseCNN(num_input_frames=2)
    port.load_state_dict(from_jax_convs(v))
    with torch.no_grad():
        aa, t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert aa.shape == (B, 1, 1, 3)
    assert _rl2(aa, aa_j) <= NET_L2 and _rl2(t, t_j) <= NET_L2
    ref = {(f"net.{k[len('convs_'):]}" if k.startswith("convs_") else k): v
           for k, v in port.state_dict().items()}
    twin = PoseCNN(num_input_frames=2)
    twin.load_state_dict(load_reference_state_dict(ref, kind="pose_cnn"))
    v_ref = convert_pose_cnn(ref)
    for k, w in twin.state_dict().items():
        assert torch.equal(w, port.state_dict()[k]), k
    aa_r, _ = jax.jit(net.apply)(v_ref, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(aa_r), aa.numpy(), atol=IMPORT_ATOL)


def test_init_pose_nets_is_flax_default():
    """Seeded flax-default initialisation: the same seed gives the same
    nets, lecun-normal kernels truncated at 2 sigma', zero biases,
    identity BatchNorm; the encoder's stem takes 6 channels."""
    a = init_pose_nets(torch.Generator().manual_seed(1))
    b = init_pose_nets(torch.Generator().manual_seed(1))
    for ma, mb in zip(a, b):
        for (name, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), name
    enc, dec = a
    assert enc.conv1.weight.shape == (64, 6, 7, 7)
    assert not dec.squeeze.bias.any()
    w = dec.pose_0.weight.detach()
    assert float(w.std()) * np.sqrt(w[0].numel()) == pytest.approx(1.0,
                                                                  rel=0.02)
    assert torch.equal(enc.bn1.running_var, torch.ones(64))


# -- the reference .pth import ----------------------------------------------------
def test_reference_pose_decoder_imports():
    """`pose.pth` (`net.0` .. `net.3`: squeeze, pose_0, pose_1, pose_2)
    -> the port's PoseDecoder: the oracle's output, and JAX's on
    `convert_pose_decoder` of the same dict."""
    torch.manual_seed(2)
    oracle = TorchPoseDecoder().eval()
    feat = np.random.RandomState(7).rand(B, 2, 3, 512).astype(np.float32)
    f = torch.from_numpy(feat).permute(0, 3, 1, 2)
    port = PoseDecoder()
    port.load_state_dict(load_reference_state_dict(oracle.state_dict(),
                                                   kind="pose"))
    with torch.no_grad():
        want, got = oracle([[f]]), port([[f]])
    aa_j, t_j = JPoseDecoder().apply(convert_pose_decoder(
        oracle.state_dict()), [[jnp.asarray(feat)]])
    for g, w, j in zip(got, want, (aa_j, t_j)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=IMPORT_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=IMPORT_ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_reference_simsiam_imports(train):
    """SimSiam's reference layout (`projector.<i>`, `predictor.<i>`;
    BatchNorm1d at projector 1, 4, 7 and predictor 1, their running
    statistics perturbed) -> the port's SimSiam: the oracle's loss in
    eval and train mode, and JAX's on `convert_simsiam`."""
    torch.manual_seed(3)
    oracle = TorchSimSiam().train(train)
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    sd = oracle.state_dict()
    port = SimSiam()
    port.load_state_dict(load_reference_state_dict(sd, kind="simsiam"))
    port.train(train)
    rng = np.random.RandomState(8)
    f1, f2 = (rng.rand(4, 2, 3, 512).astype(np.float32) for _ in range(2))
    nchw = lambda a: [torch.from_numpy(a).permute(0, 3, 1, 2)]
    with torch.no_grad():
        want = float(oracle(nchw(f1), nchw(f2)))
        got = float(port(nchw(f1), nchw(f2)))
    v = convert_simsiam(sd)
    loss_j = JSimSiam().apply(v, [jnp.asarray(f1)], [jnp.asarray(f2)],
                              train=train, mutable=["batch_stats"])[0]
    assert got == pytest.approx(want, abs=IMPORT_ATOL)
    assert got == pytest.approx(float(loss_j), abs=IMPORT_ATOL)


def test_reference_pose_encoder_imports(jax_pose_nets):
    """`pose_encoder.pth` ("encoder."-prefixed trunk with a 6-channel
    conv1 and a classifier head) -> the port's ResnetEncoder(
    num_input_images=2); JAX's `convert_resnet_encoder` of the same dict
    gives the same features."""
    j = jax_pose_nets
    enc, _ = _port_pose_nets(j)
    ref = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    ref["encoder.fc.weight"] = torch.zeros(1000, 512)
    ref["encoder.fc.bias"] = torch.zeros(1000)
    twin = ResnetEncoder(18, num_input_images=2)
    twin.load_state_dict(load_reference_state_dict(ref, kind="pose_encoder"))
    for k, w in twin.state_dict().items():
        assert torch.equal(w, enc.state_dict()[k]), k
    v, _ = convert_resnet_encoder(ref)
    feats_j = jax.jit(lambda v, x: j["enc"].apply(v, x, train=False))(
        v, jnp.asarray(j["x"]))
    with torch.no_grad():
        feats = twin.eval()(torch.from_numpy(j["x"]).permute(0, 3, 1, 2))
    assert _rl2(feats[-1].permute(0, 2, 3, 1), feats_j[-1]) <= NET_L2


@pytest.mark.parametrize("kw,err", [
    (dict(kind="pose_decoder"), ValueError),
    (dict(decoder_sd={}, kind="pose"), ValueError),
    (dict(kind="depth"), ValueError)])
def test_reference_kinds_are_checked(kw, err):
    with pytest.raises(err):
        load_reference_state_dict({}, **kw)


# -- pose eval -------------------------------------------------------------------
def _gt_poses(n=12, seed=0):
    rs = np.random.RandomState(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        T = np.eye(4)
        a = rs.uniform(-0.05, 0.05)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        T[:3, 3] = rs.uniform(-0.2, 0.2, 3) + [0, 0, 1.0]
        poses.append(poses[-1] @ T)
    return np.stack([p[:3] for p in poses])


def test_trajectory_ates_equal_jax():
    """The trajectory ATE of noisy predictions equals JAX's; an exact
    prediction gives zero."""
    g = _gt_poses()
    pred = j_pose_eval.local_gt_poses(g)
    noisy = pred + np.random.RandomState(1).normal(0, 0.01, pred.shape)
    got = pose_eval.trajectory_ates(noisy, g)
    want = j_pose_eval.trajectory_ates(noisy, g)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(pose_eval.local_gt_poses(g), pred)
    assert pose_eval.trajectory_ates(pred, g)[0] < 1e-9


def test_predict_pair_poses_matches_jax(jax_pose_nets):
    """The port's pose nets in eval mode on three (B, H, W, 6) pairs
    against JAX `predict_pair_poses`; the nets keep their mode."""
    j = jax_pose_nets
    rng = np.random.RandomState(9)
    pairs = [rng.rand(B, H, W, 6).astype(np.float32) for _ in range(3)]
    enc_apply = jax.jit(lambda v, x, train=False: j["enc"].apply(
        v, x, train=False))
    want = j_pose_eval.predict_pair_poses(
        enc_apply, jax.jit(j["dec"].apply),
        {"pose_encoder": j["v_enc"], "pose_decoder": j["v_dec"]}, pairs)
    enc, dec = _port_pose_nets(j)
    enc.train()
    got = pose_eval.predict_pair_poses(enc, dec, pairs, device="cpu")
    assert got.shape == (3 * B, 4, 4) and enc.training
    np.testing.assert_allclose(got, want, atol=POSE_EVAL_ATOL, rtol=0)


def test_predict_pair_poses_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    enc, dec = make_pose_nets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pose_eval.predict_pair_poses(enc, dec, [np.zeros((1, 64, 64, 6))])
