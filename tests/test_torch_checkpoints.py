"""The port's checkpoints (`training/checkpoints.py`) against the JAX
package's: a save and restore round trip of the mono+stereo hardening
trainer's state (student, SimSiam head, pose nets, Adam, step and the
trainer's generators) is exact; a run resumed from a checkpoint takes the
same steps as the uninterrupted run, bit for bit (the resumed trainer
draws from the restored generators); pruning keeps the latest `keep`;
`opt.json` is the JAX package's for the same options; the reference
`weights_<epoch>/{encoder,depth}.pth` the port exports read back through
the JAX package's `load_reference_pth` give the port's disparities within
1e-5 (a seeded model: the same weights in two frameworks' float32
forwards).

Sizes: the model at 32x64, 96x320 frames ("0", "-1", "1", "s"), a 24x36
car, batch 4 (SimSiam's BatchNorm needs more than 2), L-inf PGD with one
step on attack batch 2; CPU plain versions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthmodelhardening_tpu.models.wrappers import (
    make_monodepth2 as j_make_monodepth2,
)
from depthmodelhardening_tpu.training import checkpoints as j_checkpoints
from depthmodelhardening_tpu.training.config import (
    AdvSynthConfig as JAdvSynthConfig, HardeningConfig as JHardeningConfig,
    SelfSupConfig as JSelfSupConfig,
)
from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    init_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.training import checkpoints
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer

H, W, B = 32, 64, 4
ORI_H, ORI_W = 96, 320
FRAMES = ("0", "-1", "1", "s")
EXPORT_ATOL = 1e-5
SS = dict(height=H, width=W, frame_ids=FRAMES)
ADV = dict(norm_type="l_inf", steps=1, attack_batch_size=2, ori_h=ORI_H,
           ori_w=ORI_W)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trainer(seed=0):
    cfg = HardeningConfig(selfsup=SelfSupConfig(**SS),
                          adv=AdvSynthConfig(**ADV), batch_size=B)
    teacher = predictor_from(init_monodepth2(torch.Generator().manual_seed(9)))
    return HardeningTrainer(cfg, torch.Generator().manual_seed(seed),
                            *make_car_object(36, 24, seed=3), teacher,
                            device="cpu", steps_per_epoch=10)


def _inputs():
    frames = {f: torch.from_numpy(make_scene(B, ORI_H, ORI_W, seed=i))
              for i, f in enumerate(FRAMES)}
    return (frames, torch.tensor([True, False, True, False]),
            torch.tensor([False, True, True, False]),
            torch.from_numpy(make_scene(1, ORI_H, ORI_W, seed=7)))


def _step(trainer, state):
    return trainer.train_step(state, *_inputs())


def _everything(trainer, state):
    """Every tensor a checkpoint carries, by name."""
    out = {f"{k}.{n}": v for k, m in state.modules().items()
           for n, v in m.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["generator"] = trainer.generator.get_state()
    out["noise_generator"] = trainer.noise_generator.get_state()
    return out


def test_round_trip_is_exact(tmp_path):
    """A state after one step, saved and restored into a fresh trainer of
    another seed: every parameter, statistic, Adam moment and count, the
    step and both generators' states equal."""
    a = _trainer()
    state, _ = _step(a, a.make_state())
    assert set(state.modules()) == {"model", "simsiam", "pose_encoder",
                                    "pose_decoder"}
    path = checkpoints.save_state(str(tmp_path), 1, state, trainer=a)
    assert os.path.isfile(os.path.join(path, checkpoints.STATE_FILE))
    b = _trainer(seed=5)
    fresh = b.make_state()
    restored = checkpoints.restore_state(str(tmp_path), fresh, trainer=b)
    assert restored is fresh and restored.step == 1
    want, got = _everything(a, state), _everything(b, restored)
    assert set(got) == set(want) and len(state.optimizer.state) == len(
        list(p for m in state.modules().values() for p in m.parameters()))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(m.training for m in restored.modules().values())


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    """Two steps straight, against one step, a checkpoint, a new trainer
    restored from it and its step: the same losses and the same state,
    bit for bit."""
    a = _trainer()
    state = a.make_state()
    losses = []
    for _ in range(2):
        state, m = _step(a, state)
        losses.append(float(m["loss"]))
    b = _trainer()
    s1, m1 = _step(b, b.make_state())
    checkpoints.save_state(str(tmp_path), 1, s1, trainer=b)
    c = _trainer(seed=11)
    s2 = checkpoints.restore_state(str(tmp_path), c.make_state(), trainer=c)
    s2, m2 = _step(c, s2)
    assert [float(m1["loss"]), float(m2["loss"])] == losses
    assert s2.step == state.step == 2
    want, got = _everything(a, state), _everything(c, s2)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pruning_keeps_the_latest(tmp_path):
    a = _trainer()
    state = a.make_state()
    for step in (3, 1, 7, 5, 9):
        checkpoints.save_state(str(tmp_path), step, state, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["5", "7", "9"]
    assert checkpoints.latest_step(str(tmp_path)) == 9
    assert checkpoints.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoints.restore_state(str(tmp_path / "none"), state)
    with pytest.raises(ValueError, match="generator"):
        checkpoints.restore_state(str(tmp_path), state, trainer=a)
    plain = HardeningTrainer(
        HardeningConfig(selfsup=SelfSupConfig(height=H, width=W),
                        adv=AdvSynthConfig(**ADV), supervised_adv=False,
                        contrastive_learning=False, batch_size=B),
        torch.Generator().manual_seed(0), *make_car_object(36, 24),
        device="cpu")
    with pytest.raises(ValueError, match="holds"):
        checkpoints.restore_state(str(tmp_path), plain.make_state())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(selfsup=dict(frame_ids=FRAMES, height=192, width=640),
         adv=dict(norm_type="l_inf", steps=5, attack_crop_w=320),
         compute_dtype="bfloat16", learning_rate=1e-4)])
def test_options_equal_jax(tmp_path, kw):
    """`save_options` writes the JAX package's opt.json for the same
    options, byte for byte."""
    ss, adv = kw.get("selfsup", {}), kw.get("adv", {})
    rest = {k: v for k, v in kw.items() if k not in ("selfsup", "adv")}
    checkpoints.save_options(str(tmp_path / "port"), HardeningConfig(
        selfsup=SelfSupConfig(**ss), adv=AdvSynthConfig(**adv), **rest))
    j_checkpoints.save_options(str(tmp_path / "jax"), JHardeningConfig(
        selfsup=JSelfSupConfig(**ss), adv=JAdvSynthConfig(**adv), **rest))
    got, want = ((tmp_path / d / "opt.json").read_text()
                 for d in ("port", "jax"))
    assert got == want
    assert json.loads(got)["compute_dtype"] == rest.get("compute_dtype",
                                                        "float32")


def test_exported_weights_read_back_in_jax(tmp_path):
    """`export_reference_pth` of a seeded model: JAX `load_reference_pth`
    reads the files into variables whose disparities lie within 1e-5 of
    the port's; the port's own `load_reference_pth` gives back every
    tensor and the metadata. (The golden weights' random statistics drive
    the deep features to O(100), where the two float32 forwards part by
    2.7e-5 in disparity: the file format is not what this measures.)"""
    model = init_monodepth2(torch.Generator().manual_seed(4))
    folder = checkpoints.export_reference_pth(str(tmp_path), 3,
                                              model.state_dict(), height=64,
                                              width=128, use_stereo=True)
    assert sorted(os.listdir(folder)) == ["depth.pth", "encoder.pth"]
    back, meta = checkpoints.load_reference_pth(folder)
    assert meta == {"height": 64, "width": 128, "use_stereo": True}
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    jm = j_make_monodepth2()
    variables, j_meta = j_checkpoints.load_reference_pth(folder, jm)
    assert int(j_meta["height"]) == 64
    x = np.random.RandomState(2).rand(2, 64, 128, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=EXPORT_ATOL, rtol=0)


def test_manydepth_reference_names_its_slice(tmp_path):
    """ManyDepth weights load (ported in slice 6b): a folder written by
    `export_manydepth_reference` from a seeded model (the encoder
    regrouped as the reference's, with its metadata; depth.pth) gives
    back the model's tensors, at the metadata's size, in eval mode, on
    the device asked for (tests/test_torch_manydepth.py holds the load
    against JAX's)."""
    from depthmodelhardening_tpu_torch.models.wrappers import (
        ManyDepthModel, flax_init_,
    )

    model = flax_init_(ManyDepthModel(input_height=64, input_width=96),
                       torch.Generator().manual_seed(1))
    sd = model.state_dict()
    folder = checkpoints.export_manydepth_reference(
        str(tmp_path), 0, sd, height=64, width=96, min_depth_bin=0.5,
        max_depth_bin=30.0)
    enc = torch.load(os.path.join(folder, "encoder.pth"), weights_only=True)
    assert {"layer0.0.weight", "layer0.1.running_var",
            "layer1.1.0.conv1.weight", "reduce_conv.0.bias",
            "prematching_conv.0.weight", "layer4.1.bn2.bias"} <= set(enc)
    back, meta = checkpoints.load_manydepth_reference(folder, device="cpu")
    assert meta == {"height": 64, "width": 96, "use_stereo": False,
                    "min_depth_bin": 0.5, "max_depth_bin": 30.0}
    assert not back.training
    assert back.encoder.input_height == 64
    for k, v in back.state_dict().items():
        assert v.device.type == "cpu"
        assert torch.equal(v, sd[k]), k


def test_manydepth_reference_refuses_inverse_binning(tmp_path):
    """A folder whose metadata asks for inverse binning is no longer
    refused: it loads into a model that bins inversely (its bins the
    reversed inverses of linearly spaced inverse depths; held against
    JAX in tests/test_torch_manydepth.py), where the same weights without
    the key bin linearly."""
    from depthmodelhardening_tpu_torch.models.wrappers import ManyDepthModel

    folder = checkpoints.export_manydepth_reference(
        str(tmp_path), 0, ManyDepthModel(input_height=64,
                                         input_width=96).state_dict())
    linear, _ = checkpoints.load_manydepth_reference(folder, device="cpu")
    path = os.path.join(folder, "encoder.pth")
    enc = torch.load(path, weights_only=True)
    torch.save(dict(enc, depth_binning="inverse"), path)
    model, meta = checkpoints.load_manydepth_reference(folder, device="cpu")
    assert meta["depth_binning"] == "inverse"
    bins = model.encoder.depth_bins(0.5, 30.0)
    inv = 1.0 / bins.double()
    steps = inv[:-1] - inv[1:]
    assert torch.allclose(steps, steps[0].expand_as(steps), rtol=0, atol=2e-6)
    assert float(bins[0]) == pytest.approx(0.5) and float(bins[-1]) == \
        pytest.approx(30.0)
    assert not torch.equal(bins, linear.encoder.depth_bins(0.5, 30.0))
    for k, v in model.state_dict().items():
        assert torch.equal(v, linear.state_dict()[k]), k