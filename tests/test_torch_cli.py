"""The port's command line (`cli/main.py`) and `utils/` against the JAX
package's, on KITTI-layout trees the tests write (tests/kitti_trees.py).

* Each subparser's options and defaults equal JAX's `build_parser()`,
  less exactly its five TPU layout flags, which the port rejects.
* The configs each subcommand builds from one argv equal JAX's on their
  shared fields (the JAX trainer / attack builder is swapped, inside the
  test, for one that records its config and stops).
* export-gt-depths, eval-clean and infer through both CLIs on one tree
  and one reference weights folder (the golden weights of
  tests/golden_common.py at 64x192): the ground truth bit-equal, the
  metrics within CLEAN_RTOL (the zoo's, tests/test_torch_attacks_search.py;
  8.4e-8 measured with stereo scaling, 6.7e-7 with median scaling and the
  flip post-process), infer's scaled disparity within INFER_RTOL (3.5e-5
  measured: the JAX package's resize weights are float64, the port's
  float32, ROADMAP Queue 3).
* train-hardening (64x192, batch 2, L-inf 1 step, float32) and
  train-distill on the CPU, one step a run: the JSONL keys, the
  checkpoint, opt.json and the resume; the first step bit-equal to a direct `train_step` of a
  trainer built from the same seed on the same loader batch and scenes;
  the dump_dir files and the logger's images; precompute-hints bit-equal
  to JAX's, and without cv2 raising, naming it (--data-parallel runs in
  tests/test_torch_parallel.py).
* utils: MetricsLogger's rows, the PNG and .npy images; setup_seed;
  trace; the visualize helpers against JAX's.
* --trace-dir, the port's own option (eval-attacks and train-hardening):
  batches 1 and 2 of an eval-attacks run traced, with the port's spans
  and the FLOP counter.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import golden_common
import kitti_trees as kt
from depthmodelhardening_tpu.cli import main as j_cli
from depthmodelhardening_tpu.utils import logging as j_logging
from depthmodelhardening_tpu.utils import visualize as j_visualize
from depthmodelhardening_tpu_torch.cli import main as cli
from depthmodelhardening_tpu_torch.models.convert import (
    load_reference_state_dict,
)
from depthmodelhardening_tpu_torch.models.wrappers import (
    make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.training import checkpoints
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer
from depthmodelhardening_tpu_torch.utils import logging as t_logging
from depthmodelhardening_tpu_torch.utils import (
    profiling, seeding, visualize,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORI_H, ORI_W = 96, 320
H, W = 64, 192
NATIVE_H, NATIVE_W = 120, 400
LAYOUT_FLAGS = ("--s2d-stem", "--wpack-stem", "--fuse-upconv",
                "--packed-decoder", "--wpack-decoder")
# the port's options that the JAX CLI lacks, by subcommand
PORT_ONLY = {"eval-attacks": {"--trace-dir"},
             "train-hardening": {"--trace-dir"}}
# JAX config fields the port does not have: the TPU layouts, and
# DistillConfig's epochs and obj_name, which the CLI's loop reads
JAX_ONLY = {"s2d_stem", "wpack_stem", "wpack_stem8", "fuse_upconv",
            "packed_decoder", "wpack_decoder"}
CLEAN_RTOL = 1e-4
INFER_RTOL = 1e-4
SUBCOMMANDS = ("infer", "eval-attacks", "eval-clean", "train-distill",
               "train-hardening", "precompute-hints", "export-gt-depths",
               "fetch-splits")


@pytest.fixture(scope="module", autouse=True)
def lean_process():
    """The CLI's small models run their ops on one thread (under the
    suite's six workers the cores are taken, and torch's thread pool over
    tiny ops then waits more than it computes), and the loggers find no
    tensorboardX, as on the card's machine (importing it takes seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "tensorboardX", None)
    yield
    mp.undo()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A raw drive (frames 0-3, velodyne at 0-3), splits "tiny" (2 train
    lines: one step at batch 2) and "eigen" (3 test lines), an object
    tree of 4 scenes, a 300 x 60 car (low, so it fits the 96 x 320 scene),
    a reference weights folder of the golden weights and a model loaded
    from them."""
    d = tmp_path_factory.mktemp("cli")
    raw, drive = kt.write_raw_tree(str(d / "raw"), 4, NATIVE_H, NATIVE_W,
                                   seed=20, velodyne=range(4), points=800)
    splits = kt.write_split(str(d / "splits"), "tiny", train=[
        f"{drive} 1 l", f"{drive} 2 r"])
    kt.write_split(splits, "eigen", test=[f"{drive} {fr} l"
                                          for fr in (0, 1, 3)])
    obj = str(d / "object")
    kt.write_object_tree(obj, 4, 125, 414, seed=40)
    car = kt.write_car(str(d / "BMW.png"), 300, 60, seed=7)
    sd = load_reference_state_dict(
        golden_common.resnet18_encoder_state_dict(seed=0),
        golden_common.depth_decoder_state_dict(seed=0))
    weights = checkpoints.export_reference_pth(str(d), 0, sd, height=H,
                                               width=W)
    model = make_monodepth2()
    model.load_state_dict(sd)
    return argparse.Namespace(root=d, raw=raw, drive=drive, splits=splits,
                              obj=obj, car=car, weights=weights, sd=sd,
                              model=model)


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_parsers_equal_jax_less_the_layout_flags(cmd):
    got = _subparsers(cli.build_parser())
    want = _subparsers(j_cli.build_parser())
    assert set(got) == set(want) == set(SUBCOMMANDS)
    g, w = _options(got[cmd]), _options(want[cmd])
    dropped = {k: v for k, v in w.items() if k not in g}
    assert {o for v in dropped.values() for o in v[0]} == (
        set(LAYOUT_FLAGS) if cmd in ("train-distill", "train-hardening")
        else set())
    added = {k: v for k, v in g.items() if k not in w}
    assert {o for v in added.values() for o in v[0]} == \
        PORT_ONLY.get(cmd, set())
    assert {k: v for k, v in g.items() if k in w} == \
        {k: v for k, v in w.items() if k in g}


@pytest.mark.parametrize("flag", LAYOUT_FLAGS)
def test_layout_flags_are_rejected(flag, capsys):
    argv = ["train-distill", "--object-data-root", "o", "--object-image",
            "c.png", flag]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    assert f"unrecognized arguments: {flag}" in capsys.readouterr().err
    assert getattr(j_cli.build_parser().parse_args(argv),
                   flag[2:].replace("-", "_"))


class _Built(Exception):
    pass


def _recorder(captured):
    def record(cfg, *args, **kw):
        captured.append(cfg)
        raise _Built

    return record


def _shared(got, want, path=""):
    """Assert dataclass dicts equal on their shared keys, recursively;
    return the keys only `want` has."""
    only = set()
    for k, w in want.items():
        if k not in got:
            only.add(path + k)
        elif isinstance(w, dict):
            only |= _shared(got[k], w, f"{path}{k}.")
        else:
            assert got[k] == w, path + k
    return only


def _configs(tree, argv, monkeypatch, port_target, jax_target):
    """The config each CLI builds from argv: the predictor loaders
    swapped for the tree's model (the port's) and dummies (JAX's), the
    trainer or attack builder for a recorder."""
    import depthmodelhardening_tpu.evaluation.attack_eval as j_attack_eval
    import depthmodelhardening_tpu.training.distill as j_distill
    import depthmodelhardening_tpu.training.hardening as j_hardening
    import depthmodelhardening_tpu_torch.evaluation.attack_eval as attack_eval
    import depthmodelhardening_tpu_torch.training.distill as distill
    import depthmodelhardening_tpu_torch.training.hardening as hardening

    dummy = argparse.Namespace(variables={}, apply_fn=None)
    monkeypatch.setattr(j_cli, "_load_predictor",
                        lambda args: (None, {}, dummy))
    monkeypatch.setattr(cli, "_load_predictor", lambda args, device: (
        tree.model, predictor_from(tree.model)))
    got, want = [], []
    port_mod = {"trainer": hardening, "distill": distill,
                "attack": attack_eval}[port_target]
    jax_mod = {"trainer": j_hardening, "distill": j_distill,
               "attack": j_attack_eval}[jax_target]
    name = {"trainer": "HardeningTrainer", "distill": "DistillTrainer",
            "attack": "build_attack"}[port_target]
    monkeypatch.setattr(port_mod, name, _recorder(got))
    monkeypatch.setattr(jax_mod, name, _recorder(want))
    for run, kw in ((cli.main, {"device": "cpu"}), (j_cli.main, {})):
        with pytest.raises(_Built):
            run(argv, **kw)
    return got[0], want[0]


def _hardening_argv(tree, *extra):
    return ["train-hardening", "--data-path", tree.raw, "--split-dir",
            tree.splits, "--split", "tiny", "--object-data-root", tree.obj,
            "--object-image", tree.car, "--weights-folder", tree.weights,
            *extra]


HARDENING_CASES = {
    "defaults": ("--fine-tune",),
    "options": ("--frame-ids", "0,-1,1,s", "--norm-type", "l_inf", "--step",
                "3", "--attack-batch-size", "4", "--batch-size", "8",
                "--lr", "3e-5", "--no-contrastive-learning", "--gt-depth",
                "--half-no-synthesis", "--avg-reprojection",
                "--disable-automasking", "--attack-crop-w", "320",
                "--attack-crop-h", "256", "--attack-scale", "1",
                "--attack-scale-fine-steps", "2", "--compute-dtype",
                "float32", "--height", "192", "--width", "640", "--ori-h",
                "300", "--ori-w", "1000", "--use-depth-hints",
                "--no-original-train"),
    "no_adv_train": ("--no-adv-train", "--v1-multiscale"),
    "manydepth": ("--model-family", "manydepth", "--manydepth-real-lookup",
                  "--no-supervised-adv"),
}


@pytest.mark.parametrize("case", sorted(HARDENING_CASES))
def test_hardening_config_equals_jax(tree, monkeypatch, case):
    got, want = _configs(tree, _hardening_argv(tree, *HARDENING_CASES[case]),
                         monkeypatch, "trainer", "trainer")
    only = _shared(dataclasses.asdict(got), dataclasses.asdict(want))
    assert only == JAX_ONLY


def _distill_argv(tree, *extra):
    return ["train-distill", "--object-data-root", tree.obj,
            "--object-image", tree.car, *extra]


@pytest.mark.parametrize("extra", [
    (), ("--adv-type", "object_l0", "--epsilon", "0.2", "--alpha", "0.01",
         "--step", "3", "--batch-size", "4", "--lr", "2e-4",
         "--compute-dtype", "float32", "--attack-crop-w", "320",
         "--attack-crop-h", "256", "--attack-scale", "2",
         "--attack-scale-fine-steps", "2", "--height", "192", "--width",
         "640", "--ori-h", "300", "--ori-w", "1000"),
    ("--adv-type", "image", "--epochs", "3")])
def test_distill_config_equals_jax(tree, monkeypatch, extra):
    got, want = _configs(tree, _distill_argv(tree, *extra), monkeypatch,
                         "distill", "distill")
    only = _shared(dataclasses.asdict(got), dataclasses.asdict(want))
    assert only == JAX_ONLY | {"epochs", "obj_name"}


@pytest.mark.parametrize("extra", [
    (), ("--norm-type", "l_inf", "--epsilon", "0.05", "--alpha", "0.002",
         "--step", "4", "--adam-lr", "0.3", "--mask-wt", "0.1",
         "--l0-thresh", "0.2", "--batch-size", "6", "--eval-count", "3",
         "--height", "192", "--width", "640", "--ori-h", "300",
         "--ori-w", "1000", "--dump-dir", "d"),
    ("--preset", "l0_thresh02", "--eval-count", "2"),
    ("--preset", "light", "--height", "192")])
def test_eval_attacks_config_equals_jax(tree, monkeypatch, extra):
    argv = ["eval-attacks", "--object-data-root", tree.obj,
            "--object-image", tree.car, *extra]
    got, want = _configs(tree, argv, monkeypatch, "attack", "attack")
    assert _shared(dataclasses.asdict(got), dataclasses.asdict(want)) \
        == set()


def _json_out(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def test_export_gt_eval_clean_and_infer_through_both_clis(tree, capsys):
    gts = []
    for run, sub in ((j_cli.main, "jax"), (cli.main, "port")):
        split_dir = str(tree.root / f"gt_{sub}")
        kt.write_split(split_dir, "eigen", test=[
            f"{tree.drive} {fr} l" for fr in (0, 1, 3)])
        run(["export-gt-depths", "--data-path", tree.raw, "--split-dir",
             split_dir])
        gts.append(np.load(os.path.join(split_dir, "eigen",
                                        "gt_depths.npz"),
                           allow_pickle=True)["data"])
    assert gts[0].shape == gts[1].shape and len(gts[0]) == 3
    for g, w in zip(gts[1], gts[0]):
        assert np.array_equal(np.asarray(g, np.float32),
                              np.asarray(w, np.float32))

    common = ["--data-path", tree.raw, "--split-dir", str(
        tree.root / "gt_port"), "--weights-folder", tree.weights,
        "--height", str(H), "--width", str(W)]
    for extra in ((), ("--eval-mono", "--post-process")):
        capsys.readouterr()
        j_cli.main(["eval-clean", *common, *extra])
        want = _json_out(capsys)
        got = cli.main(["eval-clean", *common, *extra], device="cpu")
        assert _json_out(capsys) == got
        assert list(got) == list(want)
        assert all(np.isfinite(v) for v in got.values())
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=CLEAN_RTOL)

    image = str(tree.root / "raw" / tree.drive / "image_02" / "data" /
                "0000000001.png")
    infer = ["infer", "--image", image, "--weights-folder", tree.weights,
             "--height", str(H), "--width", str(W)]
    base = os.path.splitext(image)[0]
    j_cli.main(infer)
    want = np.load(base + "_disp.npy")
    os.remove(base + "_disp.npy")
    got = cli.main(infer, device="cpu")
    assert np.array_equal(np.load(base + "_disp.npy"), got)
    assert got.shape == want.shape == (1, NATIVE_H, NATIVE_W, 1)
    np.testing.assert_allclose(got, want, rtol=INFER_RTOL)
    assert os.path.getsize(base + "_disp.jpeg") > 0


def _rows(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _snapshot(state):
    return {f"{m}.{k}": v.detach().clone()
            for m, mod in state.modules().items()
            for k, v in mod.state_dict().items()}


@pytest.fixture(scope="module")
def hardening_run(tree, tmp_path_factory):
    """train-hardening at 64x192, batch 2, L-inf 1 step, float32, run
    twice (the second resumes), with the first step's inputs, metrics and
    state after it recorded."""
    log_dir = str(tmp_path_factory.mktemp("hlogs"))
    argv = _hardening_argv(
        tree, "--fine-tune", "--height", str(H), "--width", str(W),
        "--ori-h", str(ORI_H), "--ori-w", str(ORI_W), "--norm-type",
        "l_inf", "--step", "1", "--attack-batch-size", "2",
        "--batch-size", "2", "--epochs", "1", "--log-frequency", "1",
        "--val-eval-count", "1", "--compute-dtype", "float32",
        "--log-dir", log_dir)
    steps = []
    original = HardeningTrainer.train_step

    def recording(self, state, frames, side, flip, scenes, draws=None):
        first = not steps
        if first:
            inputs = ({k: v.clone() for k, v in frames.items()},
                      side.clone(), flip.clone(), np.array(scenes))
        state, metrics = original(self, state, frames, side, flip, scenes,
                                  draws)
        steps.append(dict(trainer=self, metrics=metrics))
        if first:
            steps[0].update(inputs=inputs, after=_snapshot(state))
        return state, metrics

    mp = pytest.MonkeyPatch()
    mp.setattr(HardeningTrainer, "train_step", recording)
    try:
        import io
        from contextlib import redirect_stdout

        outs = []
        for _ in range(2):
            buf = io.StringIO()
            with redirect_stdout(buf):
                cli.main(argv, device="cpu")
            outs.append(buf.getvalue())
    finally:
        mp.undo()
    return argparse.Namespace(log_dir=log_dir, steps=steps, outs=outs,
                              argv=argv)


def test_train_hardening_logs_checkpoints_and_resumes(hardening_run):
    run = hardening_run
    rows = _rows(run.log_dir)
    keys = set().union(*rows)
    assert {"loss", "sup_loss", "contras_loss", "selfsup_loss",
            "val/mean_abs_err", "val/max_rmse"} <= keys
    assert [r["step"] for r in rows if "loss" in r] == [0, 1]
    # one robustness val, at step 0 (10 x --log-frequency)
    assert [r["step"] for r in rows if "val/mean_abs_err" in r] == [0]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert "resumed from step" not in run.outs[0]
    assert "resumed from step 1 (checkpoint 1)" in run.outs[1]
    ckpts = os.path.join(run.log_dir, "ckpts")
    assert sorted(os.listdir(ckpts)) == ["1", "2"]
    assert os.path.isfile(os.path.join(ckpts, "2", "state.pt"))
    with open(os.path.join(run.log_dir, "opt.json")) as f:
        opt = json.load(f)
    assert opt["selfsup"]["height"] == H and opt["batch_size"] == 2
    assert opt["wpack_decoder"] is False
    assert len(run.steps) == 2


def test_train_hardening_first_step_equals_a_direct_step(hardening_run):
    """The CLI's first step, bit for bit, against `train_step` of a
    trainer built from the same seed, on the same loader batch and scene
    batch."""
    first = hardening_run.steps[0]
    t = first["trainer"]
    direct = HardeningTrainer(
        t.cfg, torch.Generator().manual_seed(17), t.obj_img, t.obj_mask,
        t.teacher, device="cpu",
        steps_per_epoch=t.transition_steps // t.cfg.scheduler_step_size,
        init_state_dict=t._init_state_dict)
    state = direct.make_state()
    frames, side, flip, scenes = first["inputs"]
    state, metrics = direct.train_step(state, frames, side, flip, scenes)
    assert set(metrics) == set(first["metrics"])
    for k, v in metrics.items():
        assert torch.equal(v, first["metrics"][k]), k
    after = _snapshot(state)
    assert set(after) == set(first["after"])
    for k, v in after.items():
        assert torch.equal(v, first["after"][k]), k


def test_train_distill_logs_images_and_weights(tree, tmp_path, capsys):
    log_dir = str(tmp_path / "dlogs")
    state = cli.main(_distill_argv(
        tree, "--weights-folder", tree.weights, "--height", str(H),
        "--width", str(W), "--ori-h", str(ORI_H), "--ori-w", str(ORI_W),
        "--step", "1", "--batch-size", "4", "--epochs", "1",
        "--eval-count", "1", "--compute-dtype", "float32", "--log-dir",
        log_dir), device="cpu")
    assert state.step == 1  # 4 scenes at batch 4
    rows = _rows(log_dir)
    keys = set().union(*rows)
    assert {"loss", "eval/model_perf", "eval/atk_perf"} <= keys
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert "not written" not in capsys.readouterr().out
    images = sorted(os.listdir(os.path.join(log_dir, "images")))
    assert images == ["eval_atk_comp_00000000.png",
                      "eval_model_comp_00000000.png"]
    for name in ("weights_1", "weights_final"):
        assert sorted(os.listdir(os.path.join(log_dir, name))) == [
            "depth.pth", "encoder.pth"]
    sd, meta = checkpoints.load_reference_pth(
        os.path.join(log_dir, "weights_final"))
    assert meta["height"] == H and meta["width"] == W
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v.cpu()), k


def test_train_distill_without_matplotlib_says_so(tree, tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    log_dir = str(tmp_path / "dlogs")
    cli.main(_distill_argv(
        tree, "--height", str(H), "--width", str(W), "--ori-h", str(ORI_H),
        "--ori-w", str(ORI_W), "--step", "1", "--batch-size", "4",
        "--epochs", "1", "--eval-count", "1", "--compute-dtype", "float32",
        "--log-dir", log_dir), device="cpu")
    assert "the panel needs matplotlib" in capsys.readouterr().out
    assert "eval/atk_perf" in set().union(*_rows(log_dir))
    assert not os.path.exists(os.path.join(log_dir, "images"))


def test_eval_attacks_writes_its_dumps(tree, tmp_path):
    dump = str(tmp_path / "dumps")
    res = cli.main(["eval-attacks", "--object-data-root", tree.obj,
                    "--object-image", tree.car, "--weights-folder",
                    tree.weights, "--height", str(H), "--width", str(W),
                    "--ori-h", str(ORI_H), "--ori-w", str(ORI_W),
                    "--norm-type", "l_inf", "--step", "1",
                    "--batch-size", "2", "--eval-count", "1",
                    "--dump-dir", dump], device="cpu")
    assert set(res) == {"mean", "max"}
    assert all(np.isfinite(v) for row in res.values() for v in row.values())
    assert sorted(os.listdir(dump)) == ["adv_000.png", "ben_000.png",
                                        "panel_000.png"]


def test_eval_attacks_traces_batches_one_and_two(tree, tmp_path):
    trace_dir = str(tmp_path / "trace")
    cli.main(["eval-attacks", "--object-data-root", tree.obj,
              "--object-image", tree.car, "--weights-folder", tree.weights,
              "--height", str(H), "--width", str(W), "--ori-h", str(ORI_H),
              "--ori-w", str(ORI_W), "--norm-type", "l_inf", "--step", "1",
              "--batch-size", "1", "--eval-count", "3",
              "--trace-dir", trace_dir], device="cpu")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    batches = [e["args"]["batch"] for e in events
               if e.get("name") == "layer:eval.attack"]
    assert batches == [1, 2]
    names = {e.get("name") for e in events}
    assert {"layer:data.wait", "layer:attack.iter", "layer:eval.metrics",
            "layer:sync.read", "layer:eot.geometry"} <= names
    with open(os.path.join(trace_dir, "counters.json")) as f:
        counters = json.load(f)
    assert counters["flops_by_dtype"]["float32"] > 0


def _hint_files(tree, *lines):
    names = str(tree.root / "hint_files.txt")
    with open(names, "w") as f:
        f.write("".join(f"{ln}\n" for ln in lines))
    return names


def test_precompute_hints_needs_cv2(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        cli.main(["precompute-hints", "--data-path", tree.raw,
                  "--filenames", _hint_files(tree, f"{tree.drive} 1 l"),
                  "--height", str(H), "--width", str(W)], device="cpu")


def test_precompute_hints_matches_jax(tree, tmp_path):
    """precompute-hints through both CLIs on two frames of the tree (SGBM
    on both eyes' PNGs, the fused hint at 64x192): the same files, equal
    but at the fused hint's argmin ties (ROADMAP Queue 3; held exactly in
    tests/test_torch_depth_hints.py): at most 0.1% of the pixels (1 of
    12288 measured)."""
    names = _hint_files(tree, f"{tree.drive} 1 l", f"{tree.drive} 2 r")
    argv = ["precompute-hints", "--data-path", tree.raw, "--filenames",
            names, "--height", str(H), "--width", str(W), "--save-path"]
    written = cli.main(argv + [str(tmp_path / "port")], device="cpu")
    j_cli.main(argv + [str(tmp_path / "jax")])
    files = lambda d: sorted(os.path.relpath(os.path.join(r, n), d)
                             for r, _, ns in os.walk(d) for n in ns)
    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want and len(got) == len(written) == 2
    for name in got:
        g, w = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax"
                                                          / name)
        assert g.shape == w.shape and (g != w).mean() <= 1e-3


def test_the_command_line_runs_on_the_card_or_raises(tree, tmp_path):
    """Without device= a subcommand that runs a model asks for the card
    (raising here); host-only subcommands need none. `python -m` runs the
    same parser and exits 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval-clean", "--data-path", tree.raw, "--split-dir",
                  tree.splits])
    dest = str(tmp_path / "splits")
    proc = subprocess.run(
        [sys.executable, "-m", "depthmodelhardening_tpu_torch.cli",
         "fetch-splits", "--dest", dest, "--generate-odom"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 4 split files" in proc.stdout
    assert len(os.listdir(os.path.join(dest, "odom"))) == 4


# -- utils --------------------------------------------------------------------
def test_metrics_logger_rows_and_images_equal_jax(tmp_path, monkeypatch):
    rows, images = [], []
    for mod, sub in ((t_logging, "port"), (j_logging, "jax")):
        logger = mod.MetricsLogger(str(tmp_path / sub))
        logger.log(3, {"loss": torch.tensor(0.25), "val/x": np.float32(2)})
        img = np.linspace(0, 1, 5 * 7 * 3).reshape(5, 7, 3)
        path = logger.log_image(4, "eval/atk_comp", img)
        msg = logger.log_time(10, 32, 2.0, 0.5, total_steps=100)
        logger.close()
        with open(os.path.join(tmp_path, sub, "train_metrics.jsonl")) as f:
            row = json.loads(f.read())
        row.pop("wall")
        rows.append((row, msg[:msg.index("elapsed")]))
        images.append((os.path.relpath(path, tmp_path / sub),
                       open(path, "rb").read()))
    assert rows[0] == rows[1]
    assert images[0] == images[1]
    assert images[0][0] == os.path.join("images",
                                        "eval_atk_comp_00000004.png")
    assert t_logging.sec_to_hm_str(10239) == j_logging.sec_to_hm_str(
        10239) == "02h50m39s"
    # without PIL the image is kept as .npy
    monkeypatch.setitem(sys.modules, "PIL", None)
    logger = t_logging.MetricsLogger(str(tmp_path / "nopil"))
    path = logger.log_image(1, "a/b", np.zeros((2, 3)))
    logger.close()
    assert path.endswith("a_b_00000001.npy")
    assert np.load(path).shape == (2, 3, 3)


def test_setup_seed_step_timer_and_trace(tmp_path):
    gen = seeding.setup_seed(5)
    a = (np.random.rand(), torch.rand(1), torch.rand(1, generator=gen))
    gen = seeding.setup_seed(5)
    b = (np.random.rand(), torch.rand(1), torch.rand(1, generator=gen))
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and \
        torch.equal(a[2], b[2])
    assert isinstance(gen, torch.Generator)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert os.path.getsize(tmp_path / "tr" / "counters.json") > 0


def test_visualize_equals_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(3)
    disp = rs.rand(24, 40).astype(np.float32)
    img1, img2 = rs.rand(2, 24, 40, 3).astype(np.float32)
    assert np.array_equal(visualize.normalize_image(disp),
                          j_visualize.normalize_image(disp))
    assert np.array_equal(visualize.colormap_disp(disp),
                          j_visualize.colormap_disp(disp))
    visualize.save_pic(img1, str(tmp_path / "a.png"))
    j_visualize.save_pic(img1, str(tmp_path / "b.png"))
    assert open(tmp_path / "a.png", "rb").read() == \
        open(tmp_path / "b.png", "rb").read()
    got = visualize.eval_depth_diff(img1, img2, disp1=disp, disp2=disp[::-1])
    want = j_visualize.eval_depth_diff(img1, img2, disp1=disp,
                                       disp2=disp[::-1])
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.cm", None)
    grey = visualize.colormap_disp(disp)
    assert np.array_equal(grey[..., 0], grey[..., 2])
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.eval_depth_diff(img1, img2, disp1=disp, disp2=disp)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        visualize.save_pic(img1, str(tmp_path / "c.png"))


def test_eval_depth_diff_predicts_with_the_ports_predictor(tree):
    predictor = predictor_from(tree.model)
    rs = np.random.RandomState(4)
    img1, img2 = rs.rand(2, H, W, 3).astype(np.float32)
    _, d1, d2 = visualize.eval_depth_diff(img1, img2, predictor=predictor)
    for got, img in ((d1, img1), (d2, img2)):
        with torch.no_grad():
            want = predictor(torch.from_numpy(img[None]))[0, ..., 0]
        assert np.array_equal(got, want.numpy())
