"""Training cells whose frames hold temporal ids, added as files and
entries alone: a ManyDepth cell with a real lookup frame (its 96-bin
cost volume, the pose networks, frames "0", "-1", "1", "s") and a
Monodepth2 mono+stereo cell (the pose networks and the temporal warp).
The test writes a copy of the benchmark, adds the configuration, the
traffic and the limits as new files and the cell as new entries of
BENCHMARK.json, and runs the command's `main` from it on the CPU (the
look for a card skipped) at a small size: the sound run reads `correct`
with the pose networks' leaves in its readings, and each fault of the
training step and the attack's start handed back, planted in the
program, reads above a limit that the sound run meets. (Kernel A's
backward zeroed is left out: here, in float32 with one L0 step, it reads
within md2r18's limits; at md2r18's own size `iterations_gap` catches
it.)"""

import contextlib
import importlib.util
import json
import os
import shutil

import pytest
import torch

from harness import faults, main as harness, train

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = "4294967311"
POSE = ("pose_encoder", "pose_decoder")
FAMILIES = {
    "tiny_manydepth.harden_mono": {
        "model_family": "manydepth", "manydepth_real_lookup": True,
        "manydepth_num_depth_bins": 96},
    "tiny_md2.harden_mono": {},
}


def _json(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _copy(tmp_path, cell: str):
    """A copy of the benchmark with `cell` added as files and entries;
    returns the copy's `run.py`, loaded."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    name = cell.split(".")[0]
    cfg = _json(bench / "configs" / "monodepth2_r18_1024x320.json")
    cfg.update(name=name, height=64, width=192, hardening=FAMILIES[cell])
    _write(bench / "configs" / f"{name}.json", cfg)
    tr = _json(bench / "traffic" / "harden_l0_bf16.json")
    tr.update(scene=[128, 416], car=[60, 40], pool=3, temporal_zoom=0.03)
    tr["hardening"].update(batch_size=4, compute_dtype="float32")
    tr["adv"].update(steps=1, attack_batch_size=2)
    tr["selfsup"]["frame_ids"] = ["0", "-1", "1", "s"]
    _write(bench / "traffic" / "tiny_harden_mono.json", tr)
    limits = _json(bench / "workloads" / "md2r18.harden_l0_bf16.json")
    _write(bench / "workloads" / f"{cell}.json", limits)
    spec = _json(tmp_path / "BENCHMARK.json")
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": ["height", "width"], "why": "test"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "tiny_harden_mono", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "md2r18.harden_l0_bf16" in m.get("workloads", []):
            m["workloads"].append(cell)
    _write(tmp_path / "BENCHMARK.json", spec)
    load = importlib.util.spec_from_file_location("copied_run",
                                                  bench / "run.py")
    run = importlib.util.module_from_spec(load)
    load.loader.exec_module(run)
    return run


def _main(run, cell: str, capsys, fault=None):
    """The command's result line for one untraced run of `cell`, with
    `fault` planted; and the records its readings compared."""
    seen = []

    def keep(rec, ref):
        seen.append((rec, ref))
        return readings(rec, ref)
    readings = train.train_readings
    threads = torch.get_num_threads()
    train.train_readings = keep
    try:
        with (faults.planted("train", fault) if fault
              else contextlib.nullcontext()):
            rc = run.main(["--workload", cell, "--seed", SEED, "--seconds",
                           "0.5", "--trace", "0"],
                          device=torch.device("cpu"))
    finally:
        train.train_readings = readings
        torch.set_num_threads(threads)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, seen[-1]


@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_temporal_cell_from_files(cell, tmp_path, capsys):
    run = _copy(tmp_path, cell)
    line, (rec, ref) = _main(run, cell, capsys)
    assert line["correct"] is True, line["checks"]
    assert not harness.banned_modules()
    # peak_mem_gib reads nothing without a card
    assert set(line["metrics"]) == {"train_imgs_per_s", "setup_s"}
    for record in (rec, ref):
        for reading in ("grad", "change"):
            modules = {k.split(".")[0] for k in record[reading]}
            assert set(POSE) <= modules, (reading, modules)
    # the pose networks moved on both sides, and alike
    for key in POSE:
        moved = [n for n, v in ref["change"].items()
                 if n.startswith(key + ".") and v > 0]
        assert moved and all(rec["change"][n] > 0 for n in moved)


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in sorted(FAMILIES)
    for fault in faults.KINDS["train"] + ("start",)])
def test_temporal_cell_fault_is_not_correct(cell, fault, tmp_path, capsys):
    run = _copy(tmp_path, cell)
    line, _ = _main(run, cell, capsys, fault)
    over = {k: c for k, c in line["checks"].items()
            if not c["value"] <= c["limit"]}
    assert line["correct"] is False and over, line["checks"]
