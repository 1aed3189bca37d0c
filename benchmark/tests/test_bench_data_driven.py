"""A cell, its configuration, its traffic and a metric added as files
alone: the harness finds each by the name in BENCHMARK.json. Runs the
command's `main` from a copy of the benchmark that the test writes and
extends, on the CPU (the look for a card skipped) at a small size."""

import importlib.util
import json
import os
import shutil

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

READER = '''"""Window steps a second (a metric added as a file)."""
from harness.readings import untraced


def read(run):
    w = untraced(run, "train")
    return None if w is None else w.steps / w.seconds
'''


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def test_cell_and_metric_from_files(tmp_path, capsys):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(bench / "configs" / "monodepth2_r18_1024x320.json") as f:
        cfg = json.load(f)
    cfg.update(name="tiny_r18", height=64, width=192)
    _write(bench / "configs" / "tiny_r18.json", cfg)
    _write(bench / "traffic" / "tiny_selfsup.json", {
        "entry": "train", "step": "selfsup", "scene": [128, 416],
        "stereo_shift": 12, "car": [60, 40], "pool": 3, "trace_steps": 1,
        "hardening": {"batch_size": 2, "compute_dtype": "float32",
                      "supervised_adv": False,
                      "contrastive_learning": False},
        "selfsup": {"frame_ids": ["0", "s"]}})
    _write(bench / "workloads" / "tiny.selfsup.json",
           {"limits": {"loss_gap.loss": 1e-3, "grad_gap": 1e-3}})
    (bench / "metrics" / "steps_per_s_probe.py").write_text(READER)
    with open(tmp_path / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_r18", "source": "test",
                            "file": "benchmark/configs/tiny_r18.json",
                            "reduced": ["height", "width"], "why": "test"})
    spec["workloads"].append({"name": "tiny.selfsup", "config": "tiny_r18",
                              "traffic": "tiny_selfsup", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "steps_per_s_probe",
                               "unit": "steps/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny.selfsup"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("tiny.selfsup")
    _write(tmp_path / "BENCHMARK.json", spec)

    load = importlib.util.spec_from_file_location("copied_run",
                                                  bench / "run.py")
    run = importlib.util.module_from_spec(load)
    load.loader.exec_module(run)
    threads = torch.get_num_threads()
    try:
        rc = run.main(["--workload", "tiny.selfsup", "--seed", "4294967311",
                       "--seconds", "0.5", "--trace", "0"],
                      device=torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"steps_per_s_probe", "train_imgs_per_s",
                                    "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["grad_gap"]["limit"] == 1e-3
