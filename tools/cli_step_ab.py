"""Compare a step of `chip_smoke.py` across checkouts on one card.

    python3 tools/cli_step_ab.py [--phase 12b|12a|10|15a] [--log-dir DIR]
        TREE [TREE ...]

For each TREE, in the order given, one process runs, with TREE as its
working directory and that checkout's own `chip_smoke.py` and package:
the device check and the kernels' build (under TREE/build/), then the
phase's step (PHASES):
12b (the default) and 12a: the CLI's bf16 `train-hardening --fine-tune`
step with frames 0,-1,1,s or 0,s at 1024x320, batch 32, the golden
teacher with its BatchNorm statistics calibrated (`phase_cli_run`: its
warm-up and timed steps, then one step under the profiler), and one more
profiled step; 10: bench.py's bf16 distillation step (3 steps, then 3
under the profiler); 15a: phase 15's `train-hardening --fine-tune` from
KITTI-layout files after `fetch-splits` (`phase_cli_train`: one of its
four steps under the profiler). List a tree twice, in the order parent, change, change,
parent, to see the drift of the card across the call. Prints one
summary line a run: s/step, peak memory, and each profiled step's device
busy ms, host wall ms and idle share; `--log-dir` keeps each run's
whole log there.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SETUP = r"""
import json, tempfile, torch
import chip_smoke as cs
dev = cs.phase_device()
cs.phase_build()
_, sd = cs._golden_weights()
obj, mask = cs.make_car_object(300, 200, seed=cs.SEED)

def repeat(step, n):
    for _ in range(n):
        busy, wall, k, _, _ = cs.device_busy(step)
        print("AB repeat " + json.dumps({"busy_ms": busy, "wall_ms": wall,
                                         "activities": k}), flush=True)
"""
CLI = r"""
cal = cs.calibrated_teacher(dev, sd)
cfg = cs._cli_cfg({frames})
trainer = cs._harden_trainer(dev, cfg, cal, obj, mask, cs.SEED + 90)
inputs = cs._harden_inputs(dev, cfg, cs.SEED + 91)
state, _ = cs.phase_cli_run("{label}", trainer, inputs)
repeat(lambda: trainer.train_step(state, *inputs), 1)
"""
PHASES = {
    "12b": CLI.format(frames="cs.MONO_FRAMES", label="12b"),
    "12a": CLI.format(frames="('0', 's')", label="12a"),
    "10": r"""
cfg = cs.BENCH_CFG
scenes = torch.from_numpy(cs.make_scene(1, cfg.ori_h, cfg.ori_w,
                                        seed=cs.SEED + 60)).to(dev)
trainer = cs._bench_trainer(dev, cfg, cs.calibrated_teacher(dev, sd), obj,
                            mask, cs.SEED + 61)
state = trainer.make_state()
for _ in range(3):
    state, _ = trainer.train_step(state, scenes)
repeat(lambda: trainer.train_step(state, scenes), 3)
""",
    "15a": r"""
with tempfile.TemporaryDirectory(prefix="dmh_ab_") as root:
    f = cs.phase_cli_files(dev, root)
    runs = cs._CliRuns()
    runs("fetch-splits", ["fetch-splits", "--dest", f.splits, "--from-dir",
                          f.src])
    cs.phase_cli_train(runs, f, dev)
""",
}


def summary(log: str) -> dict:
    """s/step, peak bytes and the profiled steps' readings from a log."""
    out = {"s_per_step": None, "peak_bytes": None, "profiles": []}
    m = re.search(r"seconds per step ([0-9.]+)", log)
    if m:
        out["s_per_step"] = float(m.group(1))
    m = re.search(r"max_memory_allocated (\d+) B", log)
    if m:
        out["peak_bytes"] = int(m.group(1))
    for m in re.finditer(r"device busy ([0-9.]+) ms of ([0-9.]+) ms host "
                         r"wall, idle share [0-9.]+, (\d+) device", log):
        out["profiles"].append((float(m.group(1)), float(m.group(2)),
                                int(m.group(3))))
    m = re.search(r"^AB repeat (.*)$", log, re.M)
    if m:
        r = json.loads(m.group(1))
        out["profiles"].append((r["busy_ms"], r["wall_ms"], r["activities"]))
    out["profiles"] = [{"busy_ms": b, "wall_ms": w, "idle": 1.0 - b / w,
                        "activities": n} for b, w, n in out["profiles"]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phase", default="12b", choices=list(PHASES))
    ap.add_argument("--log-dir")
    args = ap.parse_args()
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    rc = 0
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        p = subprocess.run([sys.executable, "-c",
                            SETUP + PHASES[args.phase]], cwd=tree,
                           capture_output=True, text=True)
        log = p.stdout + p.stderr
        if args.log_dir:
            with open(os.path.join(args.log_dir, f"{i}.log"), "w") as f:
                f.write(log)
        gpu = next((ln for ln in log.splitlines() if "W" in ln and
                    "H100" in ln), "")
        print(json.dumps({"run": i, "tree": tree, "rc": p.returncode,
                          "card": gpu.strip(), **summary(log)}), flush=True)
        if p.returncode:
            print(log[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
