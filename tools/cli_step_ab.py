"""Compare `chip_smoke.py`'s phase-12b step across checkouts on one card.

    python3 tools/cli_step_ab.py [--log-dir DIR] TREE [TREE ...]

For each TREE, in the order given, one process runs, with TREE as its
working directory and that checkout's own `chip_smoke.py` and package:
the device check and the kernels' build (under TREE/build/), the golden
teacher with its BatchNorm statistics calibrated, then 12b: the CLI's
bf16 `train-hardening --fine-tune` step with frames 0,-1,1,s at
1024x320, batch 32 (`phase_cli_run`: 2 warm-up and 3 timed steps, then
one step under the profiler), and one more profiled step. List a tree
twice, in the order parent, change, change, parent, to see the drift of
the card across the call. Prints one summary line a run: s/step, peak
memory, and each profiled step's device busy ms, host wall ms and idle
share; `--log-dir` keeps each run's whole log there.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

CHILD = r"""
import json, torch
import chip_smoke as cs
dev = cs.phase_device()
cs.phase_build()
_, sd = cs._golden_weights()
cal = cs.calibrated_teacher(dev, sd)
obj, mask = cs.make_car_object(300, 200, seed=cs.SEED)
cfg = cs._cli_cfg(cs.MONO_FRAMES)
trainer = cs._harden_trainer(dev, cfg, cal, obj, mask, cs.SEED + 90)
inputs = cs._harden_inputs(dev, cfg, cs.SEED + 91)
state, _ = cs.phase_cli_run("12b", trainer, inputs)
busy, wall, n, _, _ = cs.device_busy(lambda: trainer.train_step(state, *inputs))
print("AB repeat " + json.dumps({"busy_ms": busy, "wall_ms": wall,
                                 "activities": n}), flush=True)
"""


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
    ap.add_argument("--log-dir")
    args = ap.parse_args()
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    rc = 0
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
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
