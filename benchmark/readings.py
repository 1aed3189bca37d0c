#!/usr/bin/env python3
"""The readings that set a cell's limits: the program against the
reference on many seeds, the control and the planted faults.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--look] [--faults half,...] [--batches 6] \
        [--out file.jsonl]

For each seed, in one process on one card: the cell's set-up (its
recorded steps; for an evaluation cell `--batches` batches of its
window), the reference, and the readings that decide `correct`; with
`--control`, the control's readings (the reference one precision below
the configuration's, in the program's place); with `--look` (a bfloat16
cell), the reference with its student's convolutions on bfloat16-rounded
operands judged the same way, to show what that rounding alone reads;
with `--faults`, the
program's readings with each fault planted (`harness/faults.py`). One
JSON line a seed. The benchmark's own runs run none of this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--look", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--batches", type=int, default=6)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import faults as F, main as H, port, spec as specs
    from harness.train import worst_leaves
    import reference

    spec = specs.load(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    program = port.load()
    program.use_f32_numerics()
    tr = spec["traffic"]
    low = "fp8" if tr.get("hardening", {}).get("compute_dtype") == \
        "bfloat16" else "tf32"

    def control(model_or_state):
        if low == "tf32":
            return reference.tf32()
        return reference.fp8(getattr(model_or_state, "model",
                                     model_or_state))

    def program_run(seed):
        cell = H.CELLS[tr["entry"]](spec, seed, dev, program, reference)
        cell.setup()
        for i in range(args.batches if cell.kind == "eval" else 0):
            cell.step(i)
        torch.cuda.synchronize()
        cell.free()
        return cell

    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                "card": torch.cuda.get_device_name(dev)}
        cell = program_run(seed)
        ref = cell.reference_record()
        line["program"] = cell.readings(ref)
        if cell.kind == "train":
            line["worst_leaves"] = worst_leaves(cell.record, ref)
        line["iterations"] = cell.record.get("iterations") \
            if cell.kind == "train" else None
        line["reference_iterations"] = ref.get("iterations")
        if args.control:
            got = cell.control_record(control)
            line["control"] = cell.readings(cell.reference_record(got), got)
        if args.look:
            got = cell.control_record(
                lambda state: reference.bf16(state.model))
            look_ref = cell.reference_record(got)
            line["look_bf16"] = cell.readings(look_ref, got)
            line["look_bf16_worst_leaves"] = worst_leaves(got, look_ref)
            del got, look_ref
        for fault in filter(None, args.faults.split(",")):
            del cell
            torch.cuda.empty_cache()
            with F.planted(tr["entry"], fault):
                cell = program_run(seed)
            # the reference follows the faulty record, as in a run
            fault_ref = cell.reference_record()
            line[fault] = cell.readings(fault_ref)
            if cell.kind == "train":
                line[f"{fault}_worst_leaves"] = worst_leaves(cell.record,
                                                             fault_ref)
            del fault_ref
        del cell, ref
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
