"""A cell of the benchmark at a size a CPU test can hold: the cell's own
configuration, traffic and limits, with the sizes cut (model 64x192,
scenes 128x416, batch 4 (2 for the evaluation), one L0 or two PGD
steps, a 60x40 car)."""

import copy
import os
import time

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def spec(cell: str) -> dict:
    from harness import spec as specs

    s = copy.deepcopy(specs.load(ROOT, cell))
    s["config"].update(height=64, width=192)
    tr = s["traffic"]
    tr.update(scene=[128, 416], car=[60, 40], pool=3)
    if tr["entry"] == "train":
        tr["hardening"]["batch_size"] = 4
        if "steps" in tr.get("adv", {}):
            tr["adv"].update(steps=1, attack_batch_size=2)
    else:
        tr["attack"].update(batch_size=2, step=2)
    return s


def run(cell: str, seed: int = 2 ** 33 + 5):
    """The harness's run of the small cell on the CPU: (result, spec)."""
    from harness import main as harness, port
    import reference

    s = spec(cell)
    program = port.load()
    result = harness.run(s, seed, 0.2, False, torch.device("cpu"), program,
                         reference, time.perf_counter())
    return result, s
