"""What the port's spans cost, on and off in one process on the card.

    python3 tools/span_cost.py CELL [REPS]

Builds the benchmark cell CELL (BENCHMARK.json) as `benchmark/run.py`
does, then for each of REPS rounds, each side in turn (the order flips
every round; off: `utils/profiling.py`'s flag check patched to False, so
no span opens and nothing is counted) times the cell's `trace_steps`
steps untraced, under a device-only trace and under the full trace with
the harness's ranges, as the benchmark's traced run makes them. Prints
a JSON line a pass (wall and busy seconds, the idle share, the ranges
the trace holds), then one span's cost in microseconds: with no
profiler, under a device-only profiler and under a host and device one.
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
from harness import main as harness, port, spans, spec as specs  # noqa
from harness import trace as tracing  # noqa
import reference  # noqa
from depthmodelhardening_tpu_torch.utils import profiling  # noqa


def passes(c, steps: int, on: bool, real, counter):
    """One round's three passes of `steps` steps, spans on or off."""
    def run_steps():
        for _ in range(steps):
            c.step(counter[0])
            counter[0] += 1

    profiling._profiler_enabled = real if on else (lambda: False)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        with spans.counting():
            quiet = tracing.record(run_steps, device_only=True)
        with spans.traced(c.layers()):
            ranged = tracing.record(run_steps)
    finally:
        profiling._profiler_enabled = real
    return {"spans": on, "untraced_s": untraced,
            "device_only_s": quiet.wall_s, "device_only_busy_s": quiet.busy_s,
            "idle_share": 100 * (1 - quiet.busy_s / quiet.wall_s),
            "ranged_s": ranged.wall_s, "ranged_busy_s": ranged.busy_s,
            "ranges": len(ranged.ranges)}


def span_us(n: int) -> float:
    """One span's enter and exit, in microseconds, over n of them."""
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span(profiling.ATTACK_ITER, {"iter": 3}):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv) -> None:
    from torch.profiler import ProfilerActivity, profile

    cell_name = argv[0]
    reps = int(argv[1]) if len(argv) > 1 else 3
    s = specs.load(ROOT, cell_name)
    P = port.load()
    P.use_f32_numerics()
    c = harness.CELLS[s["traffic"]["entry"]](
        s, 3000000101, torch.device("cuda", 0), P, reference)
    c.setup()
    real, counter = profiling._profiler_enabled, [0]
    for r in range(reps):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            out = passes(c, s["traffic"]["trace_steps"], on, real, counter)
            print(json.dumps({"cell": cell_name, **out}), flush=True)
    off_us = span_us(20000)
    with profile(activities=[ProfilerActivity.CUDA]):
        cuda_us = span_us(20000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        both_us = span_us(5000)
    print(json.dumps({"span_us_off": off_us, "span_us_cuda_only": cuda_us,
                      "span_us_cpu_and_cuda": both_us}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
