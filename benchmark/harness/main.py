"""One run of one cell: set-up, the window, the trace, the check.

    run(spec, seed, seconds, trace, dev) -> (result, checks)

Set-up (timed from the process's start, `setup_s`) builds the cell's
inputs and the program's state and drives its recorded first steps,
which warm every shape the window uses. The window runs whole steps
until `seconds` have passed and ends at the synchronize after the last
one. With `trace`, the window is instead `trace_steps` whole steps under a
device-only trace, then as many under the full trace with the harness's
spans on (`_traced`). Then the program's state is
freed and the reference checks what the program produced.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import torch

from . import readings, spans, spec as specs, trace as tracing
from .evaluate import EvalCell
from .train import TrainCell

CELLS = {"train": TrainCell, "eval": EvalCell}
BANNED = ("jax", "jaxlib", "flax", "depthmodelhardening_tpu")
# each hand-written kernel family: its launch counters and the marks of its
# device functions' names in a trace (chip_smoke.py:KERNEL_NAMES)
FAMILIES = {
    "A (warp)": (("vertical_resample_fwd", "vertical_resample_bwd"),
                 ("::vert_fwd", "::vert_bwd")),
    "B (pool)": (("maxpool3x3s2_fwd", "maxpool3x3s2_bwd",
                  "maxpool3x3s2_fwd_bf16", "maxpool3x3s2_bwd_bf16"),
                 ("::pool_fwd<", "::pool_bwd<", "pool_fwd_bf16",
                  "pool_bwd_bf16")),
    "C (reprojection)": (("reproj_loss_fwd", "reproj_loss_bwd_q",
                          "reproj_loss_bwd_grad"),
                         ("::fwd_kernel(", "::bwd_q_kernel(",
                          "::bwd_grad_kernel(")),
    "D (conv)": (("conv3x3_fwd", "conv3x3_dgrad", "conv3x3_fwd_bf16",
                  "conv3x3_dgrad_bf16"),
                 ("::conv3x3_mma", "::conv3x3_co1", "conv3x3_bf16_")),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one, whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(cell, seconds: float, dev) -> SimpleNamespace:
    _sync(dev)
    t0 = time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        cell.step(len(marks) - 1)
        marks.append(time.perf_counter())
    _sync(dev)
    end = time.perf_counter()
    return SimpleNamespace(steps=len(marks) - 1, seconds=end - t0,
                           host_steps=[b - a for a, b in
                                       zip(marks, marks[1:])])


def _traced(cell, steps: int, dev, port, shapes: bool = False
            ) -> SimpleNamespace:
    """Two passes of `steps` whole steps, after as many untimed by the
    profiler (`untraced_s`, its cost on the window). The first under a
    device-only trace, with no range and no host event, so that the profiler's host
    cost stays off the window: the busy time, the window (`seconds`) and
    the model's passes (`model`) that the idle share and mfu read. The
    second under the full trace with the harness's ranges: attribution,
    the rooflines, the layers' device ms and the breakdown; with
    `shapes`, the program's op spans' arguments too (a roofline of an op
    the harness does not wrap reads its calls from them)."""
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(-steps, 0):
        cell.step(i)
    _sync(dev)
    untraced_s = time.perf_counter() - t0

    def quiet_steps():
        for i in range(steps):
            cell.step(i)

    def ranged_steps():
        for i in range(steps, 2 * steps):
            with torch.profiler.record_function("step"):
                cell.step(i)

    with spans.counting() as model:
        quiet = tracing.record(quiet_steps, device_only=True)
    port.build.reset_launches()
    with spans.traced(cell.layers()) as rec:
        tr = tracing.record(ranged_steps, shapes=shapes)
    counters = {k.name: k.launches for k in port.build.KERNELS}
    return SimpleNamespace(steps=steps, all_steps=2 * steps,
                           seconds=quiet.wall_s, busy_s=quiet.busy_s,
                           untraced_s=untraced_s,
                           model=model.model, trace=tr, recorder=rec,
                           counters=counters)


def launch_check(run) -> dict:
    """Each kernel family's launches by `_build`'s counters against the
    device activities of that family attributed to the op ranges."""
    out = {}
    for fam, (names, marks) in FAMILIES.items():
        counted = sum(run.counters.get(n, 0) for n in names)
        seen = tracing.kernel_launches(run.trace, "op:", marks)
        out[fam] = (counted, seen)
    return out


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, port,
        reference, t_start: float):
    """The result line of one run (its last key the checks)."""
    tr = spec["traffic"]
    cell = CELLS[tr["entry"]](spec, seed, dev, port, reference)
    cell.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        w = _traced(cell, tr["trace_steps"], dev, port,
                    any(readings.span_fed(m["name"])
                        for m in spec["per_layer"]))
    else:
        w = _window(cell, seconds, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = getattr(w, "all_steps", w.steps)
    runrec = SimpleNamespace(
        kind=cell.kind, setup_s=setup_s, window=w,
        images=w.steps * cell.images_per_step, peak_bytes=peak,
        iterations=list(getattr(cell, "iterations", []))[-steps:])
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in spec["end_to_end"] + spec["per_layer"]}
    for name, read in specs.readers(
            spec, "per_layer" if trace else "end_to_end").items():
        value = read(runrec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
    result = {"attempted": steps, "failed": 0, "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = w.busy_s
        device["window_s"] = w.seconds
        result["breakdown"] = tracing.breakdown(w.trace)
        for fam, (counted, seen) in launch_check(w).items():
            log(f"launches {fam}: counters {counted}, attributed {seen}")
        log(f"device activities {len(w.trace.device)}, unattributed "
            f"{w.trace.unattributed}")
        log(f"untraced: {w.steps} steps in {w.untraced_s:.4f} s; "
            f"device-only pass: {w.steps} steps in {w.seconds:.4f} s, busy "
            f"{w.busy_s:.4f} s; traced pass: {w.steps} steps in "
            f"{w.trace.wall_s:.4f} s, busy {w.trace.busy_s:.4f} s")
    parts = ", ".join(f"{k} {v:.2f}" for k, v in cell.setup_parts.items())
    log(f"window: {w.steps} steps in {w.seconds:.4f} s; setup "
        f"{setup_s:.4f} s ({parts}); peak {peak} B")
    if hasattr(w, "host_steps"):
        log("host seconds a step: "
            + " ".join(f"{t:.3f}" for t in w.host_steps))
    del w
    cell.free()
    ref = cell.readings(cell.reference_record())
    checks = {}
    for name, limit in spec["limits"].items():
        checks[name] = {"value": ref[name], "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    for name, value in sorted(ref.items()):
        if name not in checks:
            log(f"reading {name} {value!r} (not compared)")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result = {"correct": correct, **result, "checks": checks}
    return result
