"""A cell's files, found by the names in BENCHMARK.json.

- `configs/<config>.json` (the entry's `file`): the model's sizes;
- `traffic/<traffic>.json`: the job's parameters, which the harness's
  general generator and the entry named by its "entry" key read;
- `workloads/<cell>.json`: what belongs to the cell alone, the limit of
  each number that decides `correct`;
- `metrics/<metric>.py`: each metric's reader, `read(run)`, which
  returns a number or None (nothing to read in this run).

A later cell, traffic mix or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str, workload: str) -> dict:
    """Everything a run of `workload` reads, from the checkout at `root`
    (the directory of BENCHMARK.json; the cell's files under its
    benchmark folder)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, bench["paths"][0])
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in moved)]
    return {
        "bench": bench, "cell": cell, "here": here,
        "config": _json(os.path.join(root, config["file"])),
        "traffic": _json(os.path.join(here, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(here, "workloads",
                                     workload + ".json"))["limits"],
        "end_to_end": e2e, "per_layer": layer,
    }


def reader(here: str, metric: str) -> Callable:
    """`read` of metrics/<metric>.py."""
    path = os.path.join(here, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(spec: dict, which: str) -> Dict[str, Callable]:
    return {m["name"]: reader(spec["here"], m["name"]) for m in spec[which]}
