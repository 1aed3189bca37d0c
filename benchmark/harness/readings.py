"""What the metric readers share: a run's record (`main.run` builds it)
read into a number, or None where the run has nothing to read."""

from __future__ import annotations

import importlib
from typing import Optional

GIB = 2 ** 30


def traced(run, kind: str):
    """The traced window of a run of a `kind` ("train" or "eval") cell,
    or None."""
    if run.kind != kind or not hasattr(run.window, "trace"):
        return None
    return run.window


def untraced(run, kind: str = None):
    if (kind is not None and run.kind != kind) or \
            hasattr(run.window, "trace"):
        return None
    return run.window


def rate(run, kind: str) -> Optional[float]:
    """Images of every step of the window over all of its time."""
    w = untraced(run, kind)
    return None if w is None else run.images / w.seconds


def range_ms_per_step(run, kind: str, layer: str) -> Optional[float]:
    """Device ms a step launched inside the layer's range (its nested
    ranges included)."""
    w = traced(run, kind)
    if w is None or not any(r[0] == layer for r in w.trace.ranges):
        return None
    return w.trace.inside_s(layer) * 1e3 / w.steps


def op_roofline(run, kind: str, op: str) -> Optional[float]:
    """% of the op's roofline: the least time of its recorded calls
    (`counts/<op>.py`) over the device time attributed to its ranges."""
    w = traced(run, kind)
    if w is None:
        return None
    count = importlib.import_module(f"counts.{op}")
    least, calls = 0.0, 0
    from counts.peaks import least_seconds
    for name, descs in w.recorder.ops.items():
        if name.startswith(f"op:{op}."):
            for args in descs:
                least += least_seconds(*count.work(name.split(".", 1)[1],
                                                   args))
                calls += 1
    took = w.trace.range_s(f"op:{op}.")
    if not calls or took <= 0:
        return None
    return 100.0 * least / took


def idle_share(run, kind: str) -> Optional[float]:
    """% of the device-only pass in which no operation ran on the card."""
    w = traced(run, kind)
    return None if w is None else 100.0 * (1.0 - w.busy_s / w.seconds)


def mfu(run, kind: str) -> Optional[float]:
    """% of the chip's peak: the least time of the device-only pass's
    convolutions and dense layers, each pass at its dtype's peak, over
    that pass."""
    w = traced(run, kind)
    if w is None or not w.model:
        return None
    from counts.models import least_seconds
    return 100.0 * least_seconds(w.model) / w.seconds
