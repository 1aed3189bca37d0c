"""What the metric readers share: a run's record (`main.run` builds it)
read into a number, or None where the run has nothing to read."""

from __future__ import annotations

import importlib
import re
from typing import Iterator, Optional, Tuple

from .spans import OPS

GIB = 2 ** 30
ROOFLINE = "_roofline"
# the ops whose calls the harness's own wrappers record
WRAPPED = frozenset(name[3:].split(".")[0] for name in OPS)
_TENSOR = re.compile(r"^\(([\d, ]*)\) (\w+)$")


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


def span_fed(metric: str) -> bool:
    """Whether `metric` is the roofline of an op that the harness does
    not wrap (`<op>_roofline`, `<op>_roofline.<kind>`): its calls are
    read from the program's own spans, which a traced run then records
    with their arguments."""
    base = metric.split(".")[0]
    return base.endswith(ROOFLINE) and base[:-len(ROOFLINE)] not in WRAPPED


def _described(value):
    """A span argument as `counts/` takes it: a tensor's "(shape) dtype"
    as (shape, dtype), anything else as it is."""
    m = _TENSOR.match(value) if isinstance(value, str) else None
    if m is None:
        return value
    return (tuple(int(d) for d in m.group(1).replace(",", " ").split()),
            m.group(2))


def op_calls(w, op: str) -> Iterator[Tuple[str, object]]:
    """(pass, args) of each recorded call of `op` in a traced window: an
    op the harness wraps (`spans.OPS`) from its wrappers' record, args
    the call's positional arguments described; any other op from the
    program's own "op:<op>.<pass>" spans, args a dict by parameter name
    (tensors as (shape, dtype))."""
    prefix = f"op:{op}."
    if op in WRAPPED:
        for name, descs in w.recorder.ops.items():
            if name.startswith(prefix):
                for args in descs:
                    yield name[len(prefix):], args
        return
    for name, args in w.trace.op_args:
        if name.startswith(prefix):
            yield name[len(prefix):], {k: _described(v)
                                       for k, v in args.items()}


def op_roofline(run, kind: str, op: str) -> Optional[float]:
    """% of the op's roofline: the least time of its recorded calls
    (`op_calls`, each counted by `counts/<op>.py`) over the device time
    attributed to its ranges."""
    w = traced(run, kind)
    if w is None:
        return None
    count = importlib.import_module(f"counts.{op}")
    least, calls = 0.0, 0
    from counts.peaks import least_seconds
    for pass_, args in op_calls(w, op):
        least += least_seconds(*count.work(pass_, args))
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
