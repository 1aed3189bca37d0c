"""What the per-layer metrics read of the program's own spans: the
ranges the port opens itself (`depthmodelhardening_tpu_torch/utils/
profiling.py`) while the profiler runs, which the traced run's ranged
pass keeps beside the harness's own (their names start with "layer:" or
"op:"). A run of a program that opens no such range reads None.

- `idle_ms_per_step`: the card's idle time in the ranged pass, each gap
  between busy intervals counted where its middle lies inside a range of
  the given name (the host was in that layer while the card waited), in
  ms a step;
- `syncs_per_step`: the program's "layer:sync.*" ranges (a blocking read
  of a card value, a pageable host-to-card copy) that start inside a
  range of the given name, a step.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .readings import traced

SYNC_PREFIX = "layer:sync."


def _window(run, kind: str, span: str):
    """The traced window of a run whose ranged pass holds `span`."""
    w = traced(run, kind)
    if w is None or not any(r[0] == span for r in w.trace.ranges):
        return None
    return w


def _holder(tr, span: str):
    """A test of a host time (us): inside any range named `span`?"""
    spans = sorted((s, e) for n, s, e in tr.ranges if n == span)
    starts = [s for s, _ in spans]

    def holds(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]
    return holds


def idle_gaps(tr) -> List[Tuple[float, float]]:
    """The gaps (us) between the union of the device's activities."""
    gaps, end = [], None
    for s, e in sorted((s, s + d) for _, s, d, _ in tr.device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_ms_per_step(run, kind: str, span: str) -> Optional[float]:
    w = _window(run, kind, span)
    if w is None:
        return None
    holds = _holder(w.trace, span)
    idle = sum(b - a for a, b in idle_gaps(w.trace) if holds((a + b) / 2))
    return idle / 1e3 / w.steps


def syncs_per_step(run, kind: str, span: str) -> Optional[float]:
    w = _window(run, kind, span)
    if w is None:
        return None
    holds = _holder(w.trace, span)
    n = sum(1 for name, s, _ in w.trace.ranges
            if name.startswith(SYNC_PREFIX) and holds(s))
    return n / w.steps
