"""The device trace of a window and what the per-layer metrics read of it.

`device_busy`'s method (`chip_smoke.py:device_busy`): the card's kernel,
copy and set activities as kineto recorded them, read without the
profiler's tree of host events (building that tree took 40.8 s on one
trace); busy time is the union of their intervals. Attribution: a
device activity belongs to the innermost harness range (the latest
started of those whose host interval holds the activity's launch, on
any thread) of the runtime call that launched it, which kineto links to
it by CUPTI's correlation id. Nothing synchronises at a range's edges.
"""

from __future__ import annotations

import bisect
import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

RANGE_PREFIXES = ("layer:", "op:", "step")
OUTSIDE = "outside any range"


@dataclass
class Trace:
    """One traced window. Times in microseconds on the host's clock."""

    wall_s: float
    device: List[Tuple[str, float, float, int]]  # name, start, dur, corr
    launches: Dict[int, float]  # correlation id -> host launch time
    ranges: List[Tuple[str, float, float]]  # name, start, end
    by_range: Dict[str, float] = field(default_factory=dict)  # device us
    kernels_in: Dict[str, Dict[str, int]] = field(default_factory=dict)
    unattributed: int = 0
    # the program's "op:" spans that carry their call's arguments (a
    # trace recorded with `shapes`): name, {parameter: description}
    op_args: List[Tuple[str, dict]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for s, e in sorted((s, s + d) for _, s, d, _ in self.device):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def inside_s(self, name: str) -> float:
        """Device seconds launched inside any range called `name`, its
        nested ranges included."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == name)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, start, dur, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += dur
        return total / 1e6

    def range_s(self, prefix: str) -> float:
        """Device seconds attributed to the ranges whose names start with
        `prefix`."""
        return sum(us for name, us in self.by_range.items()
                   if name.startswith(prefix)) / 1e6


def _is_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIXES)


def record(fn: Callable[[], None], device_only: bool = False,
           shapes: bool = False) -> Trace:
    """Run fn under torch.profiler (host and device) and read the trace;
    the window ends at the synchronize after fn. `device_only`: the
    device's activities alone, with no host events (the profiler's host
    cost off the window), and no attribution. `shapes`: the profiler
    keeps the arguments of the ranges that carry them (the program's
    "op:" spans describe their call's tensors so, `Trace.op_args`), at
    the host cost of recording every operator's input shapes too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] if device_only else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities, record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, launches, ranges, op_args = [], {}, [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if _is_range(name) or name.startswith(("Buffer Flush",
                                                    "Activity Buffer")):
                continue  # the ranges' device shadows; profiler's own
            device.append((name, e.start_ns() / 1e3, e.duration_ns() / 1e3,
                           e.correlation_id()))
        elif _is_range(name):
            start = e.start_ns() / 1e3
            ranges.append((name, start, start + e.duration_ns() / 1e3))
            args = e.kwinputs() if shapes and name.startswith("op:") else None
            if args:
                op_args.append((name, dict(args)))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns() / 1e3
    if not device:
        raise RuntimeError("the profiler saw no device activity")
    tr = Trace(wall, device, launches, ranges, op_args=op_args)
    if not device_only:
        attribute(tr)
    return tr


def innermost(ranges, times):
    """For each of `times` (sorted), the innermost range that holds it
    (the latest started; None outside every range): one sweep with a
    heap of the open ranges."""
    order = sorted(ranges, key=lambda r: r[1])
    out, heap, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            heapq.heappush(heap, (-order[i][1], i))
            i += 1
        while heap and order[heap[0][1]][2] < t:
            heapq.heappop(heap)
        out.append(order[heap[0][1]][0] if heap else None)
    return out


def attribute(tr: Trace) -> None:
    """Fill tr.by_range (device us by innermost range of the launch),
    tr.kernels_in (activity counts by name, by range) and
    tr.unattributed (activities whose launch the trace does not give)."""
    linked = [(tr.launches[c], name, dur) for name, _, dur, c in tr.device
              if c in tr.launches]
    tr.unattributed = len(tr.device) - len(linked)
    linked.sort()
    owners = innermost(tr.ranges, [t for t, _, _ in linked])
    for (_, name, dur), owner in zip(linked, owners):
        owner = owner or OUTSIDE
        tr.by_range[owner] = tr.by_range.get(owner, 0.0) + dur
        counts = tr.kernels_in.setdefault(owner, {})
        counts[name] = counts.get(name, 0) + 1


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by the names the trace
    gives, and the device's idle time by what the host was doing: each
    gap between busy intervals labelled by the innermost harness range
    open on the host at its middle, summed by label."""
    by_name: Dict[str, float] = {}
    for name, _, dur, _ in tr.device:
        by_name[name] = by_name.get(name, 0.0) + dur
    spans = sorted((s, s + d) for _, s, d, _ in tr.device)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    labels = innermost(tr.ranges, [(a + b) / 2 for a, b in gaps])
    idle: Dict[str, float] = {}
    for (a, b), label in zip(gaps, labels):
        idle[label or OUTSIDE] = idle.get(label or OUTSIDE, 0.0) + (b - a)
    ranked = lambda d: [[k, v / 1e6] for k, v in
                        sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}


def kernel_launches(tr: Trace, prefix: str, marks) -> int:
    """Device activities attributed to the ranges starting with `prefix`
    whose names hold one of `marks` (a hand-written kernel's symbol)."""
    return sum(n for owner, counts in tr.kernels_in.items()
               if owner.startswith(prefix)
               for name, n in counts.items()
               if any(m in name for m in marks))
