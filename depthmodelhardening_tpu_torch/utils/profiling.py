"""The port's spans, its FLOP counter and the operator's trace (the
reference has none: SURVEY §5, only wall-clock prints).

Counterpart of `depthmodelhardening_tpu/utils/profiling.py`:

  * span(name, args=None) - a range on the profiler's clock around one
    piece of the program's work, while a torch profiler is active;
    otherwise a shared no-op after one flag check. The ranges are the
    profiler's own host events, on kineto's clock with the card's
    activities, so an idle gap of the card falls inside the spans the
    host was in. Every name is in `SPAN_NAMES` and starts with "layer:"
    or "op:" (a profile reader that keeps host ranges by those prefixes
    drops their device-side shadows). `args` describe the span (a step,
    an iteration, a site, an op's argument shapes); tensors among them
    are described by shape and dtype, never held;
  * op_span(name) - the decorator of each hand-written kernel's CUDA
    entry point: its launch in an "op:<op>.<pass>" span that carries
    its arguments' shapes and dtypes;
  * the FLOP counter - `count_conv` / `count_dense` at each of the
    models' convolutions and dense layers count (kind, dtype, flops of
    one pass, passes) while a profiler is active, the passes being the
    forward and the gradients its inputs' `requires_grad` will make the
    backward compute; `flop_record()` reads, `reset_flops()` empties;
  * trace(log_dir) - the operator's profile: everything inside the
    context (the port's spans among it) into <log_dir>/trace.json, a
    Chrome trace, and the FLOP record and the kernels' launches into
    <log_dir>/counters.json;
  * TraceWindow / stepped - the CLI's --trace-dir: steps `first` ..
    `first + count - 1` of a loop under `trace`, each step's wait for
    its data in a "layer:data.wait" span.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import json
import os
from typing import Iterable, Iterator, List, Optional, Tuple

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled

# -- span names ---------------------------------------------------------------
TRAIN_STEP = "layer:train.step"  # a train_step / selfsup_frames_step
TRAIN_ATTACK = "layer:train.attack"  # the texture refresh's body
TRAIN_SYNTHESIS = "layer:train.synthesis"  # synth_batch's body
TRAIN_BATCH = "layer:train.batch"  # plain_batch's body
TRAIN_UPDATE = "layer:train.update"  # _update's body
TRAIN_LOSSES = "layer:train.losses"
TRAIN_BACKWARD = "layer:train.backward"
TRAIN_OPTIMIZER = "layer:train.optimizer"
TRAIN_ALLREDUCE = "layer:train.allreduce"
ATTACK_ITER = "layer:attack.iter"  # one iteration of the L0 / PGD loop
ATTACK_GRAD = "layer:attack.grad"  # the iteration's cost and gradient
ATTACK_UPDATE = "layer:attack.update"  # its Adam or sign step
ATTACK_FINALS = "layer:attack.finals"  # the finals' composites
EOT_GEOMETRY = "layer:eot.geometry"  # host warp parameters + their copy
SYNC_READ = "layer:sync.read"  # a blocking read of a card value
SYNC_COPY = "layer:sync.copy"  # a pageable host-to-card copy
EVAL_ATTACK = "layer:eval.attack"
EVAL_METRICS = "layer:eval.metrics"
DATA_WAIT = "layer:data.wait"  # the CLI loop's wait on its data
# the hand-written ops' CUDA entry points, "op:<op>.<pass>"
OP_NAMES = ("op:warp.fwd", "op:warp.bwd", "op:reproj.fwd", "op:reproj.bwd",
            "op:conv3x3.fwd", "op:conv3x3.dgrad", "op:conv3x3.fwd_reflect",
            "op:conv3x3.dgrad_reflect", "op:pool.fwd", "op:pool.bwd")
SPAN_NAMES = (TRAIN_STEP, TRAIN_ATTACK, TRAIN_SYNTHESIS, TRAIN_BATCH,
              TRAIN_UPDATE, TRAIN_LOSSES, TRAIN_BACKWARD, TRAIN_OPTIMIZER,
              TRAIN_ALLREDUCE, ATTACK_ITER, ATTACK_GRAD, ATTACK_UPDATE,
              ATTACK_FINALS, EOT_GEOMETRY, SYNC_READ, SYNC_COPY, EVAL_ATTACK,
              EVAL_METRICS, DATA_WAIT) + OP_NAMES
_KNOWN = frozenset(SPAN_NAMES)
_NULL = contextlib.nullcontext()


def _describe(v):
    """A span argument as the trace keeps it: a tensor's shape and dtype,
    a number or a string as it is, anything else as its str."""
    if isinstance(v, torch.Tensor):
        return f"{tuple(v.shape)} {str(v.dtype).replace('torch.', '')}"
    if isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


@functools.cache
def _range_class():
    """torch's `_RecordFunctionFast` where it takes keyword values (they
    reach the Chrome trace's args; a few microseconds where no profiler
    records host events), else None: `record_function`."""
    cls = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if cls is not None:
        try:
            cls(TRAIN_STEP, [], {})
        except TypeError:
            return None
    return cls


def _open(name: str, args: Optional[dict]):
    """The profiler range of one span (the profiler is on)."""
    if name not in _KNOWN:
        raise ValueError(f"{name!r} is not in SPAN_NAMES")
    kw = {} if not args else {k: _describe(v) for k, v in args.items()
                              if v is not None}
    cls = _range_class()
    if cls is not None:
        return cls(name, [], kw)
    return torch.profiler.record_function(
        name, json.dumps(kw) if kw else None)


def span(name: str, args: Optional[dict] = None):
    """A context manager: the range `name` (one of SPAN_NAMES) with
    `args` while a torch profiler is active, else a shared no-op."""
    if not _profiler_enabled():
        return _NULL
    return _open(name, args)


def host_copy(src, site: str):
    """The span of a copy of `src` to the card at `site`: a SYNC_COPY
    where `src` is on the host (not a tensor, or a CPU tensor), the no-op
    where it already lives on a card."""
    if not _profiler_enabled() or (isinstance(src, torch.Tensor)
                                   and src.device.type != "cpu"):
        return _NULL
    return _open(SYNC_COPY, {"site": site})


def op_span(name: str):
    """Decorator of a hand-written op's CUDA entry point: each call in the
    span `name` with its arguments, by parameter name, described."""
    def wrap(fn):
        params = list(inspect.signature(fn).parameters)

        @functools.wraps(fn)
        def launch(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _open(name, {**dict(zip(params, args)), **kwargs}):
                return fn(*args, **kwargs)
        return launch
    return wrap


# -- the FLOP counter ---------------------------------------------------------
# calls by (kind, dtype, flops of one pass, passes): its size is the number of
# distinct layer calls, however long a profile runs
_flops: collections.Counter = collections.Counter()


def _passes(x, w) -> int:
    """The forward, and the input and weight gradients the backward will
    compute of it (those of x and w that need one)."""
    if not torch.is_grad_enabled():
        return 1
    return 1 + int(x.requires_grad) + int(w.requires_grad)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def count_conv(x, w, out, kind: str = "conv") -> None:
    """One convolution of x (N, Cin, ...) by w (Co, Cin / groups, ...)
    into out: 2 FLOPs a multiply-add, `out.numel() * w[0].numel()` of
    them a pass (w[0]'s size taken without making the view)."""
    if _profiler_enabled():
        _flops[(kind, _dtype(x), 2.0 * out.numel() * (w.numel() // w.shape[0]),
                _passes(x, w))] += 1


def count_dense(x, w, out) -> None:
    """One dense layer, x (..., in) by w (out, in)."""
    if _profiler_enabled():
        _flops[("linear", _dtype(x), 2.0 * out.numel() * w.shape[1],
                _passes(x, w))] += 1


def counted(layer, x):
    """layer(x) for an nn.Conv2d or nn.Linear, counted."""
    out = layer(x)
    if _profiler_enabled():
        count = (count_dense if isinstance(layer, torch.nn.Linear)
                 else count_conv)
        count(x, layer.weight, out)
    return out


def flop_record() -> List[Tuple[str, str, float, int]]:
    """(kind, dtype, flops of one pass, passes) of each counted layer
    call since the last `reset_flops`, one entry a call."""
    return list(_flops.elements())


def reset_flops() -> None:
    _flops.clear()


def flop_summary(record) -> dict:
    """The record summed: FLOPs by dtype (every pass), and the calls and
    FLOPs of each (kind, dtype, passes)."""
    by_dtype, groups = {}, {}
    for kind, dtype, flops, passes in record:
        by_dtype[dtype] = by_dtype.get(dtype, 0.0) + flops * passes
        g = groups.setdefault(f"{kind}.{dtype}.{passes}",
                              {"calls": 0, "flops_one_pass": 0.0})
        g["calls"] += 1
        g["flops_one_pass"] += flops
    return {"flops_by_dtype": by_dtype, "layers": groups}


# -- the operator's trace ---------------------------------------------------
@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile everything inside the context (CPU, and the card's
    kernels and copies where CUDA is available, with shapes, so the
    spans' args reach the trace) into <log_dir>/trace.json, and the
    FLOP record and each hand-written kernel's launches of the window
    into <log_dir>/counters.json; yields the `torch.profiler.profile`
    (its `key_averages()` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _build

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = {k.name: k.launches for k in _build.KERNELS}
    reset_flops()
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    record = flop_record()
    reset_flops()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    launches = {k.name: k.launches - before.get(k.name, 0)
                for k in _build.KERNELS}
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump({**flop_summary(record),
                   "launches": {k: n for k, n in launches.items() if n}},
                  f, indent=1)


class TraceWindow:
    """Steps `first` .. `first + count - 1` of a loop (counted from 0 by
    `step()` calls) traced into `log_dir` (`trace`); the first step is
    left out, since it builds the shapes. With no `log_dir`, nothing."""

    def __init__(self, log_dir: Optional[str], first: int = 1,
                 count: int = 2):
        self.log_dir, self.first, self.count = log_dir, first, count
        self.n = 0
        self._stack = contextlib.ExitStack()

    def step(self) -> None:
        """At the start of each step, before it waits for its data."""
        if self.log_dir:
            if self.n == self.first:
                self._stack.enter_context(trace(self.log_dir))
            elif self.n == self.first + self.count:
                self._stack.close()
        self.n += 1

    def close(self) -> None:
        """Ends the trace if the loop ended inside the window."""
        self._stack.close()


def stepped(items: Iterable, window: Optional[TraceWindow] = None
            ) -> Iterator:
    """Each of `items`, as one step: `window.step()` first, then the wait
    for the item in a DATA_WAIT span."""
    it = iter(items)
    end = object()
    while True:
        if window is not None:
            window.step()
        with span(DATA_WAIT):
            item = next(it, end)
        if item is end:
            return
        yield item
