"""Spans and shape records around the program's layers, from outside it.

In a traced run the harness wraps, for the length of the traced window
only, the calls into each layer in `torch.profiler.record_function`
ranges (as `chip_smoke.py:recording_shapes` wraps a kernel's launch);
the program's own spans nest inside them, and feed the rooflines of the
ops these wrappers leave out (`readings.op_calls`):

- "layer:<name>": a method of the object a cell drives (the trainer's
  texture refresh, synthesis and update; the evaluation's attack call
  and metrics);
- "op:<op>.<pass>": the CUDA entry point of each of the port's
  hand-written ops, looked up by name in its module at call time, so
  the wrapper sees every launch; each call's arguments are recorded for
  `counts/`;

`counting()` records, with no range and no profiler, the model's
convolutions and dense layers (`F.conv2d`, `F.linear`, the decoder's
`conv3x3_reflect`) with the passes that their inputs' `requires_grad`
will make the backward run, for the step's FLOP count; the traced run
counts the steps of its device-only pass so.

Nothing synchronises at a range's edges. Every wrapper is removed when
its pass closes, so the untraced run and the reference never see it.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

PORT = "depthmodelhardening_tpu_torch"

# op range -> (module, function): each hand-written op's CUDA entry point
OPS = {
    "op:warp.fwd": ("ops.warp", "vertical_resample_fwd_cuda"),
    "op:warp.bwd": ("ops.warp", "vertical_resample_bwd_cuda"),
    "op:reproj.fwd": ("ops.reproj", "reproj_loss_fwd_cuda"),
    "op:reproj.bwd": ("ops.reproj", "reproj_loss_bwd_cuda"),
    "op:conv3x3.fwd": ("ops.conv", "conv3x3_valid_cuda"),
    "op:conv3x3.dgrad": ("ops.conv", "conv3x3_dgrad_cuda"),
    "op:conv3x3.fwd_reflect": ("ops.conv", "conv3x3_reflect_cuda"),
    "op:conv3x3.dgrad_reflect": ("ops.conv", "conv3x3_dgrad_reflect_cuda"),
    "op:pool.fwd": ("ops.pool", "maxpool3x3s2_fwd_cuda"),
    "op:pool.bwd": ("ops.pool", "maxpool3x3s2_bwd_cuda"),
}


def _describe(t):
    """What a count needs of an argument: a tensor's shape and dtype, a
    number as it is."""
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return t


class Recorder:
    """The calls recorded while the wrappers are on: `ops[range]` a list
    of argument descriptions (and, for the warp, its row maps, cloned
    outside the range), `model` a list of (kind, dtype, flops of one
    pass, passes) of the model's convolutions and dense layers."""

    def __init__(self):
        self.ops: Dict[str, List[tuple]] = {name: [] for name in OPS}
        self.model: List[Tuple[str, str, float, int]] = []
        self._inside = threading.local()

    # -- the model's FLOPs -------------------------------------------------
    def _passes(self, x, w) -> int:
        """The passes of a convolution or dense layer: the forward, its
        input gradient where x needs one and its weight gradient where w
        does (the backward that follows computes exactly those)."""
        if not torch.is_grad_enabled():
            return 1
        return 1 + int(x.requires_grad) + int(w.requires_grad)

    def conv(self, x, w, out, kind: str) -> None:
        if getattr(self._inside, "on", False):
            return
        flops = 2.0 * out.numel() * w[0].numel()
        self.model.append((kind, str(x.dtype).replace("torch.", ""), flops,
                           self._passes(x, w)))

    def linear(self, x, w, out) -> None:
        flops = 2.0 * out.numel() * w.shape[1]
        self.model.append(("linear", str(x.dtype).replace("torch.", ""),
                           flops, self._passes(x, w)))


@contextlib.contextmanager
def _patched(obj, name: str, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _ranged(name: str, fn: Callable, before: Callable = None) -> Callable:
    def wrapped(*args, **kwargs):
        if before is not None:
            before(args)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def traced(layers: Dict[str, Tuple[object, str]]):
    """The ranges on, for one traced pass; yields the Recorder of the
    hand-written ops' calls. `layers`: range name -> (object, method
    name) of the cell's layers."""
    rec = Recorder()
    with contextlib.ExitStack() as stack:
        for name, (obj, attr) in layers.items():
            stack.enter_context(_patched(obj, attr,
                                         _ranged(name, getattr(obj, attr))))
        for name, (mod, fn) in OPS.items():
            module = importlib.import_module(f"{PORT}.{mod}")
            calls = rec.ops[name]

            def before(args, calls=calls, warp=name.startswith("op:warp")):
                desc = tuple(_describe(a) for a in args)
                if warp:  # the row maps, whose reach sets the work
                    desc += (args[1].detach().clone(),
                             args[2].detach().clone())
                calls.append(desc)
            stack.enter_context(_patched(
                module, fn, _ranged(name, getattr(module, fn), before)))
        yield rec


@contextlib.contextmanager
def counting():
    """The model's convolutions and dense layers recorded, without ranges;
    yields the Recorder (its `model`)."""
    rec = Recorder()
    with contextlib.ExitStack() as stack:
        conv2d, linear = F.conv2d, F.linear

        def conv2d_rec(x, w, *a, **k):
            out = conv2d(x, w, *a, **k)
            rec.conv(x, w, out, "conv")
            return out

        def linear_rec(x, w, *a, **k):
            out = linear(x, w, *a, **k)
            rec.linear(x, w, out)
            return out

        decoder = importlib.import_module(f"{PORT}.models.depth_decoder")
        reflect = decoder.conv3x3_reflect

        def reflect_rec(x, w, *a, **k):
            rec._inside.on = True
            try:
                out = reflect(x, w, *a, **k)
            finally:
                rec._inside.on = False
            rec.conv(x, w, out, "conv3x3")
            return out

        stack.enter_context(_patched(F, "conv2d", conv2d_rec))
        stack.enter_context(_patched(F, "linear", linear_rec))
        stack.enter_context(_patched(decoder, "conv3x3_reflect",
                                     reflect_rec))
        yield rec
