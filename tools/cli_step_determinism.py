"""Which op keeps the CLI's first hardening step from repeating on the card.

    python3 tools/cli_step_determinism.py

Two direct `train_step`s built as the CLI's first step was (bf16
student, L0, frames 0,s, batch 32 at 1024x320) differ by about 1e-2
relative L2 in their gradients, while their forward, loss and running
statistics are bit-equal. From the repo root and with `chip_smoke.py`'s
helpers, this runs the device check, the kernels' build and phase 15
(the port's command line on a KITTI tree written to a temporary
directory, which gives the CLI's first step and the spread of two direct
steps), then prints one line a reading: two more direct steps under
`torch.use_deterministic_algorithms(True, warn_only=True)` (the ops that
warn and the spread), the same with uninitialised memory left unfilled,
and, with the flag off, two direct steps with one op held deterministic:
the bilinear resize's backward as matrix products, each op of
HELD_BACKWARD (its backward recomputed under the flag) and HELD_CALL
(each call under the flag), and all of them at once. Readings, no check.
Needs one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from depthmodelhardening_tpu_torch.ops import conv  # noqa: E402


class _DeterministicResize(torch.autograd.Function):
    """F.interpolate's bilinear resize (no antialias, half-pixel) whose
    backward is Ry^T g Rx with the interpolation matrices: matrix
    products instead of the CUDA kernel's atomic adds."""

    @staticmethod
    def forward(ctx, x, size, interpolate):
        eye = lambda n, dim: interpolate(
            torch.eye(n, device=x.device)[:, None, :, None], size=(
                size[dim], 1), mode="bilinear", align_corners=False)[:, 0, :, 0]
        ctx.ry, ctx.rx = eye(x.shape[2], 0).T, eye(x.shape[3], 1).T
        return interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        return ctx.ry.T @ g @ ctx.rx, None, None


def _resize_patch(interpolate):
    """F.interpolate with its float32 bilinear resizes through
    `_DeterministicResize`."""
    def resize(x, size=None, scale_factor=None, mode="nearest",
               align_corners=None, antialias=False, **kw):
        if mode == "bilinear" and not antialias and size is not None \
                and x.dtype == torch.float32 and torch.is_grad_enabled() \
                and x.requires_grad:
            return _DeterministicResize.apply(x, tuple(size), interpolate)
        return interpolate(x, size=size, scale_factor=scale_factor,
                           mode=mode, align_corners=align_corners,
                           antialias=antialias, **kw)
    return resize


class _FlagBackward(torch.autograd.Function):
    """fn(*tensors) whose backward recomputes fn under
    torch.use_deterministic_algorithms and differentiates that: one op's
    gradient held deterministic, the rest of the step as it is."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        return fn(*tensors)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), _deterministic():
            grads = iter(torch.autograd.grad(ctx.fn(*inputs), wanted, g))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in inputs)


# what each reading of `print_readings` holds deterministic, and
# where: the op's backward recomputed under the flag (`_FlagBackward`),
# or each call under it (the in-place scatter_add_ of the stereo row
# warp's backward, kernel D's weight gradient)
HELD_BACKWARD = {"interpolate": F, "linear": F, "batch_norm": F,
                 "conv2d": F, "index_select": torch.Tensor}
HELD_CALL = {"scatter_add_": torch.Tensor, "weight_grad": conv}


def _flag_backward_patch(name: str):
    """HELD_BACKWARD's op `name` with its backward under the flag."""
    orig = getattr(HELD_BACKWARD[name], name)
    if name == "batch_norm":
        def patched(x, running_mean, running_var, weight=None, bias=None,
                    training=False, momentum=0.1, eps=1e-5):
            if not (training and x.requires_grad):
                return orig(x, running_mean, running_var, weight, bias,
                            training, momentum, eps)
            calls = []

            def fn(x, *wb):
                # the forward updates the running statistics, the
                # backward's recomputation copies of them
                stats = [s if not calls or s is None else s.clone()
                         for s in (running_mean, running_var)]
                calls.append(1)
                w, b = (wb + (None, None))[:2] if weight is not None \
                    else (None, None)
                return orig(x, *stats, w, b, training, momentum, eps)

            return _FlagBackward.apply(
                fn, x, *[t for t in (weight, bias) if t is not None])
    elif name in ("linear", "conv2d"):
        def patched(x, w, b=None, *args, **kw):
            if b is None:
                return _FlagBackward.apply(
                    lambda x, w: orig(x, w, None, *args, **kw), x, w)
            return _FlagBackward.apply(
                lambda x, w, b: orig(x, w, b, *args, **kw), x, w, b)
    else:
        def patched(x, *args, **kw):
            if not x.requires_grad:
                return orig(x, *args, **kw)
            return _FlagBackward.apply(lambda t: orig(t, *args, **kw), x)
    return patched


def _flag_call_patch(name: str):
    """HELD_CALL's op `name` with each call under the flag."""
    orig = getattr(HELD_CALL[name], name)

    def patched(*args, **kw):
        with _deterministic():
            return orig(*args, **kw)
    return patched


@contextlib.contextmanager
def _deterministic(enabled=True):
    torch.use_deterministic_algorithms(enabled)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def print_readings(f, dev) -> None:
    """Which op keeps the CLI's first step from repeating on the card: two
    direct steps (as phase 15's) under torch.use_deterministic_algorithms
    (True, warn_only=True), the ops that warn and the spread; the same
    with uninitialised memory left unfilled; then, without the flag, two
    more with one op held deterministic: the bilinear resize's backward
    as matrix products (`_DeterministicResize`), each op of HELD_BACKWARD
    (its backward recomputed under the flag: F.interpolate, F.linear,
    F.batch_norm, F.conv2d, the reflect pad's `index_select`) and of
    HELD_CALL (each call under the flag: the stereo row warp's
    `scatter_add_`, kernel D's weight gradient), and all of them at once.
    Readings, no check."""
    import warnings

    import torch.utils.deterministic as det

    held = tuple(HELD_BACKWARD) + tuple(HELD_CALL)
    readings = [("deterministic algorithms (warn_only)", True, ()),
                ("deterministic algorithms, uninitialised memory not "
                 "filled", True, ("no fill",)),
                ("the resize's backward as matrix products", False,
                 ("resize",))]
    readings += [(f"{name} held deterministic", False, (name,))
                 for name in held]
    readings.append(("all of these at once", False, ("resize",) + held))
    for label, flag, swaps in readings:
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.ExitStack() as stack:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(flag, warn_only=True)
            stack.callback(torch.use_deterministic_algorithms, False)
            fill = det.fill_uninitialized_memory
            stack.callback(setattr, det, "fill_uninitialized_memory", fill)
            if "no fill" in swaps:
                det.fill_uninitialized_memory = False
            for name in swaps:
                if name in ("resize", "no fill"):
                    continue
                owner = HELD_BACKWARD.get(name) or HELD_CALL[name]
                stack.callback(setattr, owner, name, getattr(owner, name))
                setattr(owner, name, _flag_backward_patch(name)
                        if name in HELD_BACKWARD else _flag_call_patch(name))
            if "resize" in swaps:
                # on top of interpolate's hold when both are asked for
                stack.callback(setattr, F, "interpolate", F.interpolate)
                F.interpolate = _resize_patch(F.interpolate)
            a, b = cs._direct_steps(f.first, dev)
        ops = sorted({str(w.message)[:200] for w in caught
                      if "determinis" in str(w.message)})
        cs.log(f"  determinism, {label}: {len(caught)} warnings, those on "
            f"determinism {json.dumps(ops)}; two direct steps apart by "
            f"{json.dumps(cs._outcome_distance(b, a))}")
    cs.log(f"  determinism: phase 15's direct spread without the flag "
        f"{json.dumps(f.spread)}")


def main() -> int:
    dev = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="dmh_det_") as root:
        _, f = cs.phase_cli_commands(dev, root)
        print_readings(f, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
