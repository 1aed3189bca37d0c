"""Which ops keep a path of the port from repeating on the card.

    python3 tools/cli_step_determinism.py [--native OP] [PATH ...]

PATH is one of PATHS (default: all of them), each a run of a path that
`chip_smoke.py` drives, from a fresh state and injected draws: "12a" one
`train_step` of phase 12a's trainer (the CLI's bf16 `train-hardening
--fine-tune` step, frames 0,s, batch 32 at 1024x320: the step phase 15a
runs from files), "16a" its training half alone (`synth_batch` +
`_update` on a fixed texture), "11" the same half with phase 11's
float32 student, "12b" phase 12b's step (mono+stereo), "9" phase 9's
float32 distillation step, "10" phase 10's (bench.py's bf16), "image"
and "l0" one batch of the `image_eps001` and `l0_thresh01` presets (13b)
and "5" one batch of phase 5's L-inf PGD-10 attack. For each, four
readings, no check:

1. the kernel-name diff: the path once under the profiler as it is, and
   once under `torch.use_deterministic_algorithms(True, warn_only=True)`;
   the device kernels that only one of the two ran, and those whose
   launches differ (what the flag switched), and the warnings the flagged
   run raised;
2. the op finder: the path twice under `OpHashes`, a TorchDispatchMode
   that sums the bits of every tensor an aten op takes and gives; the ops
   whose inputs were bit-equal in both runs and whose outputs were not
   (the sources of a spread: name, dtypes and shapes, how often), and the
   first op whose inputs differ before any such op (a value made outside
   the dispatcher: a kernel of `csrc/` or the host). A sum can miss a
   difference whose ulps cancel, so an op downstream of a source may be
   named too: the first source in the run is the one to trust;
3. the spread of two plain runs: each tensor of the outcome (loss terms,
   gradients, parameters, running statistics, textures, adversarial
   images) bit-equal or its relative L2 distance;
4. the cost of each op the port replaced to repeat itself (REPLACED):
   the shapes its backward took in one run, and at each, the device ms
   (`chip_smoke.cuda_ms`) of PyTorch's own backward and of the port's,
   with their sums over the run.

`--native OP` (repeatable) runs the paths with OP's backward PyTorch's
own again, the other replacements kept: the spread OP causes alone.
From the repo root, with `chip_smoke.py`'s helpers; needs one card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from depthmodelhardening_tpu_torch.ops import padding, resize  # noqa: E402

# ops whose outputs hold uninitialised memory until a later op fills them
UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided")
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64,
         torch.bool: torch.uint8}


def bit_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t's elements read as integers of their width (int64):
    a value one ulp away moves it."""
    v = t.detach()
    if v.dtype in _BITS:
        v = v.view(_BITS[v.dtype])
    elif v.is_complex() or v.is_sparse:
        return torch.zeros((), dtype=torch.int64)
    return torch.sum(v, dtype=torch.int64)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpHashes(TorchDispatchMode):
    """Records, for every aten op, (name, the dtypes and shapes of its
    tensor inputs, the bit sums of its inputs, those of its outputs)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        hin = [bit_sum(t) for t in ins]
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        hout = [] if name in UNINITIALISED else [bit_sum(t) for t in
                                                 _tensors(out)]
        meta = tuple((str(t.dtype).split(".")[-1], tuple(t.shape))
                     for t in ins)
        self.records.append((str(func), meta, hin, hout))
        return out

    def settled(self):
        """The records with their sums on the host."""
        flat = [h for r in self.records for h in r[2] + r[3]]
        host = [int(v) for v in torch.stack([h.cpu() for h in flat])] \
            if flat else []
        it = iter(host)
        return [(f, m, [next(it) for _ in hi], [next(it) for _ in ho])
                for f, m, hi, ho in self.records]


def sources(ra, rb) -> dict:
    """The ops of two runs' records whose inputs were bit-equal and whose
    outputs were not, counted by (op, dtypes and shapes); the first op
    whose inputs differ before any of those; where the two runs' op
    sequences part."""
    found = collections.Counter()
    first_in, parted = None, None
    for i, (a, b) in enumerate(zip(ra, rb)):
        if a[0] != b[0] or a[1] != b[1]:
            parted = (i, a[0], b[0])
            break
        if a[2] == b[2] and a[3] != b[3]:
            found[(a[0], a[1])] += 1
        elif a[2] != b[2] and first_in is None and not found:
            first_in = (i, a[0], a[1])
    if parted is None and len(ra) != len(rb):
        parted = (min(len(ra), len(rb)), "end", "end")
    return {"ops": len(ra), "sources": [
        {"op": op, "inputs": meta, "times": n}
        for (op, meta), n in found.most_common()],
        "first_input_differing_before_a_source": first_in,
        "sequences_part_at": parted}


# -- the paths ----------------------------------------------------------------
def _cli_trainer(dev, frame_ids=("0", "s"), cfg=None):
    _, sd = cs._golden_weights()
    obj, mask = cs.make_car_object(300, 200, seed=cs.SEED)
    if cfg is None:
        cfg = cs._cli_cfg(frame_ids)
        sd = cs.calibrated_teacher(dev, sd)
    trainer = cs._harden_trainer(dev, cfg, sd, obj, mask, cs.SEED + 90)
    frames, side, flip, scene = cs._harden_inputs(dev, cfg, cs.SEED + 91)
    draws = dataclasses.replace(
        trainer.draw(cfg.batch_size),
        identity_noise=trainer.draw_identity_noise(cfg.batch_size))
    return trainer, (frames, side, flip, scene), draws


def path_step(dev, frame_ids=("0", "s")):
    """Phase 12a's `train_step` from a fresh state on injected draws."""
    trainer, (frames, side, flip, scene), draws = _cli_trainer(dev,
                                                               frame_ids)

    def run():
        state, m = trainer.train_step(trainer.make_state(), frames, side,
                                      flip, scene, draws=draws)
        return cs.outcome(cs._state_modules(state), m, l0_iterations=[
            trainer.attack.last_iterations])
    return run


def _path_half(dev, cfg=None):
    trainer, (frames, side, flip, scene), draws = _cli_trainer(dev, cfg=cfg)
    texture = trainer.refresh_texture(trainer.make_state(), scene,
                                      draws).detach().clone()

    def run():
        batch = trainer.synth_batch(frames, side, flip, texture, draws)
        state, m = trainer._update(trainer.make_state(), batch,
                                   draws.identity_noise)
        return cs.outcome(cs._state_modules(state), m)
    return run


def path_half_bf16(dev):
    """Phase 16a's bf16 training half on a fixed texture."""
    return _path_half(dev)


def path_half_f32(dev):
    """The same half with phase 11's float32 student and golden weights."""
    return _path_half(dev, cfg=cs.HARDEN_CFG)


def _distill_path(dev, bench: bool):
    """One `train_step` of phase 9's (float32) or phase 10's (bench.py's
    bf16) distillation trainer from a fresh state, its generator seeded
    afresh each run."""
    _, sd = cs._golden_weights()
    obj, mask = cs.make_car_object(300, 200, seed=cs.SEED)
    if bench:
        cfg, n, seed = cs.BENCH_CFG, 1, cs.SEED + 61
        trainer = cs._bench_trainer(dev, cfg, cs.calibrated_teacher(dev, sd),
                                    obj, mask, seed)
    else:
        cfg, seed = cs.DISTILL_CFG, cs.SEED
        n = cfg.batch_size
        trainer = cs._distill_trainer(dev, cfg, sd, obj, mask, seed)
    scenes = torch.from_numpy(cs.make_scene(n, cfg.ori_h, cfg.ori_w,
                                            seed=seed + 1)).to(dev)

    def run():
        trainer.generator.manual_seed(seed)
        state, m = trainer.train_step(trainer.make_state(), scenes)
        return cs.outcome(cs._state_modules(state), m)
    return run


def _attack_path(dev, cfg, seed):
    """One `evaluate_attacks` batch of cfg's attack, its generator seeded
    afresh each run (`chip_smoke.eval_run`: the adversarial images, the
    attack's other outputs and the 8 metrics)."""
    from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
        build_attack,
    )

    _, sd = cs._golden_weights()
    predictor = cs._golden_predictor(dev, sd)
    obj, mask = cs.make_car_object(300, 200, seed=cs.SEED)
    attack = build_attack(cfg, predictor, obj, mask)
    scenes = cs.make_scene(cfg.batch_size, cfg.ori_h, cfg.ori_w, seed=seed)
    return lambda: cs.eval_run(predictor, attack, scenes, cfg, seed + 1)[0]


def path_image(dev):
    """One batch of the image_eps001 preset (13b's cut: one batch)."""
    return _attack_path(dev, cs.EVAL_PRESETS["image_eps001"], cs.SEED + 130)


def path_linf(dev):
    """One batch of phase 5's L-inf PGD-10 attack."""
    return _attack_path(dev, cs.CFG, cs.SEED + 5)


# -- the replaced ops -----------------------------------------------------------
def _pad_native(g):
    """F.pad(mode="reflect")'s own backward (atomic adds on the card)."""
    B, C, Hp, Wp = g.shape
    return torch.ops.aten.reflection_pad2d_backward(
        g, g.new_empty(B, C, Hp - 2, Wp - 2), [1, 1, 1, 1])


def _resize_native(ctx, g):
    """F.interpolate's own bilinear backward (atomic adds on the card)."""
    (H, W), (B, C, oh, ow) = ctx.in_hw, g.shape
    return torch.ops.aten.upsample_bilinear2d_backward(
        g, [oh, ow], [B, C, H, W], False), None, None


def _resize_port(g, in_hw):
    ctx = type("Ctx", (), {"in_hw": in_hw})()
    return resize.BilinearResize.backward(ctx, g)[0]


# op: (owner, attribute, PyTorch's own backward, the port's backward at a
# recorded (shape, dtype, extra), PyTorch's own at it)
REPLACED = {
    "reflect_pad": (padding, "reflect_pad1_adjoint", _pad_native,
                    lambda g, _: padding.reflect_pad1_adjoint(g),
                    lambda g, _: _pad_native(g)),
    "bilinear_resize": (resize.BilinearResize, "backward",
                        staticmethod(_resize_native), _resize_port,
                        lambda g, hw: _resize_native(type("Ctx", (), {
                            "in_hw": hw})(), g)[0]),
}


@contextlib.contextmanager
def native(ops):
    """The named REPLACED ops with PyTorch's own backward."""
    saved = [(REPLACED[o][0], REPLACED[o][1],
              REPLACED[o][0].__dict__[REPLACED[o][1]]) for o in ops]
    try:
        for o in ops:
            owner, attr, orig, *_ = REPLACED[o]
            setattr(owner, attr, orig)
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


@contextlib.contextmanager
def recording(calls):
    """Counts each REPLACED op's backward calls by (shape, dtype, extra)
    into `calls[op]` while the port's backward runs."""
    pad, bwd = padding.reflect_pad1_adjoint, resize.BilinearResize.__dict__[
        "backward"]

    def pad_rec(g):
        calls["reflect_pad"][(tuple(g.shape), g.dtype, None)] += 1
        return pad(g)

    def resize_rec(ctx, g):
        calls["bilinear_resize"][(tuple(g.shape), g.dtype,
                                  tuple(ctx.in_hw))] += 1
        return bwd.__func__(ctx, g)

    padding.reflect_pad1_adjoint = pad_rec
    resize.BilinearResize.backward = staticmethod(resize_rec)
    try:
        yield
    finally:
        padding.reflect_pad1_adjoint = pad
        resize.BilinearResize.backward = bwd


def op_costs(run, dev) -> dict:
    """Each REPLACED op's backward shapes in one run and, at each, the
    device ms of PyTorch's own backward and of the port's."""
    calls = {o: collections.Counter() for o in REPLACED}
    with recording(calls):
        run()
    out = {}
    for o, seen in calls.items():
        *_, port, own = REPLACED[o]
        rows, total = [], [0.0, 0.0]
        for (shape, dtype, extra), n in seen.items():
            g = torch.randn(shape, device=dev).to(dtype)
            ms = [cs.cuda_ms(lambda f=f: f(g, extra), reps=10)
                  for f in (own, port)]
            rows.append({"shape": shape, "dtype": str(dtype), "in": extra,
                         "calls": n, "pytorch_ms": ms[0], "port_ms": ms[1]})
            total = [t + n * m for t, m in zip(total, ms)]
        out[o] = {"per_run_ms": {"pytorch": total[0], "port": total[1]},
                  "shapes": rows}
    return out


PATHS = {"12a": path_step, "16a": path_half_bf16, "11": path_half_f32,
         "image": path_image, "5": path_linf,
         "12b": lambda dev: path_step(dev, cs.MONO_FRAMES),
         "9": lambda dev: _distill_path(dev, bench=False),
         "10": lambda dev: _distill_path(dev, bench=True),
         "l0": lambda dev: _attack_path(dev, cs.EVAL_PRESETS["l0_thresh01"],
                                        cs.SEED + 131)}


@contextlib.contextmanager
def deterministic_flag():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def kernel_diff(run) -> dict:
    """The device kernels of one run as it is against one run under the
    flag: names only one ran, launches that differ, the flag's warnings."""
    *_, plain = cs.device_busy(run)
    with warnings.catch_warnings(record=True) as caught, \
            deterministic_flag():
        warnings.simplefilter("always")
        *_, flagged = cs.device_busy(run)
    short = lambda n: n[:160]
    return {
        "only_as_it_is": {short(n): c for n, c in plain.items()
                          if n not in flagged},
        "only_under_the_flag": {short(n): c for n, c in flagged.items()
                                if n not in plain},
        "launches_differ": {short(n): [c, flagged[n]]
                            for n, c in plain.items()
                            if n in flagged and flagged[n] != c},
        "warnings": sorted({str(w.message)[:240] for w in caught})}


def probe(name, dev, costs: bool) -> None:
    run = PATHS[name](dev)
    run()  # warm-up: kernels built, allocator settled
    cs.log(f"determinism {name}: kernel diff, as it is against "
           f"use_deterministic_algorithms(True, warn_only=True): "
           f"{json.dumps(kernel_diff(run))}")
    traces = []
    for _ in range(2):
        with OpHashes() as mode:
            run()
        torch.cuda.synchronize()
        traces.append(mode.settled())
    cs.log(f"determinism {name}: op finder {json.dumps(sources(*traces))}")
    a, b = run(), run()
    cs.log(f"determinism {name}: two plain runs "
           f"{json.dumps(cs.repeat_distance(a, b))}")
    if costs:
        cs.log(f"determinism {name}: the replaced ops' backward, device ms "
               f"{json.dumps(op_costs(run, dev))}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help=f"of {list(PATHS)}")
    ap.add_argument("--native", action="append", default=[],
                    choices=list(REPLACED))
    args = ap.parse_args(argv)
    if unknown := set(args.paths) - set(PATHS):
        ap.error(f"unknown paths {sorted(unknown)}")
    dev = cs.phase_device()
    cs.phase_build()
    cs.log(f"determinism: PyTorch's own backward for {args.native or 'no op'}")
    with native(args.native):
        for name in args.paths or list(PATHS):
            probe(name, dev, costs=not args.native)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
