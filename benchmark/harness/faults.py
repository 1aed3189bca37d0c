"""Faults planted in the program, underneath the harness, to show that
the check catches them (`benchmark/readings.py` at the cells' sizes on
the card; `tests/test_bench_faults.py` at a small size here):

- "unchanged": a training step that returns its state unchanged (Adam
  never applied);
- "half": half of the batch left out, the mean taken over the rest (the
  training update, or the evaluation's metrics, on the first half of
  the rows);
- "altered": an answer altered where it is produced (the evaluation
  attack's texture moved by one PGD step);
- "start": the attack runs (its work and its counters as they are) and
  hands back its starting texture instead of the one it optimised;
- "warp_bwd": kernel A's backward (the EoT warp's adjoint, through which
  every attack gradient reaches the texture) returns zeros;
- "conv_dgrad": kernel D's input gradient returns zeros (the evaluation
  attack's gradient reaches the scene through the decoder's D convs);
- "reversed": the training update applied with its sign flipped (each
  parameter moved by the step's change, backwards).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

PORT = "depthmodelhardening_tpu_torch"
KINDS = {"train": ("unchanged", "half", "reversed"),
         "harden": ("start", "warp_bwd"),
         "eval": ("half", "altered", "start", "warp_bwd", "conv_dgrad")}


def kinds(traffic: dict) -> tuple:
    """The faults a cell with this traffic can have."""
    if traffic["entry"] == "eval":
        return KINDS["eval"]
    return KINDS["train"] + (KINDS["harden"]
                             if traffic.get("step") == "harden" else ())


def _first(x, n: int, h: int):
    if isinstance(x, dict):
        return {k: _first(v, n, h) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == n:
        return x[:h]
    return x


def _zeros(orig):
    def zeros(g, *args, **kwargs):
        return torch.zeros_like(orig(g, *args, **kwargs))
    return zeros


def _start(attack_class):
    """`_optimize` that runs, then returns the texture it started from."""
    def make(orig):
        def optimize(self, scenes_full, draws):
            orig(self, scenes_full, draws)
            return start_texture(self, draws)
        return optimize
    return _patched(attack_class, "_optimize", make)


def start_texture(attack, draws) -> torch.Tensor:
    """The texture an attack's `_optimize` starts from: the L0 attack's
    thresholded starting patterns on the object, PGD's random start."""
    obj = attack.obj_img
    if hasattr(attack, "_thresholded"):
        pp, pn = attack._thresholded(
            draws.pos.to(device=obj.device, dtype=torch.float32),
            draws.neg.to(device=obj.device, dtype=torch.float32))
        return torch.clamp(obj + pp + pn, 0.0, 1.0)
    if getattr(attack, "random_start", False):
        return torch.clamp(obj + draws.noise.to(device=obj.device,
                                                dtype=torch.float32),
                           0.0, 1.0)
    return obj


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def planted(kind: str, fault: str):
    """The context in which the program carries `fault`."""
    if fault == "start":
        stack = contextlib.ExitStack()
        for mod, cls in (("l0_object", "L0ObjectAttack"),
                         ("pgd_object", "PGDObjectAttack")):
            stack.enter_context(_start(getattr(importlib.import_module(
                f"{PORT}.attacks.{mod}"), cls)))
        return stack
    if fault in ("warp_bwd", "conv_dgrad"):
        mod, names = {
            "warp_bwd": ("warp", ("vertical_resample_bwd_cuda",
                                  "vertical_resample_adjoint_plain")),
            "conv_dgrad": ("conv", ("conv3x3_dgrad_cuda",
                                    "conv3x3_dgrad_plain",
                                    "conv3x3_dgrad_reflect_cuda",
                                    "conv3x3_dgrad_reflect_plain"))}[fault]
        module = importlib.import_module(f"{PORT}.ops.{mod}")
        stack = contextlib.ExitStack()
        for name in names:
            stack.enter_context(_patched(module, name, _zeros))
        return stack
    trainer = importlib.import_module(f"{PORT}.training.hardening") \
        .HardeningTrainer
    if kind == "train" and fault == "unchanged":
        def make(orig):
            def apply_grads(self, state):
                state.step += 1
            return apply_grads
        return _patched(trainer, "_apply_grads", make)
    if kind == "train" and fault == "half":
        def make(orig):
            def update(self, state, batch, noise):
                n = batch["color"]["0"].shape[0]
                return orig(self, state, _first(batch, n, n // 2),
                            None if noise is None else noise[:n // 2])
            return update
        return _patched(trainer, "_update", make)
    evaluation = importlib.import_module(f"{PORT}.evaluation.attack_eval")
    if kind == "eval" and fault == "half":
        def make(orig):
            def metrics(predictor, adv, ben, masks):
                h = adv.shape[0] // 2
                return orig(predictor, adv[:h], ben[:h], masks[:h])
            return metrics
        return _patched(evaluation, "_batch_metrics", make)
    if kind == "eval" and fault == "altered":
        pgd = importlib.import_module(f"{PORT}.attacks.pgd_object") \
            .PGDObjectAttack

        def make(orig):
            def optimize(self, scenes_full, draws):
                return torch.clamp(orig(self, scenes_full, draws)
                                   + self.alpha, 0.0, 1.0)
            return optimize
        return _patched(pgd, "_optimize", make)
    if kind == "train" and fault == "reversed":
        def make(orig):
            def apply_grads(self, state):
                params = [p for m in state.modules().values()
                          for p in m.parameters()]
                before = [p.detach().clone() for p in params]
                orig(self, state)
                with torch.no_grad():
                    for p, b in zip(params, before):
                        p.copy_(2 * b - p)
            return apply_grads
        return _patched(trainer, "_apply_grads", make)
    raise ValueError(f"no fault {fault!r} for a {kind} cell")
