"""The port's spans and FLOP counter (`utils/profiling.py`) on the CPU, at
small sizes: a bf16 L0 hardening step (the CLI's default trainer, 64x192
model, 96x320 frames, a 36x24 car, batch 2, attack batch 2, steps 2) and
an L-inf PGD evaluation batch of two scenes, two steps.

* The names: each starts with "layer:" or "op:" (the prefixes by which a
  profile reader keeps host ranges and drops their device shadows); no
  "layer:" name is one of the benchmark harness's own layer ranges
  (nested ranges of one name would split its inclusive sums); the "op:"
  names are the harness's op ranges, one each per hand-written entry
  point, which carries its span.
* With no profiler active, a hardening step and an evaluation batch open
  no range (`record_function` and the port's range both patched to
  count) and count no FLOPs.
* Under torch.profiler (CPU activity) the spans nest as the layers do,
  the L0 loop's `layer:attack.iter` spans number `last_iterations`, the
  PGD loop's its steps, and the `layer:sync.*` spans inside the texture
  refresh and the evaluation's attack equal the sites' count at the
  iterations run.
* The FLOP record against an independent sum of 2 * out.numel() *
  w[0].numel() over every F.conv2d and 2 * out.numel() * in over every
  F.linear of a forward, and its passes against what the gradients ask.
"""

import collections
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.evaluation.attack_eval import (
    AttackEvalConfig, build_attack, evaluate_attacks,
)
from depthmodelhardening_tpu_torch.models.simsiam import SimSiam
from depthmodelhardening_tpu_torch.models.wrappers import (
    EvalView, make_monodepth2, predictor_from,
)
from depthmodelhardening_tpu_torch.ops import conv, pool, reproj, warp
from depthmodelhardening_tpu_torch.training.config import (
    AdvSynthConfig, HardeningConfig, SelfSupConfig,
)
from depthmodelhardening_tpu_torch.training.hardening import HardeningTrainer
from depthmodelhardening_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "benchmark", "harness")
H, W = 64, 192
ORI_H, ORI_W = 96, 320
STEPS, PGD_STEPS = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _harness_names(pattern: str, *files: str):
    """The quoted names matching `pattern` in the harness's sources."""
    out = set()
    for f in files:
        with open(os.path.join(HARNESS, f)) as fh:
            out |= set(re.findall(pattern, fh.read()))
    return out


@pytest.fixture(scope="module")
def hardening():
    cfg = HardeningConfig(
        selfsup=SelfSupConfig(height=H, width=W),
        adv=AdvSynthConfig(ori_h=ORI_H, ori_w=ORI_W, norm_type="l_0",
                           steps=STEPS, attack_batch_size=2),
        batch_size=2, compute_dtype="bfloat16")
    obj, mask = make_car_object(36, 24)
    tr = HardeningTrainer(cfg, torch.Generator().manual_seed(0), obj, mask,
                          predictor_from(make_monodepth2()), device="cpu")
    state = tr.make_state()
    frames = {f: torch.from_numpy(make_scene(2, ORI_H, ORI_W, seed=i))
              for i, f in enumerate("0s")}
    scene = torch.from_numpy(make_scene(1, ORI_H, ORI_W, seed=5))
    sides, flips = torch.tensor([True, False]), torch.tensor([False, True])

    def step():
        nonlocal state
        state, _ = tr.train_step(state, frames, sides, flips, scene)
    return tr, step


@pytest.fixture(scope="module")
def evaluation():
    cfg = AttackEvalConfig(norm_type="l_inf", step=PGD_STEPS, batch_size=2,
                           eval_count=1, scene_h=H, scene_w=W, ori_h=ORI_H,
                           ori_w=ORI_W)
    predictor = predictor_from(make_monodepth2())
    obj, mask = make_car_object(36, 24)
    attack = build_attack(cfg, predictor, obj, mask)
    scenes = [make_scene(2, ORI_H, ORI_W, seed=9)]

    def batch():
        return evaluate_attacks(predictor, attack, scenes, cfg,
                                generator=torch.Generator().manual_seed(3))
    return batch


def _spans(fn):
    """fn() under the CPU profiler: the port's spans as (name, start,
    end, thread, args), by start."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
            e.kwinputs())
           for e in p.profiler.kineto_results.events()
           if e.name() in profiling.SPAN_NAMES]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The innermost span on span i's thread that holds it, or None."""
    name, s, e, tid, _ = spans[i]
    best = None
    for j, (_, s2, e2, t2, _) in enumerate(spans):
        if j != i and t2 == tid and s2 <= s and e <= e2 and \
                (best is None or s2 >= spans[best][1]):
            best = j
    return None if best is None else spans[best][0]


def _inside(spans, outer: str):
    """The spans that lie inside a span named `outer` (at any depth)."""
    holders = [(s, e) for n, s, e, _, _ in spans if n == outer]
    return [sp for sp in spans
            if any(s <= sp[1] and sp[2] <= e for s, e in holders)
            and sp[0] != outer]


# -- the names -----------------------------------------------------------------
@pytest.mark.parametrize("name", profiling.SPAN_NAMES)
def test_span_names_carry_the_readers_prefixes(name):
    assert name.startswith(("layer:", "op:"))


def test_no_layer_span_is_a_harness_range():
    harness = _harness_names(r'"(layer:[\w.]+)"', "train.py", "evaluate.py")
    assert {"layer:attack", "layer:synthesis", "layer:update",
            "layer:metrics"} <= harness
    assert not harness & set(profiling.SPAN_NAMES)


def test_op_spans_are_the_harness_op_ranges():
    harness = _harness_names(r'"(op:[\w.]+)":', "spans.py")
    assert set(profiling.OP_NAMES) == harness
    entry = {"op:warp.fwd": warp.vertical_resample_fwd_cuda,
             "op:warp.bwd": warp.vertical_resample_bwd_cuda,
             "op:reproj.fwd": reproj.reproj_loss_fwd_cuda,
             "op:reproj.bwd": reproj.reproj_loss_bwd_cuda,
             "op:conv3x3.fwd": conv.conv3x3_valid_cuda,
             "op:conv3x3.dgrad": conv.conv3x3_dgrad_cuda,
             "op:conv3x3.fwd_reflect": conv.conv3x3_reflect_cuda,
             "op:conv3x3.dgrad_reflect": conv.conv3x3_dgrad_reflect_cuda,
             "op:pool.fwd": pool.maxpool3x3s2_fwd_cuda,
             "op:pool.bwd": pool.maxpool3x3s2_bwd_cuda}
    assert set(entry) == set(profiling.OP_NAMES)
    for name, fn in entry.items():
        closure = dict(zip(fn.__code__.co_freevars,
                           (c.cell_contents for c in fn.__closure__)))
        assert closure["name"] == name and fn.__wrapped__ is not fn


def test_op_span_describes_the_launch_arguments():
    @profiling.op_span("op:pool.fwd")
    def launch(x, g, flag: bool = False):
        return x + g

    x = torch.ones(2, 3)
    spans = _spans(lambda: launch(x, torch.zeros(2, 3, dtype=torch.float32),
                                  flag=True))
    assert [s[0] for s in spans] == ["op:pool.fwd"]
    assert spans[0][4] == {"x": "(2, 3) float32", "g": "(2, 3) float32",
                           "flag": True}


def test_record_function_carries_the_spans_without_the_fast_range(
        monkeypatch):
    monkeypatch.setattr(profiling, "_range_class", lambda: None)

    def nested():
        with profiling.span("layer:attack.iter", {"iter": 0}):
            with profiling.span("layer:attack.grad"):
                torch.ones(3) + 1
    spans = _spans(nested)
    assert [s[0] for s in spans] == ["layer:attack.iter", "layer:attack.grad"]
    assert _parent(spans, 1) == "layer:attack.iter"


# -- off ---------------------------------------------------------------------------
def test_no_range_and_no_flops_without_a_profiler(hardening, evaluation,
                                                  monkeypatch):
    tr, step = hardening
    opened = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or
                        record_function(*a, **k))
    real_open = profiling._open
    monkeypatch.setattr(profiling, "_open",
                        lambda *a: opened.append(a) or real_open(*a))
    profiling.reset_flops()
    step()
    evaluation()
    assert opened == [] and profiling.flop_record() == []
    assert tr.attack.last_iterations >= STEPS


# -- on ----------------------------------------------------------------------------
PARENTS = {
    "layer:train.attack": {"layer:train.step"},
    "layer:train.synthesis": {"layer:train.step"},
    "layer:train.update": {"layer:train.step"},
    "layer:train.losses": {"layer:train.update"},
    "layer:train.backward": {"layer:train.update"},
    "layer:train.optimizer": {"layer:train.update"},
    "layer:attack.iter": {"layer:train.attack", "layer:eval.attack"},
    "layer:attack.grad": {"layer:attack.iter"},
    "layer:attack.update": {"layer:attack.iter"},
    "layer:attack.finals": {"layer:eval.attack"},
    "layer:eot.geometry": {"layer:attack.grad", "layer:train.synthesis"},
    "layer:eval.attack": {None},
    "layer:eval.metrics": {None},
    "layer:train.step": {None},
}


def test_spans_nest_as_the_layers_do(hardening, evaluation):
    _, step = hardening
    spans = _spans(step) + _spans(evaluation)
    names = collections.Counter(s[0] for s in spans)
    assert set(PARENTS) <= set(names)
    for i, sp in enumerate(spans):
        if sp[0] in PARENTS:
            assert _parent(spans, i) in PARENTS[sp[0]], sp[0]
    steps = [s for s in spans if s[0] == "layer:train.step"]
    assert len(steps) == 1 and isinstance(steps[0][4]["step"], int)


def _sites(spans, outer: str):
    return collections.Counter(
        (s[0], s[4]["site"]) for s in _inside(spans, outer)
        if s[0].startswith("layer:sync."))


def test_l0_refresh_syncs_and_iterations(hardening):
    tr, step = hardening
    spans = _spans(step)
    it, brk = tr.attack.last_iterations, int(tr.attack.last_early_break)
    inside = _inside(spans, "layer:train.attack")
    assert sum(s[0] == "layer:attack.iter" for s in inside) == it
    assert [s[4]["iter"] for s in inside
            if s[0] == "layer:attack.iter"] == list(range(it))
    # the scene comes from the host here (it lives on the card in the
    # benchmark's cells, which then copy 2 + 3 it and read 1 + it + brk)
    assert _sites(spans, "layer:train.attack") == {
        ("layer:sync.copy", "train.scenes"): 1,
        ("layer:sync.copy", "l0.start"): 2,
        ("layer:sync.copy", "eot.geometry"): 3 * it,
        ("layer:sync.read", "l0.init"): 1,
        ("layer:sync.read", "l0.ratio"): it + brk,
    }
    # the synthesis: the sides read once, two warps' geometry, the z0s
    assert _sites(spans, "layer:train.synthesis") == {
        ("layer:sync.read", "synth.sides"): 1,
        ("layer:sync.copy", "eot.geometry"): 6,
        ("layer:sync.copy", "synth.draws"): 1,
    }


def test_pgd_eval_syncs_and_iterations(evaluation):
    spans = _spans(evaluation)
    inside = _inside(spans, "layer:eval.attack")
    assert [s[4]["iter"] for s in inside
            if s[0] == "layer:attack.iter"] == list(range(PGD_STEPS))
    # the random start, each step's geometry, the finals' two
    # homographies (the exact warp of the adversarial and benign texture)
    assert _sites(spans, "layer:eval.attack") == {
        ("layer:sync.copy", "pgd.start"): 1,
        ("layer:sync.copy", "eot.geometry"): 3 * PGD_STEPS,
        ("layer:sync.copy", "eot.homography"): 2,
    }
    assert _sites(spans, "layer:eval.metrics") == {
        ("layer:sync.read", "eval.metrics"): 1}


# -- the FLOP counter ------------------------------------------------------------
def _independent(monkeypatch):
    """Every F.conv2d's and F.linear's FLOPs of a pass, summed."""
    total = [0.0]
    conv2d, linear = F.conv2d, F.linear

    def conv2d_sum(x, w, *a, **k):
        out = conv2d(x, w, *a, **k)
        total[0] += 2.0 * out.numel() * w[0].numel()
        return out

    def linear_sum(x, w, *a, **k):
        out = linear(x, w, *a, **k)
        total[0] += 2.0 * out.numel() * w.shape[1]
        return out
    monkeypatch.setattr(F, "conv2d", conv2d_sum)
    monkeypatch.setattr(F, "linear", linear_sum)
    return total


@pytest.mark.parametrize("layers", [18, 50])
def test_flop_record_matches_an_independent_sum(layers, monkeypatch):
    model = make_monodepth2(layers)
    x = torch.from_numpy(make_scene(2, H, W, seed=1))
    total = _independent(monkeypatch)
    profiling.reset_flops()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model.features_and_disps(x)
    rec = profiling.flop_record()
    profiling.reset_flops()
    # a forward of plain PyTorch runs one F.conv2d a convolution
    assert sum(f for _, _, f, _ in rec) == pytest.approx(total[0], rel=1e-12)
    assert {p for *_, p in rec} == {1}
    assert {(k, d) for k, d, _, _ in rec} == {("conv", "float32"),
                                              ("conv3x3", "float32")}
    assert sum(k == "conv3x3" for k, *_ in rec) == 10 + 4  # and 4 heads


def test_flop_passes_follow_the_gradients(monkeypatch):
    model = make_monodepth2(18)
    x = torch.from_numpy(make_scene(2, H, W, seed=1))
    head = SimSiam(in_dim=512)
    feats = [torch.rand(4, 512, 2, 6)]
    total = _independent(monkeypatch)
    profiling.reset_flops()
    with profile(activities=[ProfilerActivity.CPU]):
        # the attack's view: detached weights, the image needs a gradient
        EvalView("cpu", model)(x.clone().requires_grad_(True))
        view = profiling.flop_record()
        profiling.reset_flops()
        # a train-mode step: the weights need gradients, the image not
        model(x)
        train = profiling.flop_record()
        profiling.reset_flops()
        head(feats, feats)
        dense = profiling.flop_record()
    profiling.reset_flops()
    assert {p for *_, p in view} == {2}
    assert [p for *_, p in train][0] == 2
    assert {p for *_, p in train[1:]} == {3}
    assert {k for k, *_ in dense} == {"linear"} and len(dense) == 10
    assert sum(f for _, _, f, _ in view + train + dense) == \
        pytest.approx(total[0], rel=1e-12)


# -- the operator's window -------------------------------------------------------
def test_trace_window_covers_steps_one_and_two(tmp_path):
    window = profiling.TraceWindow(str(tmp_path / "tr"))
    seen = []
    for item in profiling.stepped(range(5), window):
        with profiling.span("layer:train.step", {"step": item}):
            seen.append(item)
    window.close()
    assert seen == [0, 1, 2, 3, 4]
    import json

    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e["args"]["step"] for e in events
             if e.get("name") == "layer:train.step"]
    assert steps == [1, 2]
    assert sum(e.get("name") == "layer:data.wait" for e in events) == 2
    with open(tmp_path / "tr" / "counters.json") as f:
        assert set(json.load(f)) == {"flops_by_dtype", "layers", "launches"}


def test_flop_summary_sums_by_dtype_and_group():
    rec = [("conv", "bfloat16", 10.0, 3), ("conv", "bfloat16", 5.0, 3),
           ("linear", "float32", 2.0, 1)]
    s = profiling.flop_summary(rec)
    assert s["flops_by_dtype"] == {"bfloat16": 45.0, "float32": 2.0}
    assert s["layers"]["conv.bfloat16.3"] == {"calls": 2,
                                              "flops_one_pass": 15.0}
    assert np.isclose(sum(g["flops_one_pass"] for g in s["layers"].values()),
                      17.0)
