"""The readers of the program's own spans (`harness/program_spans.py`,
`metrics/attack_idle_ms.*`, `metrics/attack_syncs.*`) on hand-made traces
(kineto's events as the reader keeps them), and the program's FLOP
record against the harness's `spans.counting()` on the small cells."""

import collections
import contextlib
import os
from types import SimpleNamespace

import pytest
import torch

from harness import program_spans, spans, spec as specs
from harness import trace as tracing

import small

METRICS = ("attack_idle_ms.train", "attack_idle_ms.eval",
           "attack_syncs.train", "attack_syncs.eval")


def _run(kind: str, ranges, device, steps: int = 2):
    tr = tracing.Trace(1e-3, device, {}, ranges)
    return SimpleNamespace(kind=kind,
                           window=SimpleNamespace(trace=tr, steps=steps))


def _train_trace():
    # two steps (us): each a harness "layer:attack" holding the program's
    # texture refresh, which holds a read and two copies; the update's
    # own copy outside the refresh
    ranges = []
    for t0 in (0.0, 1000.0):
        ranges += [("step", t0, t0 + 900.0),
                   ("layer:attack", t0 + 10.0, t0 + 600.0),
                   ("layer:train.attack", t0 + 12.0, t0 + 598.0),
                   ("layer:sync.read", t0 + 20.0, t0 + 60.0),
                   ("layer:attack.iter", t0 + 61.0, t0 + 500.0),
                   ("layer:eot.geometry", t0 + 62.0, t0 + 120.0),
                   ("layer:sync.copy", t0 + 70.0, t0 + 80.0),
                   ("layer:sync.copy", t0 + 90.0, t0 + 100.0),
                   ("layer:update", t0 + 650.0, t0 + 890.0),
                   ("layer:sync.copy", t0 + 700.0, t0 + 710.0)]
    # device busy [0, 30] [100, 560] [640, 880] in each step: idle gaps
    # [30, 100] (mid 65, the refresh), [560, 640] (mid 600: the harness
    # range, outside the refresh), [880, 1000] (the step), per step
    device = []
    for t0 in (0.0, 1000.0):
        device += [("k", t0 + 0.0, 30.0, 1), ("k", t0 + 100.0, 460.0, 2),
                   ("k", t0 + 640.0, 240.0, 3)]
    return ranges, device


def test_idle_and_syncs_inside_the_refresh():
    ranges, device = _train_trace()
    run = _run("train", ranges, device)
    # gaps whose middle lies in layer:train.attack: [30, 100] each step
    assert program_spans.idle_ms_per_step(
        run, "train", "layer:train.attack") == pytest.approx(0.070)
    assert program_spans.syncs_per_step(
        run, "train", "layer:train.attack") == 3.0
    # the harness's own range holds the second gap too
    assert program_spans.idle_ms_per_step(
        run, "train", "layer:attack") == pytest.approx(0.070 + 0.080)
    assert program_spans.idle_gaps(run.window.trace)[:3] == [
        (30.0, 100.0), (560.0, 640.0), (880.0, 1000.0)]


def test_metric_files_read_their_span_and_kind():
    ranges, device = _train_trace()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    read = {m: specs.reader(here, m) for m in METRICS}
    train = _run("train", ranges, device)
    assert read["attack_idle_ms.train"](train) == pytest.approx(0.070)
    assert read["attack_syncs.train"](train) == 3.0
    assert read["attack_idle_ms.eval"](train) is None
    assert read["attack_syncs.eval"](train) is None
    ev = [(("layer:eval.attack" if n == "layer:train.attack" else n), s, e)
          for n, s, e in ranges]
    evaluation = _run("eval", ev, device, steps=1)
    assert read["attack_idle_ms.eval"](evaluation) == pytest.approx(0.140)
    assert read["attack_syncs.eval"](evaluation) == 6.0


@pytest.mark.parametrize("metric", METRICS)
def test_none_without_the_programs_spans(metric):
    # a program that opens no span of its own (the harness's ranges only)
    ranges, device = _train_trace()
    harness_only = [r for r in ranges if not r[0].startswith(
        ("layer:train.", "layer:sync.", "layer:eot.", "layer:attack."))]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kind = metric.split(".")[-1]
    assert specs.reader(here, metric)(_run(kind, harness_only,
                                           device)) is None
    assert specs.reader(here, metric)(SimpleNamespace(
        kind=kind, window=SimpleNamespace(steps=1, seconds=1.0))) is None


def test_op_spans_are_the_harness_ranges():
    from depthmodelhardening_tpu_torch.utils import profiling

    assert set(profiling.OP_NAMES) == set(spans.OPS)


@contextlib.contextmanager
def _kernel_d_uncounted(rec):
    """On the card kernel D computes the input gradient of the decoder's
    3x3 convolutions, where no F.conv2d runs; on the CPU its plain
    stand-ins run F.conv2d in the backward. Those calls are kept out of
    the harness's record, as its own forward wrapper keeps the plain
    forward's."""
    from depthmodelhardening_tpu_torch.ops import conv

    names = ("conv3x3_dgrad_plain", "conv3x3_dgrad_reflect_plain")
    saved = {n: getattr(conv, n) for n in names}

    def quiet(fn):
        def call(*a, **k):
            was = getattr(rec._inside, "on", False)
            rec._inside.on = True
            try:
                return fn(*a, **k)
            finally:
                rec._inside.on = was
        return call
    for n in names:
        setattr(conv, n, quiet(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(conv, n, fn)


@pytest.mark.parametrize("cell", ["md2r18.harden_l0_bf16",
                                  "dhr50.harden_l0_bf16"])
def test_program_flop_record_equals_the_harness_count(cell):
    from torch.profiler import ProfilerActivity, profile

    from depthmodelhardening_tpu_torch.utils import profiling
    from harness import main as harness, port
    import reference

    s = small.spec(cell)
    threads = torch.get_num_threads()
    try:
        c = harness.CELLS[s["traffic"]["entry"]](
            s, 2 ** 33 + 5, torch.device("cpu"), port.load(), reference)
        c.setup()
        profiling.reset_flops()
        with spans.counting() as rec, _kernel_d_uncounted(rec), \
                profile(activities=[ProfilerActivity.CPU]):
            c.step(0)
        program = profiling.flop_record()
        profiling.reset_flops()
    finally:
        torch.set_num_threads(threads)
    assert program
    assert collections.Counter(program) == collections.Counter(rec.model)
