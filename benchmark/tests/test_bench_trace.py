"""The trace reader's attribution, idle gaps and launch counts on a
hand-made trace (kineto's events as the reader keeps them)."""

import pytest

from harness import trace as tracing


def _trace():
    # host ranges (us): a step holding an attack holding two op ranges,
    # the second op's launch on another thread (the backward) while the
    # attack is open; then an update with nothing inside
    ranges = [("step", 0.0, 100.0), ("layer:attack", 5.0, 60.0),
              ("op:conv3x3.fwd", 10.0, 12.0),
              ("op:conv3x3.dgrad", 30.0, 31.0),
              ("layer:update", 70.0, 95.0)]
    # device activities: name, start, duration, correlation id
    device = [("conv3x3_bf16_mma", 20.0, 5.0, 1),  # launched at 11
              ("elementwise", 26.0, 2.0, 2),  # launched at 20 (attack)
              ("conv3x3_bf16_mma", 40.0, 4.0, 3),  # launched at 30.5
              ("gemm", 80.0, 10.0, 4),  # launched at 75 (update)
              ("memcpy", 96.0, 1.0, 5),  # launched at 99 (step)
              ("stray", 98.0, 1.0, 6)]  # no launch in the trace
    launches = {1: 11.0, 2: 20.0, 3: 30.5, 4: 75.0, 5: 99.0}
    tr = tracing.Trace(1e-4, device, launches, ranges)
    tracing.attribute(tr)
    return tr


def test_innermost_range_of_each_launch():
    tr = _trace()
    assert tr.by_range == {"op:conv3x3.fwd": 5.0, "layer:attack": 2.0,
                           "op:conv3x3.dgrad": 4.0, "layer:update": 10.0,
                           "step": 1.0}
    assert tr.unattributed == 1
    assert tr.range_s("op:conv3x3.") == pytest.approx(9e-6)
    # inclusive: the attack's own and its nested ranges' activities
    assert tr.inside_s("layer:attack") == pytest.approx(11e-6)
    assert tracing.kernel_launches(tr, "op:", ("conv3x3_bf16_",)) == 2


def test_busy_and_idle_gaps():
    tr = _trace()
    # union: [20, 25], [26, 28], [40, 44], [80, 90], [96, 97], [98, 99]
    assert tr.busy_s == pytest.approx(23e-6)
    b = tracing.breakdown(tr)
    assert b["device_ops"][0] == ["gemm", pytest.approx(10e-6)]
    gaps = dict(b["idle_gaps"])
    # gaps [25, 26] and [28, 40] in the attack, [44, 80] (mid 62) in the
    # step only, [90, 96] in the update, [97, 98] (mid 97.5) in the step
    assert gaps == {"layer:attack": pytest.approx(13e-6),
                    "step": pytest.approx(37e-6),
                    "layer:update": pytest.approx(6e-6)}


def test_outside_every_range():
    assert tracing.innermost([("step", 0.0, 1.0)], [2.0]) == [None]
