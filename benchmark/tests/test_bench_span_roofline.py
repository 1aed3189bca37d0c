"""A kernel that the harness does not wrap reports its roofline from two
new files alone: its count (`counts/<op>.py`) and its reader
(`metrics/<op>_roofline.<kind>.py`). The calls' shapes come from the
program's own "op:<op>.<pass>" spans, whose arguments a traced run keeps
(`Trace.op_args`); the ten wrapped ops keep reading their wrappers'
records. On hand-made traces, the metric read from a copy of the
benchmark that holds the two new files."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from harness import readings, spec as specs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

COUNT = '''"""A probe op: reads x once and writes its like once."""
from .peaks import PEAK_F32_S, nbytes


def work(op, args):
    return 2 * nbytes(args["x"]), 0.0, PEAK_F32_S
'''
READER = '''"""% of the probe op's roofline in a training cell."""
from harness.readings import op_roofline


def read(run):
    return op_roofline(run, "train", "probe")
'''
# a hand-made traced window: the program's probe span (its arguments as
# the span gives them) and a wrapped op's range, whose wrapper recorded
# its call; each launches one kernel
SCRIPT = textwrap.dedent('''
    import json, sys
    from types import SimpleNamespace
    sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[1]]
    from harness import spans, spec as specs, trace as tracing
    from counts import reproj
    from counts.peaks import least_seconds

    x = (32, 64, 80, 256)
    probe_s = least_seconds(2 * 4 * 32 * 64 * 80 * 256, 0.0, 1.0)
    reproj_args = (((4, 3, 64, 192), "float32"),
                   ((4, 3, 64, 192), "float32"))
    reproj_s = least_seconds(*reproj.work("fwd", reproj_args))
    ranges = [("op:probe.fwd", 0.0, 10.0), ("op:reproj.fwd", 20.0, 30.0)]
    device = [("probe_kernel", 40.0, 2 * probe_s * 1e6, 1),
              ("reproj_kernel", 400.0, 4 * reproj_s * 1e6, 2)]
    tr = tracing.Trace(1e-3, device, {1: 5.0, 2: 25.0}, ranges, op_args=[
        ("op:probe.fwd", {"x": "(32, 64, 80, 256) float32", "k": 3}),
        # a span of a wrapped op: its wrapper's record is read instead
        ("op:reproj.fwd", {"x": "(64, 3, 320, 1024) float32",
                           "y": "(64, 3, 320, 1024) float32"})])
    tracing.attribute(tr)
    rec = spans.Recorder()
    rec.ops["op:reproj.fwd"].append(reproj_args)
    run = SimpleNamespace(kind="train", window=SimpleNamespace(
        trace=tr, recorder=rec, steps=1))
    here = sys.argv[1] + "/benchmark"
    print(json.dumps({m: specs.reader(here, m)(run) for m in
                      ("probe_roofline.train", "reproj_roofline.train")}))
''')


def test_span_fed_roofline_from_new_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (bench / "counts" / "probe.py").write_text(COUNT)
    (bench / "metrics" / "probe_roofline.train.py").write_text(READER)
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the probe's device time is twice its least time; the wrapped op's
    # four times, as its wrapper's call counts it (its span's shapes,
    # with 427 times the work, would read far above 100%)
    assert got["probe_roofline.train"] == pytest.approx(50.0)
    assert got["reproj_roofline.train"] == pytest.approx(25.0)


def test_which_rooflines_read_spans():
    assert readings.span_fed("probe_roofline.train")
    assert readings.span_fed("sweep_roofline")
    for name in ("conv3x3_roofline.train", "warp_roofline.eval",
                 "reproj_roofline.selfsup", "pool_roofline.train",
                 "mfu.train", "idle_share.train"):
        assert not readings.span_fed(name), name
    assert readings.WRAPPED == {"warp", "reproj", "conv3x3", "pool"}


def test_the_four_cells_trace_without_shapes():
    """No metric of the benchmark's cells reads a span's arguments, so
    their traced runs record no shapes, as before."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [c["name"] for c in json.load(f)["workloads"]]
    for cell in cells:
        spec = specs.load(ROOT, cell)
        assert not any(readings.span_fed(m["name"])
                       for m in spec["per_layer"]), cell


def test_span_arguments_as_counts_take_them():
    assert readings._described("(32, 64, 80, 256) float32") == \
        ((32, 64, 80, 256), "float32")
    assert readings._described("(5,) bfloat16") == ((5,), "bfloat16")
    assert readings._described("() float32") == ((), "float32")
    assert readings._described(3) == 3
    assert readings._described("reflect") == "reflect"
