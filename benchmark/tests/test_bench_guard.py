"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or the JAX package's (names compared whole: the port's
`depthmodelhardening_tpu_torch` begins with the JAX package's name), and
nothing of the program in the reference."""

import ast
import json
import os
import subprocess
import sys

import pytest

from harness import main as harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PORT = "depthmodelhardening_tpu_torch"

LOAD_RUN = f"""
import glob, json, os, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from harness import evaluate, faults, main, port, readings, spans, spec
from harness import trace, traffic, train
port.load()
import reference
import counts.conv3x3, counts.models, counts.peaks, counts.pool
import counts.reproj, counts.warp
for path in glob.glob(os.path.join({BENCH!r}, "metrics", "*.py")):
    spec.reader({BENCH!r}, os.path.basename(path)[:-3])
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path[:0] = [{BENCH!r}]
import reference
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"}).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def _tops(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_run_loads_no_jax():
    tops = _tops(_loaded(LOAD_RUN))
    assert not tops & set(harness.BANNED), sorted(tops & set(harness.BANNED))
    assert PORT in tops  # the program under test is what it loads


def test_reference_loads_nothing_of_the_program():
    tops = _tops(_loaded(LOAD_REFERENCE))
    assert not tops & (set(harness.BANNED) | {PORT})


def test_whole_names_not_prefixes(monkeypatch):
    for name in ("jaxtyping", PORT, PORT + ".ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in harness.BANNED:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "depthmodelhardening_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.banned_modules() == ["depthmodelhardening_tpu.ops", "jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("part", ["harness", "counts", "metrics",
                                  "reference", "run.py", "readings.py"])
def test_sources_import_no_banned_module(part):
    path = os.path.join(BENCH, part)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    banned = set(harness.BANNED)
    if part == "reference":
        banned.add(PORT)
    for f in files:
        found = {m for m in _imports(f) if m.split(".")[0] in banned}
        assert not found, (f, found)
