"""The command's contract where no card or no program is: a non-zero
exit and no result line."""

import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "md2r18.harden_l0_bf16", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _no_result(proc):
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())


def test_without_a_card():
    _no_result(_run(ROOT))


def test_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
