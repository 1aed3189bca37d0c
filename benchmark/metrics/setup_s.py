"""Seconds from the process's start to the first timed step: imports,
the kernels' build or load, weights, inputs, the recorded warm-up
steps."""
from harness.readings import untraced


def read(run):
    return None if untraced(run) is None else run.setup_s
