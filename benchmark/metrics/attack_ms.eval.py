"""Device ms a batch launched inside the evaluation's attack call (PGD
and its finals)."""
from harness.readings import range_ms_per_step


def read(run):
    return range_ms_per_step(run, "eval", "layer:attack")
