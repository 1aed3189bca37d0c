"""Device ms a step launched inside the trainer's texture refresh (the
L0 attack)."""
from harness.readings import range_ms_per_step


def read(run):
    return range_ms_per_step(run, "train", "layer:attack")
