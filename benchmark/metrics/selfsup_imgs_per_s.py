"""Self-supervised training images a second: every image of every step
of the window over all of the window's time (host clock, synchronised)."""
from harness.readings import rate


def read(run):
    return rate(run, "train")
