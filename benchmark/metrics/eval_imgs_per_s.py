"""Attacked-and-evaluated images a second: every image of every batch of
the window over all of the window's time (host clock, synchronised)."""
from harness.readings import rate


def read(run):
    return rate(run, "eval")
