"""The L0 attack's Adam iterations a step (`attack.last_iterations`,
read after each step of the traced window): work the data sets."""
from harness.readings import traced


def read(run):
    w = traced(run, "train")
    if w is None or not run.iterations:
        return None
    return sum(run.iterations) / len(run.iterations)
