"""The program's host syncs a batch inside the evaluation's attack call:
its `layer:sync.read` and `layer:sync.copy` spans within
`layer:eval.attack`."""
from harness.program_spans import syncs_per_step


def read(run):
    return syncs_per_step(run, "eval", "layer:eval.attack")
