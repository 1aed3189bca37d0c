"""The program's host syncs a step inside its texture refresh: its
`layer:sync.read` and `layer:sync.copy` spans (blocking reads of card
values, pageable host-to-card copies) within `layer:train.attack`."""
from harness.program_spans import syncs_per_step


def read(run):
    return syncs_per_step(run, "train", "layer:train.attack")
