"""% of the photometric loss's roofline (kernel C's op, forward and
backward) in a training cell."""
from harness.readings import op_roofline


def read(run):
    return op_roofline(run, "train", "reproj")
