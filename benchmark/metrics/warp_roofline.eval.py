"""% of the EoT warp's roofline (kernel A's op, forward and adjoint) in
an evaluation cell."""
from harness.readings import op_roofline


def read(run):
    return op_roofline(run, "eval", "warp")
