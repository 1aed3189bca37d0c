"""% of the decoder's narrow 3x3 convolutions' roofline (kernel D's op,
forward and input gradient) in an evaluation cell."""
from harness.readings import op_roofline


def read(run):
    return op_roofline(run, "eval", "conv3x3")
