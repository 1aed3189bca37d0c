"""% of the decoder's narrow 3x3 convolutions' roofline (kernel D's op,
forward and input gradient) in a training cell."""
from harness.readings import op_roofline


def read(run):
    return op_roofline(run, "train", "conv3x3")
