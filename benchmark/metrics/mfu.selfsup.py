"""% of the chip's peak: the least time of the window's convolutions and
dense layers (forward, input and weight gradients as run, each pass at
its dtype's peak) over the window."""
from harness.readings import mfu


def read(run):
    return mfu(run, "train")
