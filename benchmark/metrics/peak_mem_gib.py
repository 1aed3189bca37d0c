"""The card's peak allocated memory over the window, in GiB
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`)."""
from harness.readings import GIB, untraced


def read(run):
    if untraced(run) is None or not run.peak_bytes:
        return None
    return run.peak_bytes / GIB
