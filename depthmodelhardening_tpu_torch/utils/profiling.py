"""Profiling hooks (the reference has none: SURVEY §5, only wall-clock
prints).

Counterpart of `depthmodelhardening_tpu/utils/profiling.py`:

  * trace(log_dir) - context manager around `torch.profiler.profile`
    (CPU, and the card's kernels and copies where CUDA is available),
    writing a Chrome trace to <log_dir>/trace.json;
  * StepTimer - host-clock per-step timing that waits for the card: a
    CUDA tensor or device passed to `start`/`stop` synchronises that
    device first, since PyTorch returns before the card has finished.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile everything inside the context into <log_dir>/trace.json;
    yields the `torch.profiler.profile` (its `key_averages()` sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(on) -> None:
    """Wait for the card `on` names: a CUDA tensor, or a CUDA device."""
    if on is None:
        return
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """Times steps on the host clock: stop(result) first waits for the
    card that `result` (a CUDA tensor or device) lives on. Pass the
    PREVIOUS step's output to start(sync_on=...) to exclude still-queued
    device work from the measurement."""

    def __init__(self):
        self.durations = []
        self._t = None

    def start(self, sync_on=None) -> None:
        _sync(sync_on)
        self._t = time.perf_counter()

    def stop(self, result=None) -> float:
        _sync(result)
        dt = time.perf_counter() - self._t
        self.durations.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)

    def imgs_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.durations else 0.0
