"""Stand-in for the program's kernel module: the reference has no kernels.

Every op of this copy takes its plain PyTorch version on every device:
`on_cuda` answers False, so no op launches a hand-written kernel, and
the CUDA entry points (never called) have nothing to launch.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

POINTER = ctypes.c_void_p
INT = ctypes.c_int


def register(name: str, source: str, argtypes: Sequence, replaces: str):
    """No kernel to register: the reference launches none."""
    return None


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """False on every device: run the plain version."""
    return False


def check_dtype(op: str, t: torch.Tensor,
                dtypes: Sequence[torch.dtype]) -> None:
    """Raise unless `t` has one of `dtypes` (the program's own rule)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{op}: no kernel for {t.dtype} (it has "
                        f"{' and '.join(str(d) for d in dtypes)})")


def check_cuda_tensor(*args, **kwargs) -> None:
    raise RuntimeError("the reference launches no kernel")


def stream_handle(t: torch.Tensor) -> int:
    raise RuntimeError("the reference launches no kernel")
