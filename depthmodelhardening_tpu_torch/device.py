"""The device contract of the port's kernels.

Counterpart of `depthmodelhardening_tpu/ops/dispatch.py:30-51`, without
its on/off switch: a kernel runs on a Hopper card or not at all. CPU
tensors take each op's plain PyTorch version (decided per tensor in the
op's `autograd.Function`); a CUDA tensor on anything older than
compute capability 9.0 is an error, never a silent fallback.
"""

from __future__ import annotations

import torch

MIN_CAPABILITY = (9, 0)  # the kernels are built for sm_90a only


def require_cuda(device=None) -> torch.device:
    """Return `device` (default: the current CUDA device) as a
    `torch.device`, or raise `RuntimeError` unless it is a CUDA device
    of compute capability >= 9.0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an "
                           "NVIDIA Hopper GPU (sm_90a)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"expected a CUDA device, got {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    cap = torch.cuda.get_device_capability(index)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"cuda:{index} has compute capability {cap}; the kernels are "
            f"built for sm_90a and need >= {MIN_CAPABILITY}")
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """A trainer's device: the given one, or else the current CUDA card.
    A CUDA device goes through `require_cuda`, which raises without a
    card. The CPU is taken only when asked for, as the tests do."""
    dev = torch.device("cuda" if device is None else device)
    return require_cuda(dev) if dev.type == "cuda" else dev


def use_f32_numerics() -> None:
    """Run convolutions and matmuls in plain float32, as the reference
    does. Process-wide: call it once before running a model on the card.

    PyTorch lets cuDNN and cuBLAS round through TF32 by default, which
    breaks float32 parity with the reference, so TF32 goes off. With
    TF32 off, cuDNN's algorithm choice (heuristic or benchmarked) is
    10-250x slower than PyTorch's own im2col + SGEMM convolution at
    several Monodepth2 shapes (on an H100 80GB HBM3 at 700 W, batch 12
    at 1024x320: 267 ms for the decoder's 256->128 conv at 1/8 scale;
    the whole forward takes 458 ms with cuDNN and 44 ms without), so
    cuDNN goes off as well, for the process: every float32 convolution
    runs on im2col. bf16 convolutions choose per call
    (`ops/conv_route.py`): a routed pass turns cuDNN on, on its
    deterministic algorithms, for itself alone and then off again.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
