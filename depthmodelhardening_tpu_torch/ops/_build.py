"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface (`extern "C"`, raw
pointers, the stream as `cudaStream_t`, returning `cudaGetLastError()`)
and is compiled on first use by `nvcc` for `sm_90a` into
`build/torch_kernels/lib<name>-<hash>.so` at the repository root, then
loaded with `ctypes`. The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Nothing
here runs at import time: the CPU tests import every module of the port
on machines with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from ..device import require_cuda

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -fmad=false: no multiply-add contraction, so each kernel rounds the
# same products and sums as its plain PyTorch version (eager PyTorch
# never contracts across ops).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

POINTER = ctypes.c_void_p  # pointers and the stream: 64 bits
INT = ctypes.c_int
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the port's kernels are built from source")


def library_path(source: str) -> Path:
    """Where the shared library built from `csrc/<source>` lives."""
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _compile(source: str) -> Path:
    """Build `csrc/<source>` unless its library exists; its path."""
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library(source: str) -> ctypes.CDLL:
    """Build `csrc/<source>` if its library is missing, then load it."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(_compile(source)))
        return lib


class CudaKernel:
    """One C entry point of a `csrc/` source, with its launch count.

    `launch(*args)` calls the entry point, raises if it returned a CUDA
    error, and only then adds one to `launches`. Pointers and the stream
    are passed as `c_void_p` (64-bit), sizes as `c_int`.
    """

    def __init__(self, name: str, source: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def source_path(self) -> str:
        return f"depthmodelhardening_tpu_torch/csrc/{self.source}"

    def _bind(self):
        fn = getattr(load_library(self.source), self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        fn = self._fn or self._bind()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


KERNELS: List[CudaKernel] = []


def register(name: str, source: str, argtypes: Sequence,
             replaces: str) -> CudaKernel:
    k = CudaKernel(name, source, argtypes, replaces)
    KERNELS.append(k)
    return k


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def build_all() -> float:
    """Build every registered kernel's library, one nvcc per source, all
    started together, then load and bind them; seconds taken."""
    t0 = time.perf_counter()
    sources = sorted({k.source for k in KERNELS})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(_compile, sources))
    for k in KERNELS:
        k._fn or k._bind()
    return time.perf_counter() - t0


def stream_handle(t: torch.Tensor) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, ndim: int,
                      device: torch.device = None,
                      dtypes: Sequence[torch.dtype] = (torch.float32,)
                      ) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of one of `dtypes`
    (the element types the entry point has an instance for; float32
    alone by default) and of rank `ndim` (on `device`, when given) on a
    Hopper-class card. The dtype is checked first: no tensor is ever
    cast to fit a kernel."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{t.dtype}")
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: kernel input must be a CUDA tensor, "
                           f"got one on {t.device}")
    require_cuda(t.device)
    if device is not None and t.device != device:
        raise RuntimeError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_dtype(op: str, t: torch.Tensor,
                dtypes: Sequence[torch.dtype]) -> None:
    """Raise unless `t` has one of `dtypes`: an op with kernel instances
    for those types refuses any other on every device, so the CPU's
    plain version accepts exactly what the card's kernels do."""
    if t.dtype not in dtypes:
        raise TypeError(f"{op}: no kernel for {t.dtype} (it has "
                        f"{' and '.join(str(d) for d in dtypes)})")


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{op}: no kernel for {t.device}")
