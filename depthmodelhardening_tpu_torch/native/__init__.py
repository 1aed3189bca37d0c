"""Image decoding for the KITTI loaders, on the host.

Counterpart of `depthmodelhardening_tpu/native/__init__.py`:

    load_image(path)            -> float32 (H, W, 3) in [0, 1] (u8 / 255)
    load_resized(path, h, w)    -> float32 (h, w, 3) in [0, 1], torch
                                   half-pixel bilinear
    image_dims(path)            -> (H, W), or None without the C route
    decoder()                   -> the route `load_image` takes
    require_pil(what)           -> PIL.Image, or ImportError naming it

Two routes give the same bytes:

* "c": `fastio.c` (libpng, libjpeg and the half-pixel resampler, a copy
  of the JAX package's), compiled with `cc` at first use into
  `build/native/` at the repository root (never into the package) and
  bound with ctypes, which releases the GIL, so the prefetch loader's
  threads decode in parallel;
* "pil": Pillow's decode, then `_resize_u8`, a numpy transcription of
  the C resampler's float32 arithmetic, operation for operation, so the
  route returns the C route's values bit for bit. (The JAX package's
  numpy resize computes its weights in float64 and blends the [0, 1]
  values instead: it lies up to 1.5e-5 from its C resampler.)

A file the C route cannot read falls to PIL, as in the JAX package; where
neither can be had, the ImportError carries the compiler's stderr. An
H100 machine this port runs on had cc and PIL but not the libpng and
libjpeg headers: there the route is "pil" (`decoder()` says so).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "fastio.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = ("-lpng", "-ljpeg")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error = ""
_lock = threading.Lock()


def library_path() -> Path:
    """Where the C route's library is built: the hash covers the source
    and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(
        CC_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastio-{digest}.so"


def _build(out: Path) -> bool:
    """Compile to a temporary file, then rename: concurrent builds
    cannot leave a torn library behind. Keeps the compiler's stderr."""
    global _build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["cc", *CC_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = f"{' '.join(cmd)}: {e}"
        return False
    if proc.returncode != 0:
        _build_error = f"{' '.join(cmd)}:\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.image_dims.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    lib.decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int]
    lib.resize_bilinear.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    lib.decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int]
    for fn in (lib.image_dims, lib.decode_rgb, lib.resize_bilinear,
               lib.decode_resize):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The C route's library, built on first use; None where it cannot
    be built or loaded (the reason is kept for the error message)."""
    global _lib, _tried, _build_error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        out = library_path()
        if out.exists() or _build(out):
            try:
                _lib = _bind(ctypes.CDLL(str(out)))
            except OSError as e:
                _build_error = f"loading {out}: {e}"
        _tried = True
        return _lib


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def require_pil(what: str):
    """`PIL.Image`, or ImportError naming PIL and `what` needs it."""
    Image = _pil()
    if Image is None:
        raise ImportError(f"{what} needs PIL (Pillow), which is not "
                          "installed here")
    return Image


def decoder() -> str:
    """The route `load_image` and `load_resized` take ("c" or "pil",
    with what it runs on), or "none" and why."""
    if _load() is not None:
        return f"c (libpng + libjpeg, {library_path().name})"
    if _pil() is not None:
        import PIL

        lines = _build_error.strip().splitlines() or ["?"]
        why = next((ln for ln in lines if "error" in ln), lines[-1])
        return (f"pil (Pillow {PIL.__version__}, numpy resize; the C route "
                f"did not build: {why})")
    return f"none (no PIL; the C route did not build: {_build_error})"


def image_dims(path: str) -> Optional[Tuple[int, int]]:
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.image_dims(path.encode(), ctypes.byref(h),
                      ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def _decode_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 through the first route that reads the file."""
    lib = _load()
    if lib is not None:
        dims = image_dims(path)
        if dims is not None:
            buf = np.empty(dims + (3,), np.uint8)
            if lib.decode_rgb(path.encode(),
                              buf.ctypes.data_as(ctypes.c_void_p),
                              *dims) == 0:
                return buf
    Image = _pil()
    if Image is None:
        raise ImportError(
            f"no route decodes {path}: the C route did not build or load "
            f"(it needs cc and the libpng and libjpeg headers) and PIL is "
            f"not installed. The C route said:\n{_build_error}")
    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("RGB"), np.uint8)


def _axis(n_in: int, n_out: int):
    """The C resampler's source index and weight along one axis, in its
    float32 operations: s = (i + 0.5f) * (n_in / n_out) - 0.5f, clamped
    to [0, n_in - 1], lo = (int)s, hi = min(lo + 1, n_in - 1)."""
    f32 = np.float32
    scale = f32(n_in) / f32(n_out)
    s = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    s = np.minimum(np.maximum(s, f32(0)), f32(n_in - 1))
    lo = s.astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, s - lo.astype(f32)


def _resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """`resize_bilinear` of fastio.c in numpy, operation for operation
    in float32: uint8 (H, W, 3) -> float32 (out_h, out_w, 3) in [0, 1],
    bit-equal to the C route."""
    f32 = np.float32
    h, w = img.shape[:2]
    y0, y1, fy = _axis(h, out_h)
    x0, x1, fx = _axis(w, out_w)
    wx = fx[None, :, None]
    p = img.astype(np.int32)

    def row(y):
        a, b = p[y][:, x0], p[y][:, x1]
        return a.astype(f32) + (b - a).astype(f32) * wx

    top, bot = row(y0), row(y1)
    out = (top + (bot - top) * fy[:, None, None]) * (f32(1) / f32(255))
    return out.astype(f32)


def load_image(path: str) -> np.ndarray:
    """float32 (H, W, 3) in [0, 1]: the decoded bytes / 255."""
    return _decode_u8(path).astype(np.float32) / 255.0


def load_resized(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Fused decode + half-pixel bilinear resize to (out_h, out_w)."""
    lib = _load()
    if lib is not None:
        out = np.empty((out_h, out_w, 3), np.float32)
        if lib.decode_resize(path.encode(),
                             out.ctypes.data_as(ctypes.c_void_p),
                             out_h, out_w) == 0:
            return out
    return _resize_u8(_decode_u8(path), out_h, out_w)
