"""Layouts of kernel C's forward and warp A1 on the card, side by side.

    python3 kernel_variants.py

Each variant is a copy of `csrc/reproj_loss.cu` or
`csrc/vertical_resample.cu` with layout constants replaced (rows and
columns a thread, threads a block, blocks an SM), built with the
library's nvcc flags into `build/variants/`, one nvcc per variant, all
started together. Each variant is held with `torch.equal` against the
plain version at the main path's shape and at ragged ones, then timed at
the main path's shapes on the card alone (`chip_smoke.cuda_ms`), the
variants in turns, in three rounds (in order, reversed, in order).
Prints each variant's registers, stack and local memory, and for warp
A1 the time of a fill of its output alone (`out.zero_()`), the least a
launch that writes that output takes. The first variant of each kernel
is the source as committed. Needs one CUDA card; no jax.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from depthmodelhardening_tpu_torch.ops import _build, reproj, warp

OUT_DIR = Path(cs.REPO) / "build" / "variants"
P, I = ctypes.c_void_p, ctypes.c_int
# (label, source, entry point, argtypes, {constant: value})
VARIANTS = (
    [(f"C rows {r}, blocks/SM {mb}", "reproj_loss.cu", "reproj_loss_fwd",
      [P, P, P, I, I, I, I, P], dict(kFwdRows=r, kFwdMinBlocks=mb))
     for r, mb in ((8, 6), (4, 1), (4, 3), (8, 2), (8, 5), (8, 7))]
    + [(f"A1 rows {r}, threads {t}x{s}", "vertical_resample.cu",
        "vertical_resample_fwd", [P, P, P, P, I, I, I, I, I, P],
        dict(kFwdRows=r, kFwdThreads=t, kFwdStrips=s))
       for r, t, s in ((1, 32, 4), (2, 32, 4), (4, 32, 4), (8, 32, 4),
                       (1, 32, 8), (1, 64, 4))])
REPROJ_SHAPES = ((32, 3, 320, 1024), (3, 3, 37, 53), (2, 3, 33, 33),
                 (1, 3, 65, 132), (1, 3, 1, 37), (1, 3, 37, 1))
WARP_CASES = (((12, 4, 200, 256, 256), "attack"),
              ((32, 4, 200, 256, 256), "attack"),
              ((4, 4, 200, 250, 200), "random"),
              ((3, 5, 37, 45, 53), "ragged"))
ROUNDS = 3


def variant_source(source: str, consts: dict) -> str:
    text = (_build.CSRC / source).read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"\b{name} = \d+", f"{name} = {value}", text,
                          count=1)
        if n != 1:
            raise ValueError(f"{name} not found in {source}")
    return text


def build(variant):
    label, source, entry, argtypes, consts = variant
    stem = re.sub(r"\W+", "_", label).strip("_")
    src = OUT_DIR / f"{stem}.cu"
    src.write_text(variant_source(source, consts))
    lib = OUT_DIR / f"lib{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    kernel = "fwd_kernel" if entry == "reproj_loss_fwd" else "vert_fwd"
    usage = [u for k, u in cs.resource_usage(lib) if kernel in k]
    return label, fn, usage


def launch(fn, *args):
    if fn(*args) != 0:
        raise RuntimeError("CUDA error at launch")


def rounds(fns: dict, call) -> dict:
    """name -> [ms of each round], the variants timed in turns."""
    names = list(fns)
    times = {n: [] for n in names}
    for k in range(ROUNDS):
        for n in (names if k % 2 == 0 else names[::-1]):
            times[n].append(cs.cuda_ms(lambda: call(fns[n]), reps=50))
    return times


def sweep_reproj(gen, dev, fns) -> None:
    for shape in REPROJ_SHAPES:
        x, y = cs._reproj_inputs(gen, dev, shape)
        B, C, H, W = shape
        want = reproj.reproj_loss_plain(x, y)
        out = torch.empty_like(want)
        for label, fn in fns.items():
            out.fill_(float("nan"))
            launch(fn, x.data_ptr(), y.data_ptr(), out.data_ptr(), B, C, H,
                   W, _build.stream_handle(x))
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label} disagrees at {shape}")
        if shape != REPROJ_SHAPES[0]:
            continue
        stream = _build.stream_handle(x)
        times = rounds(fns, lambda fn: launch(
            fn, x.data_ptr(), y.data_ptr(), out.data_ptr(), B, C, H, W,
            stream))
        for label, ts in times.items():
            cs.log(f"  {label} at {shape}: "
                   + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    cs.log(f"  every C variant bit-exact at {len(REPROJ_SHAPES)} shapes")


def sweep_warp(gen, dev, fns) -> None:
    for shape, maps in WARP_CASES:
        Bn, C, OH, TH, TW = shape
        inter, A, B = cs._warp_inputs(gen, dev, Bn, C, OH, TH, TW, maps)
        want = warp.vertical_resample_plain(inter, A, B, TH)
        out = torch.empty_like(want)
        stream = _build.stream_handle(inter)

        def call(fn):
            launch(fn, inter.data_ptr(), A.data_ptr(), B.data_ptr(),
                   out.data_ptr(), Bn, C, OH, TH, TW, stream)

        for label, fn in fns.items():
            out.fill_(float("nan"))
            call(fn)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label} disagrees at {shape}")
        if maps != "attack":
            continue
        cs.log(f"  out.zero_() at {shape} (a fill of the output alone): "
               f"{cs.cuda_ms(lambda: out.zero_(), reps=50):.4f} ms")
        for label, ts in rounds(fns, call).items():
            cs.log(f"  {label} at {shape}, the attack's maps: "
                   + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    cs.log(f"  every A1 variant equal to the plain version at "
           f"{len(WARP_CASES)} shapes")


def main() -> int:
    dev = cs.phase_device()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    for label, _, usage in built:
        cs.log(f"  {label}: " + "; ".join(
            f"{u.get('REG')} registers, {u.get('STACK')} B stack, "
            f"{u.get('LOCAL')} B local" for u in usage))
    gen = torch.Generator().manual_seed(cs.SEED)
    cs.log("kernel C's forward, (B, C, H, W), card alone:")
    sweep_reproj(gen, dev, {name: fn for name, fn, _ in built
                            if name.startswith("C")})
    cs.log("warp A1, (B, C, OH, TH, TW), card alone:")
    sweep_warp(gen, dev, {name: fn for name, fn, _ in built
                          if name.startswith("A1")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
