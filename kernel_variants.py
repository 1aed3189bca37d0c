"""Layouts of kernels C's forward, warp A1, D-bf16 and B-bf16 on the card.

    python3 kernel_variants.py [C] [A1] [D] [B] [--before DIR ...]
    (default: all four)

Each variant is a copy of `csrc/reproj_loss.cu`,
`csrc/vertical_resample.cu`, `csrc/conv3x3.cu` or `csrc/maxpool3x3s2.cu`
with layout constants replaced (rows and columns a thread or a warp,
threads a block, blocks an SM, persistent blocks or one tile a block,
stores through shared memory or straight from the registers), built
with the library's nvcc flags into `build/variants/`, one nvcc per
variant, all started together. Each
variant is held against the plain version (C, A1 and B-bf16 with
`torch.equal`; D-bf16 within one bf16 ulp plus `CONV_RTOL` of the
largest magnitude, `chip_smoke.check_conv`'s rule, both entry points in
reflect mode) at the main path's shapes and at ragged ones, then timed
at the main path's shapes on the card alone (`chip_smoke.cuda_ms`), the
variants in turns, in three rounds (in order, reversed, in order).
Prints each variant's registers, stack and local memory, for warp A1
the time of a fill of its output alone (`out.zero_()`), the least a
launch that writes that output takes, and for D-bf16 the sum over the
crop pass's four convs of each round. The first variant of each kernel
is the source as committed. `--before DIR`: DIR is another checkout of
the repository (e.g. an older commit's `git archive`); its
`maxpool3x3s2.cu` joins the B-bf16 variants as it is, timed in the same
turns (repeat the option for more). Needs one CUDA card; no jax.
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
from depthmodelhardening_tpu_torch.ops import _build, conv, pool, reproj, warp

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
                       (1, 32, 8), (1, 64, 4))]
    + [(f"D-bf16 warps {nw}, rows/warp {r16}+{r64}, blocks/SM {mb}, "
        f"{'persistent' if per else 'one tile a block'}, "
        f"{'shared-memory' if sm else 'register'} stores", "conv3x3.cu",
        "conv3x3_fwd_bf16", None,
        dict(kBfWarps=nw, kBfRows16=r16, kBfRows64=r64, kBfBlocksPerSm=mb,
             kBfPersistent=per, kBfSmemStores=sm))
       for nw, r16, r64, mb, per, sm in (
           (8, 2, 1, 2, 1, 1), (8, 2, 1, 2, 1, 0), (8, 2, 1, 2, 0, 1),
           (8, 1, 1, 2, 1, 1), (4, 2, 1, 4, 1, 1), (4, 2, 2, 4, 1, 1),
           (4, 4, 2, 3, 1, 1), (16, 1, 1, 1, 1, 1))]
    + [(f"B-bf16 forward {c} columns x {r} rows a thread, {t} threads; "
        f"backward {br} window rows x {bc} columns a thread, {bt} threads, "
        f"blocks/SM >= {mb}", "maxpool3x3s2.cu", None, None,
        dict(kFwdCols=c, kFwdRows=r, kFwdThreads=t, kBwdRows=br, kBwdCols=bc,
             kBwdThreads=bt, kBwdMinBlocks=mb))
       for (c, r, t), (br, bc, bt, mb) in zip(
           ((8, 1, 64), (8, 2, 64), (4, 1, 64), (16, 1, 64), (8, 1, 128),
            (4, 2, 64), (8, 4, 64), (8, 1, 256)),
           ((1, 16, 64, 1), (2, 8, 64, 1), (1, 8, 128, 1), (1, 16, 128, 1),
            (2, 16, 128, 1), (1, 24, 128, 1), (1, 32, 128, 1),
            (1, 16, 64, 16)))])
REPROJ_SHAPES = ((32, 3, 320, 1024), (3, 3, 37, 53), (2, 3, 33, 33),
                 (1, 3, 65, 132), (1, 3, 1, 37), (1, 3, 37, 1))
WARP_CASES = (((12, 4, 200, 256, 256), "attack"),
              ((32, 4, 200, 256, 256), "attack"),
              ((4, 4, 200, 250, 200), "random"),
              ((3, 5, 37, 45, 53), "ragged"))
# D-bf16: the crop pass's convs (name, Cin, Co, H, W) at batch 32, and
# ragged shapes for both staging paths (W % 8 != 0 and == 0)
CONV_CROP = cs.CONV_CROP_SHAPES
CONV_CHECK = ((2, 16, 16, 37, 53), (2, 64, 32, 37, 48), (2, 32, 16, 19, 40),
              (2, 3, 13, 2, 3), (2, 16, 1, 3, 16), (2, 16, 16, 1, 8))
ROUNDS = 3


def variant_source(source: str, consts: dict) -> str:
    text = (_build.CSRC / source).read_text()
    for name, value in consts.items():
        # the first assignment outside a comment line: a note may name a
        # constant with its value
        text, n = re.subn(rf"^(?!\s*//)(.*?\b{name} = )\d+",
                          rf"\g<1>{value}", text, count=1, flags=re.M)
        if n != 1:
            raise ValueError(f"{name} not found in {source}")
    return text


def build(variant):
    """(label, entry point(s), resource usage of the variant's kernels).
    A B-bf16 variant may name its source by path (`--before`)."""
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
    dll = ctypes.CDLL(str(lib))
    if source == "conv3x3.cu":
        fwd, dgrad = dll.conv3x3_fwd_bf16, dll.conv3x3_dgrad_bf16
        fwd.argtypes, fwd.restype = conv._FWD_ARGS, ctypes.c_int
        dgrad.argtypes, dgrad.restype = conv._DGRAD_ARGS, ctypes.c_int
        usage = [u for k, u in cs.resource_usage(lib) if "bf16" in k]
        return label, (fwd, dgrad), usage
    if source.endswith("maxpool3x3s2.cu"):
        fwd, bwd = dll.maxpool3x3s2_fwd_bf16, dll.maxpool3x3s2_bwd_bf16
        fwd.argtypes, fwd.restype = pool._FWD_ARGS, ctypes.c_int
        bwd.argtypes, bwd.restype = pool._BWD_ARGS, ctypes.c_int
        usage = [u for k, u in cs.resource_usage(lib)
                 if "bf16" in k or "bfloat16" in k]
        return label, (fwd, bwd), usage
    fn = getattr(dll, entry)
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


def _conv_calls(fns, x, w, b, g, elu):
    """The reflect-mode forward (bias, ELU where the decoder has it) and
    input gradient of one variant's entry points, as closures."""
    B, cin, H, W = x.shape
    co = w.shape[0]
    out = torch.empty((B, co, H, W), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    stream = _build.stream_handle(x)

    def fwd():
        launch(fns[0], x.data_ptr(), w.data_ptr(), b.data_ptr(),
               out.data_ptr(), B, cin, H, W, co, int(elu), 1, stream)
        return out

    def dgrad():
        launch(fns[1], g.data_ptr(), w.data_ptr(), dx.data_ptr(), B, co, H,
               W, cin, 1, stream)
        return dx

    return fwd, dgrad


def _hold(label, got, want):
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = cs.CONV_RTOL * float(want.float().abs().max())
    over = int((diff > cs.bf16_ulp(want) + tol).sum())
    if over or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: {over} elements beyond one ulp")


def sweep_conv(gen, dev, fns) -> None:
    """Each D-bf16 variant against the plain versions at CONV_CHECK and
    the crop; timed at the crop's four convs, in turns."""
    for shape in CONV_CHECK + tuple((cs.CONV_BATCH,) + tuple(s[1:])
                                    for s in CONV_CROP):
        x, w, b, g = cs._conv_bf16_inputs(gen, dev, *shape)
        want_f = conv.conv3x3_reflect_plain(x, w, b, True)
        want_d = conv.conv3x3_dgrad_reflect_plain(g, w)
        for label, pair in fns.items():
            fwd, dgrad = _conv_calls(pair, x, w, b, g, True)
            _hold(f"{label} forward at {shape}", fwd(), want_f)
            _hold(f"{label} input gradient at {shape}", dgrad(), want_d)
    cs.log(f"  every D-bf16 variant within one ulp at "
           f"{len(CONV_CHECK) + len(CONV_CROP)} shapes, both directions")
    totals = {}
    for name, cin, co, h, w in CONV_CROP:
        x, wt, b, g = cs._conv_bf16_inputs(gen, dev, cs.CONV_BATCH, cin, co,
                                           h, w)
        for d, which in enumerate(("forward", "input gradient")):
            calls = {label: _conv_calls(pair, x, wt, b, g, co > 1)[d]
                     for label, pair in fns.items()}
            for label, ts in rounds(calls, lambda fn: fn()).items():
                cs.log(f"  {label}, {name} crop {which}: "
                       + ", ".join(f"{t:.4f}" for t in ts) + " ms")
                tot = totals.setdefault((label, which), [0.0] * ROUNDS)
                for k, t in enumerate(ts):
                    tot[k] += t
    for (label, which), ts in totals.items():
        cs.log(f"  {label}, crop pass {which}: "
               + ", ".join(f"{t:.4f}" for t in ts) + " ms")


def _pool_calls(pair, x, g):
    """One B-bf16 variant's forward and backward on x and g, as closures
    (outputs allocated here, 16-byte aligned)."""
    B, C, H, W = x.shape
    Ho, Wo = g.shape[2:]
    y = torch.full((B, C, Ho, Wo), float("nan"), dtype=x.dtype,
                   device=x.device)
    dx = torch.full_like(x, float("nan"))
    stream = _build.stream_handle(x)

    def fwd():
        launch(pair[0], x.data_ptr(), y.data_ptr(), B, C, H, W, Ho, Wo,
               stream)
        return y

    def bwd():
        launch(pair[1], x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, C, H,
               W, Ho, Wo, stream)
        return dx

    return fwd, bwd


def sweep_pool(gen, dev, fns) -> None:
    """Each B-bf16 variant equal to the plain versions at chip_smoke's
    POOL_BF16_CHECKS; timed at the bench step's two stems, in turns."""
    for shape, aligned, sparse in cs.POOL_BF16_CHECKS:
        x, g = cs._pool_bf16_inputs(gen, dev, shape, aligned, sparse)
        want_f = pool.maxpool3x3s2_plain(x)
        want_b = pool.maxpool3x3s2_backward_plain(x, g)
        for label, pair in fns.items():
            fwd, bwd = _pool_calls(pair, x, g)
            got_f, got_b = fwd(), bwd()
            torch.cuda.synchronize()
            if not (torch.equal(got_f, want_f) and torch.equal(got_b, want_b)):
                raise AssertionError(f"{label} disagrees at {shape}, "
                                     f"aligned {aligned}, sparse {sparse}")
    cs.log(f"  every B-bf16 variant equal to the plain versions at "
           f"{len(cs.POOL_BF16_CHECKS)} shapes, both directions")
    for shape in cs.POOL_BF16_TIMED:
        x, g = cs._pool_bf16_inputs(gen, dev, shape)
        for d, which in enumerate(("forward", "backward")):
            calls = {label: _pool_calls(pair, x, g)[d]
                     for label, pair in fns.items()}
            for label, ts in rounds(calls, lambda fn: fn()).items():
                cs.log(f"  {label}, {which} at {shape}: "
                       + ", ".join(f"{t:.4f}" for t in ts) + " ms")
        del x, g


def main() -> int:
    args = sys.argv[1:]
    before = []
    while "--before" in args:
        i = args.index("--before")
        before.append(Path(args[i + 1]).resolve())
        del args[i:i + 2]
    which = set(args) or {"C", "A1", "D", "B"}
    dev = cs.phase_device()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    variants = [v for v in VARIANTS if v[0].split()[0].split("-")[0]
                in which]
    for d in before if "B" in which else ():
        source = d / "depthmodelhardening_tpu_torch" / "csrc" / \
            "maxpool3x3s2.cu"
        variants.append((f"B-bf16 before ({d.name})", str(source), None,
                         None, {}))
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = list(pool.map(build, variants))
    for label, _, usage in built:
        cs.log(f"  {label}: " + "; ".join(
            f"{u.get('REG')} registers, {u.get('STACK')} B stack, "
            f"{u.get('LOCAL')} B local" for u in usage))
    gen = torch.Generator().manual_seed(cs.SEED)
    if "C" in which:
        cs.log("kernel C's forward, (B, C, H, W), card alone:")
        sweep_reproj(gen, dev, {name: fn for name, fn, _ in built
                                if name.startswith("C")})
    if "A1" in which:
        cs.log("warp A1, (B, C, OH, TH, TW), card alone:")
        sweep_warp(gen, dev, {name: fn for name, fn, _ in built
                              if name.startswith("A1")})
    if "D" in which:
        cs.log("kernel D-bf16 in reflect mode, the crop's convs at batch "
               f"{cs.CONV_BATCH}, card alone:")
        sweep_conv(gen, dev, {name: fn for name, fn, _ in built
                              if name.startswith("D-bf16")})
    if "B" in which:
        cs.log("kernel B-bf16, (B, C, H, W) of its input, card alone:")
        sweep_pool(gen, dev, {name: fn for name, fn, _ in built
                              if name.startswith("B-bf16")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
