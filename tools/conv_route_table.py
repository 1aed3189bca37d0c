"""Each bf16 convolution of a benchmark cell, timed on cuDNN and on
PyTorch's im2col path (and on kernel D where it runs the layer).

    python3 tools/conv_route_table.py [--reps N] [--out DIR] CELL [CELL ...]

For each CELL of BENCHMARK.json, builds the cell as `benchmark/run.py`
does and records, over its three set-up steps, every bf16 convolution
the program runs on the card: `F.conv2d` calls (the encoders, the
decoder's wide convs, with the passes their inputs' `requires_grad`
make the backward run), kernel D's forward and input gradient, and D's
weight gradient (`torch.nn.grad.conv2d_weight`). Then one step of the
cell twice each way, in turns: as it is, and with every bf16
`F.conv2d` pass and D's weight gradient on cuDNN's deterministic
algorithms (the step's seconds and `max_memory_allocated`). Then, per
distinct shape, each pass (forward, input gradient, weight gradient,
and both gradients in one `convolution_backward`, as autograd's node
computes them) three ways:

- cuDNN under `torch.backends.cudnn.flags(enabled=True, benchmark=False,
  deterministic=True, allow_tf32=False)`;
- PyTorch's im2col + GEMM (cuDNN off, as `device.use_f32_numerics`
  leaves it);
- kernel D's forward and input gradient, where it takes the layer;

as the median of REPS CUDA-event timings after a warm-up, with the
memory each pass allocates beyond its outputs (cuDNN's workspace or
im2col's column buffers) and its error against the float32 result of
the same bf16 operands (cuDNN off, TF32 off): the largest difference in
bf16 ulps of that result rounded once, and the elements beyond one ulp
plus 1e-5 of its largest magnitude. Writes <DIR>/<CELL>.json and prints
one line a shape and pass.
"""
import argparse
import collections
import contextlib
import gc
import json
import os
import statistics
import sys
import time
import zlib

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
from harness import port, spec as specs  # noqa: E402
from harness.train import RECORDED, TrainCell  # noqa: E402
import reference  # noqa: E402
from depthmodelhardening_tpu_torch.ops import conv  # noqa: E402
from depthmodelhardening_tpu_torch.ops.padding import reflect_pad1  # noqa

CUDNN = dict(enabled=True, benchmark=False, deterministic=True,
             allow_tf32=False)
BF16 = torch.bfloat16
SEED = 3000000401


def log(msg: str) -> None:
    print(msg, flush=True)


# -- what the cell runs -------------------------------------------------------
class Recorder:
    """bf16 convolutions on the card, by shape, while installed:
    `calls[key][pass]` counts each pass. A key is ("conv", N, Cin, H, W,
    Co, kh, kw, stride, padding, bias) for `F.conv2d` or ("D", N, Cin,
    H, W, Co) for a layer kernel D takes (reflect mode)."""

    def __init__(self):
        self.calls = collections.defaultdict(collections.Counter)
        self.orig = {}

    def install(self):
        self.orig = {"conv2d": F.conv2d,
                     "conv2d_weight": torch.nn.grad.conv2d_weight,
                     "fwd": conv.conv3x3_reflect_cuda,
                     "dgrad": conv.conv3x3_dgrad_reflect_cuda}
        o = self.orig

        def conv2d(x, w, bias=None, stride=1, padding=0, *a, **k):
            if x.dtype == BF16 and x.is_cuda:
                key = ("conv", *x.shape, w.shape[0], *w.shape[2:],
                       _one(stride), _one(padding), bias is not None)
                c = self.calls[key]
                c["fwd"] += 1
                if torch.is_grad_enabled():
                    c["dgrad"] += int(x.requires_grad)
                    c["wgrad"] += int(w.requires_grad)
            return o["conv2d"](x, w, bias, stride, padding, *a, **k)

        def conv2d_weight(xp, w_size, g, *a, **k):
            if xp.dtype == BF16 and xp.is_cuda:
                N, Cin, Hp, Wp = xp.shape
                self.calls[("D", N, Cin, Hp - 2, Wp - 2, w_size[0])][
                    "wgrad"] += 1
            return o["conv2d_weight"](xp, w_size, g, *a, **k)

        def fwd(x, w, bias=None, elu=False):
            self.calls[("D", *x.shape, w.shape[0])]["fwd"] += 1
            return o["fwd"](x, w, bias, elu)

        def dgrad(g, w):
            B, Co, H, W = g.shape
            self.calls[("D", B, w.shape[1], H, W, Co)]["dgrad"] += 1
            return o["dgrad"](g, w)

        F.conv2d = conv2d
        torch.nn.grad.conv2d_weight = conv2d_weight
        conv.conv3x3_reflect_cuda = fwd
        conv.conv3x3_dgrad_reflect_cuda = dgrad

    def remove(self):
        F.conv2d = self.orig["conv2d"]
        torch.nn.grad.conv2d_weight = self.orig["conv2d_weight"]
        conv.conv3x3_reflect_cuda = self.orig["fwd"]
        conv.conv3x3_dgrad_reflect_cuda = self.orig["dgrad"]


def _one(v):
    """A conv2d stride or padding as one int (the models' are square)."""
    if isinstance(v, (tuple, list)):
        assert len(set(v)) == 1, v
        return int(v[0])
    return int(v)


class AllCudnn:
    """Every bf16 `F.conv2d` pass (its backward node under the flags by a
    pre-hook and a hook) and D's weight gradient on cuDNN, but the
    (key, pass) pairs of `exclude` ("fwd", "bwd": the node, "wgrad":
    D's). `trace`: a list that gets (key, pass, max_memory_allocated
    before the pass, after it), each pass synchronised."""

    def __init__(self, exclude=(), trace=None):
        self.exclude, self.trace = set(exclude), trace

    def _max(self):
        if self.trace is None:
            return None
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    def _after(self, key, pass_, before):
        if self.trace is not None:
            self.trace.append((key, pass_, before, self._max()))

    def __enter__(self):
        self.conv2d, self.wg = F.conv2d, torch.nn.grad.conv2d_weight
        conv2d, wg = self.conv2d, self.wg

        def routed(x, w, bias=None, stride=1, padding=0, *a, **k):
            if x.dtype != BF16:
                return conv2d(x, w, bias, stride, padding, *a, **k)
            key = ("conv", *x.shape, w.shape[0], *w.shape[2:], _one(stride),
                   _one(padding), bias is not None)
            before = self._max()
            if (key, "fwd") in self.exclude:
                y = conv2d(x, w, bias, stride, padding, *a, **k)
            else:
                with torch.backends.cudnn.flags(**CUDNN):
                    y = conv2d(x, w, bias, stride, padding, *a, **k)
            self._after(key, "fwd", before)
            node = y.grad_fn
            if node is not None:
                held = []
                on = (key, "bwd") not in self.exclude

                def pre(grad_outputs):
                    held.append(self._max())
                    if on:
                        cm = torch.backends.cudnn.flags(**CUDNN)
                        cm.__enter__()
                        held.append(cm)

                def post(grad_inputs, grad_outputs):
                    if on:
                        held.pop().__exit__(None, None, None)
                    self._after(key, "bwd", held.pop())
                node.register_prehook(pre)
                node.register_hook(post)
            return y

        def wgrad(xp, w_size, g, *a, **k):
            if xp.dtype != BF16:
                return wg(xp, w_size, g, *a, **k)
            N, Cin, Hp, Wp = xp.shape
            key = ("D", N, Cin, Hp - 2, Wp - 2, w_size[0])
            before = self._max()
            if (key, "wgrad") in self.exclude:
                out = wg(xp, w_size, g, *a, **k)
            else:
                with torch.backends.cudnn.flags(**CUDNN):
                    out = wg(xp, w_size, g, *a, **k)
            self._after(key, "wgrad", before)
            return out

        F.conv2d = routed
        torch.nn.grad.conv2d_weight = wgrad
        return self

    def __exit__(self, *exc):
        F.conv2d, torch.nn.grad.conv2d_weight = self.conv2d, self.wg


def _site(e) -> str:
    """An allocation's innermost frames of this repository."""
    frames = [f"{os.path.basename(f['filename'])}:{f['line']}"
              for f in e.get("frames", [])
              if ROOT in f["filename"] and "conv_route_table" not in
              f["filename"]]
    return " < ".join(frames[:4])


def at_peak(snapshot) -> dict:
    """Bytes alive when the traced step's allocated bytes peaked, by the
    site (the repository's frames) that allocated them."""
    events = snapshot["device_traces"][0]
    alive, total, best, best_alive = {}, 0, -1, {}
    for e in events:
        if e["action"] == "alloc":
            alive[e["addr"]] = e
            total += e["size"]
        elif e["action"] == "free_completed" and e["addr"] in alive:
            total -= alive.pop(e["addr"])["size"]
        if total > best:
            best, best_alive = total, dict(alive)
    sites = collections.Counter()
    for e in best_alive.values():
        sites[_site(e)] += e["size"]
    return dict(sites)


def _recorded(fn):
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        out = fn()
        return out, at_peak(torch.cuda.memory._snapshot())
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)


def peak_passes(name: str, dev, rounds: int = 6) -> list:
    """Which cuDNN passes raise the step's peak: a step as it is, then
    steps with every bf16 pass on cuDNN, each synchronised pass's running
    `max_memory_allocated` traced; the pass that first reached the step's
    peak is put back on im2col for the next step, until the peak is the
    step's as it is or `rounds` steps have run."""
    spec = specs.load(ROOT, name)
    program = port.load()
    program.use_f32_numerics()
    cell = TrainCell(spec, SEED, dev, program, reference)
    cell.setup()
    out = []

    def step(i, ctx):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with ctx:
            cell.step(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)

    (s, base), sites_as_is = _recorded(
        lambda: step(0, contextlib.nullcontext()))
    log(f"{name} peaks: as it is {base} ({s:.3f} s)")
    out.append({"exclude": None, "peak_bytes": base, "s": s})
    exclude = []
    for r in range(rounds):
        trace = []
        (s, peak), sites = _recorded(
            lambda: step(r + 1, AllCudnn(exclude, trace)))
        diff = {k: sites.get(k, 0) - sites_as_is.get(k, 0)
                for k in set(sites) | set(sites_as_is)}
        for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:8]:
            log(f"  alive at the peak, cuDNN minus as it is: {v} B at {k}")
        # the pass during which the running max reached the peak
        first = next((t for t in trace if t[2] < t[3] == peak), None)
        log(f"{name} peaks: cuDNN but {exclude}: {peak} ({s:.3f} s); "
            f"first at {first}")
        within = sorted(trace, key=lambda t: t[2] - t[3])[:5]
        between = sorted(zip(trace, trace[1:]),
                         key=lambda ab: ab[0][3] - ab[1][2])[:5]
        log("  largest rises within a pass: " + "; ".join(
            f"{t[0]} {t[1]} {t[2]} -> {t[3]}" for t in within))
        log("  largest rises between passes: " + "; ".join(
            f"after {a[0]} {a[1]} {a[3]} -> before {b[0]} {b[1]} {b[2]}"
            for a, b in between))
        out.append({"exclude": [list(e) for e in exclude], "peak_bytes": peak,
                    "s": s, "first": None if first is None else
                    [list(first[0]), first[1], first[2], first[3]]})
        if peak <= base or first is None:
            break
        exclude.append((first[0], first[1]))
    cell.free()
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def record_cell(name: str, dev):
    """The cell's bf16 convolutions a step (set-up's steps / RECORDED)
    and its step, as it is and with every bf16 pass on cuDNN."""
    spec = specs.load(ROOT, name)
    program = port.load()
    program.use_f32_numerics()
    cell = TrainCell(spec, SEED, dev, program, reference)
    rec = Recorder()
    rec.install()
    try:
        cell.setup()
    finally:
        rec.remove()
    steps = []
    for i, variant in enumerate(("as_is", "cudnn", "cudnn", "as_is",
                                 "as_is", "cudnn")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if variant == "cudnn":
            with AllCudnn():
                cell.step(i)
        else:
            cell.step(i)
        torch.cuda.synchronize()
        steps.append({"variant": variant,
                      "s": time.perf_counter() - t0,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        log(f"{name} step {i} {variant}: {steps[-1]['s']:.4f} s, peak "
            f"{steps[-1]['peak_bytes']}")
    cell.free()
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    calls = {k: {p: n / RECORDED for p, n in c.items()}
             for k, c in rec.calls.items()}
    return calls, steps


# -- one shape's passes ------------------------------------------------------
def ms(fn, reps: int) -> float:
    """Median ms of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def extra_bytes(fn) -> int:
    """Bytes fn() allocates beyond what it returns (its workspace)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kept = sum(t.numel() * t.element_size() for t in _outputs(out))
    return int(peak - base - kept)


def bf16_ulp(t):
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def error(got, want) -> dict:
    """got (bf16) against want (float32 of the same operands)."""
    out = {}
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        r = w.to(BF16).float()
        d = (g.float() - r).abs()
        ulp = bf16_ulp(r)
        slack = 1e-5 * float(w.abs().max())
        out[f"max_ulps{i}"] = float((d / ulp).max())
        out[f"over{i}"] = int((d > ulp + slack).sum())
    return out


def bwd(g, x, w, bias: bool, stride, padding, mask):
    return torch.ops.aten.convolution_backward(
        g, x, w, [w.shape[0]] if bias else None, [stride] * 2,
        [padding] * 2, [1, 1], False, [0, 0], 1, mask)


def shape_rows(key, passes: dict, reps: int, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(str(key).encode()))
    kind = key[0]
    if kind == "conv":
        _, N, Cin, H, W, Co, kh, kw, stride, padding, bias = key
    else:
        _, N, Cin, H, W, Co = key
        kh = kw = 3
        stride, padding, bias = 1, 0, True
    x = torch.rand((N, Cin, H, W), generator=gen, device=dev)
    w = torch.randn((Co, Cin, kh, kw), generator=gen, device=dev) / (
        kh * kw * Cin) ** 0.5
    b = 0.1 * torch.randn((Co,), generator=gen, device=dev)
    xin = reflect_pad1(x) if kind == "D" else x  # F.conv2d's input
    xb, wb, bb = xin.to(BF16), w.to(BF16), b.to(BF16)
    yshape = F.conv2d(xb[:1], wb, None, stride, padding).shape[1:]
    g = torch.randn((N, *yshape), generator=gen, device=dev).to(BF16)
    bias_b = bb if bias else None
    f32 = (xb.float(), wb.float(), None if bias_b is None else
           bias_b.float(), g.float())
    both_mask = [True, True, bias]
    fns = {
        "fwd": (lambda X, Wt, Bs, G: F.conv2d(X, Wt, Bs, stride, padding)),
        "dgrad": (lambda X, Wt, Bs, G: bwd(G, X, Wt, False, stride, padding,
                                           [True, False, False])[0]),
        "wgrad": (lambda X, Wt, Bs, G: bwd(G, X, Wt, False, stride, padding,
                                           [False, True, False])[1]),
        "dgrad+wgrad": (lambda X, Wt, Bs, G: bwd(G, X, Wt, bias, stride,
                                                 padding, both_mask)),
    }
    rows = []
    for p, fn in fns.items():
        if p == "dgrad+wgrad" and (kind == "D" or not (
                passes.get("dgrad") and passes.get("wgrad"))):
            continue
        if p != "dgrad+wgrad" and not passes.get(p):
            continue
        want = fn(*f32)
        row = {"key": list(key), "pass": p,
               "calls_a_step": passes.get("wgrad" if p == "dgrad+wgrad"
                                          else p)}
        args = (xb, wb, bias_b, g)
        with torch.backends.cudnn.flags(**CUDNN):
            row["cudnn_ms"] = ms(lambda: fn(*args), reps)
            row["cudnn_ws"] = extra_bytes(lambda: fn(*args))
            row["cudnn_err"] = error(fn(*args), want)
        row["im2col_ms"] = ms(lambda: fn(*args), reps)
        row["im2col_ws"] = extra_bytes(lambda: fn(*args))
        row["im2col_err"] = error(fn(*args), want)
        if kind == "D" and p in ("fwd", "dgrad"):
            xd = x.to(BF16)
            if p == "fwd":
                d_fn = lambda: conv.conv3x3_reflect_cuda(xd, wb, bb)  # noqa
                want_d = F.conv2d(reflect_pad1(xd.float()), wb.float(),
                                  bb.float())
            else:
                d_fn = lambda: conv.conv3x3_dgrad_reflect_cuda(g, wb)  # noqa
                want_d = conv.conv3x3_dgrad_reflect_plain(g.float(),
                                                          wb.float())
            row["D_ms"] = ms(d_fn, reps)
            row["D_err"] = error(d_fn(), want_d)
        rows.append(row)
        del want
        log(json.dumps(row))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--peaks", action="store_true",
                   help="only find the passes that raise the step's peak")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "conv_table"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    os.makedirs(args.out, exist_ok=True)
    log(f"{torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, cuDNN "
        f"{torch.backends.cudnn.version()}")
    for name in args.cells:
        if args.peaks:
            with open(os.path.join(args.out, f"{name}.peaks.json"), "w") as f:
                json.dump(peak_passes(name, dev), f, indent=1)
            continue
        calls, steps = record_cell(name, dev)
        rows = []
        for key, passes in sorted(calls.items(), key=str):
            rows += shape_rows(key, passes, args.reps, dev)
            torch.cuda.empty_cache()
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump({"cell": name, "steps": steps,
                       "calls": [[list(k), v] for k, v in calls.items()],
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
