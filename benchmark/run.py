#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Reads BENCHMARK.json and the cell's files under benchmark/, runs the
cell on as many CUDA cards as it asks for, and prints one JSON object as
the last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device` and, traced, `breakdown`; last, `checks`: each
number that decided `correct` with its limit, also the last lines of
standard error. Exits non-zero with no result when the cards are
missing, when the program cannot be loaded, or when jax, jaxlib, flax or
the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"


def cards(n: int):
    """The first card, once `n` are there; else exit 3 with no result."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {n} CUDA card(s), found {count}", file=sys.stderr)
        sys.exit(3)
    return torch.device("cuda", 0)


def main(argv=None, device=None) -> int:
    args = parse(argv)
    sys.path[:0] = [HERE, ROOT]
    caches()
    from harness import main as harness, port, spec as specs

    spec = specs.load(ROOT, args.workload)
    dev = device if device is not None else cards(spec["cell"]["chips"])
    program = port.load()
    import reference

    program.use_f32_numerics()  # as the command line does
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         dev, program, reference, T_START)
    found = harness.banned_modules()
    if found:
        print(f"modules loaded that the run may not load: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
