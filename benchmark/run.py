#!/usr/bin/env python3
"""The benchmark of libstb_tpu_torch, the PyTorch and CUDA port: one run
of one cell, one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The
run sets up (inputs and weights from ``--seed``, the kernels built or
loaded, the cell's shapes warmed), measures the window, checks the
window's outputs against the plain reference in ``benchmark/reference/``
and prints the result object as the last line of standard output; the
numbers it compared, each with its limit, are the last lines of standard
error.  ``--trace 1`` prints the per-layer metrics of a profiled run in
place of the end-to-end ones.  It fails, and prints no result, without a
card, with fewer cards than the cell asks for, or when JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# PyTorch compiles some of its kernels at run time (NVRTC: torch.lgamma on
# the card, which make's S1 and the grid's fill call) and keeps them in
# this cache: one fixed directory inside the checkout, so that only a
# cell's first run there compiles.  PyTorch makes only the last directory
# of the path and turns the cache off where its parent is missing.
KERNEL_CACHE = ROOT / ".bench_cache" / "torch_kernels"
KERNEL_CACHE.mkdir(parents=True, exist_ok=True)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(KERNEL_CACHE)


def _plain(x):
    """Non-finite numbers as strings, which JSON can carry."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    manifest = harness.load_manifest()
    cell = next((w for w in manifest["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    try:
        import libstb_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 5
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START, manifest)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print("loaded in the run's process: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_plain(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
