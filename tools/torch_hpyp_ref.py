#!/usr/bin/env python
"""Write the JAX reference moments of the HPYP model that the PyTorch
port's HPYP gate (chip_smoke.py phase 14a) is held to.

Runs the JAX package's run_hpyp on the CPU in float64 on the README
Quick-start data ``crp_generate(0, 4, 20, 100, 0.5, 10.0)`` with 256
chains (--chains), HPYPConfig(iters=1000, hyper_cycle=2), starts (a1, b1,
a0, b0) = (0.5, 10, 0.5, 10), key 1 (--key), on a g = 96 grid that covers the
level-0 bound (the largest sum_j n[j, i] + 2), and writes the data counts
and the mean and Monte-Carlo SE (over chains, per-chain averages as the
replicates) of E[T1_j], E[T0], E[a1], E[b1], E[a0], E[b0] to
tests/data/torch_hpyp_ref.json.

Usage:  python tools/torch_hpyp_ref.py [--out PATH] [--chains C] [--key K]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

DATA_ARGS = (0, 4, 20, 100, 0.5, 10.0)   # seed, groups, dim, items, a, b
CONFIG = dict(iters=1000, hyper_cycle=2)
STARTS = dict(a1=0.5, b1=10.0, a0=0.5, b0=10.0)
CHAINS, GRID_G, KEY = 256, 96, 1


def moments(vals):
    vals = np.asarray(vals, np.float64)
    return dict(mean=vals.mean(0).tolist(),
                se=(vals.std(0, ddof=1) / np.sqrt(len(vals))).tolist())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data",
        "torch_hpyp_ref.json"))
    ap.add_argument("--chains", type=int, default=CHAINS)
    ap.add_argument("--key", type=int, default=KEY,
                    help="JAX key of the run (another key: the "
                         "reference's own Monte-Carlo spread)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from libstb_tpu.core import agrid
    from libstb_tpu.models import hpyp, pyp

    data = pyp.crp_generate(*DATA_ARGS)
    n_max = int(data.n.sum(axis=0).max()) + 2
    grid = agrid.make_grid(n_max, n_max, g=GRID_G, dtype=jnp.float64)
    t0 = time.perf_counter()
    out = hpyp.run_hpyp(jax.random.key(args.key), data, grid, args.chains,
                        STARTS["a1"], STARTS["b1"], STARTS["a0"],
                        STARTS["b0"], hpyp.HPYPConfig(**CONFIG))
    m = {k: moments(np.asarray(out[src]).reshape(args.chains, -1))
         for k, src in (("T1", "T1ave"), ("T0", "T0ave"), ("a1", "a1ave"),
                        ("b1", "b1ave"), ("a0", "a0ave"), ("b0", "b0ave"))}
    print(" ".join(f"E[{k}]={v['mean']}" for k, v in m.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    ref = dict(source="libstb_tpu run_hpyp, CPU float64 "
                      f"(python tools/torch_hpyp_ref.py --chains "
                      f"{args.chains} --key {args.key})",
               data_args=list(DATA_ARGS), config=CONFIG, starts=STARTS,
               chains=args.chains, grid_g=GRID_G, grid_n=n_max,
               n=data.n.tolist(), moments=m)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
