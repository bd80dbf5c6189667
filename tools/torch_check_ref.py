#!/usr/bin/env python
"""Write the JAX reference moments of the check.c samplers that the
PyTorch port's multi-sampler gate (chip_smoke.py phase 11) is held to.

Runs the JAX package's run_gibbs on the CPU in float64 for the samplers
CT, CTW (window 10) and HSA, one seed each, on cli/check.py's default data
``crp_generate(seed, 1, 20, 40, 0.5, 10.0)`` with 256 chains (--chains),
bcycle 2, acycle 5, a g = 96 grid and starts a = 0.5, b = 10, and writes, per
sampler, the data counts and the mean and Monte-Carlo SE (over chains,
per-chain averages as the replicates) of E[T_j], E[a], E[b] to
tests/data/torch_check_ref.json.  The TI gate's reference
(tests/data/torch_gate_ref.json) runs the legacy TI odds, so these
samplers need their own.

Usage:  python tools/torch_check_ref.py [--out PATH]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

SAMPLERS = {"CT": 31, "CTW": 37, "HSA": 41}     # sampler -> data seed
DATA_ARGS = (1, 20, 40, 0.5, 10.0)     # groups, dim, items/group, a, b
CONFIG = dict(iters=1000, bcycle=2, acycle=5, window=10, scale=20.0)
CHAINS, GRID_G, A0, B0 = 256, 96, 0.5, 10.0


def moments(vals):
    vals = np.asarray(vals, np.float64)
    return dict(mean=vals.mean(0).tolist(),
                se=(vals.std(0, ddof=1) / np.sqrt(len(vals))).tolist())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data",
        "torch_check_ref.json"))
    ap.add_argument("--chains", type=int, default=CHAINS)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from libstb_tpu.core import agrid
    from libstb_tpu.models import driver, pyp

    runs = {}
    for sampler, seed in SAMPLERS.items():
        cfg = driver.GibbsConfig(sampler=sampler, **CONFIG)
        data = pyp.crp_generate(seed, *DATA_ARGS)
        n_max = max(int(data.N.max()) + 2, 16)
        grid = agrid.make_grid(n_max, n_max, g=GRID_G, dtype=jnp.float64)
        t0 = time.perf_counter()
        out = driver.run_gibbs(jax.random.key(seed + 1), data, grid,
                               args.chains, A0, B0, cfg)
        r = runs[sampler] = dict(
            seed=seed, n=data.n.tolist(), T=moments(out["Tave"]),
            a=moments(np.asarray(out["aave"])[:, None]),
            b=moments(np.asarray(out["bave"])[:, None]))
        print(f"{sampler} seed {seed}: E[T_j]={r['T']['mean']} "
              f"E[a]={r['a']['mean']} E[b]={r['b']['mean']} "
              f"({time.perf_counter() - t0:.1f} s)")
    ref = dict(source="libstb_tpu run_gibbs, CPU float64 "
                      "(tools/torch_check_ref.py)",
               data_args=list(DATA_ARGS), config=CONFIG,
               chains=args.chains,
               grid_g=GRID_G, a0=A0, b0=B0, samplers=runs)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
