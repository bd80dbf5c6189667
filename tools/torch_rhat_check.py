#!/usr/bin/env python
"""Split-R-hat and ESS of a and b from the JAX package's run_gibbs and from
the port's, side by side, on the CPU in float64.

Both run ``run_gibbs(collect_traces=True)`` at the gate's configuration
(tests/data/torch_gate_ref.json: ``crp_generate(seed, 2, 20, 40, 0.5,
10.0)``, demo-compat TI, bcycle 2, acycle 5, a g = 96 grid, starts a =
0.5, b = 1.0, 64 chains) for ``--iters`` iterations, the JAX run from
``jax.random.key(seed + 1)``, the port's from a CPU ``torch.Generator``
seeded ``seed + 1``.  The two streams differ, so the figures agree only
as two runs of one sampler do.  Prints one JSON line per seed and package
and a last line with all of them.

Usage:  python tools/torch_rhat_check.py [--seeds 7,11,23] [--iters 1000]
        [--chains 64]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GATE_REF = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                        "torch_gate_ref.json")


def _stats(out, package):
    return {f"{x}_{k}": float(np.asarray(out[f"{x}_{k}"]))
            for x in ("a", "b") for k in ("rhat", "ess")} | dict(
        package=package, a_mean=float(np.asarray(out["aave"]).mean()),
        b_mean=float(np.asarray(out["bave"]).mean()))


def run_jax(seed, iters, chains, ref):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from libstb_tpu.core import agrid
    from libstb_tpu.models import driver, pyp

    cfg = driver.GibbsConfig(**dict(ref["config"], iters=iters,
                                    collect_traces=True))
    data = pyp.crp_generate(seed, *ref["data_args"])
    n_max = max(int(data.N.max()) + 2, 16)
    grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], dtype=jnp.float64)
    out = driver.run_gibbs(jax.random.key(seed + 1), data, grid, chains,
                           ref["a0"], ref["b0"], cfg)
    return _stats(out, "jax")


def run_port(seed, iters, chains, ref):
    import torch

    from libstb_tpu_torch.core import agrid
    from libstb_tpu_torch.models import driver, pyp

    cfg = driver.GibbsConfig(**dict(ref["config"], iters=iters,
                                    collect_traces=True))
    data = pyp.crp_generate(seed, *ref["data_args"])
    n_max = max(int(data.N.max()) + 2, 16)
    grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"],
                           dtype=torch.float64, device="cpu")
    out = driver.run_gibbs(torch.Generator().manual_seed(seed + 1), data,
                           grid, chains, ref["a0"], ref["b0"], cfg)
    return _stats({k: v.numpy() if hasattr(v, "numpy") else v
                   for k, v in out.items()}, "port")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="7,11,23")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--chains", type=int, default=64)
    args = p.parse_args(argv)
    with open(GATE_REF) as f:
        ref = json.load(f)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for run in (run_jax, run_port):
            row = dict(seed=seed, iters=args.iters, chains=args.chains,
                       **run(seed, args.iters, args.chains, ref))
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
