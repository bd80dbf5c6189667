#!/usr/bin/env python
"""PYP Gibbs demo on the PyTorch/CUDA port -- cli/demo.py's flags plus
--device (default cuda).

Generates data by CRP simulation, runs the chosen sampler (TI, CT, CTW
or HSA) with optional (b, a) resampling cycles, and reports posterior
mean table counts (demo.c:284-311 data gen, 405-489 loop, 507-519
report).  The (a, b) moves take the sampler config's 1-D kernel, slice or
ARS.

  python cli/demo_torch.py -C 200 -H 2 -I 5
  python cli/demo_torch.py -C 200 -H 2 -I 5 --sampler HSA
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.5, help="discount")
    p.add_argument("-b", type=float, default=10.0, help="concentration")
    p.add_argument("-B", type=int, default=0, help="burnin (default 50%%)")
    p.add_argument("-C", type=int, default=200, help="recording cycles")
    p.add_argument("-H", type=int, default=0, help="b-sampling cycle")
    p.add_argument("-I", type=int, default=0, help="a-sampling cycle")
    p.add_argument("-N", type=int, default=40, help="samples per group")
    p.add_argument("-s", type=int, default=0, help="seed")
    p.add_argument("-T", type=int, default=1000, help="max t for tables")
    p.add_argument("-v", action="count", default=0, help="verbose")
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--groups", type=int, default=1)
    p.add_argument("--dim", type=int, default=20, help="base dimension")
    p.add_argument("--sampler", default="TI",
                   choices=["TI", "CT", "CTW", "HSA"])
    p.add_argument("--base", default="uniform",
                   choices=["uniform", "linear", "slowlinear", "dirichlet"])
    p.add_argument("--device", default="cuda",
                   help="torch device the tables and chains live on")
    args = p.parse_args()

    import torch

    from libstb_tpu_torch.core import agrid, rng
    from libstb_tpu_torch.models import driver, pyp
    from libstb_tpu_torch.utils import config, yaps

    device = torch.device(args.device)
    tcfg = config.from_env(config.TableConfig)
    scfg = config.from_env(config.SamplerConfig)
    yaps.message("Configuration: a=%g b=%g chains=%d sampler=%s device=%s",
                 args.a, args.b, args.chains, args.sampler, device)
    H = pyp.base_distribution(args.base, args.dim, args.b,
                              np.random.default_rng(args.s))
    data = pyp.crp_generate(args.s, args.groups, args.dim, args.N,
                            args.a, args.b, H=H)
    yaps.message("data: n=%s T_true(per-group)=%s",
                 data.n.tolist(), (data.n > 0).sum(axis=1).tolist())

    n_max = max(int(data.N.max()) + 2, 16)
    m_max = min(args.T, n_max)
    grid = agrid.make_grid(n_max, m_max, g=tcfg.grid_points,
                           a_lo=tcfg.a_lo, a_hi=tcfg.a_hi,
                           build_s=tcfg.build_s, build_v=tcfg.build_v,
                           device=device,
                           max_n=tcfg.max_n, max_m=tcfg.max_m,
                           use_asympt=tcfg.use_asympt)
    cfg = driver.GibbsConfig(iters=args.C, burnin=args.B, bcycle=args.H,
                             acycle=args.I, sampler=args.sampler,
                             scale=float(args.dim), kernel=scfg.kernel,
                             shape=scfg.b_shape,
                             quit_on_bound=tcfg.quit_on_bound)
    t0 = time.time()
    out = driver.run_gibbs(rng.generator(args.s + 1, device), data, grid,
                           args.chains, args.a, args.b, cfg)
    tave = out["tave_mean"].cpu().numpy()
    Tave = out["Tave_mean"].cpu().numpy()
    dt = time.time() - t0
    yaps.message("ran %d iters x %d chains in %.2fs", args.C, args.chains, dt)
    for j in range(args.groups):
        nz = np.nonzero(data.n[j])[0]
        print(f"group {j}: T_ave = {Tave[j]:.3f}")
        if args.v:
            for i in nz:
                print(f"  cat {i}: n={data.n[j, i]} t_ave={tave[j, i]:.3f}")
    if args.I > 0:
        print(f"a_ave = {float(out['aave_mean']):.4f}  (true {args.a})")
    if args.H > 0:
        print(f"b_ave = {float(out['bave_mean']):.4f}  (true {args.b})")


if __name__ == "__main__":
    main()
