#!/usr/bin/env python
"""NGG generalized-Stirling tables -- the test/ngg_test.c analog, on the
PyTorch/CUDA port: cli/ngg.py's flags plus --device (default cuda).

Builds the S table and the Lambda1 ratio table of the Normalized
Generalized Gamma process, then prints the (n, k) comparison of table
values, the saddle-point approximations and tanh-sinh quadrature
(ngg_test.c:502-533's main output, with the quadrature column that
ngg_integral.cpp provides).  Everything runs in f64 on --device.

--chains C: the posterior workload of BASELINE config 5 -- C (n, k)
chains evaluate the u- and x-representation saddle points at once, whose
agreement must stay below 5% (the same check as cli/ngg.py); prints
saddle-evals/s.  Under torchrun the chains are sharded over the
processes (C rounded down to a multiple of them, as cli/ngg.py rounds to
the mesh): each rank evaluates its slice of the same seed-0 draws, the
worst disagreement is reduced as a maximum and the mean as a
chain-weighted sum, and rank 0 prints the line.  --device cuda (the
default) is each process's own card, cuda:LOCAL_RANK.

  python cli/ngg_torch.py
  python cli/ngg_torch.py --chains 100000
  torchrun --nproc_per_node 2 cli/ngg_torch.py --chains 100000
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

AGREE = 0.05        # the largest u-vs-g disagreement the workload accepts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.1, help="NGG discount")
    p.add_argument("-M", type=float, default=10.0, help="NGG mass")
    p.add_argument("-N", type=int, default=16, help="max n")
    p.add_argument("-K", type=int, default=10, help="max k")
    p.add_argument("--step", type=int, default=2)
    p.add_argument("--chains", type=int, default=0,
                   help="posterior-workload mode: evaluate the saddle-point "
                        "family over this many (n, k) chains on the device "
                        "(BASELINE config 5)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="with --chains: rank 0 also writes the result "
                        "(chains, seconds, evals_per_s, worst, mean) here")
    args = p.parse_args(argv)

    import torch

    from libstb_tpu_torch.core import ngg
    from libstb_tpu_torch.parallel import distributed

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("ngg_torch: --device cuda but no CUDA device")
    device = distributed.local_device(
        None if args.device == "cuda" else args.device)
    if args.chains:
        return ngg_workload(args, device)
    a, M, N, K = args.a, args.M, args.N, args.K
    tab = ngg.ngg_table(a, M, N, K, device=device).cpu().numpy()
    R = ngg.ngg_ratio_table(a, M, N, K, device=device).cpu().numpy()
    print(f"NGG tables: a={a} M={M} N={N} K={K} device={device}")
    print(f"{'n':>4} {'k':>3} {'T=log table':>14} {'umax':>12} "
          f"{'hmax':>12} {'hmax2':>12} {'gmax':>12} {'quadrature':>14} "
          f"{'L1 ratio':>12}")
    for n in range(1, N, args.step):
        for k in range(1, min(n, K - 1) + 1, args.step):
            nk = dict(N=float(n), K=float(k), device=device)
            t = tab[k - 1, n - 1]
            u = float(ngg.umax_log(a, M, **nk))
            h = float(ngg.hmax_log(a, M, **nk))
            h2 = float(ngg.hmax2_log(a, M, **nk))
            g = float(ngg.gmax_log(a, M, **nk))
            q = float(ngg.ngg_quadrature_log(a, M, **nk))
            r = R[k - 1, n - 1] if n < N else float("nan")
            print(f"{n:4d} {k:3d} {t:14.6f} {u:12.6f} {h:12.6f} "
                  f"{h2:12.6f} {g:12.6f} {q:14.6f} {r:12.8f}")
    print("\nlarge-n ratio table via quadrature method (n up to 200):")
    Rb = ngg.ngg_ratio_table(a, M, 200, K, method="quadrature",
                             device=device).cpu().numpy()
    for n in (50, 100, 199):
        row = " ".join(f"{Rb[k - 1, n - 1]:.6f}" for k in range(1, K, 2))
        print(f"  n={n:4d}: {row}")
    return None


def workload_inputs(chains, device):
    """cli/ngg.py's (N, K) draws (numpy seed 0) as f64 tensors."""
    import torch

    rng = np.random.default_rng(0)
    Ns = rng.integers(50, 100000, chains).astype(np.float64)
    Ks = np.maximum(1, (Ns * rng.uniform(0.005, 0.05, chains))).astype(
        np.float64)
    return (torch.as_tensor(Ns, device=device),
            torch.as_tensor(Ks, device=device))


def evaluate(a, M, N, K):
    """One pass of the workload: both saddle representations at every
    chain and their worst and mean relative disagreement."""
    import torch

    from libstb_tpu_torch.core import ngg

    u = ngg.umax_log(a, M, N, K)
    g = ngg.gmax_log(a, M, N, K)
    rel = torch.abs(u - g) / torch.clamp(torch.abs(u), min=1.0)
    return u, g, torch.amax(rel), torch.mean(rel)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ngg_workload(args, device):
    """The NGG posterior workload (BASELINE config 5) on this process's
    share of the chains (all of them in a single process); raises
    SystemExit if the two saddle representations disagree by AGREE or
    more.  Returns dict(chains, seconds, evals_per_s, worst, mean), the
    statistics over all chains, the time that of the slowest process."""
    import torch

    from libstb_tpu_torch.parallel import distributed
    from libstb_tpu_torch.parallel import mesh as pmesh

    distributed.init()
    P = distributed.world_size()
    C = (args.chains // P) * P or P
    cm = pmesh.chain_mesh(device=device)
    st = pmesh.shard_chain_tree(dict(zip("NK", workload_inputs(C, "cpu"))),
                                cm, C)
    N, K = st["N"], st["K"]
    evaluate(args.a, args.M, N, K)             # warm: allocator, lazy init
    _sync(device)
    t0 = time.perf_counter()
    _, _, worst, mean = evaluate(args.a, args.M, N, K)
    _sync(device)
    dt = time.perf_counter() - t0
    if P > 1:
        worst = pmesh.max_over(worst, cm, pmesh.CHAIN_AXIS)
        mean = pmesh.sum_over(mean * (C // P), cm, pmesh.CHAIN_AXIS) / C
        dt = float(pmesh.max_over(
            torch.tensor(dt, dtype=torch.float64, device=device), cm,
            pmesh.CHAIN_AXIS))
    worst, mean = float(worst), float(mean)
    res = dict(chains=C, seconds=dt, evals_per_s=2 * C / dt, worst=worst,
               mean=mean)
    if distributed.rank() == 0:
        print(f"NGG workload: {C} chains on {P} device(s) ({device}): "
              f"{2 * C / dt:.3g} saddle-evals/s; u-vs-g agreement "
              f"max {worst:.2e} mean {mean:.2e}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(res, f)
    if not worst < AGREE:
        raise SystemExit(f"ngg_torch: saddle representations disagree: "
                         f"max {worst:.3g} >= {AGREE}")
    return res


if __name__ == "__main__":
    main()
