#!/usr/bin/env python
"""The two discount routes of the port against the exact posterior mean.

``hyper.sample_a`` (the grid curve) and ``hyper.sample_a_m`` (the table
configuration, then the table-free posterior) are two samplers for one
posterior over the discount a.  On the workload of
tests/test_samplea_m.py (16 pairs, n in 2..24, t = max(1, 0.4 n), b = 5)
that posterior is one-dimensional, so its mean is also a plain quadrature
of exp(conc_terms(a) + curve(a)) over [A_MIN, A_MAX].  This script prints
the quadrature mean and each route's mean over many chains with its
standard error, in f64, on --device (default cuda):

  python tools/config_route_check_torch.py --chains 512 --steps 60

The tests hold the routes to each other at 64 chains within 3 SE + 0.01,
which a difference of ~0.03 passes; this script is the sharper reading.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chains", type=int, default=512)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--burn", type=int, default=20,
                   help="moves dropped before the mean is taken")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("config_route_check_torch: --device cuda but no "
                         "CUDA device")

    from libstb_tpu_torch.core import agrid, rng
    from libstb_tpu_torch.samplers import hyper

    dt, dev = torch.float64, torch.device(args.device)
    r = np.random.default_rng(3)
    C, P = args.chains, 16
    ns_h = r.integers(2, 25, P)
    ts_h = np.maximum(1, (ns_h * 0.4).astype(np.int64))
    ns = torch.as_tensor(ns_h, device=dev)
    ts = torch.as_tensor(ts_h, device=dev)
    T = torch.full((C, 1), float(ts_h.sum()), dtype=dt, device=dev)
    b = torch.full((C, 1), 5.0, dtype=dt, device=dev)
    grid = agrid.make_grid(64, 12, g=64, dtype=dt, device=dev)

    x = torch.linspace(hyper.A_MIN, hyper.A_MAX, 20001, dtype=dt, device=dev)
    curve = grid.data_curve(ns, ts).expand(x.shape + (grid.g_max,))
    logp = hyper._conc_terms(x, T[:1], b[:1]) + grid.curve_at(curve, x)
    w = torch.exp(logp - logp.max())
    print(f"quadrature: E[a] = {float((w * x).sum() / w.sum()):.5f}")

    def run(name, seed, move):
        gen = rng.generator(seed, dev)
        a = torch.full((C,), 0.5, dtype=dt, device=dev)
        acc = torch.zeros_like(a)
        for s in range(args.steps):
            a = move(gen, a)
            if s >= args.burn:
                acc += a
        m = (acc / (args.steps - args.burn)).cpu().numpy()
        print(f"{name}: E[a] = {m.mean():.5f} +- "
              f"{m.std(ddof=1) / np.sqrt(C):.5f} ({C} chains, moves "
              f"{args.burn + 1}..{args.steps})")

    run("sample_a (grid route)", 10,
        lambda gen, a: hyper.sample_a(gen, a, grid, ns, ts, T, b)[0])
    nsb, tsb = ns.expand(C, P), ts.expand(C, P)
    run("sample_a_m (config route)", 20,
        lambda gen, a: hyper.sample_a_m(gen, a, grid, nsb, tsb, T, b,
                                        max_t=12, max_n=32)[0])


if __name__ == "__main__":
    main()
