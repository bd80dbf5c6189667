#!/usr/bin/env python
"""Probes of the port's check.c sweeps (libstb_tpu_torch/models/pyp.py).

  ops      the operations one sweep issues, by sampler, at chip_smoke.py
           phase 11's size (cli/check.py's data, 256 chains, a g = 96
           grid): device kernels on a CUDA device, top-level aten ops on
           the CPU;
  replay   one relative-window CTW sweep at check.c scale (phase 12's
           data, 32 chains) in f32 on an f32 table and in f64 on an f64
           table under the same f32 Gumbels, in --states successive
           states: the chains whose integer state differs, with the
           sweep's window-sum product term and with the JAX sweep's
           lgamma difference (--product);
  moments  run_gibbs with --sampler at phase 11's configuration for each
           of --seeds: E[T], E[a], E[b] and their MC-SE over --chains
           chains (the spread behind phase 11's chain count).

Usage:  python tools/sweep_probe_torch.py ops|replay|moments [--device cpu]
"""
import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHECK_REF = os.path.join(ROOT, "tests", "data", "torch_check_ref.json")


def lgamma_product(base, tts, log_ha):
    """The JAX sweep's product term, (tt - 1) log(H a) + lgamma(base + tt)
    - lgamma(base + 1) (libstb_tpu/models/pyp.ctw_sweep_rel)."""
    mm = (tts - 1).to(base.dtype)
    return (mm * log_ha[:, None] + torch.lgamma(base[:, None] + mm + 1.0)
            - torch.lgamma(base[:, None] + 1.0))


def count_ops(fn, device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    if device.type == "cuda":
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    return sum(1 for e in aten if e.cpu_parent is None
               or not e.cpu_parent.name.startswith("aten::"))


def ops(args, device):
    from libstb_tpu_torch.core import agrid, rng
    from libstb_tpu_torch.models import pyp

    ref = json.load(open(CHECK_REF))
    C = ref["chains"]
    gen = rng.generator(0, device)
    a = torch.full((C,), 0.5, device=device)
    b = torch.full((C,), 10.0, device=device)
    counts = collections.OrderedDict()
    for sampler, r in ref["samplers"].items():
        data = pyp.crp_generate(r["seed"], *ref["data_args"])
        n_max = max(int(data.N.max()) + 2, 16)
        grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], device=device)
        t, T = pyp.init_state(data, C, device)
        tmax = int(data.n.max()) + 1
        if sampler == "HSA":
            h, hT = pyp.init_hsa(data, C, device)
            fn = lambda: pyp.hsa_sweep(gen, h, hT, a, b, data)  # noqa: E731
            per = ("an item", data.data_cat.size)
        else:
            w = ref["config"]["window"] if sampler == "CTW" else None
            fn = lambda: pyp.ct_sweep(gen, t, T, a, b, grid, data,  # noqa
                                      tmax, window=w)
            per = ("a category", data.n.shape[1])
        fn()
        n = count_ops(fn, device)
        counts[sampler] = n
        print(f"{sampler}: {n} ops a sweep = {n / per[1]:.1f} {per[0]} "
              f"({C} chains, device {device})")
    return counts


def replay(args, device):
    from libstb_tpu_torch.core import rng, stirling
    from libstb_tpu_torch.models import pyp

    if args.product == "lgamma":
        pyp._window_product = lgamma_product
    data = pyp.crp_generate(1, 100, 20, 1000, 0.5, 10.0)
    J, D = data.n.shape
    n_max = int(data.n.max()) + 2
    m_max = min(n_max, 1024)
    cpu = torch.device("cpu")
    t32 = stirling.make(n_max, m_max, n_max + 64, m_max + 64, 0.5,
                        use_asympt=True, device=device)
    t64 = stirling.make(n_max, m_max, n_max + 64, m_max + 64, 0.5,
                        use_asympt=True, dtype=torch.float64, device=cpu)
    C, w = 32, 10
    gen = rng.generator(0, cpu)
    a64 = torch.full((C,), 0.5, dtype=torch.float64)
    b64 = torch.full((C,), 10.0, dtype=torch.float64)
    m64 = pyp.ctw_m_sel(t64, data, window=w)
    t, T = pyp.init_state(data, C, cpu)
    for _ in range(2):
        t, T = pyp.ctw_sweep_rel(gen, t, T, a64, b64, t64, data, window=w,
                                 m_sel=m64)
    diffs = []
    for _ in range(args.states):
        t, T = pyp.ctw_sweep_rel(gen, t, T, a64, b64, t64, data, window=w,
                                 m_sel=m64)
        g = [rng.gumbel(gen, (D, C * J, 2 * w + 1), torch.float32,
                        cpu).numpy()]
        r32 = pyp.ctw_sweep_rel(rng.Replay(g), t.to(device), T.to(device),
                                a64.float().to(device),
                                b64.float().to(device), t32, data, window=w,
                                m_sel=pyp.ctw_m_sel(t32, data, window=w))
        r64 = pyp.ctw_sweep_rel(rng.Replay(g), t, T, a64, b64, t64, data,
                                window=w, m_sel=m64)
        diffs.append(int((r32[0].cpu() != r64[0]).flatten(1).any(1).sum()))
    print(f"CTW rel, {args.product} product term, f32 on {device} vs f64: "
          f"chains that differ in each of {args.states} states: {diffs} "
          f"of {C}")
    return diffs


def moments(args, device):
    from libstb_tpu_torch.core import agrid, rng
    from libstb_tpu_torch.models import driver, pyp

    ref = json.load(open(CHECK_REF))
    r = ref["samplers"][args.sampler]
    data = pyp.crp_generate(r["seed"], *ref["data_args"])
    n_max = max(int(data.N.max()) + 2, 16)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], dtype=dtype,
                           device=device)
    cfg = driver.GibbsConfig(sampler=args.sampler, **ref["config"])
    for seed in args.seeds:
        out = driver.run_gibbs(rng.generator(seed, device), data, grid,
                               args.chains, ref["a0"], ref["b0"], cfg)
        line = []
        for k in ("Tave", "aave", "bave"):
            v = out[k].double().reshape(args.chains, -1).sum(-1).cpu().numpy()
            line.append(f"E[{k[0]}] {v.mean():.4f} +- "
                        f"{v.std(ddof=1) / np.sqrt(len(v)):.4f}")
        print(f"{args.sampler} {args.dtype} seed {seed}, {args.chains} "
              f"chains: {', '.join(line)} ({device})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["ops", "replay", "moments"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--states", type=int, default=5)
    ap.add_argument("--product", choices=["window", "lgamma"],
                    default="window")
    ap.add_argument("--sampler", default="CTW", choices=["CT", "CTW", "HSA"])
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    return {"ops": ops, "replay": replay, "moments": moments}[args.mode](
        args, device)


if __name__ == "__main__":
    main()
