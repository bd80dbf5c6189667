#!/usr/bin/env python
"""lgamma/digamma-difference micro-benchmark (seconds per element) of
libstb_tpu_torch.core.lgcache: the PyTorch/CUDA counterpart of
tools/lgcache_bench.py, itself the analogue of the reference's ``#ifdef
MAINTEST`` timing of its gammadiff/psidiff variants (lib/lgamma.c:242-310).

Each variant is evaluated on a (BATCH,) vector of (n, alpha) pairs, REPS
times in a chain (each rep adds the previous result, scaled far below an
ulp, to alpha, so no rep can be skipped); the time is the best of three
runs after a warm one, by CUDA events on a card (utils/metrics
.device_timer), and the table reports seconds per ELEMENT evaluation.

Variants (reference counterparts in lib/lgamma.c):
  gammadiff      lgamma difference with exact small-n products (:143-190)
  lgamma-raw     plain lgamma(n+alpha) - lgamma(alpha)
  psidiff        digamma difference with exact small-n sums (:194-240)
  digamma-raw    plain digamma(n+alpha) - digamma(alpha) (core/special)
  qval           S^{n+1}_2/S^{n+1}_1 closed form (qcache/qval, :78-114)
  gcache-gather  one gcache_table build (:30-52) per rep, amortised over
                 16 gathers of BATCH indices

Usage:  python tools/lgcache_bench_torch.py [--batch 1048576] [--reps 32]
        [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

GATHERS = 16                   # gathers a gcache_table build serves


def variants():
    from libstb_tpu_torch.core import lgcache, special

    return {
        "gammadiff": lambda n, al: lgcache.gammadiff(n, al),
        "lgamma-raw": lambda n, al: (torch.lgamma(n.to(al.dtype) + al)
                                     - torch.lgamma(al)),
        "psidiff": lambda n, al: lgcache.psidiff(n, al),
        "digamma-raw": lambda n, al: (special.digamma(n.to(al.dtype) + al)
                                      - special.digamma(al)),
        "qval": lambda n, al: lgcache.qval(al * 0.9, n),
    }


def run(device, card, batch=1 << 20, reps=32):
    """Print the table; returns {variant: seconds per element}."""
    from libstb_tpu_torch.core import lgcache
    from libstb_tpu_torch.utils import metrics

    device = torch.device(device)
    B, K = batch, reps
    rng = np.random.default_rng(0)
    alpha = torch.as_tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                            device=device)
    nvec = torch.as_tensor(rng.integers(1, 200, B), dtype=torch.int32,
                           device=device)
    jidx = torch.as_tensor(rng.integers(0, 100, B), device=device)

    def chained(fn):
        def go(alpha):
            c = torch.zeros((), dtype=alpha.dtype, device=device)
            for _ in range(K):
                c = fn(nvec, alpha + c * 1e-12).max() * 1e-20
            return c
        return go

    def gather_run(alpha):
        c = torch.zeros((), dtype=alpha.dtype, device=device)
        for _ in range(K):
            tab = lgcache.gcache_table(alpha[0] + c * 1e-12, 100)
            s = torch.zeros((), dtype=alpha.dtype, device=device)
            for _ in range(GATHERS):
                s = s + tab[(jidx + s.long()) % 100].max() * 1e-20
            c = s * 1e-3
        return c

    print(f"# lgcache micro-bench: device={device} [{card}], batch={B}, "
          f"reps={K} (lgamma.c:242-310 analogue)")
    print("| variant | sec/call | Gcalls/s |")
    print("|---|---|---|")
    rows = {}
    for name, fn in variants().items():
        rows[name] = metrics.device_timer(chained(fn), alpha) / (B * K)
        print(f"| {name} | {rows[name]:.4g} | {1e-9 / rows[name]:.3f} |")
    dt = metrics.device_timer(gather_run, alpha) / (B * K * GATHERS)
    rows["gcache-gather"] = dt
    print(f"| gcache-gather (x{GATHERS} reuse) | {dt:.4g} | "
          f"{1e-9 / dt:.3f} |", flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lgcache_bench_torch: --device cuda but no CUDA "
                         "device")
    from extra_bench_torch import card_label

    return run(device, card_label(device), args.batch, args.reps)


if __name__ == "__main__":
    main()
