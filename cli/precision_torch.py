#!/usr/bin/env python
"""Precision comparison -- the test/precision_test.c analog, on the
PyTorch/CUDA port: cli/precision.py's flags plus --device (default cuda).

Fills the last row of the same table four ways -- {f32, f64} x {log
recursion, ratio recursion} -- and prints each one's largest error against
ratio/f64 and its time, showing the reference's conclusion that the ratio
recursion is far more accurate in float (precision_test.c:10-13).

The log recursion (stable.c:380-387) is written inline here, as the JAX
CLI writes it: the library ships only the ratio form.  The ratio recursion
is the port's ``stirling.fill_rows``, the counterpart of the XLA function
the JAX CLI calls.  The recursion itself is what this program
demonstrates, so it runs the recursion as PyTorch operations on --device;
it is not a stand-in for the hand-written fill kernels (K1-K3), which
``stirling.make`` and ``agrid.make_grid`` launch on a card.

  python cli/precision_torch.py -N 10000 -M 4000
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.5)
    p.add_argument("-N", type=int, default=10000)
    p.add_argument("-M", type=int, default=4000, help="columns")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from libstb_tpu_torch.core import stirling

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("precision_torch: --device cuda but no CUDA device")
    N, M, a = args.N, min(args.M, args.N), args.a

    def log_fill(dtype):
        """The reference's log-space recurrence (stable.c:380-387)."""
        mvec = torch.arange(1, M + 1, dtype=dtype, device=device)
        head = torch.full((1,), -torch.inf, dtype=dtype, device=device)
        # log(n - 1 - a) for n = 2..N, in the fill's dtype
        first = torch.log(torch.arange(2, N + 1, dtype=dtype, device=device)
                          - 1.0 - a)

        def run():
            row = torch.where(mvec == 1.0, 0.0, -torch.inf).to(dtype)
            for n in range(2, N + 1):
                coef = torch.log(torch.clamp(n - 1.0 - mvec * a, min=1e-30))
                shifted = torch.cat([head, row[:-1]])
                new = torch.logaddexp(shifted, coef + row)
                row = torch.where(mvec == 1.0, row[0] + first[n - 2], new)
            return row
        return run

    def ratio_fill(dtype):
        s1 = torch.tensor(stirling.s1_host(a, N)[-1], dtype=dtype,
                          device=device)

        def run():
            _, srel, _ = stirling.fill_rows(a, N, M, dtype=dtype,
                                            device=device)
            return srel[-1] + s1
        return run

    runs = {
        "log/f64": log_fill(torch.float64),
        "log/f32": log_fill(torch.float32),
        "ratio/f64": ratio_fill(torch.float64),
        "ratio/f32": ratio_fill(torch.float32),
    }
    rows, times = {}, {}
    for name, fn in runs.items():
        fn()                                   # warm: allocator, lazy init
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = (time.perf_counter() - t0) * 1e3
        rows[name] = out.double().cpu().numpy()

    ref = rows["ratio/f64"]
    fin = np.isfinite(ref)
    errs = {name: float(np.max(np.abs(rows[name][fin] - ref[fin])))
            for name in runs}
    print(f"log S(N={N}, m; a={a}) final row, per-variant "
          f"max |err| vs ratio/f64 and time (device {device}):")
    for name in runs:
        print(f"  {name:10s}: max|err| = {errs[name]:10.4g}   "
              f"fill = {times[name]:8.1f} ms")
    print("\nconclusion check (precision_test.c:10-13): "
          "ratio/f32 error should be orders of magnitude below log/f32.")
    return dict(errors=errs, ms=times)


if __name__ == "__main__":
    main()
