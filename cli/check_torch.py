#!/usr/bin/env python
"""Multi-sampler comparison -- the test/check.c analog, on the PyTorch/CUDA
port: cli/check.py's flags plus --device (default cuda).

Runs the sampler variants (SA / HSA / TI / CT / CTW) on the same
generated data with repeats, reporting run-averaged posterior statistics
+- stderr and wall time (check.c:663-1130 methodology).  Agreement of
posterior means across mathematically equivalent samplers is the
correctness criterion.  SA is the explicit-seating host oracle
(check.c:716-765; libstb_tpu_torch/models/sa.py), run on the host at
small scale only; the others run on ``--device`` on a discount grid.

check.c parity covered here: the 5 sampler types (check.c:98), the 4
base-distribution types (check.c:88-89 via --base), ms-bounded burn-in /
cycle budgets ('-C 500ms' / '-B 100ms', check.c:380-393), hyper-sampling
cycles (-H / -I), ARS vs slice for the hyper steps (-A, check.c:283),
and repeat runs with run-averaged means +- stderr (check.c:1098-1130).

Tables and samplers are configured through utils.config
(TableConfig/SamplerConfig; env-overridable via LIBSTB_*).

  python cli/check_torch.py -C 300 -R 2 --samplers SA,TI,CT,CTW,HSA
  python cli/check_torch.py -C 500ms -B 100ms
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _ms_arg(val, name="-C", allow_zero=True):
    """check.c's '-C 200' vs '-C 200ms' convention."""
    s = str(val)
    if s.endswith("ms"):
        ms = float(s[:-2])
        if ms <= 0:
            raise SystemExit(f"check: {name} {s}: budget must be > 0")
        return None, ms
    n = int(s)
    if n < 0 or (n == 0 and not allow_zero):
        raise SystemExit(f"check: {name} {s}: count must be positive")
    return n, None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", type=float, default=0.5)
    p.add_argument("-b", type=float, default=10.0)
    p.add_argument("-A", action="store_true", help="ARS kernel for a,b")
    p.add_argument("-C", default="300",
                   help="cycles per run; 'Nms' = wall-clock budget")
    p.add_argument("-B", default="0",
                   help="burnin; 'Nms' = wall-clock budget")
    p.add_argument("-H", dest="bcycle", type=int, default=0,
                   help="cycles between b samples")
    p.add_argument("-I", dest="acycle", type=int, default=0,
                   help="cycles between a samples")
    p.add_argument("-N", type=int, default=40, help="samples per group")
    p.add_argument("-R", type=int, default=4, help="repeat runs")
    p.add_argument("-s", type=int, default=0)
    p.add_argument("-w", type=int, default=10, help="CTW window")
    p.add_argument("-c", dest="maxrel", type=float, default=0.0,
                   help="bound t sampling when the weight ratio drops "
                        "(check.c:289; 0 = off, ref default 1e30)")
    p.add_argument("-p", dest="printmean", type=int, default=0,
                   help="print running mean T/a/b every repcyc cycles "
                        "(check.c:996-1010)")
    p.add_argument("-v", action="store_true",
                   help="per-category mean-t report (check.c:1135-1137)")
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--dim", type=int, default=20)
    p.add_argument("--base", default="uniform",
                   choices=["uniform", "linear", "slowlinear", "dirichlet"])
    p.add_argument("--samplers", default="TI,CT,CTW,HSA")
    p.add_argument("--device", default="cuda",
                   help="torch device the grid and chains live on")
    args = p.parse_args(argv)

    import torch

    from libstb_tpu_torch.core import agrid
    from libstb_tpu_torch.core import rng as trng
    from libstb_tpu_torch.models import driver, pyp, sa
    from libstb_tpu_torch.samplers import hyper
    from libstb_tpu_torch.utils import config

    device = torch.device(args.device)

    tcfg = config.from_env(config.TableConfig)
    scfg = config.from_env(config.SamplerConfig)
    kernel = "ars" if args.A else scfg.kernel

    H = pyp.base_distribution(args.base, args.dim, args.b,
                              np.random.default_rng(args.s))
    data = pyp.crp_generate(args.s, 1, args.dim, args.N, args.a, args.b,
                            H=H)
    T_true = int((data.n > 0).sum())
    iters, iter_ms = _ms_arg(args.C, "-C", allow_zero=False)
    burnin, burnin_ms = _ms_arg(args.B, "-B")
    print(f"data: N={args.N} dim={args.dim} a={args.a} b={args.b} "
          f"base={args.base} T_init={T_true} "
          f"device={device} kernel={kernel}")

    n_req, m_req = agrid.required_dims(data.n)
    grid = agrid.make_grid(max(n_req, tcfg.init_n), max(m_req, tcfg.init_m),
                           g=tcfg.grid_points, a_lo=tcfg.a_lo,
                           a_hi=tcfg.a_hi,
                           build_s=tcfg.build_s, build_v=tcfg.build_v,
                           device=device, max_n=tcfg.max_n,
                           max_m=tcfg.max_m, use_asympt=tcfg.use_asympt)

    for name in args.samplers.split(","):
        name = name.strip().upper()
        Ts, bs, as_, secs = [], [], [], []
        for r in range(args.R):
            t0 = time.time()
            if name == "SA":
                if iter_ms or burnin_ms:
                    # wall-clock budget: time-bounded sweep loop (the SA
                    # analog of check.c's '-C Nms' mode)
                    rng = np.random.default_rng(args.s + r)
                    st = sa.sa_init(data)
                    tsum = np.zeros_like(st.T, np.float64)
                    kept = 0
                    done = 0
                    tstart = time.time()
                    while True:
                        sa.sa_sweep(rng, st, args.a, args.b)
                        done += 1
                        el = (time.time() - tstart) * 1e3
                        in_burn = (el <= burnin_ms if burnin_ms
                                   else done <= (burnin or 0))
                        if not in_burn:
                            tsum += st.T
                            kept += 1
                        if iter_ms and el > iter_ms:
                            break
                        if not iter_ms and done >= (iters or 300):
                            break
                    if kept == 0:
                        # budget exhausted inside burn-in: fall back to the
                        # last sweep's state (run_gibbs_timed does the same)
                        print("check: SA budget exhausted in burn-in; "
                              "reporting last-sweep T", file=sys.stderr)
                        tsum = st.T.astype(np.float64)
                        kept = 1
                    out = {"Tave": tsum / max(kept, 1),
                           "iters_done": done,
                           "elapsed_ms": (time.time() - tstart) * 1e3}
                else:
                    out = sa.sa_run(data, iters or 300, args.a, args.b,
                                    burnin=burnin or None, seed=args.s + r)
                Tm = float(out["Tave"].sum())
                am = bm = None     # SA never hyper-samples (check.c SA row)
            else:
                cfg = driver.GibbsConfig(
                    iters=iters or 300, burnin=burnin or 0,
                    sampler=name, window=args.w, scale=float(args.dim),
                    maxrel=args.maxrel,
                    bcycle=args.bcycle, acycle=args.acycle, kernel=kernel,
                    quit_on_bound=tcfg.quit_on_bound)
                prog = None
                if args.printmean and r == 0:
                    # check.c keeps running means for the first run only
                    # (check.c:1002 'if (redo==1)')
                    def prog(done, ms, rm):
                        print(f"    p: iter {done:5d} {ms:8.1f}ms "
                              f"E[T]={rm['Tave_mean']:.4f} "
                              f"E[a]={rm['aave_mean']:.4f} "
                              f"E[b]={rm['bave_mean']:.4f}")
                gen = trng.generator(args.s + 17 * r + 1, device)
                if (iter_ms or burnin_ms) or prog is not None:
                    out = driver.run_gibbs_timed(
                        gen, data, grid, args.chains, args.a, args.b, cfg,
                        iter_ms=iter_ms, burnin_ms=burnin_ms,
                        chunk=args.printmean or 16, progress=prog)
                else:
                    out = driver.run_gibbs(gen, data, grid, args.chains,
                                           args.a, args.b, cfg)
                Tm = float(out["Tave_mean"].sum())
                am = float(out["aave_mean"])
                bm = float(out["bave_mean"])
            secs.append(time.time() - t0)
            Ts.append(Tm); as_.append(am); bs.append(bm)
        Ts = np.asarray(Ts)
        se = Ts.std(ddof=1) / np.sqrt(len(Ts)) if len(Ts) > 1 else 0.0
        line = (f"  {name:4s}: E[T] = {Ts.mean():8.4f} +- {se:.4f}   "
                f"({np.mean(secs)*1e3:.0f} ms/run)")
        if args.acycle:
            line += ("  E[a]=-" if as_[0] is None
                     else f"  E[a]={np.mean(as_):.4f}")
        if args.bcycle:
            line += ("  E[b]=-" if bs[0] is None
                     else f"  E[b]={np.mean(bs):.4f}")
        if iter_ms:
            line += f"  [{out['iters_done']} iters in {out['elapsed_ms']:.0f}ms]"
        print(line)
        if args.v and name != "SA":
            # per-category mean t (check.c:1135-1137 prints taveave[i])
            tm = out["tave_mean"].reshape(-1).tolist()
            print("    t-ave:", " ".join(f"{v:.3f}" for v in tm))
        if kernel == "ars" and args.bcycle and name != "SA":
            # ARS efficiency telemetry (arms.c neval, BASELINE.md row 8):
            # one diagnostic b-step from the final state
            b_out = out["b"]
            _, _, nev = hyper.sample_b(
                trng.generator(99, device), b_out,
                torch.as_tensor(data.N[:1], dtype=b_out.dtype, device=device),
                out["T"][:, :1].to(b_out.dtype), out["a"], 1.1,
                float(args.dim), kernel="ars", with_info=True)
            print(f"    ARS neval/call: mean {nev.double().mean():.1f} "
                  f"max {int(nev.max())}")


if __name__ == "__main__":
    main()
