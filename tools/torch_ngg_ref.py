#!/usr/bin/env python
"""Write the JAX f64 reference values of the NGG subsystem that the
PyTorch port is held to on the card (chip_smoke.py phase 15a), and the
cancellation bounds of its tables.

Runs the JAX package's core.ngg on the CPU in float64 at the reference's
a = 0.1, M = 10 (ngg_test.c:506): ngg_table(16, 10); ngg_ratio_table by
the recurrence at (16, 10) and by quadrature at (200, 10); the five
saddle points and ngg_quadrature_log at cli/ngg.py's table-mode (n, k)
grid and at 256 (N, K) points drawn as its --chains workload draws them
(numpy seed 0, cli/ngg.py:84-85).  Writes them to
tests/data/torch_ngg_ref.json.

Tolerances (tests/test_torch_ngg.py states the same): the saddle points
and quadrature to rtol 1e-10 (the same arithmetic); the table and the
recurrence ratio table cell by cell to KAPPA_ULPS x 2^-52 x (kappa +
|S|) (the ratios relatively: x rho), kappa and rho the first-order
condition numbers of the cells (``table_kappa``,
``ratio_kappa``): the alternating sum of the K=1 row cancels (test_ngg.py:
at a = 0.1 it loses ~12 digits by (16, 10)), and the log-difference /
rational recursions carry and amplify that, so a rounding of one exp or
lgamma grows by kappa in either package.

Usage:  python tools/torch_ngg_ref.py [--out PATH]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from scipy.special import gammaln

A, M = 0.1, 10.0
TABLE = (16, 10)              # the reference's MAXN, cli/ngg.py's -N / -K
RATIO_QUAD = (200, 10)        # cli/ngg.py's large-n quadrature table
WORKLOAD_POINTS, WORKLOAD_SEED = 256, 0
SADDLES = ("umax_log", "smax_log", "hmax_log", "hmax2_log", "gmax_log",
           "ngg_quadrature_log")
KAPPA_ULPS = 16       # the CPU parity runs reach ~2 (tests/test_torch_ngg.py)
EPS = 2.0 ** -52


def cli_points(N=16, K=10, step=2):
    """cli/ngg.py's table-mode (n, k) grid."""
    return [(n, k) for n in range(1, N, step)
            for k in range(1, min(n, K - 1) + 1, step)]


def workload_points(n=WORKLOAD_POINTS, seed=WORKLOAD_SEED):
    """(N, K) drawn as cli/ngg.py's --chains workload draws them."""
    r = np.random.default_rng(seed)
    Ns = r.integers(50, 100000, n).astype(np.float64)
    Ks = np.maximum(1, Ns * r.uniform(0.005, 0.05, n)).astype(np.float64)
    return Ns, Ks


def table_kappa(a, m, N, K):
    """(kappa, S): the JAX table S (K, N) and each cell's first-order
    condition number in units of a relative rounding (0 on -inf cells).

    Row 1: sum_i |term_i| w_i / |sum_i term_i|, each term's relative
    error grown by the magnitudes of the logs it exponentiates (w_i = 1 +
    |log C| + |log G_i| + |log G_0|).  Rows 2..: the log-difference
    logdiff(x, y) carries d = (dx + w dy) / (1 - w), w = exp(y - x), plus
    one rounding."""
    import jax.numpy as jnp

    from libstb_tpu.core import ngg

    i = np.arange(N, dtype=np.float64)
    logG = np.asarray(ngg.log_gamma_inc_upper(jnp.asarray(1.0 - i / a),
                                              m)) + np.log(m) * i / a
    n = np.arange(1, N + 1.0)[:, None]
    logc = gammaln(n) - gammaln(i + 1) - gammaln(np.maximum(n - i, 1))
    term = np.where(i <= n - 1, np.exp(logc + logG - logG[0]), 0.0)
    sign = 1 - 2 * (i % 2)
    w_i = 1 + np.abs(logc) + np.abs(logG) + abs(logG[0])
    kap = [(term * w_i).sum(1) / np.abs((sign * term).sum(1))]
    S = np.asarray(ngg.ngg_table(a, m, N, K))
    nn = np.arange(1, N + 1.0)
    for k in range(2, K + 1):
        prev = kap[-1]
        lhs = (np.log(np.maximum((nn - 1) / a, 1e-300))
               + np.concatenate([[-np.inf], S[k - 2][:-1]]))
        rhs = np.log(np.maximum((nn - 1) / a - (k - 1), 1e-300)) + S[k - 2]
        with np.errstate(all="ignore"):
            w = np.exp(rhs - lhs)
            e = (np.concatenate([[0.0], prev[:-1]]) + w * prev) / (1 - w) + 1
        kap.append(np.where(nn >= k, e, 0.0))
    return np.stack(kap), S


def ratio_kappa(a, m, N, K):
    """(rho, R): the JAX recurrence ratio table R (K, N-1) and each cell's
    relative condition number in units of a rounding (0 where R is 0):
    R[1][n] = exp(S[1][n+1] - S[1][n]) from the base row's kappa, then
    new = numer / denom carries |n/a - k| |R| rho / |numer| + (n-1)/a
    rho' / (|R'| |denom|) (R' the shifted row) plus two roundings."""
    from libstb_tpu.core import ngg

    kap, _ = table_kappa(a, m, N, 1)
    R = np.asarray(ngg.ngg_ratio_table(a, m, N, K, method="recurrence"))
    n = np.arange(1, N, dtype=np.float64)
    rel = [kap[0][1:] + kap[0][:-1] + 1]
    for k in range(1, K):
        prev, prevR = rel[-1], R[k - 1]
        shR = np.concatenate([[1.0], prevR[:-1]])
        shE = np.concatenate([[0.0], prev[:-1]])
        with np.errstate(all="ignore"):
            numer = n / a - (n / a - k) * prevR
            denom = k + (1.0 / shR - 1.0) * (n - 1.0) / a
            e = (np.abs(n / a - k) * np.abs(prevR) * prev / np.abs(numer)
                 + (n - 1.0) / a * shE / np.abs(shR) / np.abs(denom) + 2)
        rel.append(np.where(n >= k + 1.0, e, 0.0))
    return np.stack(rel), R


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data",
        "torch_ngg_ref.json"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from libstb_tpu.core import ngg

    kap, S = table_kappa(A, M, *TABLE)
    rho, R = ratio_kappa(A, M, *TABLE)
    Rq = np.asarray(ngg.ngg_ratio_table(A, M, *RATIO_QUAD,
                                        method="quadrature"))
    points = {}
    cn, ck = (np.array(v, np.float64) for v in zip(*cli_points()))
    for name, (Ns, Ks) in (("cli", (cn, ck)), ("workload",
                                                workload_points())):
        a = jnp.full(Ns.shape, A)
        m = jnp.full(Ns.shape, M)
        points[name] = dict(N=Ns.tolist(), K=Ks.tolist(), **{
            fn: np.asarray(getattr(ngg, fn)(a, m, jnp.asarray(Ns),
                                            jnp.asarray(Ks))).tolist()
            for fn in SADDLES})
    ref = dict(
        source="libstb_tpu core.ngg, CPU float64 (python "
               "tools/torch_ngg_ref.py; workload points numpy seed "
               f"{WORKLOAD_SEED}, {WORKLOAD_POINTS} points)",
        a=A, M=M, kappa_ulps=KAPPA_ULPS, rtol=1e-10,
        table=dict(shape=list(TABLE), S=S.tolist(), kappa=kap.tolist()),
        ratio_recurrence=dict(shape=list(TABLE), R=R.tolist(),
                              rho=rho.tolist()),
        ratio_quadrature=dict(shape=list(RATIO_QUAD), R=Rq.tolist()),
        points=points)
    with open(args.out, "w") as f:
        json.dump(ref, f)
        f.write("\n")
    print(f"wrote {args.out}: table {TABLE}, ratio tables, "
          f"{len(cn)} + {WORKLOAD_POINTS} saddle points")


if __name__ == "__main__":
    main()
