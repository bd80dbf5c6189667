"""Exact posterior moments of the Pitman-Yor model that the Gibbs cells
sample, in plain f64 numpy.

The model (upstream libstb test/demo.c with every group in the
concentration move): J groups share a discount a and a concentration b;
group j seats n_jk customers of category k at t_jk tables,

    p(t, a, b | n) ~ p(a) p(b) prod_j (b|a)_{T_j} / (b)_{N_j}
                     prod_k S(n_jk, t_jk; a) H_k^{t_jk},

with T_j = sum_k t_jk, (b|a)_T = prod_{i<T} (b + i a), (b)_N the rising
factorial, S the generalised Stirling numbers (S(n+1, t) = S(n, t-1) +
(n - t a) S(n, t), S(1, 1) = 1), p(a) uniform on [a_lo, a_hi] and p(b)
a Gamma(shape, scale) density on [b_lo, b_hi].  Given (a, b) the groups
are independent and T_j carries all the coupling, so the table counts
sum out exactly: the per-category weights are convolved into a
distribution over T_j.  (a, b) is integrated on a grid: uniform in a,
uniform in log b.

The marginal distributions of a and of log b are returned too, as
their CDFs on the grid's nodes (the density integrated by the trapezoid
rule), and ``ks_distance`` reads the Kolmogorov distance between a sample
and such a CDF.

Nothing here comes from the program: the counts are the benchmark's own
(datagen.crp_generate), the Stirling numbers are filled here in f64.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln, logsumexp

__all__ = ["log_stirling", "group_weights", "posterior_moments",
           "ks_distance"]


def log_stirling(avec: np.ndarray, n_max: int) -> np.ndarray:
    """(A, n_max + 1, n_max + 1) log S(n, t; a) for 0 <= t <= n <= n_max
    (-inf elsewhere; S(0, 0) = 1), by the row recurrence in log space."""
    A = len(avec)
    L = np.full((A, n_max + 1, n_max + 1), -np.inf)
    L[:, 0, 0] = 0.0
    t = np.arange(n_max + 1, dtype=np.float64)
    for n in range(n_max):
        prev = L[:, n]
        shift = np.concatenate([np.full((A, 1), -np.inf), prev[:, :-1]],
                               axis=1)
        c = n - t[None, :] * avec[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            keep = np.where(c > 0, np.log(np.where(c > 0, c, 1.0)) + prev,
                            -np.inf)
        L[:, n + 1] = np.logaddexp(shift, keep)
    return L


def group_weights(L: np.ndarray, n_j: np.ndarray, H: np.ndarray):
    """(A, N_j + 1) log sum over the tables of group j with T_j = T of
    prod_k S(n_jk, t_jk; a) H_k^t_jk: the per-category weights (t from 1
    to n_jk, or only t = 0 where n_jk = 0) convolved over k."""
    A = L.shape[0]
    out = np.zeros((A, 1))                       # log 1 at T = 0
    for k in np.nonzero(n_j)[0]:
        nk = int(n_j[k])
        w = L[:, nk, : nk + 1] + np.arange(nk + 1) * np.log(H[k])
        w[:, 0] = -np.inf                        # S(n, 0) = 0 for n >= 1
        s1 = out.max(axis=1, keepdims=True)
        s2 = w.max(axis=1, keepdims=True)
        x, y = np.exp(out - s1), np.exp(w - s2)
        conv = np.zeros((A, x.shape[1] + nk))
        for q in range(1, nk + 1):
            conv[:, q:q + x.shape[1]] += x * y[:, q:q + 1]
        with np.errstate(divide="ignore"):
            out = np.log(conv) + s1 + s2
    return out


def posterior_moments(n: np.ndarray, H: np.ndarray, *, a_lo: float,
                      a_hi: float, b_lo: float, b_hi: float, shape: float,
                      scale: float, a_points: int = 195,
                      b_points: int = 300) -> dict:
    """E[a], E[b] and E[T_j] under the model above, for counts ``n``
    (J, D) and base ``H`` (D,); and the marginal CDFs of a and of log b
    on the grid's nodes (``a_grid``, ``a_cdf``, ``logb_grid``,
    ``logb_cdf``)."""
    n = np.asarray(n, np.int64)
    J = n.shape[0]
    N = n.sum(axis=1)
    avec = np.linspace(a_lo, a_hi, a_points)
    lb = np.linspace(np.log(b_lo), np.log(b_hi), b_points)
    bvec = np.exp(lb)
    L = log_stirling(avec, int(n.max()))
    W = [group_weights(L, n[j], H) for j in range(J)]
    # log prior of b in log-b coordinates (the Jacobian b included)
    lpb = (shape - 1.0) * lb - bvec / scale + lb
    lpost = np.empty((a_points, b_points))
    ET = np.empty((J, a_points, b_points))
    for ia, a in enumerate(avec):
        acc = lpb.copy()
        for j in range(J):
            T = np.arange(W[j].shape[1], dtype=np.float64)
            # log (b|a)_T = sum_{i<T} log(b + i a)
            lr = np.concatenate(
                [np.zeros((b_points, 1)),
                 np.cumsum(np.log(bvec[:, None] + T[None, :-1] * a),
                           axis=1)], axis=1)
            lt = W[j][ia][None, :] + lr                    # (B, T)
            lz = logsumexp(lt, axis=1)
            ET[j, ia] = np.exp(logsumexp(lt, axis=1, b=T[None, :]) - lz)
            acc += lz - (gammaln(bvec + N[j]) - gammaln(bvec))
        lpost[ia] = acc
    # trapezoid weights on both axes
    wa = np.full(a_points, avec[1] - avec[0])
    wa[[0, -1]] *= 0.5
    wb = np.full(b_points, lb[1] - lb[0])
    wb[[0, -1]] *= 0.5
    lw = lpost + np.log(wa)[:, None] + np.log(wb)[None, :]
    p = np.exp(lw - lw.max())
    p /= p.sum()
    # the marginal densities at the nodes (the other axis integrated by
    # the trapezoid rule), integrated again into CDFs
    dens = np.exp(lpost - lpost.max())
    return dict(a=float((p * avec[:, None]).sum()),
                b=float((p * bvec[None, :]).sum()),
                T=[float((p * ET[j]).sum()) for j in range(J)],
                a_grid=avec, a_cdf=_cdf(avec, dens @ wb),
                logb_grid=lb, logb_cdf=_cdf(lb, wa @ dens))


def _cdf(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The CDF at the nodes ``x`` of the density ``f`` given there, by the
    trapezoid rule, normalised to end at 1."""
    c = np.concatenate([[0.0], np.cumsum(np.diff(x) * (f[1:] + f[:-1])
                                         / 2.0)])
    return c / c[-1]


def ks_distance(sample, grid: np.ndarray, cdf: np.ndarray) -> float:
    """sup_x |F_sample(x) - F(x)|, F linear between the nodes of ``grid``
    (0 below it, 1 above it)."""
    x = np.sort(np.asarray(sample, np.float64))
    n = len(x)
    F = np.interp(x, grid, cdf, left=0.0, right=1.0)
    i = np.arange(n, dtype=np.float64)
    return float(np.maximum(np.max((i + 1) / n - F), np.max(F - i / n)))
