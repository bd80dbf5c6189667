"""Generalized Stirling-like numbers for the Normalized Generalized Gamma
(NGG) process, in PyTorch.

Port of libstb_tpu/core/ngg.py (the capabilities of test/ngg_test.c and
test/ngg_integral.cpp):

* ``log_gamma_inc_upper`` -- log Gamma(s, x) for any real s by the
  Lentz-form continued fraction (ngg_test.c:38-76) at a fixed iteration
  count;
* ``ngg_base_row`` / ``ngg_table`` -- S[k][n] = log(Gamma(n)/a^{n-1}
  T^{n,k}_{a,M}): the K=1 row by the alternating binomial sum over
  incomplete gammas (ngg_test.c:128-247), rows 2.. by the cross-K
  log-difference recursion (ngg_test.c:249-292);
* ``ngg_ratio_table`` -- the Lambda1 ratio table (T_make / T_remake,
  ngg_test.c:442-499) by the rational recurrence in k or by quadrature;
  ``t_l1`` / ``t_l2`` read it;
* ``umax_log``, ``smax_log``, ``hmax_log``, ``hmax2_log``, ``gmax_log`` --
  the saddle-point approximations of the integral representations
  (vectorised Newton / fixed-point iterations with the reference's step
  safeguards), and ``ngg_quadrature_log``, the tanh-sinh oracle they are
  validated against.

Everything is f64 by default: a function computes in the dtype of its
first floating tensor argument, else in f64, on the device of its first
tensor argument, else on ``device``; a call with plain numbers and no
``device`` runs on the card (``parallel.distributed.local_device``) and
raises where there is none -- the CPU only when asked for.  The JAX package's ``fori_loop`` / ``scan`` bodies are fixed-count
Python loops over tensors here.  The table route cancels catastrophically
beyond n ~ 35 even in f64, which is why the reference caps MAXN at 16; the
scalable large-n path is the saddle point.
"""
from __future__ import annotations

import math

import torch

from ..parallel.distributed import local_device
from . import quadrature, special

__all__ = ["log_gamma_inc_upper", "ngg_base_row", "ngg_table",
           "ngg_ratio_table", "t_l1", "t_l2", "umax_log", "smax_log",
           "hmax_log", "hmax2_log", "gmax_log", "ngg_quadrature_log"]


def _floats(*xs, device=None):
    """The arguments as tensors of one float dtype on one device (see the
    module docstring)."""
    tens = [x for x in xs if isinstance(x, torch.Tensor)]
    floating = [x for x in tens if x.is_floating_point()]
    dtype = floating[0].dtype if floating else torch.float64
    dev = tens[0].device if tens else local_device(device)
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]


def log_gamma_inc_upper(s, x, iters: int = 400, *, device=None):
    """log Gamma(s, x) (upper), valid for any real s and x > 0.

    Lentz-evaluated continued fraction Gamma(s, x) = x^{s-1} e^{-x} F with
    ngg_test.c:54-60's terms: odd n: a_n = ((n-1)/2)/x, even n:
    a_n = (n/2 - s)/x.  Convergence needs x not too small relative to |s|;
    the NGG workloads use x = M >= 1."""
    s, x = _floats(s, x, device=device)
    small = 1e-30
    hn = torch.ones_like(s * x)
    Cn = torch.full_like(hn, 1e30)
    Dn = torch.ones_like(hn)
    for n in range(2, iters):
        an = 0.5 * (n - 1) / x if n % 2 == 1 else (0.5 * n - s) / x
        Dn = 1.0 + an * Dn
        Dn = torch.where(torch.abs(Dn) < small, small, Dn)
        Cn = 1.0 + an / Cn
        Cn = torch.where(torch.abs(Cn) < small, small, Cn)
        Dn = 1.0 / Dn
        hn = hn * Cn * Dn
    return torch.log(hn) + (s - 1.0) * torch.log(x) - x


def ngg_base_row(a: float, M: float, n_max: int, *, device=None):
    """S[1][n] for n = 1..n_max, (n_max,) f64:

    S[1][n] = log( sum_{i=0}^{n-1} (-1)^i C(n-1, i) G_i ) - M,
    G_i = Gamma(1 - i/a, M) M^{i/a} e^M   (ngg_test.c:136-146, 232-239),
    summed in f64 where the reference sums in long double."""
    device = local_device(device)
    i = torch.arange(n_max, dtype=torch.float64, device=device)
    Mt = torch.tensor(M, dtype=torch.float64, device=device)
    logG = log_gamma_inc_upper(1.0 - i / a, Mt) + torch.log(Mt) * i / a + M
    G = torch.exp(logG - logG[0])          # scale by G_0 for headroom
    nf = torch.arange(1, n_max + 1, dtype=torch.float64,
                      device=device)[:, None]
    logc = (torch.lgamma(nf) - torch.lgamma(i + 1.0)
            - torch.lgamma(torch.clamp(nf - i, min=1.0)))
    sign = 1.0 - 2.0 * (i % 2)
    term = torch.where(i <= nf - 1.0, sign * torch.exp(logc) * G, 0.0)
    return torch.log(torch.sum(term, dim=-1)) + logG[0] - M


def ngg_table(a: float, M: float, n_max: int, k_max: int, *, device=None):
    """Full table S[k][n], k = 1..k_max as rows, (k_max, n_max).

    Row 1 from ``ngg_base_row``; rows 2.. by the log-difference recursion
    (ngg_test.c:276-291).  Cells with k > n are -inf."""
    base = ngg_base_row(a, M, n_max, device=device)
    n = torch.arange(1, n_max + 1, dtype=base.dtype, device=base.device)
    head = torch.full((1,), -torch.inf, dtype=base.dtype, device=base.device)
    rows = [base]
    for k in range(2, k_max + 1):
        prev = rows[-1]
        # S[k][n] = logdiff(log((n-1)/a) + S[k-1][n-1],
        #                   log((n-1)/a - (k-1)) + S[k-1][n])
        shifted = torch.cat([head, prev[:-1]])
        lhs = torch.log(torch.clamp((n - 1.0) / a, min=1e-300)) + shifted
        rhs = torch.log(torch.clamp((n - 1.0) / a - (k - 1.0),
                                    min=1e-300)) + prev
        new = special.logdiff(lhs, rhs)
        rows.append(torch.where(n >= k, new, -torch.inf))
    return torch.stack(rows)


def ngg_ratio_table(a: float, M: float, n_max: int, k_max: int,
                    table=None, method: str = "auto", *, device=None):
    """Lambda1-ratio table R[k][n] = exp(S[k][n+1] - S[k][n]), (k_max,
    n_max - 1) with R[k][n] at [k-1, n-1], valid for n >= k (the T_remake
    capability, ngg_test.c:455-470).

    * "recurrence": the T recursion divided through by T[k][n],
        R[k+1][n] = ( n/a - (n/a - k) R[k][n] )
                    / ( k + (n-1)/a (1/R[k][n-1] - 1) ),
      seeded from the K=1 row (``table``, or ngg_table(a, M, n_max, 1)).
      Exact at small n, but each k-step amplifies the base error by ~n/a.
    * "quadrature": R[k][n] = exp(Q(n+1, k) - Q(n, k)) with Q the tanh-sinh
      integral (``ngg_quadrature_log``): stable at any (n, k).
    "auto" picks the recurrence for n_max <= 32, else quadrature."""
    if method == "auto":
        method = "recurrence" if n_max <= 32 else "quadrature"
    if method == "quadrature":
        device = local_device(device)
        n = torch.arange(1, n_max + 1, dtype=torch.float64, device=device)
        k = torch.arange(1, k_max + 1, dtype=torch.float64, device=device)
        nn, kk = torch.meshgrid(n, k, indexing="xy")    # (K, N)
        q = ngg_quadrature_log(torch.full_like(nn, a), torch.full_like(nn, M),
                               nn, kk)
        r = torch.exp(q[:, 1:] - q[:, :-1])
        return torch.where(nn[:, :-1] >= kk[:, :-1], r, 0.0)
    if table is None:
        table = ngg_table(a, M, n_max, 1, device=device)
    base = torch.exp(table[0][1:] - table[0][:-1])  # R[1][n], n=1..n_max-1
    n = torch.arange(1, n_max, dtype=base.dtype, device=base.device)
    one = torch.ones((1,), dtype=base.dtype, device=base.device)
    rows = [base]
    for k in range(1, k_max):
        prev = rows[-1]
        shifted = torch.cat([one, prev[:-1]])
        numer = n / a - (n / a - k) * prev
        denom = k + (1.0 / shifted - 1.0) * (n - 1.0) / a
        rows.append(torch.where(n >= k + 1.0, numer / denom, 0.0))
    return torch.stack(rows)


def t_l1(rtab, n, k):
    """Lambda1 ratio T[k][n+1]/T[k][n] from a ``ngg_ratio_table`` result
    (T_L1, ngg_test.c:484-490): R[k][n] lives at rtab[k-1, n-1]."""
    n = torch.as_tensor(n, device=rtab.device)
    k = torch.as_tensor(k, device=rtab.device)
    return rtab[k - 1, n - 1]


def t_l2(rtab, n, k, a):
    """Lambda2 ratio  1/R[k][n-1] + (k - n/a)  (T_L2, ngg_test.c:491-499),
    from the cross-k recursion divided through by T[k][n]; valid for
    n >= 2, n-1 >= k."""
    n = torch.as_tensor(n, device=rtab.device)
    k = torch.as_tensor(k, device=rtab.device)
    dt = rtab.dtype
    return 1.0 / rtab[k - 1, n - 2] + (k.to(dt) - n.to(dt) / a)


def _shape(*xs):
    return torch.broadcast_shapes(*(x.shape for x in xs))


def umax_log(a, M, N, K, iters: int = 40, *, device=None):
    """Saddle-point approximation of S[K][N] via the u-representation
    (ngg_test.c:372-416): Newton with the reference's +-2u step clamp.
    Returns log(Gamma(N)/a^{N-1} T^{N,K}) ~ the table value (the K log M -
    M shift of ngg_test.c:524 included)."""
    a, M, N, K = _floats(a, M, N, K, device=device)

    def dd_of(eu):
        return ((N - K * a) * eu / (1 + eu) ** 2
                + a * a * M * eu * torch.exp((a - 1.0) * torch.log1p(eu))
                + a * (1 - a) * M * eu * torch.exp((a - 2.0)
                                                   * torch.log1p(eu)))

    u = torch.full(_shape(a, M, N, K), 0.1, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        eu = torch.exp(u)
        delta = (N - K * a) * eu / (1 + eu) - N + a * M * eu \
            * torch.exp((a - 1.0) * torch.log1p(eu))
        step = delta / dd_of(eu)
        step = torch.clamp(step, -2.0 * torch.abs(u), 2.0 * torch.abs(u))
        u = u - step
    eu = torch.exp(u)
    sigma = dd_of(eu)
    return (0.5 * torch.log(2 * math.pi / sigma)
            - ((N - K * a) * torch.log1p(eu) - N * u
               - M * (1.0 - torch.exp(a * torch.log1p(eu))))
            + K * torch.log(M) - M + torch.log(a))


def smax_log(a, M, N, K, iters: int = 40, *, device=None):
    """Saddle point via the s = u/(1+u) representation (ngg_test.c:296-
    370); same normalisation as ``umax_log``."""
    a, M, N, K = _floats(a, M, N, K, device=device)

    def dd_of(s):
        omx = 1.0 - s
        return (-(N - 1) / s ** 2 + (1 + K * a) / omx ** 2
                - a * (1 + a) * M * torch.exp(-(2 + a) * torch.log(omx)))

    s = torch.full(_shape(a, M, N, K), 0.5, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        omx = 1.0 - s
        delta = (N - 1) / s + (1 + K * a) / omx \
            - a * M * torch.exp(-(1 + a) * torch.log(omx))
        step = torch.clamp(delta / (-dd_of(s)), -0.1, 0.1)
        s_new = s + step
        s_new = torch.where(s_new <= 0, s / 2, s_new)
        s = torch.where(s_new >= 1, s + (1 - s) / 2, s_new)
    omx = 1.0 - s
    sigma = -dd_of(s)
    return (0.5 * torch.log(2 * math.pi / sigma)
            + (N - 1) * torch.log(s) - (1 + K * a) * torch.log(omx)
            + M * (1.0 - torch.exp(-a * torch.log(omx)))
            + K * torch.log(M) - M + torch.log(a))


def _h(x, a, M, N, K):
    """h(x) = -(N-1) log x + (K a + 1) log(1-x) + M (1-x)^-a
    (ngg_integral.cpp:37-39): minus the log integrand of the [0,1]
    representation."""
    return (-(N - 1.0) * torch.log(x) + (K * a + 1.0) * torch.log1p(-x)
            + M * torch.exp(-a * torch.log1p(-x)))


def _ddh(x, a, M, N, K):
    omx = 1.0 - x
    return (-(K * a + 1.0) / omx / omx + (N - 1.0) / x / x
            + M * a * (1.0 + a) * torch.exp(-(2.0 + a) * torch.log(omx)))


def hmax_log(a, M, N, K, iters: int = 60, interror: float = 1e-10,
             with_bounds: bool = False, *, device=None):
    """Safeguarded-Newton maximizer of the [0,1] integral representation
    (``hmax``, ngg_integral.cpp:47-130): a Newton step where h'' > 0, else
    a halved remembered step in the descent direction, with the
    0.7-fraction boundary clamps.  Returns the Gaussian log-area 0.5
    log(2 pi / h'') - h(x*) + K log M + log a (ngg_integral.cpp:121); with
    ``with_bounds`` also x* and the (lo, hi) window where the integrand is
    within ``interror`` of its peak (ngg_integral.cpp:450)."""
    a, M, N, K = _floats(a, M, N, K, device=device)
    shape = _shape(a, M, N, K)

    def dh(x):
        omx = 1.0 - x
        return (-(N - 1.0) / x - (K * a + 1.0) / omx
                + M * a * torch.exp(-(1.0 + a) * torch.log(omx)))

    x = torch.full(shape, 0.5, dtype=a.dtype, device=a.device)
    olddelta = torch.full(shape, 0.1, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        delta = dh(x)
        dd = _ddh(x, a, M, N, K)
        # h'' <= 0: a (signed) remembered step, halved until it descends
        # (ngg_integral.cpp:63-94); one halving an iteration, the loop
        # re-checks
        fallback = torch.where(delta < 0, -torch.abs(olddelta),
                               torch.abs(olddelta))
        step = torch.where(dd > 0, delta / torch.where(dd > 0, dd, 1.0),
                           fallback)
        # boundary clamps: x - step must stay in (0, 1)
        step = torch.where(x - step <= 0, x * 0.7, step)
        step = torch.where(x - step >= 1, -(1.0 - x) * 0.7, step)
        worse = (dd <= 0) & (_h(x - step, a, M, N, K) >= _h(x, a, M, N, K))
        step = torch.where(worse, step / 2.0, step)
        x, olddelta = x - step, step * 0.9
    sigma = _ddh(x, a, M, N, K)
    logarea = (0.5 * torch.log(2 * math.pi / sigma) - _h(x, a, M, N, K)
               + K * torch.log(M) + torch.log(a))
    if not with_bounds:
        return logarea
    lo = torch.where(N > 1, x * torch.exp(math.log(interror) / (N - 1.0)),
                     0.0)
    hi = 1.0 - torch.exp(-torch.log(
        torch.exp(-a * torch.log1p(-x)) - math.log(interror) / M) / a)
    return logarea, x, lo, hi


def hmax2_log(a, M, N, K, iters: int = 50, *, device=None):
    """Fixed-point maximizer of the same representation (``hmax2``,
    ngg_integral.cpp:132-171), u <- 1 / (1 + (M a (1-u)^-a - 1 - K a) /
    (N - 1)), clamped to (0, 1) and damped by averaging.  The +log(a) term
    the reference's hmax2 omits is included, as the JAX package does, so
    the four approximations compare directly.  Returns NaN where the final
    point is not a genuine fixed point and maximum (outside the map's
    contraction domain, the small-K regime)."""
    a, M, N, K = _floats(a, M, N, K, device=device)

    def raw(u):
        return 1.0 / (1.0 + (M * a * torch.exp(-a * torch.log1p(-u))
                             - 1.0 - K * a) / torch.clamp(N - 1.0, min=1e-9))

    u = torch.full(_shape(a, M, N, K), 0.5, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        u = 0.5 * (u + torch.clamp(raw(u), 1e-9, 1.0 - 1e-9))
    resid = torch.abs(raw(u) - u)
    sigma = _ddh(u, a, M, N, K)
    area = (0.5 * torch.log(2 * math.pi / torch.abs(sigma))
            - _h(u, a, M, N, K) + K * torch.log(M) + torch.log(a))
    return torch.where((sigma > 0) & (resid < 1e-5 * (u + 1e-3)), area,
                       torch.nan)


def gmax_log(a, M, N, K, iters: int = 60, *, device=None):
    """Saddle point of the second integral representation, x = t - M over
    [0, inf) (``gmax``, ngg_integral.cpp:173-243): Newton in u = log x with
    the +-2u step clamp, started at u = log(max(N - M, 0.5)).

        g(x) = x - (K-1) log(1+x/M) - (N-1) log(1 - (1+x/M)^{-1/a})
        log area = 0.5 log(2 pi / sigma) - g + u + (K-1) log M - M,
        sigma = x^2 g'' + x g'."""
    a, M, N, K = _floats(a, M, N, K, device=device)
    shape = _shape(a, M, N, K)

    def g(x, pxm):
        return (x - (K - 1.0) * torch.log1p(x / M)
                - (N - 1.0) * torch.log(1.0 - 1.0 / pxm))

    def dg(x, pxm):
        return 1.0 - ((K - 1.0) + (N - 1.0) / a / (pxm - 1.0)) \
            / (1.0 + x / M) / M

    def ddg(x, pxm):
        return ((K - 1.0) + (N - 1.0) / a / (pxm - 1.0)
                + (N - 1.0) * pxm / a / a / (pxm - 1.0) ** 2) \
            / ((1.0 + x / M) * M) ** 2

    u = torch.log(torch.clamp(N - M, min=0.5)).expand(shape)
    for _ in range(iters):
        eu = torch.exp(u)
        pxm = torch.exp(torch.log1p(eu / M) / a)
        delta = eu * dg(eu, pxm) - 1.0
        dd = eu * eu * ddg(eu, pxm) + eu * dg(eu, pxm)
        step = delta / torch.where(dd > 0, dd, 1.0)
        step = torch.clamp(step, -2.0 * torch.abs(u), 2.0 * torch.abs(u))
        u = u - torch.where(dd > 0, step, 0.0)
    eu = torch.exp(u)
    pxm = torch.exp(torch.log1p(eu / M) / a)
    sigma = eu * eu * ddg(eu, pxm) + eu * dg(eu, pxm)
    return (0.5 * torch.log(2 * math.pi / sigma) - g(eu, pxm) + u
            + (K - 1.0) * torch.log(M) - M)


def ngg_quadrature_log(a, M, N, K, levels: int = 11, *, device=None):
    """Quadrature oracle: log of the exact s-integral the saddle points
    approximate (the ngg_integral.cpp:105-121 validation), by tanh-sinh on
    (1e-12, 1 - 1e-12)."""
    a, M, N, K = _floats(a, M, N, K, device=device)

    def logf(s):
        omx = 1.0 - s
        return ((N[..., None] - 1) * torch.log(s)
                - (1 + K[..., None] * a[..., None]) * torch.log(omx)
                + M[..., None] * (1.0 - torch.exp(
                    -a[..., None] * torch.log(omx))))

    shape = _shape(a, M, N, K)
    lo = torch.full(shape, 1e-12, dtype=a.dtype, device=a.device)
    hi = torch.full(shape, 1.0 - 1e-12, dtype=a.dtype, device=a.device)
    return (quadrature.tanh_sinh_log(logf, lo, hi, levels)
            + K * torch.log(M) - M + torch.log(a))
