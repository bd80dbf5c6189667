"""Closed-form approximations for log S^n_{m,a}, m <= 4, in PyTorch.

Port of libstb_tpu/core/sapprox.py (lib/sapprox.c:28-114): exact at a==0,
good estimates for small a, via lgamma differences g_k = lgamma(n - k a) -
lgamma(1 - k a), plus the d/da derivative used for gradient-based
samplers.  All functions are vectorised over (n, m, a).
"""
from __future__ import annotations

import math

import torch

from . import special

__all__ = ["s_approx", "s_approx_da"]


def _g(n, k, a):
    return torch.lgamma(n - k * a) - torch.lgamma(1.0 - k * a)


def _args(n, m, a):
    n = special._float(n)
    m = torch.as_tensor(m, device=n.device)
    a = torch.as_tensor(a, dtype=n.dtype, device=n.device)
    return n, m, a, m.to(n.dtype)


def _select(n, m, mf, by_m):
    """by_m[m - 1] for m = 1..4; 0 for n == m, -inf for n < m or m > 4."""
    out = torch.where(m == 1, by_m[0],
          torch.where(m == 2, by_m[1],
          torch.where(m == 3, by_m[2],
          torch.where(m == 4, by_m[3], -torch.inf))))
    out = torch.where(n == mf, 0.0, out)
    return torch.where(n < mf, -torch.inf, out)


def s_approx(n, m, a):
    """log S^n_{m,a} for m<=4 (sapprox.c:28-71).

    The a<0.001 polygamma branch (sapprox.c:37-50) and the a>0 lgamma-diff
    branch (sapprox.c:52-68) are both computed and selected per element.
    Returns 0 for n==m, -inf for n<m or m>4.
    """
    n, m, a, mf = _args(n, m, a)
    tiny = torch.finfo(n.dtype).tiny

    # lgamma(1 - k a) may see negative arguments for larger a; both C lgamma
    # and torch.lgamma compute log|Gamma| there, matching the reference.
    ga = _g(n, 1.0, a)
    g2a = _g(n, 2.0, a)
    g3a = _g(n, 3.0, a)
    g4a = _g(n, 4.0, a)

    la = torch.log(torch.where(a > 0, a, 1.0))
    # log(exp(ga-g2a)-1) = (ga-g2a) + log(1-exp(-(ga-g2a)))
    m2 = g2a - la + special.log1mexp(-(ga - g2a)) + (ga - g2a)
    d3 = torch.log(torch.clamp(
        torch.exp(ga - g3a) - 2.0 * torch.exp(g2a - g3a) + 1.0, min=tiny))
    m3 = g3a - 2.0 * la - math.log(2.0) + d3
    d4 = torch.log(torch.clamp(
        torch.exp(ga - g4a) - 3.0 * torch.exp(g2a - g4a)
        + 3.0 * torch.exp(g3a - g4a) - 1.0, min=tiny))
    m4 = g4a - 3.0 * la - math.log(6.0) + d4

    # a ~ 0 polygamma forms (exact at a==0), sapprox.c:37-50
    dg = special.digamma(n - a) - special.digamma(1.0 - a)
    tg = special.trigamma(n - a) - special.trigamma(1.0 - a)
    qg = special.tetragamma(n - a) - special.tetragamma(1.0 - a)
    z2 = ga + torch.log(dg)
    z3 = ga - math.log(2.0) + torch.log(tg + dg * dg)
    z4 = ga - math.log(6.0) + torch.log(qg + 3.0 * tg * dg + dg * dg * dg)

    small_a = a < 0.001
    return _select(n, m, mf, (ga, torch.where(small_a, z2, m2),
                              torch.where(small_a, z3, m3),
                              torch.where(small_a, z4, m4)))


def s_approx_da(n, m, a):
    """d/da log S^n_{m,a} for m<=4 (sapprox.c:76-114)."""
    n, m, a, mf = _args(n, m, a)

    snm = s_approx(n, m, a)
    ga = _g(n, 1.0, a)
    g2a = _g(n, 2.0, a)
    g3a = _g(n, 3.0, a)
    g4a = _g(n, 4.0, a)
    dga = -(special.digamma(n - a) - special.digamma(1.0 - a))
    dg2a = -2.0 * (special.digamma(n - 2 * a) - special.digamma(1.0 - 2 * a))
    dg3a = -3.0 * (special.digamma(n - 3 * a) - special.digamma(1.0 - 3 * a))
    dg4a = -4.0 * (special.digamma(n - 4 * a) - special.digamma(1.0 - 4 * a))

    safe_a = torch.where(a > 0, a, 1.0)
    r1 = dga  # d/da [lgamma(n-a)-lgamma(1-a)] = -(psi(n-a)-psi(1-a))
    r2 = (torch.exp(ga - snm) * dga - torch.exp(g2a - snm) * dg2a
          - 1.0) / safe_a
    r3 = (-2.0 / safe_a
          + (torch.exp(ga - snm) * dga - 2.0 * torch.exp(g2a - snm) * dg2a
             + torch.exp(g3a - snm) * dg3a) / 2.0 / safe_a / safe_a)
    # the reference divides the m==4 bracket by 3a^3 (sapprox.c:111), but
    # S(n,4) = (e^ga - 3e^g2a + 3e^g3a - e^g4a)/(6 a^3), so the correct
    # factor is 6a^3 (finite differences confirm; the reference's m==3 case
    # correctly uses its 2a^2); this is the correct derivative, as in the
    # JAX package
    r4 = (-3.0 / safe_a
          + (torch.exp(ga - snm) * dga - 3.0 * torch.exp(g2a - snm) * dg2a
             + 3.0 * torch.exp(g3a - snm) * dg3a
             - torch.exp(g4a - snm) * dg4a)
          / 6.0 / safe_a / safe_a / safe_a)
    return _select(n, m, mf, (r1, r2, r3, r4))
