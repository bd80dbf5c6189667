"""Fast lgamma/digamma difference helpers, in PyTorch.

Port of libstb_tpu/core/lgcache.py.  The reference caches scalar calls in
little memo tables (lib/lgamma.c:30-114 ``gcache``/``pcache``/``qcache``)
and Taylor-expands around integer nodes (lib/lgamma.c:143-240
``gammadiff``/``psidiff``) because scalar lgamma is expensive on a CPU.
Here the equivalents are vectorised expressions and *precomputed tensors*
over the integer index -- one lgamma sweep amortised over every later
gather.
"""
from __future__ import annotations

import torch

from . import special

__all__ = ["gammadiff", "psidiff", "qval", "gcache_table", "pcache_table",
           "qcache_table"]


def _small_n(n, exact, direct):
    """0 for n <= 0, exact[n - 1] for n = 1..3, ``direct`` beyond."""
    return torch.where(n <= 0, 0.0,
           torch.where(n == 1, exact[0],
           torch.where(n == 2, exact[1],
           torch.where(n == 3, exact[2], direct))))


def gammadiff(n, alpha):
    """lgamma(n + alpha) - lgamma(alpha) with exact small-n products
    (lgamma.c:143-157): n<=3 evaluated as log(alpha (1+alpha) ...) which
    avoids the cancellation of subtracting two lgammas near alpha ~ 0."""
    alpha = special._float(alpha)
    n = torch.as_tensor(n, device=alpha.device)
    direct = torch.lgamma(n.to(alpha.dtype) + alpha) - torch.lgamma(alpha)
    p1 = torch.log(alpha)
    p2 = torch.log(alpha * (1.0 + alpha))
    p3 = torch.log(alpha * (1.0 + alpha) * (2.0 + alpha))
    return _small_n(n, (p1, p2, p3), direct)


def psidiff(n, alpha):
    """digamma(n + alpha) - digamma(alpha) with exact small-n sums
    (lgamma.c:194-209)."""
    alpha = special._float(alpha)
    n = torch.as_tensor(n, device=alpha.device)
    direct = (special.digamma(n.to(alpha.dtype) + alpha)
              - special.digamma(alpha))
    s1 = 1.0 / alpha
    s2 = s1 + 1.0 / (1.0 + alpha)
    s3 = s2 + 1.0 / (2.0 + alpha)
    return _small_n(n, (s1, s2, s3), direct)


def qval(a, n):
    """S^{n+1}_{2,a} / S^{n+1}_{1,a}  (lgamma.c:92-97).

    The reference's comment (lgamma.c:88) says /S^n_{1,a}, but its code
    and its exact small-j cache values (lgamma.c:105-109, e.g. j=1 ->
    1/(1-a) = S^2_2/S^2_1) both compute the same-n ratio; this matches the
    code, as the JAX package does.  a<0.02:
    digamma(n+1-a)-digamma(1-a); else
    (1 - Gamma(n+1-2a)Gamma(1-a)/(Gamma(n+1-a)Gamma(1-2a)))/a."""
    a = special._float(a)
    n = torch.as_tensor(n, device=a.device).to(a.dtype)
    small = special.digamma(n + 1.0 - a) - special.digamma(1.0 - a)
    safe_a = torch.where(a >= 0.02, a, 1.0)
    lga0 = torch.lgamma(1.0 - 2.0 * safe_a) - torch.lgamma(1.0 - safe_a)
    big = (1.0 - torch.exp(torch.lgamma(n + 1.0 - 2.0 * safe_a)
                           - torch.lgamma(n + 1.0 - safe_a) - lga0)) / safe_a
    return torch.where(a < 0.02, small, big)


def gcache_table(p, jmax: int):
    """Tensor cache: out[j] = lgamma(j+p) - lgamma(p) for j = 0..jmax-1.

    The vectorised successor of gcache_init/gcache_value (lgamma.c:30-52);
    build once per density sweep, then use cheap gathers."""
    p = special._float(p)
    return gammadiff(torch.arange(jmax, device=p.device), p)


def pcache_table(p, jmax: int):
    """Tensor cache of digamma diffs (lgamma.c:54-76)."""
    p = special._float(p)
    return psidiff(torch.arange(jmax, device=p.device), p)


def qcache_table(a, jmax: int):
    """Tensor cache of qval with the exact small-j closed forms
    (lgamma.c:98-114): j=1 -> 1/(1-a); j=2 -> 3/(2-a);
    j=3 -> (11-7a)/((3-a)(2-a))."""
    a = special._float(a)
    j = torch.arange(jmax, device=a.device)
    e1 = 1.0 / (1.0 - a)
    e2 = 3.0 / (2.0 - a)
    e3 = (11.0 - 7.0 * a) / (3.0 - a) / (2.0 - a)
    return _small_n(j, (e1, e2, e3), qval(a, j))
