"""Scalar special functions on tensors, in PyTorch.

Port of libstb_tpu/core/special.py: the reference's L0 layer
(``lib/digamma.c:31-48``, ``lib/digammainv.c:27-38``, the ``lib/polygamma.c``
wrappers and the log-space helpers of ``lib/stable.c:95-103`` /
``lib/samplea.c:233-239``) as branch-free tensor expressions.  The
polygamma family keeps the JAX package's own series -- a masked 10-step
recurrence shift to y >= 8, then the Bernoulli asymptotic tail -- so the
two packages agree elementwise; ``torch.special`` is the oracle of the
tests, not the implementation.

All functions keep the dtype and device of their inputs.
"""
from __future__ import annotations

import torch

__all__ = [
    "logadd",
    "logdiff",
    "log1mexp",
    "digamma",
    "trigamma",
    "tetragamma",
    "pentagamma",
    "digamma_inv",
    "lgamma",
]

lgamma = torch.lgamma

# Number of masked recurrence steps used to shift arguments above the
# asymptotic-series threshold.  The smallest argument produced by the
# samplers is ~A_MIN=0.01 (psample.h:89), so ceil(ASYMPT_MIN - 0.01) steps
# suffice.
_SHIFT_STEPS = 10
_ASYMPT_MIN = 8.0
_LN2 = 0.6931471805599453

# Bernoulli numbers B_2, B_4, ..., B_14 for the polygamma asymptotic tails.
_B2K = (1.0 / 6.0, -1.0 / 30.0, 1.0 / 42.0, -1.0 / 30.0,
        5.0 / 66.0, -691.0 / 2730.0, 7.0 / 6.0)


def _float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _bern_tail(f, coeffs):
    """Horner evaluation of sum_k c_k f^k for f = 1/y^2 (c_1 first)."""
    acc = 0.0
    for c in reversed(coeffs):
        acc = f * (c + acc)
    return acc


def logadd(x, y):
    """log(exp(x) + exp(y)), the reference's ``logadd`` (stable.c:95-103);
    logadd(-inf, -inf) is -inf, not nan."""
    x = _float(x)
    return torch.logaddexp(x, torch.as_tensor(y, dtype=x.dtype,
                                              device=x.device))


def log1mexp(d):
    """log(1 - exp(d)) for d <= 0, stable in both tails."""
    d = _float(d)
    small = d > -_LN2
    safe_d = torch.where(small, torch.clamp(d, max=-torch.finfo(d.dtype).tiny),
                         d)
    return torch.where(small, torch.log(-torch.expm1(safe_d)),
                       torch.log1p(-torch.exp(d)))


def logdiff(x, y):
    """log(exp(x) - exp(y)) for x >= y, cf. ``logminus`` (samplea.c:233-239).

    Returns -inf where y >= x (the reference's convention)."""
    x = _float(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    d = y - x
    return torch.where(d < 0, x + log1mexp(d), -torch.inf)


def _shift_mask(x):
    """Masked upward recurrence shift: returns (y, xj, mask) where y = x + k
    with y >= _ASYMPT_MIN, xj enumerates the shifted-out points x, x+1, ...
    and mask marks the ones below the threshold.

    Branch-free replacement for the reference's ``while (x<=5)`` loop
    (digamma.c:37-40).
    """
    j = torch.arange(_SHIFT_STEPS, dtype=x.dtype, device=x.device)
    xj = x[..., None] + j  # (..., S)
    mask = xj < _ASYMPT_MIN
    k = torch.sum(mask, dim=-1).to(x.dtype)
    return x + k, xj, mask


def digamma(x):
    """psi(x) via recurrence + asymptotic series (digamma.c:31-48 semantics).

    Valid for x > 0; vectorised and branch-free.
    """
    x = _float(x)
    y, xj, mask = _shift_mask(x)
    r = -torch.sum(torch.where(mask, 1.0 / xj, 0.0), dim=-1)
    f = 1.0 / (y * y)
    # psi(y) ~ log y - 1/(2y) - sum_k B_{2k}/(2k) y^{-2k}
    t = -_bern_tail(f, [b / (2.0 * (k + 1)) for k, b in enumerate(_B2K)])
    return r + torch.log(y) - 0.5 / y + t


def trigamma(x):
    """psi'(x) for x > 0 (polygamma.c MLtrigamma capability)."""
    x = _float(x)
    y, xj, mask = _shift_mask(x)
    r = torch.sum(torch.where(mask, 1.0 / (xj * xj), 0.0), dim=-1)
    f = 1.0 / (y * y)
    # psi'(y) ~ 1/y + 1/(2y^2) + sum_k B_{2k} y^{-2k-1}
    t = (1.0 / y) * (1.0 + _bern_tail(f, list(_B2K))) + 0.5 * f
    return r + t


def tetragamma(x):
    """psi''(x) for x > 0 (polygamma.c MLtetragamma capability)."""
    x = _float(x)
    y, xj, mask = _shift_mask(x)
    r = -2.0 * torch.sum(torch.where(mask, 1.0 / (xj * xj * xj), 0.0), dim=-1)
    f = 1.0 / (y * y)
    # psi''(y) ~ -1/y^2 - 1/y^3 - sum_k (2k+1) B_{2k} y^{-2k-2}
    t = -f * (1.0 + 1.0 / y
              + _bern_tail(f, [(2 * (k + 1) + 1) * b
                               for k, b in enumerate(_B2K)]))
    return r + t


def pentagamma(x):
    """psi'''(x) for x > 0 (polygamma.c MLpentagamma capability)."""
    x = _float(x)
    y, xj, mask = _shift_mask(x)
    x4 = xj * xj
    x4 = x4 * x4
    r = 6.0 * torch.sum(torch.where(mask, 1.0 / x4, 0.0), dim=-1)
    f = 1.0 / (y * y)
    y3 = 1.0 / (y * y * y)
    # psi'''(y) ~ 2/y^3 + 3/y^4 + sum_k (2k+1)(2k+2) B_{2k} y^{-2k-3}
    t = y3 * (2.0 + 3.0 / y + _bern_tail(
        f, [(2 * (k + 1) + 1) * (2 * (k + 1) + 2) * b
            for k, b in enumerate(_B2K)]))
    return r + t


def digamma_inv(x, iters: int = 5):
    """Inverse digamma via Minka's Newton iteration (digammainv.c:27-38).

    guess = -1/(x - psi(1)) for x < -2.22 else exp(x) + 0.5, then
    ``iters`` Newton steps  guess -= (psi(guess) - x)/psi'(guess).
    """
    x = _float(x)
    neg_euler = -0.5772156649015329  # digamma(1)
    g = torch.where(x < -2.22, -1.0 / (x - neg_euler), torch.exp(x) + 0.5)
    for _ in range(iters):
        g = g - (digamma(g) - x) / trigamma(g)
    return g
