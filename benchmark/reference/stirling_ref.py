"""Plain Stirling-number tables, one column at a time: the reference of
the table cells and of the Gibbs cells' discount grid.

With V(n, m) = S(n, m) / S(n, m - 1) and the recurrence S(n, m) =
S(n-1, m-1) + (n - 1 - m a) S(n-1, m), one column of V follows from the
column before it by an affine recurrence down the rows,

    V(n, m) = alpha_n V(n-1, m) + beta_n,
    D_n = 1 / V(n-1, m-1) + (n - 1 - (m-1) a),
    alpha_n = (n - 1 - m a) / D_n,   beta_n = 1 / D_n,

from V(m-1, m) = 0.  Every alpha_n (n > m) and beta_n (n >= m) is
positive, so the recurrence is solved in logs by a prefix sum and a
prefix log-sum-exp over the whole column:

    log V(n, m) = LA_n + logcumsumexp_{i=m..n}(log beta_i - LA_i),
    LA_n = sum_{k=m+1..n} log alpha_k.

Srel(n, m) = log S(n, m) - log S(n, 1) is the running sum over columns
of log V (log V(n, 1) = log inf taken as 0), and S1(n) = lgamma(n - a) -
lgamma(1 - a).  Cells with m > n hold V = 0 and Srel = -inf; column 1 of
V holds +inf.  The same layout as the program's tables, but nothing of
the program is imported or read: the discounts are handed in.

``dtype`` is float64 for the reference; the control runs the same code
in a lower precision.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

__all__ = ["columns", "s1"]


def s1(a: torch.Tensor, n: int, dtype=torch.float64) -> torch.Tensor:
    """(..., n) log S(n, 1; a) = lgamma(n - a) - lgamma(1 - a), rows
    n = 1..n, for discounts ``a`` of shape (...)."""
    a = a.to(dtype)[..., None]
    rows = torch.arange(1, n + 1, dtype=dtype, device=a.device)
    return torch.lgamma(rows - a) - torch.lgamma(1.0 - a)


def columns(a: torch.Tensor, n: int, m: int, dtype=torch.float64
            ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Yield (j, V, Srel) for j = 0..m-1 (column j holds m = j + 1), each
    of shape (..., n) over rows 1..n, for discounts ``a`` (...)."""
    a = a.to(dtype)[..., None]
    dev = a.device
    rows = torch.arange(1, n + 1, dtype=dtype, device=dev)     # n
    v = torch.full(a.shape[:-1] + (n,), torch.inf, dtype=dtype, device=dev)
    srel = torch.zeros_like(v)
    yield 0, v, srel
    ninf = torch.tensor(-torch.inf, dtype=dtype, device=dev)
    zero = torch.tensor(0.0, dtype=dtype, device=dev)
    for j in range(1, m):
        mm = j + 1
        # V(n-1, m-1) for n = 1..N: the previous column shifted down a row
        # (row 0 has no predecessor; it only meets masked cells)
        prev = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
        d = 1.0 / prev + (rows - 1.0 - (mm - 1) * a)
        alpha = (rows - 1.0 - mm * a) / d
        la = torch.where(rows > mm, torch.log(torch.abs(alpha)), zero)
        lbeta = torch.where(rows >= mm, -torch.log(torch.abs(d)), ninf)
        LA = torch.cumsum(la, dim=-1)
        lv = LA + torch.logcumsumexp(lbeta - LA, dim=-1)
        v = torch.exp(lv)
        srel = srel + lv
        yield j, v, srel
