"""Elementary symmetric polynomials and the exact choose-H sampler, in
PyTorch.

Port of libstb_tpu/core/sympoly.py (the capabilities of lib/sympoly.c):

* ``sympoly`` -- log e_h(x_0..x_{K-1}) for h = 0..H (sympoly.c:60-110),
  the linear recursion run in log space (``logaddexp``): the update for
  all h at once is one shifted add per item;

* ``sympoly_sample`` -- a subset of exactly H of K features with
  probability proportional to the product of the selected weights
  (sympoly.c:129-239: forward DP table + backward pass), as a boolean
  mask of shape (..., K), batched over the leading axes.

Identities used by tests: e_h(1,...,1) = C(K,h); sum_h e_h z^h =
prod_k (1 + z x_k).
"""
from __future__ import annotations

import torch

from . import rng

__all__ = ["sympoly", "sympoly_sample", "SYMPOLY_MAX"]

# the reference caps H at 10 by default (sympoly.h:39); ours is soft.
SYMPOLY_MAX = 10


def _forward_tables(logx, h_max: int):
    """All prefix DP rows: prefix[k, ..., h] = log e_h(x_0..x_{k-1})
    (sympoly.c:129-207 builds the same table row by row), and the last
    row, over all K items."""
    batch = logx.shape[:-1]
    le = torch.full(batch + (h_max + 1,), -torch.inf, dtype=logx.dtype,
                    device=logx.device)
    le[..., 0] = 0.0
    ninf = le[..., :1].clone().fill_(-torch.inf)
    prefix = []
    for k in range(logx.shape[-1]):
        prefix.append(le)        # the row BEFORE item k is included
        shifted = torch.cat([ninf, le[..., :-1]], dim=-1)
        le = torch.logaddexp(le, logx[..., k, None] + shifted)
    return le, prefix


def sympoly(logx, h_max: int):
    """log e_h for h = 0..h_max over the trailing axis of ``logx``.

    Args:
      logx: (..., K) log-weights (use -inf for absent features).
      h_max: largest subset size.
    Returns:
      (..., h_max+1) tensor of log e_h; log e_0 = 0.
    """
    return _forward_tables(torch.as_tensor(logx), h_max)[0]


def sympoly_sample(gen, logx, h: int):
    """Sample a size-``h`` subset with P(mask) prop. to prod_{k in mask} x_k.

    Exact backward pass on the DP table (sympoly.c:215-239): walk items
    K-1..0; include item k with probability
    x_k e_{r-1}(x_<k) / e_r(x_<=k) where r = remaining picks.

    Args:
      gen: torch.Generator on ``logx``'s device (or an rng.Replay); one
        (K,) + batch block of uniforms is drawn, row i for item K-1-i.
      logx: (..., K) log weights; h: subset size.
    Returns:
      (..., K) boolean mask with exactly h True per batch entry
      (fewer only if fewer than h weights are finite).
    """
    logx = torch.as_tensor(logx)
    batch = logx.shape[:-1]
    K = logx.shape[-1]
    _, prefix = _forward_tables(logx, h)
    us = rng.uniform(gen, (K,) + batch, logx.dtype, logx.device)
    r = torch.full(batch, h, dtype=torch.int64, device=logx.device)
    takes = [None] * K
    for k in range(K - 1, -1, -1):
        lx, row_before, u = logx[..., k], prefix[k], us[K - 1 - k]
        ri = torch.clamp(r, 0, h)
        # log P(include) = lx + e_{r-1}(x_<k) - e_r(x_<=k)
        num = lx + torch.gather(row_before, -1,
                                torch.clamp(ri - 1, min=0)[..., None])[..., 0]
        # e_r(x_<=k) = logaddexp(e_r(x_<k), lx + e_{r-1}(x_<k))
        den = torch.logaddexp(
            torch.gather(row_before, -1, ri[..., None])[..., 0], num)
        take = (u < torch.exp(num - den)) & (r > 0)
        r = r - take.to(r.dtype)
        takes[k] = take
    return torch.stack(takes, dim=-1)
