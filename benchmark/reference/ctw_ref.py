"""The windowed collapsed-table sampler (CTW) of upstream libstb's
test/check.c (``-S CTW``, TWINDOW, :905-943), one sweep and one
iteration's moves at a time, in plain float64 PyTorch.

The model: J groups, each a PYP(a, b) restaurant over the base H of D
categories; group j seats n[j, i] customers of category i at t[j, i]
tables, T_j = sum_i t[j, i].  A sweep takes the categories in turn; for
category i every count t[j, i] with n[j, i] > 0 is drawn from

    p(t | rest) ~ S(n, t; a) H[i]^(t - 1) prod_{k=1}^{t-1} (b + (T_j' + k) a)

over the window of 2w + 1 candidates t_i - w .. t_i + w, shifted to lie
inside [1, n] where it reaches past an end (check.c:915-918); T_j' =
T_j - t_i, the group's other tables.  A row with n < 2w + 1 takes 1..2w +
1 with the candidates past n weighing nothing.  S(n, t; a) is exact:
Srel(n, t) = log S(n, t) - log S(n, 1) from ``stirling_ref``'s f64
column recurrence at each chain's own discount (the constant log S(n, 1)
of a row does not move a draw).  The moves of b and a are those of
``hpyp_ref`` (sampleb.c, samplea.c by libstb's SliceSimple), over the
groups' totals and the (count, tables) pairs.

Departures from check.c:905-943, each the port's semantics:

* a draw is the Gumbel-max over the window's log weights (``gumbel``: the
  block the port drew, (D, C J, 2w + 1)), where check.c draws from the
  normalised weights with one uniform: the same distribution;
* every group of a category at once, where check.c walks the groups in
  turn: a count's conditional reads only its own group's T_j, so the
  order of the groups within a category does not change a draw;
* many independent chains, each with its own a and b, where check.c runs
  one; the port reads Srel off a grid of discounts where check.c reads
  one ``S_make`` table at the current a: here it is exact;
* the b move reads every group's totals (``b_groups`` = J).

Nothing of the program is imported.  ``low``: the control, the sweep's
log weights rounded to ``low`` before the draw.
"""
from __future__ import annotations

import torch

from . import hpyp_ref

__all__ = ["window", "srel_rows", "srel_at", "log_weights", "probs_on",
           "sweep"]

F64 = torch.float64


def window(t: torch.Tensor, n: torch.Tensor, w: int) -> torch.Tensor:
    """(R, 2w + 1) the candidates of each row: t - w .. t + w shifted to
    start at 1 where t - w < 1 and to end at n where t + w > n (a row with
    n < 2w + 1 starts at 1)."""
    K = 2 * w + 1
    t, n = t.to(torch.int64), n.to(torch.int64)
    lo = t - w
    lo = torch.where(lo + K - 1 > n, n - K + 1, lo)
    lo = torch.where(lo < 1, torch.ones_like(lo), lo)
    return lo[:, None] + torch.arange(K, device=t.device)[None]


def srel_rows(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(C, J, D, max n) exact Srel(n[j, i], t) for t = 1..max n at the
    discounts ``a`` (C,) of the counts ``n`` (J, D); -inf where t > n."""
    J, D = n.shape
    tmax = max(1, int(n.max()))
    return hpyp_ref.srel_exact(a, n.reshape(1, -1), tmax).reshape(
        a.shape[0], J, D, tmax)


def srel_at(rows: torch.Tensor, n: torch.Tensor, tts: torch.Tensor
            ) -> torch.Tensor:
    """(R, K) Srel(n_r, t) at the candidates ``tts`` (R, K) of each row,
    read from the row's (R, tmax) ``rows`` (``srel_rows``); -inf outside
    [1, n]."""
    tmax = rows.shape[-1]
    got = torch.gather(rows, 1, torch.clamp(tts - 1, 0, tmax - 1))
    return torch.where((tts >= 1) & (tts <= n.to(torch.int64)[:, None]),
                       got, -torch.inf)


def log_weights(srel, n, t_stored, T, a, b, h, tts) -> torch.Tensor:
    """(R, K) unnormalised log p(t | rest) at the candidates ``tts``:
    Srel(n, t) + (t - 1) log h + log prod_{k=1}^{t-1} (b + (T' + k) a),
    T' = T - t_stored; the product a ratio of Gamma functions for a > 0,
    b^(t - 1) for a = 0.  -inf outside [1, n]."""
    t = tts.to(F64)
    a, b = a.to(F64)[:, None], b.to(F64)[:, None]
    other = (T - t_stored).to(F64)[:, None]
    safe_a = torch.where(a > 0, a, 1.0)
    y = b / safe_a + other
    poch = torch.where(
        a > 0,
        (t - 1) * torch.log(safe_a) + torch.lgamma(y + t)
        - torch.lgamma(y + 1),
        (t - 1) * torch.log(b))
    lw = srel.to(F64) + (t - 1) * torch.log(h.to(F64))[:, None] + poch
    ok = (tts >= 1) & (tts <= n.to(torch.int64)[:, None])
    return torch.where(ok, lw, -torch.inf)


def probs_on(lw: torch.Tensor, tts: torch.Tensor, tmax: int) -> torch.Tensor:
    """(R, tmax) the normalised conditional of the log weights ``lw`` at
    the candidates ``tts``, laid on t = 1..tmax (0 off the window), so
    that two windows that differ compare; a row with no candidate is all
    0."""
    p = hpyp_ref.ct_probs(lw.to(F64))
    out = torch.zeros((lw.shape[0], tmax), dtype=F64, device=lw.device)
    idx = torch.clamp(tts - 1, 0, tmax - 1)
    return out.scatter_add_(1, idx, torch.where(
        (tts >= 1) & (tts <= tmax), p, 0.0))


def sweep(t, T, a, b, n, H, gumbel, w: int, block: int = 8, low=F64):
    """One CTW sweep of (C, J, D) counts ``t`` with (C, J) totals ``T`` at
    (C,) ``a``, ``b`` over the counts ``n`` (J, D) and base ``H`` (D,):
    category by category, t[:, :, i] = the window's candidate at
    argmax(log weights + Gumbels), 0 where n = 0.  ``gumbel``: (D, C J,
    2w + 1) the port's block.  Chains run in blocks of ``block``.
    Returns (t, T), new tensors."""
    C, J, D = t.shape
    K = 2 * w + 1
    g = gumbel.to(F64).reshape(D, C, J, K)
    n = n.to(torch.int64)
    t, T = t.clone(), T.clone()
    for c0 in range(0, C, block):
        cs = slice(c0, c0 + block)
        Cb = t[cs].shape[0]
        a_r = a[cs, None].expand(Cb, J).reshape(-1)
        b_r = b[cs, None].expand(Cb, J).reshape(-1)
        rows = srel_rows(a[cs], n)
        for i in range(D):
            ni = n[None, :, i].expand(Cb, J).reshape(-1)
            stored = t[cs, :, i].reshape(-1)
            Tj = T[cs].reshape(-1)
            tts = window(stored, ni, w)
            srel = srel_at(rows[:, :, i].reshape(Cb * J, -1), ni, tts)
            lw = log_weights(srel, ni, stored, Tj, a_r, b_r,
                             H[i].to(F64).expand(Cb * J), tts)
            if low != F64:
                lw = lw.to(low).to(F64)
            pick = torch.argmax(lw + g[i, cs].reshape(-1, K), dim=-1)
            new = torch.gather(tts, 1, pick[:, None])[:, 0]
            new = torch.where(ni > 0, new, 0).to(t.dtype)
            T[cs] = (Tj + new - stored).reshape(Cb, J).to(T.dtype)
            t[cs, :, i] = new.reshape(Cb, J)
    return t, T
