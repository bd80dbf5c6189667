"""The two-level hierarchical Pitman-Yor process (HPYP) of the HPYP cells,
one Gibbs iteration at a time, in plain float64 PyTorch.

The model (arXiv:1007.0296, the application pattern of upstream libstb):
J group restaurants PYP(a1, b1) draw from a shared restaurant PYP(a0,
b0) over the base H.  Group j seats n[j, i] customers of category i at
t1[j, i] tables; the shared restaurant seats the level-1 tables, n0[i] =
sum_j t1[j, i], at t0[i] tables.  An iteration, as the port runs it:

1. level 1: the collapsed-table (CT) conditional of each t1[j, i] in
   turn, category by category, every group at once, with the level-0
   posterior predictive as its base,

       p0[i] = (n0[i] - a0 t0[i] + (b0 + a0 T0) H[i]) / (b0 + N0),
       p(t1[j, i] = t | rest) ~ S(n[j, i], t; a1) p0[i]^t
                                prod_{k=1}^{t-1} (b1 + (T1_j' + k) a1),

   t = 1..n[j, i] (0 where n[j, i] = 0), T1_j' the group's other tables
   (libstb test/check.c:868-904 for one restaurant);
2. level 0: the same conditional for each t0[i] over its counts n0 = the
   fresh sums of t1, one group, base H;
3. every ``hyper_cycle`` iterations the moves of b1, a1, b0 and a0: b by
   the auxiliary-variable draws of sampleb.c (log q_j ~ log Beta(b, N_j)
   from two log-Gamma draws, a conjugate Gamma draw for a = 0) and a slice
   move on its log posterior; a by a slice move on the log posterior of
   samplea.c: sum_j [T_j log a + lgamma(T_j + b/a) - lgamma(b/a)] + sum
   over the (count, tables) pairs with n > 1 of log S(n, t; a).

Every Stirling number is exact: S(n, t; a) = S1(n) + Srel(n, t) from
``stirling_ref``'s f64 recurrence at each chain's own discount, where the
port interpolates a grid of discounts.  The draws are handed in, in the
order the port takes them (``draws``: the level-1 Gumbel block (D, C J,
tmax), the level-0 block (D, C, tmax0), then each move's draws), so one
iteration given the port's draws is the port's iteration with exact
arithmetic.  Nothing of the program is imported.

Departures, each the port's semantics:

* level 1 uses the predictive p0 as its base: the conditional leaves out
  what a change of t1 does to the level-0 term through n0 (the CT
  sampler of the HPYP, arXiv:1007.0296);
* a CT draw is the Gumbel-max over the candidates; the level-0 counts
  move between sweeps, so a stored t0 may exceed its new n0: the other
  tables T' subtract the stored count, as the port does;
* the slice moves are libstb's SliceSimple (sslice.c) with a 200-try cap,
  all chains in lockstep until every chain has accepted (the port's batch
  form, which draws one uniform a chain a try); a starts at its value
  clamped into [A_MIN, A_MAX] and moves within SQUEEZEA of it
  (samplea.c:161-177), b in [B_MIN, B_MAX] from its current value.

The CT sweeps and conditionals run in blocks of ``block`` chains, so that
the (block, J, D, tmax) Srel block fits on a card; the moves run over all
chains, as their lockstep draws need.

``low`` (the sweep and the moves): the control.  The log weights of a
sweep and every evaluation of a move's log posterior are rounded to
``low`` before they are compared, the reference computed one precision
below the configuration's, which the cell's check has to refuse.
"""
from __future__ import annotations

from typing import Iterator

import torch

from . import stirling_ref

__all__ = ["A_MIN", "A_MAX", "SQUEEZEA", "B_MIN", "B_MAX", "srel_exact",
           "log_s_exact", "predictive", "ct_log_weights", "ct_probs",
           "total_variation", "ct_sweep", "sample_b", "sample_a",
           "slice_sample", "iteration"]

F64 = torch.float64
# psample.h:54-59, 87-94
A_MIN, A_MAX, SQUEEZEA = 0.01, 0.98, 0.2
B_MIN, B_MAX = 0.01, 2000.0
MAX_TRIES = 200                                     # sslice.c:24


def srel_exact(a: torch.Tensor, ns: torch.Tensor, tmax: int) -> torch.Tensor:
    """(C, P, tmax) Srel(n, t; a_c) = log S(n, t) - log S(n, 1) for the
    counts ``ns`` (C or 1, P) at discounts ``a`` (C,), t = 1..tmax; -inf
    where t > n or n = 0."""
    a = a.to(F64)
    C = a.shape[0]
    ns = ns.to(torch.int64).expand(C, ns.shape[-1])
    out = torch.full(ns.shape + (tmax,), -torch.inf, dtype=F64,
                     device=a.device)
    n_rows = max(1, int(ns.max()))
    rows = torch.clamp(ns - 1, min=0)
    for j, _, s in stirling_ref.columns(a, n_rows, min(tmax, n_rows)):
        out[:, :, j] = torch.gather(s, 1, rows)
    return torch.where((ns >= 1)[..., None], out, -torch.inf)


def log_s_exact(a: torch.Tensor, ns: torch.Tensor,
                ts: torch.Tensor) -> torch.Tensor:
    """(C, P) log S(n_p, t_p; a_c) for 1 <= t <= n, else -inf."""
    a = a.to(F64)
    C = a.shape[0]
    ns = ns.to(torch.int64).expand(C, ns.shape[-1])
    ts = ts.to(torch.int64).expand(ns.shape)
    n_rows = max(1, int(ns.max()))
    rows = torch.clamp(ns - 1, min=0)
    out = torch.full(ns.shape, -torch.inf, dtype=F64, device=a.device)
    for j, _, s in stirling_ref.columns(a, n_rows,
                                        max(1, min(int(ts.max()), n_rows))):
        out = torch.where(ts == j + 1, torch.gather(s, 1, rows), out)
    s1 = torch.gather(stirling_ref.s1(a, n_rows), 1, rows)
    return torch.where((ts >= 1) & (ts <= ns), out + s1, -torch.inf)


def predictive(n0, t0, T0, a0, b0, H) -> torch.Tensor:
    """(C, D) the level-0 posterior predictive p0."""
    n0, t0 = n0.to(F64), t0.to(F64)
    a0, b0, T0 = a0.to(F64)[:, None], b0.to(F64)[:, None], T0.to(F64)
    return ((n0 - a0 * t0 + (b0 + a0 * T0[:, None]) * H.to(F64)[None])
            / (b0 + n0.sum(-1, keepdim=True)))


def ct_log_weights(srel, n, t_stored, T, a, b, h) -> torch.Tensor:
    """(R, tmax) unnormalised log p(t | rest) of one category's count for
    R rows (a chain's group): ``srel`` (R, tmax) Srel(n, t); ``n``,
    ``t_stored`` (the count now held), ``T`` (the row's tables), ``a``,
    ``b``, ``h`` (the base's mass of the category), each (R,).  The
    Pochhammer product prod_{k=1}^{t-1} (b + (T' + k) a) is a ratio of
    Gamma functions for a > 0 and b^(t-1) for a = 0."""
    tmax = srel.shape[-1]
    t = torch.arange(1, tmax + 1, dtype=F64, device=srel.device)[None]
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
    return torch.where(t <= n.to(F64)[:, None], lw, -torch.inf)


def ct_probs(lw: torch.Tensor) -> torch.Tensor:
    """The normalised conditional of log weights ``lw`` (R, tmax); a row
    with no candidate (n = 0) is all 0."""
    some = torch.isfinite(lw).any(-1, keepdim=True)
    return torch.where(some, torch.softmax(torch.where(some, lw, 0.0), -1),
                       0.0)


def total_variation(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(R,) 1/2 sum_t |p - q| of two (R, tmax) distributions."""
    return 0.5 * (p.to(F64) - q.to(F64)).abs().sum(-1)


def _round(x: torch.Tensor, low) -> torch.Tensor:
    return x if low == F64 else x.to(low).to(F64)


def ct_sweep(t, T, a, b, n_all, h_all, gumbel, block: int = 8, low=F64):
    """One CT sweep of (C, J, D) counts ``t`` with (C, J) totals ``T``:
    category by category, t[:, :, i] = 1 + argmax(log weights + Gumbels),
    0 where its count is 0.  ``n_all`` (C or 1, J, D) counts; ``h_all``
    (C, D) base; ``gumbel`` (D, C J, tmax) the port's block.  Returns (t,
    T), new tensors."""
    C, J, D = t.shape
    tmax = gumbel.shape[-1]
    g = gumbel.to(F64).reshape(D, C, J, tmax)
    n_all = n_all.expand(C, J, D)
    t, T = t.clone(), T.clone()
    for c0 in range(0, C, block):
        cs = slice(c0, c0 + block)
        Cb = t[cs].shape[0]
        srel = srel_exact(a[cs], n_all[cs].reshape(Cb, J * D),
                          tmax).reshape(Cb, J, D, tmax)
        for i in range(D):
            n = n_all[cs, :, i].reshape(-1)
            stored = t[cs, :, i].reshape(-1)
            Tj = T[cs].reshape(-1)
            lw = ct_log_weights(
                srel[:, :, i].reshape(-1, tmax), n, stored, Tj,
                a[cs, None].expand(Cb, J).reshape(-1),
                b[cs, None].expand(Cb, J).reshape(-1),
                h_all[cs, i, None].expand(Cb, J).reshape(-1))
            lw = _round(lw, low)
            new = 1 + torch.argmax(lw + g[i, cs].reshape(-1, tmax), dim=-1)
            new = torch.where(n > 0, new, 0).to(t.dtype)
            T[cs] = (Tj + new - stored).reshape(Cb, J).to(T.dtype)
            t[cs, :, i] = new.reshape(Cb, J)
    return t, T


def slice_sample(draws: Iterator, logpost, x0, lo, hi, low=F64):
    """SliceSimple: the level log p(x0) + log u, then shrinking proposals,
    every chain in lockstep until all have accepted (or MAX_TRIES).
    Where the draws run out first (the chains that drew them accepted
    sooner), the chains still trying read NaN."""
    def lp(x):
        return _round(logpost(x), low)

    y = lp(x0) + torch.log(next(draws).to(F64))
    xp, rlo, rhi = x0, lo, hi
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for _ in range(MAX_TRIES):
        if bool(done.all()):
            break
        u = next(draws, None)
        if u is None:
            return torch.where(done, xp, torch.nan)
        xprop = rlo + u.to(F64) * (rhi - rlo)
        accept = lp(xprop) > y
        live = ~done
        shrink = live & ~accept
        rlo = torch.where(shrink & (xprop < xp), xprop, rlo)
        rhi = torch.where(shrink & (xprop >= xp), xprop, rhi)
        xp = torch.where(live & accept, xprop, xp)
        done = done | accept
    return xp


def sample_b(draws: Iterator, b, N, T, a, shape: float, scale: float,
             low=F64):
    """The concentration move (sampleb.c:79-159): ``b``, ``a`` (C,); ``N``,
    ``T`` (C, I) group totals and tables."""
    b, a = b.to(F64), a.to(F64)
    N, T = N.to(F64).expand(T.shape), T.to(F64)
    lg1, lg2 = next(draws).to(F64), next(draws).to(F64)
    logq = torch.where(N > 0, lg1 - torch.logaddexp(lg1, lg2), 0.0)
    Q = 1.0 / scale - logq.sum(-1)
    conj = torch.clamp(next(draws).to(F64) / Q, B_MIN, B_MAX)
    safe_a = torch.where(a > 0, a, 1.0)

    def logpost(x):
        y = (x / safe_a)[:, None]
        return (-Q * x + (shape - 1.0) * torch.log(x)
                + (torch.lgamma(T + y) - torch.lgamma(y)).sum(-1))

    x = slice_sample(draws, logpost, torch.clamp(b, B_MIN, B_MAX),
                     torch.full_like(b, B_MIN), torch.full_like(b, B_MAX),
                     low)
    return torch.where(a > 0, x, conj)


def sample_a(draws: Iterator, a, ns, ts, T, b, low=F64):
    """The discount move (samplea.c): ``a`` (C,); ``ns`` (C or 1, P) and
    ``ts`` (C, P) the (count, tables) pairs; ``T``, ``b`` (C, I)."""
    a = a.to(F64)
    T, b = T.to(F64), b.to(F64).expand(T.shape)
    ns = ns.to(torch.int64)
    use = (ns > 1) & (ts >= 1) & (ts <= ns)

    def logpost(x):
        y = b / x[:, None]
        conc = (T * torch.log(x)[:, None] + torch.lgamma(T + y)
                - torch.lgamma(y)).sum(-1)
        ls = log_s_exact(x, ns, ts)
        return conc + torch.where(use, ls, 0.0).sum(-1)

    mid = torch.clamp(a, A_MIN * 0.999 + A_MAX * 0.001,
                      A_MAX * 0.999 + A_MIN * 0.001)
    lo = torch.where(mid - SQUEEZEA > A_MIN, mid - SQUEEZEA, A_MIN)
    hi = torch.where(mid + SQUEEZEA < A_MAX, mid + SQUEEZEA, A_MAX)
    return slice_sample(draws, logpost, mid, lo, hi, low)


def iteration(state: dict, n: torch.Tensor, H: torch.Tensor,
              draws: Iterator, hyper: bool, shape: float = 1.1,
              scale: float = 20.0, block: int = 8) -> dict:
    """One Gibbs iteration from ``state`` (t1 (C, J, D), T1 (C, J), t0
    (C, D), T0 (C,), a1, b1, a0, b0 (C,)) over the counts ``n`` (J, D) and
    base ``H`` (D,), the moves included when ``hyper``; returns the new
    state with the counts n0 the level-0 sweep read."""
    s = dict(state)
    C = s["t1"].shape[0]
    H = H.to(F64)
    n0 = s["t1"].sum(1)
    p0 = predictive(n0, s["t0"], s["T0"], s["a0"], s["b0"], H)
    s["t1"], s["T1"] = ct_sweep(s["t1"], s["T1"], s["a1"], s["b1"],
                                n[None], p0, next(draws), block)
    n0 = s["t1"].sum(1)
    t0, T0 = ct_sweep(s["t0"][:, None], s["T0"][:, None], s["a0"], s["b0"],
                      n0[:, None], H[None].expand(C, -1), next(draws), block)
    s["t0"], s["T0"], s["n0"] = t0[:, 0], T0[:, 0], n0
    if hyper:
        T1 = s["T1"].to(F64)
        N1 = n.sum(-1).to(F64)[None].expand(C, -1)
        s["b1"] = sample_b(draws, s["b1"], N1, T1, s["a1"], shape, scale)
        s["a1"] = sample_a(draws, s["a1"], n.reshape(1, -1),
                           s["t1"].reshape(C, -1), T1, s["b1"][:, None])
        T0 = s["T0"].to(F64)[:, None]
        N0 = n0.sum(-1, keepdim=True).to(F64)
        s["b0"] = sample_b(draws, s["b0"], N0, T0, s["a0"], shape, scale)
        s["a0"] = sample_a(draws, s["a0"], n0, s["t0"], T0, s["b0"][:, None])
    return s
