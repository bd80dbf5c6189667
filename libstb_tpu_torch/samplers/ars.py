"""Batched derivative-free Adaptive Rejection Sampling, in PyTorch.

Port of libstb_tpu/samplers/ars.py (see its docstring for the design):
Gilks' ARMS as modified in lib/arms.c -- a piecewise-exponential envelope
built from chords (arms.c:268-375, 701-806), inverse-CDF sampling of the
envelope (arms.c:379-462), the squeeze and rejection tests with an
optional Metropolis step for non-log-concave targets (arms.c:466-563),
envelope refinement by sorted insertion (arms.c:567-663) and the
give-up-after-100-rejects guard (arms.c:221-248, error 2001).

The envelope is a fixed-capacity sorted array of (x, f) support points per
chain, (C, n_max); leading chain axes are flattened to one.  On interval
[x_j, x_{j+1}] the upper hull is the minimum of the chord through
(x_{j-1}, x_j) extended right and the chord through (x_{j+1}, x_{j+2})
extended left, so each interval contributes two exponential pieces split
at the chords' intersection.  All chains propose and test in lockstep with
finished chains masked; the JAX ``while_loop`` becomes a Python loop that
reads ``all(done)`` back from the device once per round.

The log-density callback is batched: it maps a tensor of the bounds' shape
to the same shape.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import rng

__all__ = ["ars_sample", "MAX_REJECTS"]

MAX_REJECTS = 100          # arms.c give-up counter (arms.c:221-248)
_BIG = torch.inf


def _line(x0, y0, x1, y1, x):
    """Value at x of the line through (x0,y0),(x1,y1); safe for x1==x0."""
    dx = x1 - x0
    s = (y1 - y0) / torch.where(dx == 0, 1.0, dx)
    return y0 + s * (x - x0), s


def _log_int_exp(y0, s, h):
    """log of the integral over [0, h] of exp(y0 + s u) du, stable for any
    sign/size of s*h."""
    sh = s * h
    tiny = torch.abs(sh) < 1e-6
    safe_s = torch.where(tiny, 1.0, s)
    # (exp(sh)-1)/s  ->  log: max(0,sh) + log1mexp-style
    pos = torch.clamp(sh, min=0.0) + torch.log(
        torch.abs(-torch.expm1(-torch.abs(sh))) / torch.abs(safe_s))
    lin = torch.log(torch.clamp(h, min=1e-300)) + 0.5 * sh   # sh -> 0 limit
    out = torch.where(tiny, lin, pos)
    return y0 + torch.where(h > 0, out, -_BIG)


def _inv_int_exp(y0, s, h, logw):
    """x in [0,h] with the integral over [0, x] of exp(y0+su) du equal to
    exp(logw); logw <= mass."""
    sh = s * h
    tiny = torch.abs(sh) < 1e-6
    safe_s = torch.where(tiny, 1.0, s)
    # x = log1p(w s e^{-y0}) / s
    z = torch.exp(torch.clamp(logw - y0 + torch.log(torch.abs(safe_s)),
                              max=30.0))
    z = torch.where(s >= 0, z, -z)
    x_gen = torch.log1p(torch.clamp(z, min=-1.0 + 1e-12)) / safe_s
    x_lin = torch.exp(torch.clamp(logw - y0, max=30.0))
    x = torch.where(tiny, x_lin, x_gen)
    return torch.minimum(torch.clamp(x, min=0.0), h)


def _hull_pieces(xs, fs, k):
    """Decompose the upper hull into 2*(P-1) exponential pieces.

    xs, fs: (C, P) sorted support (slots >= k hold the last point
    repeated, zero-width => zero mass); k: (C,) live points.  Returns
    per-piece (start, width, y_at_start, slope, logmass), each
    (C, 2(P-1)).
    """
    P = xs.shape[-1]
    x0 = xs[..., :-1]
    x1 = xs[..., 1:]
    f0 = fs[..., :-1]
    f1 = fs[..., 1:]
    # chord through (j-1, j) extended right; first interval: none
    xl = torch.cat([xs[..., :1], xs[..., :-2]], dim=-1)
    fl = torch.cat([fs[..., :1], fs[..., :-2]], dim=-1)
    yl0, sl = _line(xl, fl, x0, f0, x0)        # value at x0, slope
    # chord through (j+1, j+2) extended left; last interval: none
    xr = torch.cat([xs[..., 2:], xs[..., -1:]], dim=-1)
    fr = torch.cat([fs[..., 2:], fs[..., -1:]], dim=-1)
    yr0, sr = _line(x1, f1, xr, fr, x0)        # value extrapolated to x0
    idx = torch.arange(P - 1, device=xs.device)
    has_r = idx < (k[..., None] - 2)
    has_l = (idx >= 1) & (idx < (k[..., None] - 1))

    w = x1 - x0
    # intersection of the two lines within [0, w] (offset from x0)
    ds = sl - sr
    t = torch.where(torch.abs(ds) > 1e-30,
                    (yr0 - yl0) / torch.where(ds == 0, 1.0, ds), 0.0)
    t = torch.minimum(torch.clamp(t, min=0.0), w)
    # where only one line exists, that line covers the whole interval
    only_l = has_l & ~has_r
    both = has_l & has_r
    # hull = min of lines; left piece uses the line lower at x0
    l_first = yl0 <= yr0
    yA0 = torch.where(both, torch.where(l_first, yl0, yr0),
                      torch.where(only_l, yl0, yr0))
    sA = torch.where(both, torch.where(l_first, sl, sr),
                     torch.where(only_l, sl, sr))
    wA = torch.where(both, t, w)
    yB_start = yA0 + sA * wA
    sB = torch.where(l_first, sr, sl)
    wB = torch.where(both, w - t, 0.0)
    live = (idx < (k[..., None] - 1)) & (w > 0)
    wA = torch.where(live, wA, 0.0)
    wB = torch.where(live & both, wB, 0.0)

    starts = torch.cat([x0, x0 + wA], dim=-1)
    widths = torch.cat([wA, wB], dim=-1)
    y0s = torch.cat([yA0, yB_start], dim=-1)
    slopes = torch.cat([sA, sB], dim=-1)
    logm = _log_int_exp(y0s, slopes, widths)
    logm = torch.where(widths > 0, logm, -_BIG)
    return starts, widths, y0s, slopes, logm


def _at(arr, idx):
    """arr[c, idx[c]] for (C, P) ``arr`` and (C,) ``idx``."""
    return torch.gather(arr, -1, idx[..., None])[..., 0]


def _interval(xs, x):
    """Index j of the support interval [x_j, x_{j+1}] holding x, per chain."""
    P = xs.shape[-1]
    j = torch.searchsorted(xs, x[..., None], right=True)[..., 0] - 1
    return torch.clamp(j, 0, P - 2)


def _hull_at(xs, fs, k, x):
    """Upper-hull value at x (the ``eval`` side of the test step)."""
    P = xs.shape[-1]
    j = _interval(xs, x)
    jl = torch.clamp(j - 1, min=0)
    yl, _ = _line(_at(xs, jl), _at(fs, jl), _at(xs, j), _at(fs, j), x)
    jr = torch.clamp(j + 2, max=P - 1)
    yr, _ = _line(_at(xs, j + 1), _at(fs, j + 1), _at(xs, jr), _at(fs, jr), x)
    has_l = j >= 1
    has_r = j + 2 <= k - 1
    return torch.where(has_l & has_r, torch.minimum(yl, yr),
                       torch.where(has_l, yl, yr))


def _squeeze_at(xs, fs, k, x):
    """Chord (lower bound) value at x (arms.c squeeze test)."""
    j = _interval(xs, x)
    y, _ = _line(_at(xs, j), _at(fs, j), _at(xs, j + 1), _at(fs, j + 1), x)
    return torch.where(j < k - 1, y, -_BIG)


def _insert(xs, fs, k, x, f):
    """Sorted insert of (x, f) into every chain's envelope: slots right of
    the insertion point shift by one; full envelopes ignore the insert."""
    P = xs.shape[-1]
    j = torch.searchsorted(xs, x[..., None], right=False)    # (C, 1)
    idx = torch.arange(P, device=xs.device).expand(xs.shape)
    src = torch.clamp(torch.where(idx < j, idx, idx - 1), min=0)
    xs_new = torch.where(idx < j, xs, torch.where(
        idx == j, x[..., None], torch.gather(xs, -1, src)))
    fs_new = torch.where(idx < j, fs, torch.where(
        idx == j, f[..., None], torch.gather(fs, -1, src)))
    ok = k < P
    xs = torch.where(ok[..., None], xs_new, xs)
    fs = torch.where(ok[..., None], fs_new, fs)
    return xs, fs, k + ok.to(k.dtype)


def ars_sample(logpost: Callable, gen, lo, hi, x_prev=None,
               n_init: int = 5, n_max: int = 16,
               max_rejects: int = MAX_REJECTS, metropolis: bool = False,
               with_info: bool = False):
    """Batched derivative-free ARS / ARMS step.

    Args:
      logpost: batched log density, maps a tensor of ``lo``'s shape to the
        same shape.
      gen: torch.Generator on ``lo``'s device (or an rng.Replay).
      lo, hi: bounds (the reference's xl/xr); ``lo`` is a tensor whose
        shape, dtype and device the draw takes, ``hi`` broadcasts to it.
      x_prev: previous value -- required when ``metropolis`` (the ARMS
        chain state, arms.c:129-151); also used as a mid support point
        when given.
      n_init: initial envelope points (arms_simple uses 3; ninit<=17
        allowed, arms.c:104-117).
      n_max: envelope capacity (reference: npoint, typically 100; chords
        converge fast so 16 suffices -- extra inserts are dropped).
      metropolis: apply the ARMS Metropolis correction (do_metro,
        arms.c:156-160) making the step exact for non-log-concave targets.

    Draws per round, in order: a Gumbel block of shape lo.shape +
    (2 (n_max - 1),) that picks the hull piece, a uniform on [1e-12, 1)
    for the inverse CDF within it, one for the accept test, and with
    ``metropolis`` a third.

    Returns:
      (x, ok): accepted draws and per-chain success mask (False = hit the
      reject cap, the reference's error 2001; the returned x is then the
      warm-start value).  With ``with_info``: (x, ok, neval) where neval
      is the per-chain density-evaluation count -- the reference's
      efficiency telemetry (arms.c:24,151): n_init envelope evals + 1
      warm-start eval + one per round until acceptance.
    """
    lo = torch.as_tensor(lo)
    if not lo.is_floating_point():
        lo = lo.to(torch.get_default_dtype())
    dt, dev, shape = lo.dtype, lo.device, lo.shape
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(shape).reshape(-1)
    lo = lo.reshape(-1)
    C = lo.shape[0]
    P = n_max

    def evalf(x):
        return logpost(x.reshape(shape)).reshape(-1)

    # -- initial envelope: n_init points spanning [lo, hi] -----------------
    # the first/last points sit (almost) on the bounds so the hull pieces
    # cover the whole domain (the reference anchors its envelope at xl/xr,
    # arms.c:281-299)
    frac = torch.arange(n_init, dtype=dt, device=dev) / (n_init - 1.0)
    frac = 1e-6 + (1.0 - 2e-6) * frac
    xs0 = lo[:, None] + (hi - lo)[:, None] * frac              # (C, I)
    if x_prev is not None:
        x_prev = torch.as_tensor(x_prev, dtype=dt, device=dev).expand(
            shape).reshape(-1)
    if x_prev is not None and not metropolis:
        # seed the envelope at the previous value -- a warm start like the
        # reference's xprev handling (arms.c:143-151).  NOT done in
        # Metropolis mode: the MH ratio below assumes an independence
        # proposal, so the envelope must not depend on the current state.
        xp = torch.minimum(torch.maximum(x_prev, lo + 1e-9), hi - 1e-9)
        xs0 = xs0.clone()
        xs0[:, n_init // 2] = xp
        xs0 = torch.sort(xs0, dim=-1).values
    fs0 = torch.stack([evalf(xs0[:, i]) for i in range(n_init)], dim=-1)
    xs = torch.cat([xs0, xs0[:, -1:].expand(C, P - n_init)], dim=-1)
    fs = torch.cat([fs0, fs0[:, -1:].expand(C, P - n_init)], dim=-1)
    k = torch.full((C,), n_init, dtype=torch.int64, device=dev)

    x_cur = (xs0[:, n_init // 2] if x_prev is None
             else torch.minimum(torch.maximum(x_prev, lo), hi))
    f_cur = evalf(x_cur)

    done = torch.zeros(C, dtype=torch.bool, device=dev)
    ok = torch.zeros(C, dtype=torch.bool, device=dev)
    nev = torch.full((C,), n_init + 1, dtype=torch.int32, device=dev)
    x_out = x_cur
    tries = 0
    while tries < max_rejects and not bool(done.all()):
        # draw from the envelope: a hull piece by Gumbel-max, then the
        # inverse CDF of its exponential
        starts, widths, y0s, slopes, logm = _hull_pieces(xs, fs, k)
        norm = torch.logsumexp(logm, dim=-1, keepdim=True)
        g = rng.gumbel(gen, shape + (2 * (P - 1),), dt, dev).reshape(C, -1)
        piece = torch.argmax(logm - norm + g, dim=-1)
        u = rng.uniform_open(gen, shape, dt, dev).reshape(-1)
        logw = _at(logm, piece) + torch.log(u)
        y0p, sp = _at(y0s, piece), _at(slopes, piece)
        off = _inv_int_exp(y0p, sp, _at(widths, piece), logw)
        x = torch.minimum(torch.maximum(_at(starts, piece) + off, lo), hi)
        h = y0p + sp * off

        u = rng.uniform_open(gen, shape, dt, dev).reshape(-1)
        # the reference's squeeze accept avoids the density eval
        # (arms.c:490-500); evaluating every round keeps the chains in
        # lockstep and decides the same way
        f = evalf(x)
        accept = torch.log(u) <= (f - h)
        if metropolis:
            # ARMS correction (arms.c:509-563)
            h_cur = _hull_at(xs, fs, k, x_cur)
            um = rng.uniform_open(gen, shape, dt, dev).reshape(-1)
            ratio = (f + torch.minimum(f_cur, h_cur)
                     - f_cur - torch.minimum(f, h))
            keep_new = torch.log(um) <= torch.clamp(ratio, max=0.0)
            x_acc = torch.where(keep_new, x, x_cur)
            f_acc = torch.where(keep_new, f, f_cur)
        else:
            x_acc, f_acc = x, f
        newly = accept & ~done
        x_out = torch.where(newly, x_acc, x_out)
        ok = ok | newly
        # rejected points refine the envelope (arms.c:567-663)
        ins = (~accept) & (~done)
        xs2, fs2, k2 = _insert(xs, fs, k, x, f)
        xs = torch.where(ins[:, None], xs2, xs)
        fs = torch.where(ins[:, None], fs2, fs)
        k = torch.where(ins, k2, k)
        nev = nev + (~done).to(nev.dtype)      # still-sampling chains
        done = done | accept
        x_cur = torch.where(newly, x_acc, x_cur)
        f_cur = torch.where(newly, f_acc, f_cur)
        tries += 1
    out = (x_out.reshape(shape), ok.reshape(shape))
    if with_info:
        return out + (nev.reshape(shape),)
    return out
