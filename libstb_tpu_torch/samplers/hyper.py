"""Hyperparameter posterior samplers for PYP/DP models, in PyTorch.

Port of libstb_tpu/samplers/hyper.py (see its docstring), batched over
chains:

* ``sample_b`` -- concentration posterior: the auxiliary-variable draws,
  the conjugate Gamma at a == 0, and for a > 0 the slice sampler started
  at the current value or ARS on a window around the Newton mode
  (``kernel="ars"``, the reference's PSAMPLE_ARS route);
* ``sample_a`` -- discount posterior on the discount-grid curve (dense, or
  streamed in chunks from 2^18 pairs), by either kernel;
* ``sample_table_config`` / ``sample_a_m`` -- the SAMPLEA_M route: draw
  the table-size configuration from a table (``AGridTable`` or
  ``StirlingTable``), then slice sample ``a`` on the table-free posterior;
* ``sample_a_rebuild`` -- the oracle that refills the table inside every
  density evaluation.

All samplers take and return batched tensors on the device of their
inputs and draw from an explicit ``gen``; none mutate state.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import agrid, rng, special, stirling
from ..ops import slice_cuda
from ..parallel import mesh as pmesh
from ..utils import metrics
from . import ars as arsmod
from . import slice as slicemod

__all__ = ["A_MIN", "A_MAX", "SQUEEZEA", "B_MIN", "B_MAX",
           "sample_b", "sample_a", "sample_a_rebuild", "sample_a_m",
           "sample_table_config", "a_bounds"]

# psample.h:54-59, 87-94
B_MIN = 0.01
B_MAX = 2000.0
A_MIN = 0.01
A_MAX = 0.98
SQUEEZEA = 0.2


def _mcmc_1d(logpost, gen, x0, lo, hi, loops: int, kernel: str,
             with_info: bool = False, card=None):
    """Dispatch the 1-D kernel: "slice" (sslice.c route) or "ars"
    (PSAMPLE_ARS route, psample.h:31-37).  ``with_info`` returns a third
    element: the per-chain density-evaluation count for ARS (the arms.c
    neval telemetry), 0 for the slice kernel (the reference exposes no
    equivalent there).  ``card(gen, x0, lo, hi, loops)``: the move's
    slice kernel (ops/slice_cuda), which replaces the generic loop where
    the chains lie on a CUDA device."""
    if kernel == "ars":
        return arsmod.ars_sample(logpost, gen, lo, hi, x_prev=x0,
                                 with_info=with_info)
    if kernel != "slice":
        raise ValueError(f"kernel={kernel!r}: \"slice\" or \"ars\"")
    if x0.is_cuda:
        out = card(gen, x0, lo, hi, loops)
    else:
        out = slicemod.slice_sample(logpost, gen, x0, lo, hi, loops=loops)
    if with_info:
        return out[0], out[1], torch.zeros(out[0].shape, dtype=torch.int32,
                                           device=out[0].device)
    return out


def _conc_terms(x, T, b):
    """sum_i [ T_i log x + lgamma(T_i + b_i/x) - lgamma(b_i/x) ]
    (samplea.c:65-67), batched; x broadcasts against the group axis."""
    xT = x[..., None]
    y = b / xT
    val = T * torch.log(xT) + torch.lgamma(T + y) - torch.lgamma(y)
    return torch.sum(val, dim=-1)


def _logpost_a(T, b, curve, grid: agrid.AGridTable):
    """The discount's log posterior on the grid curve: x (C,) -> (C,)."""
    def logpost(x):
        return _conc_terms(x, T, b) + grid.curve_at(curve, x)
    return logpost


def a_bounds(a0):
    """Start clamping + SQUEEZEA move bounds (samplea.c:161-177)."""
    mid = torch.clamp(a0, A_MIN * 0.999 + A_MAX * 0.001,
                      A_MAX * 0.999 + A_MIN * 0.001)
    lo = torch.where(mid - SQUEEZEA > A_MIN, mid - SQUEEZEA, A_MIN)
    hi = torch.where(mid + SQUEEZEA < A_MAX, mid + SQUEEZEA, A_MAX)
    return mid, lo, hi


def sample_a(gen, a0, grid: agrid.AGridTable, ns, ts, T, b,
             loops: int = 1, kernel: str = "slice",
             sparse_chunk: Optional[int] = None, mesh=None):
    """Discount posterior step using the grid curve (samplea semantics).

    Args:
      a0: (C,) current discounts.
      ns, ts: (C, P) or (P,) count/table pairs (flattened over groups and
        categories; zero-padded entries are masked by n<=1).  For large
        sparse workloads pass OCCUPIED pairs only (the getval capability,
        psample.h:101-115) -- from 2^18 pairs the curve reduction streams
        in chunks automatically; ``sparse_chunk`` forces the chunk size.
      T: (C, I) per-group table totals; b: (C, I) or (I,) concentrations.
      mesh: a parallel.mesh.ChainMesh whose "data" axis shards the pair
        axis: each rank passes its own pairs, its partial curve is summed
        over the data group (in rank order, so the peers of a group get
        the same curve and make the same move) before ``curve_at``.  The
        collective runs once, before the 1-D sampler: none sits inside
        its try loop, which each rank runs to its own slowest chain.
    Returns (a, ok).
    """
    with metrics.span("hyper.sample_a"):
        dt = a0.dtype
        T = torch.as_tensor(T, dtype=dt, device=a0.device)
        b = torch.as_tensor(b, dtype=dt, device=a0.device).expand(T.shape)
        ns = torch.as_tensor(ns, device=a0.device)
        ts = torch.as_tensor(ts, device=a0.device)
        if sparse_chunk is None and ns.shape[-1] >= (1 << 18):
            sparse_chunk = 1 << 16
        with metrics.span("hyper.curve"):
            if sparse_chunk:
                curve = grid.data_curve_sparse(ns, ts, chunk=sparse_chunk)
            else:
                curve = grid.data_curve(ns, ts)
        if mesh is not None:
            curve = pmesh.sum_over(curve, mesh, pmesh.DATA_AXIS)
        if curve.ndim == 1:                # shared data pairs across chains
            curve = curve.expand(a0.shape + curve.shape)
        # the moves compare differences of the log posterior only; a curve
        # of ~1e5 in size (check.c's 10^5 items) rounds each f32
        # evaluation by ~0.02, as much as a slice level sits below the
        # current point, and a chain can then run to the try cap.  Taken
        # from each chain's largest node it rounds by ~1e-5.
        curve = curve - curve.amax(dim=-1, keepdim=True)

        def card(gen, x0, lo, hi, loops):
            return slice_cuda.slice_move_a(gen, x0, lo, hi, T, b, curve,
                                           grid, loops)

        mid, lo, hi = a_bounds(a0)
        return _mcmc_1d(_logpost_a(T, b, curve, grid), gen, mid, lo, hi,
                        loops, kernel, card=card)


def sample_a_rebuild(gen, a0, ns, ts, T, b, n_max: int, m_max: int,
                     loops: int = 1, dtype=torch.float64):
    """Oracle discount sampler: refills the table inside every density
    evaluation, exactly like aterms (samplea.c:46-83).  Single chain or
    small batches; meant for f64/CPU validation of sample_a.

    The refill is the plain ``stirling.fill_rows`` + ``s1_ingraph`` at the
    chains' trial discounts, on ``a0``'s device whichever that is: it is a
    density evaluation, not a fill route of ``stirling.make``, so it goes
    through no kernel.  ``ns``, ``ts``: (P,) pairs shared by the chains."""
    a0 = torch.atleast_1d(torch.as_tensor(a0, dtype=dtype))
    dev = a0.device
    ns = torch.as_tensor(ns, device=dev)
    ts = torch.as_tensor(ts, device=dev)
    T = torch.as_tensor(T, dtype=dtype, device=dev)
    b = torch.as_tensor(b, dtype=dtype, device=dev).expand(T.shape)
    i = torch.clamp(ns - 1, 0, n_max - 1)
    j = torch.clamp(ts - 1, 0, m_max - 1)
    use = (ns > 1) & (ts >= 1) & (ts <= ns)

    def s_terms(x):
        """(C,) discounts -> (C,): refill each chain's table at its x and
        sum the log-S terms (the S_remake + S_S sum of aterms)."""
        _, srel, _ = stirling.fill_rows(x, n_max, m_max, dtype=dtype,
                                        with_srel=True)
        s1 = stirling.s1_ingraph(x[:, None], n_max, dtype)[:, i]
        vals = s1 + srel[:, i, j]
        vals = torch.where(ns == ts, 0.0, vals)
        vals = torch.where(ts == 1, s1, vals)
        return torch.sum(torch.where(use, vals, 0.0), dim=-1)

    def logpost(x):
        return _conc_terms(x, T, b) + s_terms(x)

    mid, lo, hi = a_bounds(a0)
    return slicemod.slice_sample(logpost, gen, mid, lo, hi, loops=loops)


def _pair_S(tab, n, m, a):
    """log S query batched over chains with per-chain discounts."""
    if isinstance(tab, agrid.AGridTable):
        return tab.S(n, m, a)
    return tab.S(n, m)


def sample_table_config(gen, tab, ns, ts, a, max_t: int, max_n: int):
    """Sample the table-size configuration (samplea2, samplea.c:293-323).

    For each (chain, pair) with 1 < t < n, draws the sizes of the t
    tables from their exact posterior given (n, t) by peeling one table
    at a time:  P(size = l | N remaining, M tables left) proportional to

        exp( sum_{j=2..l} log((j-a)(N-j+1)/(j-1)) ) S(N-l, M) / S(N, M+1)

    The reference's sequential log-CDF subtraction loop (samplea.c:
    303-317) becomes one Gumbel-max categorical over l = 1..max_n per
    step, vectorised over chains x pairs; the max_t - 1 peeling steps run
    in a Python loop, each drawing one (C, P, max_n) Gumbel block.

    The (j - a) factor above is the JAX function's, kept so that the two
    packages' histograms are equal under the same draws; the Pochhammer
    factor of a table of size l is prod_{j=2..l} (j - 1 - a), and with
    (j - a) the route's E[a] sits ~0.03 above the posterior mean on the
    tests' workload (tools/config_route_check_torch.py; ROADMAP Queue 3).

    Returns ``hist``: (C, max_n+1) counts of table sizes (index = size),
    aggregated over pairs, INCLUDING the t==1 whole-pair table of size n
    (aterms2's t==1 branch) and excluding t==n pairs (all singletons).

    Args:
      ns, ts: (C, P) int counts; a: (C,) discounts; tab: AGridTable or
      StirlingTable covering (max_n, max_t), on ``a``'s device.

    ``max_t`` must be >= max(ts) + 1 and ``max_n`` >= max(ns): the peel
    loop runs max_t - 1 steps, so a smaller max_t silently lumps the
    unpeeled tables into one oversized remainder, skewing the size
    histogram.  The reference derives maxt from the data for this reason
    (samplea.c:277-284); do the same at the call site.
    """
    dt, dev = a.dtype, a.device
    ns = torch.as_tensor(ns, device=dev).to(torch.int64)
    ts = torch.as_tensor(ts, device=dev).to(torch.int64)
    if ts.numel():
        if int(ts.max()) + 1 > max_t:
            raise ValueError(
                f"max_t={max_t} < max(ts)+1={int(ts.max()) + 1}: the "
                "peel loop would truncate table configurations")
        if int(ns.max()) > max_n:
            raise ValueError(f"max_n={max_n} < max(ns)={int(ns.max())}")
    C, P = ns.shape
    L = max_n
    lvec = torch.arange(1, L + 1, device=dev)         # candidate sizes
    jf = lvec.to(dt)
    a3 = a[:, None, None]
    # the part of fact(l)'s terms that does not depend on N
    base = (torch.log(torch.clamp(jf - a3, min=1e-12))
            - torch.log(torch.clamp(jf - 1.0, min=1e-12)))

    hist = torch.zeros((C, L + 1), dtype=dt, device=dev)

    def add(h, vals, live):
        """h[c, vals[c, p]] += 1 over the live pairs."""
        idx = torch.clamp(torch.where(live, vals, 0), 0, L)
        return h.scatter_add_(1, idx, live.to(dt))

    active_pair = (ts > 1) & (ts < ns)
    N = ns                                            # (C, P) remaining
    for s in range(max_t - 1):
        M = ts - 1 - s                                # tables left after this
        live = active_pair & (M >= 1)
        # fact(l) = sum_{j=2..l} log((j - a)(N - j + 1)/(j - 1))
        terms = base + torch.log(torch.clamp(
            N[..., None].to(dt) - jf + 1.0, min=1e-12))
        terms = torch.where(lvec >= 2, terms, 0.0)
        fact = torch.cumsum(terms, dim=-1)
        logS = _pair_S(tab, N[..., None] - lvec, M[..., None], a3)
        ok = lvec <= (N - M)[..., None]
        logw = torch.where(ok & live[..., None], fact + logS, -torch.inf)
        g = rng.gumbel(gen, logw.shape, dt, dev)
        size = 1 + torch.argmax(logw + g, dim=-1)     # (C, P)
        size = torch.where(live, size, 0)
        hist = add(hist, size, live)
        N = N - size
    # remainder table of each active pair
    hist = add(hist, N, active_pair)
    # t == 1 pairs: one table of size n
    return add(hist, torch.clamp(ns, max=L), (ts == 1) & (ns >= 1))


def sample_a_m(gen, a0, tab, ns, ts, T, b, max_t: int, max_n: int,
               loops: int = 1):
    """Discount step via the SAMPLEA_M config route (samplea2,
    samplea.c:244-340): sample the table configuration once, then slice
    sample ``a`` on the S-table-FREE posterior aterms2 (samplea.c:87-149)

        conc_terms(a) + sum_{sizes s >= 2} hist_s (lgamma(s - a)
                                                   - lgamma(1 - a)).

    Each density evaluation is an O(max_n) dot product -- no table fills,
    no table gathers -- which is why the reference calls this route
    "usually 70% faster" (psample.h:22-29).  Draws: the configuration's
    Gumbel blocks, then the slice uniforms.
    """
    dt, dev = a0.dtype, a0.device
    hist = sample_table_config(gen, tab, ns, ts, a0, max_t, max_n)
    T = torch.as_tensor(T, dtype=dt, device=dev)
    b = torch.as_tensor(b, dtype=dt, device=dev).expand(T.shape)
    svec = torch.arange(max_n + 1, dtype=dt, device=dev)
    hist = hist * (svec >= 2).to(dt)                  # sizes >= 2 only
    ntab = torch.sum(hist, dim=-1)

    def logpost(x):
        lg = torch.lgamma(torch.clamp(svec - x[:, None], min=1e-12))
        stir = torch.sum(hist * lg, dim=-1) - ntab * torch.lgamma(1.0 - x)
        return _conc_terms(x, T, b) + stir

    mid, lo, hi = a_bounds(a0)
    return slicemod.slice_sample(logpost, gen, mid, lo, hi, loops=loops)


def _bterms(x, Q, T, shape, a):
    """Concentration log posterior for a>0 (sampleb.c:33-41)."""
    safe_a = torch.where(a > 0, a, 1.0)
    y = (x / safe_a)[..., None]
    val = -Q * x + (shape - 1.0) * torch.log(x)
    return val + torch.sum(torch.lgamma(T + y) - torch.lgamma(y), dim=-1)


def _logpost_b(Q, T, shape, a):
    """The concentration's log posterior for a > 0: x (C,) -> (C,)."""
    def logpost(x):
        return _bterms(x, Q, T, shape, a)
    return logpost


def _bmax(x, Q, T, shape, a, iters: int = 5):
    """Newton warm start for the concentration move (sampleb.c:51-68)."""
    safe_a = torch.where(a > 0, a, 1.0)
    groups = T.shape[-1]
    x = x * 1.1
    for _ in range(iters):
        val = ((shape - 1.0) * safe_a / x - Q * safe_a
               + torch.sum(special.digamma(T + (x / safe_a)[..., None]),
                           dim=-1))
        x = safe_a * special.digamma_inv(val / groups)
    return torch.clamp(x, B_MIN, B_MAX)


def sample_b(gen, b0, N, T, a, shape: float, scale: float,
             loops: int = 1, kernel: str = "slice",
             with_info: bool = False):
    """Concentration posterior step (sampleb.c:79-159), batched.

    Args:
      b0: (C,) current values; N, T: (C, I) or (I,) group totals;
      a: (C,) discounts (a==0 chains take the conjugate draw, a>0 chains
      the 1-D kernel's move).
    Draws, in order: two loggamma blocks, one gamma block, the kernel's
    draws.  Returns (b, ok), and with ``with_info`` the per-chain count of
    density evaluations as a third element (ARS; 0 for the slice kernel
    and for conjugate chains).
    """
    with metrics.span("hyper.sample_b"):
        dt, dev = b0.dtype, b0.device
        a = torch.as_tensor(a, dtype=dt, device=dev).expand(b0.shape)
        N = torch.as_tensor(N, dtype=dt, device=dev)
        T = torch.as_tensor(T, dtype=dt, device=dev)
        if N.ndim < b0.ndim + 1:
            N = N.expand(b0.shape + N.shape[-1:])
        if T.ndim < b0.ndim + 1:
            T = T.expand(b0.shape + T.shape[-1:])

        # auxiliary variables (sampleb.c:90-100); N_i==0 groups contribute
        # 0.  log q ~ log Beta(b, N_i) from two loggamma draws, so small b
        # does not underflow q to 0 in f32 (the reference exits(1) there,
        # sampleb.c:96).
        bshape = torch.broadcast_shapes(b0[..., None].shape, N.shape)
        lg1 = rng.loggamma(gen, torch.clamp(b0[..., None], min=B_MIN * 1e-3)
                           .expand(bshape))
        lg2 = rng.loggamma(gen, torch.clamp(N, min=1.0).expand(bshape))
        logq = lg1 - torch.logaddexp(lg1, lg2)
        logq = torch.where(N > 0, logq, 0.0)
        Q = 1.0 / scale - torch.sum(logq, dim=-1)

        # a == 0: conjugate Gamma (sampleb.c:101-118)
        Tsum = shape + torch.sum(T, dim=-1)
        conj = torch.clamp(rng.gamma(gen, Tsum) / Q, B_MIN, B_MAX)

        # a > 0: slice / ARS on bterms (sampleb.c:119-153)
        def card(gen, x0, lo, hi, loops):
            return slice_cuda.slice_move_b(gen, x0, lo, hi, Q, T, shape,
                                           a.contiguous(), loops)

        if kernel == "ars":
            # ARS over the full [B_MIN, B_MAX] range wastes envelope points
            # on a 2000-wide domain; bound it around the Newton mode like
            # the reference's ARS setup does via its initial points
            # (sampleb.c:125-131).  ARS draws are (approximately)
            # independent conditional draws, so a mode-informed window is
            # safe.
            mode = _bmax(torch.clamp(b0, B_MIN, B_MAX), Q, T, shape, a)
            lo = torch.clamp(mode * 0.05, min=B_MIN)
            hi = torch.clamp(mode * 20.0 + 1.0, max=B_MAX)
            start = mode
        else:
            # The slice transition must start at the CURRENT value: a mode
            # start breaks detailed balance (libstb_tpu's sample_b notes the
            # measured ~15% bias)
            lo = torch.full_like(b0, B_MIN)
            hi = torch.full_like(b0, B_MAX)
            start = torch.clamp(b0, B_MIN, B_MAX)
        res = _mcmc_1d(_logpost_b(Q, T, shape, a), gen, start, lo, hi,
                       loops, kernel, with_info=with_info, card=card)
        out = torch.where(a > 0, res[0], conj)
        ok = res[1] | (a <= 0)
        if with_info:
            # conjugate (a==0) chains draw exactly, no density evals
            return out, ok, torch.where(a > 0, res[2], 0)
        return out, ok
