"""Discount-grid Stirling tables, in PyTorch.

Port of libstb_tpu/core/agrid.py (see its docstring for the design): V and
Srel tables are filled once for a uniform grid of discounts, and queries
at any per-chain ``a`` interpolate along the grid axis by Catmull-Rom
cubics.  The fill runs where the tensors live: the hand-written CUDA
kernel on a GPU, the plain fill on the CPU (ops/stirling_cuda.fill_grid).

``data_curve`` always takes the gather route (``_data_curve_gather``);
the JAX package's one-hot matmul route is ported as ``_data_curve_mm``,
held to both JAX routes by tests/test_torch_agrid.py and timed beside the
gather route on the card (PERF.md section 6), but no caller takes it;
``data_curve_sparse`` streams the gather reduction over the pairs in
chunks.  ``make_grid(mesh=...)`` is the sharded fill: each process fills
its share of the discounts and the shares are all-gathered, so every rank
holds the whole grid (a query at any chain's ``a`` reads every discount,
and a torch tensor has no global form to shard it by).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import stirling_cuda
from ..parallel import distributed
from ..parallel import mesh as pmesh
from ..utils import yaps
from . import stirling

__all__ = ["AGridTable", "make_grid", "ensure_grid", "required_dims"]

# the most bytes _data_curve_mm's one-hot or row block takes at once
MM_BUDGET = 256 << 20


def _catmull_weights(t, dtype):
    """Catmull-Rom basis at offset t in [0,1] for nodes (-1, 0, 1, 2)."""
    t = t.to(dtype)
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t3 + 2 * t2 - t)
    w1 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w2 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    return w0, w1, w2, w3


@dataclasses.dataclass(frozen=True)
class AGridTable:
    """Stacked Stirling tables over a uniform discount grid.

    srel[g, i, j] = log S(i+1, j+1; a_g) - S1(i+1; a_g)
    vtab[g, i, j] = V(i+1, j+1; a_g)
    s1_hi[g, i] + s1_lo[g, i] = log S^{i+1}_{1, a_g} (f64 host values,
                    split into a hi/lo pair for f32 tables)

    Queries take ints/floats or tensors; ``a`` may carry one discount per
    chain and broadcasts against ``n``/``m``.
    """
    a0: float
    da: float
    g_max: int
    n_max: int
    m_max: int
    avec: torch.Tensor                   # (G,)
    s1_hi: torch.Tensor                  # (G, N)
    s1_lo: torch.Tensor                  # (G, N)
    vtab: Optional[torch.Tensor]         # (G, N, M)
    srel: Optional[torch.Tensor]         # (G, N, M)
    max_n: int = 0                       # hard bounds, 0 = (n_max, m_max)
    max_m: int = 0
    use_asympt: bool = True
    tag: str = ""

    @property
    def device(self) -> torch.device:
        return self.s1_hi.device

    @property
    def _a_sign(self) -> str:
        """Asymptote-branch selector: a0 > 0 makes every interpolated
        discount positive."""
        return "pos" if self.a0 > 0 else "any"

    def _hard_n(self) -> int:
        return self.max_n if self.max_n else self.n_max

    def _hard_m(self) -> int:
        return self.max_m if self.max_m else self.m_max

    def report(self) -> str:
        """One-line stats string (S_report analog, stable.c:1025-1055)."""
        nbytes = sum(x.numel() * x.element_size()
                     for x in (self.vtab, self.srel, self.s1_hi, self.s1_lo)
                     if x is not None)
        name = f" '{self.tag}'" if self.tag else ""
        return (f"a-grid{name}: G={self.g_max} a=[{self.a0:g},"
                f"{self.a0 + self.da * (self.g_max - 1):g}], "
                f"N={self.n_max}/{self._hard_n()}, "
                f"M={self.m_max}/{self._hard_m()}, "
                f"{'+S' if self.srel is not None else ''}"
                f"{'+U/V' if self.vtab is not None else ''} "
                f"{str(self.s1_hi.dtype).replace('torch.', '')} "
                f"mem={nbytes // 1024}k")

    def _int(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _a(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.s1_hi.dtype, device=self.device)

    # -- grid locate --------------------------------------------------------
    def _locate(self, a):
        """Return (g0, t): base index for the 4-point stencil and offset."""
        dt = self.s1_hi.dtype
        pos = (self._a(a) - self.a0) / self.da
        g = torch.clamp(torch.floor(pos).to(torch.int64), 1, self.g_max - 3)
        t = pos - g.to(dt)
        return g, t

    # -- queries ------------------------------------------------------------
    def S(self, n, m, a):
        """log S^n_{m,a} by cubic interpolation (S_S, stable.c:941-974).

        Total function: n==m -> 0, m==1 -> S1, m<1 or n<m -> -inf; beyond
        (n_max, m_max) the asymptote when ``use_asympt`` else -inf."""
        n, m, af = self._int(n), self._int(m), self._a(a)
        dt = self.srel.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        g, t = self._locate(af)
        w = _catmull_weights(t, dt)
        acc = torch.zeros(torch.broadcast_shapes(n.shape, m.shape, af.shape),
                          dtype=dt, device=self.device)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * (self.s1_hi[gk, i] + self.srel[gk, i, j]
                                + self.s1_lo[gk, i])
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.use_asympt:
            lga1 = torch.lgamma(1.0 - af)
            asy = stirling.s_asympt(af, lga1, torch.clamp(n, min=1).to(dt),
                                    torch.clamp(m, min=1).to(dt),
                                    a_sign=self._a_sign)
            acc = torch.where(in_tab, acc, asy.to(dt))
        else:
            acc = torch.where(in_tab, acc, -torch.inf)
        acc = torch.where(n == m, 0.0, acc)
        acc = torch.where(m == 1, self.S1(n, af), acc)
        return torch.where((m < 1) | (n < m), -torch.inf, acc)

    def Srel(self, n, m, a):
        """log S^n_{m,a} - log S^n_{1,a} (difference form; -inf-safe).
        Out-of-grid queries follow S()'s asymptote/-inf conventions."""
        n, m, af = self._int(n), self._int(m), self._a(a)
        dt = self.srel.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        g, t = self._locate(af)
        w = _catmull_weights(t, dt)
        acc = torch.zeros(torch.broadcast_shapes(n.shape, m.shape, af.shape),
                          dtype=dt, device=self.device)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * self.srel[gk, i, j]
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.use_asympt:
            lga1 = torch.lgamma(1.0 - af)
            asy = stirling.s_asympt(af, lga1, torch.clamp(n, min=1).to(dt),
                                    torch.clamp(m, min=1).to(dt),
                                    a_sign=self._a_sign)
            acc = torch.where(in_tab, acc, (asy - self.S1(n, af)).to(dt))
        else:
            acc = torch.where(in_tab, acc, -torch.inf)
        acc = torch.where(m == 1, 0.0, acc)
        acc = torch.where(n == m, -self.S1(n, af), acc)
        return torch.where((m < 1) | (n < m), -torch.inf, acc)

    def S1(self, n, a):
        """log S^n_{1,a}; beyond the grid rows the exact lgamma formula
        (stable.h:154-160) replaces the table read."""
        n, af = self._int(n), self._a(a)
        dt = self.s1_hi.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        g, t = self._locate(af)
        w = _catmull_weights(t, dt)
        acc = torch.zeros(torch.broadcast_shapes(n.shape, af.shape),
                          dtype=dt, device=self.device)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * (self.s1_hi[gk, i] + self.s1_lo[gk, i])
        beyond = (torch.lgamma(torch.clamp(n, min=1).to(dt) - af)
                  - torch.lgamma(1.0 - af))
        acc = torch.where(n <= self.n_max, acc, beyond)
        return torch.where(n >= 1, acc, -torch.inf)

    def V(self, n, m, a):
        """V^n_{m,a} interpolated in a (S_V, stable.c:900-939): 0 out of
        domain; beyond n_max the V asymptote (stable.c:905-912) when
        ``use_asympt``, else 0."""
        n, m, af = self._int(n), self._int(m), self._a(a)
        dt = self.vtab.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        g, t = self._locate(af)
        w = _catmull_weights(t, dt)
        acc = torch.zeros(torch.broadcast_shapes(n.shape, m.shape, af.shape),
                          dtype=dt, device=self.device)
        for k in range(4):
            gk = g - 1 + k
            acc = acc + w[k] * self.vtab[gk, i, j]
        in_tab = (n <= self.n_max) & (m <= self.m_max)
        if self.use_asympt:
            asy = stirling.v_asympt(af, torch.clamp(n, min=2).to(dt),
                                    torch.clamp(m, min=2).to(dt),
                                    a_sign=self._a_sign).to(dt)
            acc = torch.where(in_tab, acc,
                              torch.where(n > self.n_max, asy, 0.0))
        else:
            acc = torch.where(in_tab, acc, 0.0)
        return torch.where((m < 2) | (n < m), 0.0, acc)

    def U(self, n, m, a):
        n, m, af = self._int(n), self._int(m), self._a(a)
        dt = self.vtab.dtype
        v = self.V(n, m, af)
        safe = torch.where(v > 0, v, 1.0)
        gen = n.to(dt) - m.to(dt) * af + 1.0 / safe
        return torch.where(m == 1, n.to(dt) - af,
                           torch.where(v > 0, gen, 0.0))

    def data_curve(self, ns, ts, weights=None):
        """sum_k w_k * log S(n_k, t_k; a_g) for every grid point g.

        Entries with n<=1 contribute 0 (samplea.c:73-79 skips n<=1); t==n
        contributes 0 and t==1 contributes S1.  Returns (G,), or (..., G)
        for ts/ns with leading axes.  Out-of-grid non-identity pairs must
        be covered by growing the grid first (ensure_grid).

        Every input takes the gather route, ``_data_curve_gather``, where
        the JAX package takes its one-hot matmul route for shared ``ns``
        and m_max <= 512.  ``_data_curve_mm`` is that route; both are timed
        on the card in PERF.md section 6, and which one ``sample_a`` should
        take is left to a benchmark cell (ROADMAP.md)."""
        return self._data_curve_gather(ns, ts, weights)

    def _data_curve_gather(self, ns, ts, weights=None):
        """data_curve by gathers: (G, ..., P) table reads, masked and
        summed over the pairs (libstb_tpu/core/agrid.py:258-272)."""
        ns, ts = self._int(ns), self._int(ts)
        shape = torch.broadcast_shapes(ns.shape, ts.shape)
        ns = ns.expand(shape)
        ts = ts.expand(shape)
        i = torch.clamp(ns - 1, 0, self.n_max - 1)
        j = torch.clamp(ts - 1, 0, self.m_max - 1)
        dt = self.srel.dtype
        vals = self.s1_hi[:, i] + self.srel[:, i, j] + self.s1_lo[:, i]
        vals = torch.where(ns == ts, 0.0, vals)
        vals = torch.where(ts == 1, self.s1_hi[:, i] + self.s1_lo[:, i], vals)
        mask = (ns > 1) & (ts >= 1) & (ts <= ns)
        w = mask.to(dt) if weights is None else weights * mask
        out = torch.sum(vals * w, dim=-1)         # (G, ...) summed over pairs
        return torch.movedim(out, 0, -1)          # (..., G)

    def _data_curve_mm(self, ns, ts, weights=None):
        """data_curve as a one-hot contraction for counts ``ns`` (P,)
        shared by the chains (libstb_tpu/core/agrid.py:315-343): rows[g, p,
        m] = S1(n_p) + Srel(n_p, m + 1), non-finite rows zeroed (-inf * 0
        is NaN), times the one-hot of clip(t - 1) weighted by the mask
        (n > 1) & (1 <= t <= n) & (t != n).  ``ts``: (..., P); returns
        (..., G).

        The pair axis runs in chunks so that neither the (C, chunk * M)
        one-hot nor the (G, chunk, M) row block passes MM_BUDGET bytes;
        the chunks' products are summed.  Each product is taken in f64
        and the sum rounded to the table's dtype once: the TF32 switches
        (torch.backends.cuda.matmul.allow_tf32,
        torch.set_float32_matmul_precision) reach only f32 products, and a
        10-bit mantissa on log S ~ 10^4 would move the curve by ~10."""
        ns, ts = self._int(ns), self._int(ts)
        if ns.ndim != 1:
            raise ValueError(f"_data_curve_mm: ns must be the (P,) counts "
                             f"the chains share, got shape {tuple(ns.shape)}")
        dt, G, M = self.srel.dtype, self.g_max, self.m_max
        P = ns.shape[-1]
        lead = ts.shape[:-1]
        ts = ts.reshape(-1, P)
        C = ts.shape[0]
        w_all = None if weights is None else torch.as_tensor(
            weights, dtype=dt, device=self.device).expand(
                lead + (P,)).reshape(C, P)
        f64 = torch.float64
        chunk = max(1, min(P, MM_BUDGET // (8 * M * max(C, G))))
        out = torch.zeros((C, G), dtype=f64, device=self.device)
        for p0 in range(0, P, chunk):
            n, t = ns[p0:p0 + chunk], ts[:, p0:p0 + chunk]
            i = torch.clamp(n - 1, 0, self.n_max - 1)
            rows = (self.s1_hi[:, i, None] + self.srel[:, i, :]
                    + self.s1_lo[:, i, None])           # (G, chunk, M)
            rows = torch.where(torch.isfinite(rows), rows, 0.0)
            mask = (n > 1) & (t >= 1) & (t <= n) & (t != n)
            w = (mask.to(dt) if w_all is None
                 else w_all[:, p0:p0 + chunk] * mask)
            j = torch.clamp(t - 1, 0, M - 1)
            oh = torch.zeros(t.shape + (M,), dtype=f64, device=self.device)
            oh.scatter_(-1, j[..., None].long(), w[..., None].to(f64))
            out += oh.reshape(C, -1) @ rows.reshape(G, -1).to(f64).T
        return out.to(dt).reshape(lead + (G,))

    def data_curve_sparse(self, ns, ts, weights=None, chunk: int = 65536):
        """Streaming data_curve (the ``getval`` capability,
        psample.h:101-115): the gather reduction taken over the pair axis
        ``chunk`` pairs at a time, so sample_a handles 10^6 occupied pairs
        without a (G, C, P) intermediate -- peak memory is O(G * C *
        chunk), the work that of the gather route.

        ``ns``: (P,) counts; ``ts``: (P,) or (C, P) tables; the caller
        passes OCCUPIED pairs only.  Returns data_curve's (..., G) curve."""
        ns, ts = self._int(ns), self._int(ts)
        lead = torch.broadcast_shapes(ns.shape, ts.shape)[:-1]
        out = torch.zeros(lead + (self.g_max,), dtype=self.srel.dtype,
                          device=self.device)
        for p0 in range(0, ns.shape[-1], chunk):
            seg = slice(p0, p0 + chunk)
            out = out + self._data_curve_gather(
                ns[..., seg], ts[..., seg],
                None if weights is None else weights[..., seg])
        return out

    def curve_at(self, curve, a):
        """Cubic interpolation of a (..., G) curve (from data_curve) at a;
        batched curves pair with batched a along the leading axes."""
        g, t = self._locate(a)
        w = _catmull_weights(t, curve.dtype)
        if curve.ndim == 1:
            return (w[0] * curve[g - 1] + w[1] * curve[g]
                    + w[2] * curve[g + 1] + w[3] * curve[g + 2])
        acc = torch.zeros(g.shape, dtype=curve.dtype, device=curve.device)
        for k in range(4):
            idx = (g - 1 + k)[..., None]
            acc = acc + w[k] * torch.gather(curve, -1, idx)[..., 0]
        return acc


def make_grid(n_max: int, m_max: int, g: int = 100,
              a_lo: float = 0.0, a_hi: float = 0.99,
              build_s: bool = True, build_v: bool = True,
              dtype=torch.float32, *, device=None, mesh=None,
              max_n: int = 0, max_m: int = 0,
              use_asympt: bool = True, tag: str = "") -> AGridTable:
    """Fill tables for a uniform discount grid on ``device`` (default: the
    mesh's device, else the card).

    The default [0, 0.99] covers the sampler bounds A_MIN=0.01..A_MAX=0.98
    (psample.h:89-90) with a full 4-point stencil inside.  On a CUDA
    device the fill is the hand-written kernel K1 (f32 or f64); on the CPU
    the plain fill.  ``max_n``/``max_m``: hard bounds (0 = no growth
    headroom); ``use_asympt``: asymptote policy for out-of-grid queries.

    ``mesh`` (parallel.mesh.ChainMesh): every process fills ``g / P`` of
    the discounts (``g`` must divide by the P processes), then the V,
    Srel and S1 shares are all-gathered along the grid axis.  Each
    discount's walk is independent, so the gathered grid equals a
    one-process fill of the same discounts bitwise."""
    avec = np.linspace(a_lo, a_hi, g)
    if mesh is not None:
        shard = _fill_shard(avec, n_max, m_max, build_s, build_v, dtype,
                            mesh, device)
        parts = _gather_shard(shard, mesh)
        return _grid(avec, *parts, n_max, m_max, max_n, max_m, use_asympt,
                     tag)
    s1 = np.stack([stirling.s1_host(float(a), n_max) for a in avec])
    return _finish_grid(avec, s1, n_max, m_max, build_s, build_v, dtype,
                        distributed.local_device(device), max_n, max_m,
                        use_asympt, tag)


def _fill(avec, s1, n_max, m_max, build_s, build_v, dtype, device):
    """(a, s1_hi, s1_lo, V or None, Srel or None) tensors of discounts
    ``avec`` with host S1 rows ``s1``, filled on ``device``."""
    if dtype == torch.float64:
        s1_hi = torch.as_tensor(s1, device=device)
        s1_lo = torch.zeros_like(s1_hi)
    else:
        hi, lo = stirling._split_hi_lo(s1)
        s1_hi = torch.as_tensor(hi, device=device)
        s1_lo = torch.as_tensor(lo, device=device)
    a_t = torch.as_tensor(avec, dtype=dtype, device=device)
    vtab, srel = stirling_cuda.fill_grid(a_t, n_max, m_max, with_srel=build_s)
    return (a_t, s1_hi, s1_lo, vtab if build_v else None,
            srel if build_s else None)


def _grid(avec, a_t, s1_hi, s1_lo, vtab, srel, n_max, m_max, max_n=0,
          max_m=0, use_asympt=True, tag=""):
    return AGridTable(
        a0=float(avec[0]), da=float(avec[1] - avec[0]), g_max=len(avec),
        n_max=n_max, m_max=m_max, avec=a_t, s1_hi=s1_hi, s1_lo=s1_lo,
        vtab=vtab, srel=srel, max_n=max_n, max_m=max_m,
        use_asympt=use_asympt, tag=tag)


def _finish_grid(avec, s1, n_max, m_max, build_s, build_v, dtype, device,
                 max_n=0, max_m=0, use_asympt=True, tag=""):
    return _grid(avec, *_fill(avec, s1, n_max, m_max, build_s, build_v,
                              dtype, device),
                 n_max, m_max, max_n, max_m, use_asympt, tag)


def _fill_shard(avec, n_max, m_max, build_s, build_v, dtype, mesh,
                device=None):
    """This process's share of a sharded grid fill: the tensors of
    ``_fill`` for discounts [r g / P, (r + 1) g / P) of ``avec``."""
    P, g = mesh.world, len(avec)
    if g % P:
        raise ValueError(f"grid size {g} not divisible by the mesh's {P} "
                         "processes")
    r = distributed.rank()
    mine = avec[r * (g // P):(r + 1) * (g // P)]
    s1 = np.stack([stirling.s1_host(float(a), n_max) for a in mine])
    return _fill(mine, s1, n_max, m_max, build_s, build_v, dtype,
                 mesh.device if device is None else torch.device(device))


def _gather_shard(shard, mesh):
    """All-gather a ``_fill_shard`` result along the grid axis: every rank
    gets the whole grid's tensors."""
    return tuple(None if x is None else pmesh._all_gather(x, mesh.world_group)
                 for x in shard)


def _grow_bucket(used: int, want: int) -> int:
    """S_extend's >=10%-or-+50 hysteresis, rounded to buckets
    (stable.c:590-630 semantics, same policy as the JAX package)."""
    if want <= used:
        return used
    want = max(want, int(used * 1.1), used + 50)
    k = int(np.floor(np.log2(max(want, 64))))
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        b = int(frac * 2 ** k)
        if b >= want:
            return b
    return want


def ensure_grid(grid: AGridTable, n: int, m: int,
                quit_on_bound: bool = False) -> AGridTable:
    """Growth for grid tables (the S_extend analog, host-level): returns a
    (possibly new) grid covering (n, m) with bucketed dimensions, refilled
    on the grid's device.  Growth clamps at the hard bounds; with
    ``quit_on_bound`` hitting them raises LibstbError instead."""
    n = int(n) + 1
    m = int(m) + 1
    if quit_on_bound and (n > grid._hard_n() or m > grid._hard_m()):
        yaps.quit("a-grid%s: ensure_grid(%d,%d) hit hard bounds (%d,%d) "
                  "(stable.c:915-917)",
                  f" '{grid.tag}'" if grid.tag else "",
                  n, m, grid._hard_n(), grid._hard_m())
    n = min(n, grid._hard_n())
    m = min(m, grid._hard_m())
    if n <= grid.n_max and m <= grid.m_max:
        return grid
    new_n = min(_grow_bucket(grid.n_max, max(n, grid.n_max)), grid._hard_n())
    new_m = min(_grow_bucket(grid.m_max, max(m, grid.m_max)), new_n,
                grid._hard_m())
    # the discounts make_grid filled, in f64 (grid.avec holds them in the
    # grid's dtype: refilled there, an f32 grid's S1 would move by ~1e-6)
    avec = np.linspace(grid.a0, grid.a0 + grid.da * (grid.g_max - 1),
                       grid.g_max)
    s1 = np.stack([stirling.s1_host(float(a), new_n) for a in avec])
    return _finish_grid(avec, s1, new_n, new_m,
                        grid.srel is not None, grid.vtab is not None,
                        grid.s1_hi.dtype, grid.device,
                        grid.max_n, grid.max_m, grid.use_asympt, grid.tag)


def required_dims(data_n, t=None):
    """(n, m) the grid must cover for a Gibbs run over category counts
    ``data_n``: n = max count + 1, m = max table count + 1 (bounded by the
    counts unless a state ``t`` with larger entries is supplied)."""
    n_req = int(np.asarray(data_n).max()) + 1
    m_req = n_req
    if t is not None:
        m_req = max(m_req, int(np.asarray(t).max()) + 1)
    return n_req, m_req
