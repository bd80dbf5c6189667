"""Stirling-number table engine, in PyTorch.

Port of libstb_tpu/core/stirling.py (see that module's docstring for the
design):

* ``s1_host`` / ``_split_hi_lo``: the host f64 S1 column and its f32 hi/lo
  split (numpy copies, held equal to the originals by
  tests/test_torch_stirling.py); ``s1_anchored``: the pair from f64 host
  anchors every 32 rows and f32 log prefix sums on the device, which
  ``make`` takes for long f32 tables on a card (``s1_route``);
  ``s1_ingraph`` for a tensor ``a``;
* ``fill_rows``: the V-ratio recurrence walked over n, with Srel as the
  per-row prefix sum of log V, and its resume form -- the plain version of
  the CUDA fills (ops/stirling_cuda.py) and their oracle;
* ``s_asympt`` / ``v_asympt``: the out-of-table asymptotes;
* ``StirlingTable`` with ``make`` / ``remake`` / ``ensure``: the single-
  table path.  On a CUDA device ``make`` fills with the hand-written
  kernels (``fill_route`` says which), on the CPU with ``fill_rows``.

Layout as in the JAX package: index ``[..., i, j]`` holds n = i+1,
m = j+1; column 0 of V holds +inf and cells with m > n hold 0.  A table
filled by the column kernel keeps that kernel's column-major layout
(``StirlingTable.cols``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..parallel.distributed import local_device
from ..utils import metrics, yaps

__all__ = ["StirlingTable", "make", "s1_anchored", "remake", "ensure",
           "fill_route", "s1_route", "fill_rows", "s1_host", "s1_ingraph",
           "s_asympt", "v_asympt"]


def s1_host(a: float, n_max: int) -> np.ndarray:
    """Host-side f64 S1 vector, s1[i] = log S^{i+1}_{1,a} (stable.h:154-160)."""
    from scipy.special import gammaln

    n = np.arange(1, n_max + 1, dtype=np.float64)
    return gammaln(n - a) - gammaln(1.0 - a)


def s1_ingraph(a, n_max: int, dtype=torch.float32, device=None):
    """S1 for a tensor ``a`` (the rebuild-per-eval oracle path of samplea,
    samplea.c:57-60) by torch lgamma, on ``a``'s device; a plain-number
    ``a`` goes to ``device``, by default the card (raising where there is
    none).  The host path is preferred whenever ``a`` is a plain number."""
    if not isinstance(a, torch.Tensor):
        device = local_device(device)
    a = torch.as_tensor(a, dtype=dtype, device=device)
    n = torch.arange(1, n_max + 1, dtype=dtype, device=a.device)
    return torch.lgamma(n - a) - torch.lgamma(1.0 - a)


def _split_hi_lo(x64: np.ndarray):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


_S1_CHUNK = 32


def _s1_device_fill(anchor_hi, anchor_lo, a, n_max: int):
    """Anchored S1 hi/lo pair on the anchors' device (see s1_anchored)."""
    B = _S1_CHUNK
    nc = n_max // B
    dt = torch.float32
    # terms t_i = log(i - a) for i >= 1 (the increment S1[i] - S1[i-1]);
    # within chunk c the prefix P_i = sum_{k=cB+1..i} t_k restarts at 0
    idx = torch.arange(n_max, dtype=dt,
                       device=anchor_hi.device).reshape(nc, B)
    term = torch.where(idx >= 1.0,
                       torch.log(torch.abs(idx - a) + (idx < 1.0).to(dt)),
                       0.0)
    # chunk position 0 is the anchor row itself (P = 0); positions
    # 1..B-1 accumulate terms
    term[:, 0] = 0.0
    pref = torch.cumsum(term, dim=1)
    s1_hi = anchor_hi[:, None].expand(nc, B).reshape(-1)
    s1_lo = (anchor_lo[:, None] + pref).reshape(-1)
    return s1_hi, s1_lo


def _s1_anchors(a: float, n_max: int):
    """The f64 host anchors of s1_anchored, S1 at rows 1, 1 + B, ...,
    split into f32 (hi, lo)."""
    from scipy.special import gammaln

    assert n_max % _S1_CHUNK == 0
    rows = np.arange(0, n_max, _S1_CHUNK, dtype=np.float64) + 1.0
    return _split_hi_lo(gammaln(rows - a) - gammaln(1.0 - a))


def s1_anchored(a: float, n_max: int, *, device):
    """S1 hi/lo computed on ``device`` from f64 host anchors, the JAX
    package's route for long f32 tables on its accelerator: the host
    evaluates one anchor per ``_S1_CHUNK`` rows (2^15 gammaln calls at
    2^20 rows, not 2^20) and the device fills the within-chunk log prefix
    sums:

        S1[i] = A_c + sum_{k=cB+1..i} log(k - a),   c = i // B,

    stored as (hi, lo) = (f32(A_c), f32(A_c - hi) + P_i), all in f32.
    |S1_device - S1_host| <= ~5e-4 absolute at any n (32 f32 log terms of
    <~1.5e-6 each, and eps * |P| per add).  Requires n_max % _S1_CHUNK ==
    0."""
    hi, lo = _s1_anchors(a, n_max)
    device = torch.device(device)
    with metrics.span("make.s1_upload"):
        hi = torch.as_tensor(hi, device=device)
        lo = torch.as_tensor(lo, device=device)
        a_t = torch.tensor(a, dtype=torch.float32, device=device)
    return _s1_device_fill(hi, lo, a_t, n_max)


def _v_first_row(m_max: int, dtype, device, batch=()) -> torch.Tensor:
    """Row n=1: col0=+inf (V(n,1) sentinel), rest 0 (m>n undefined)."""
    row = torch.zeros(tuple(batch) + (m_max,), dtype=dtype, device=device)
    row[..., 0] = torch.inf
    return row


def _v_step(vrow, n: int, mvec, a):
    """One row of the V recurrence (stable.c:475-482), vectorised over m.

    vrow[..., j] = V(n-1, j+1) with the col0=+inf / m>n-1 = 0 invariant;
    ``a`` broadcasts against vrow's leading axes (shape (..., 1)).
    """
    nm1 = n - 1
    inf = torch.full(vrow.shape[:-1] + (1,), torch.inf, dtype=vrow.dtype,
                     device=vrow.device)
    shift = torch.cat([inf, vrow[..., :-1]], dim=-1)
    numer = 1.0 + (nm1 - mvec * a) * vrow
    denom = 1.0 / shift + (nm1 - (mvec - 1.0) * a)
    return numer / denom


def fill_rows(a, n_max: int, m_max: int, dtype=torch.float32,
              with_srel: bool = True, device=None,
              v_start: Optional[torch.Tensor] = None, n_start: int = 1):
    """Fill V (and Srel) rows for n = n_start..n_max.

    ``a``: a scalar or a (G,) tensor of discounts; outputs carry a's shape
    in front: V and Srel are (..., n_max - n_start + 1, m_max).  Returns
    (V, Srel, v_last) like the JAX fill_rows (Srel is None without
    ``with_srel``); V[..., i, :] is the row for n = n_start+i and
    Srel[..., i, j] = log S(n, j+1) - S1(n), Srel[..., 0] == 0.

    Resume form (S_remake_part's startN path, stable.c:315-320):
    ``v_start`` is the V row for n = ``n_start`` (the v_last of an earlier
    fill); the walk continues from it, and the start row's Srel is
    recomputed from ``v_start``.
    """
    a = torch.as_tensor(a, dtype=dtype, device=device)
    av = a[..., None]
    mvec = torch.arange(1, m_max + 1, dtype=dtype, device=a.device)
    vtab = torch.empty(a.shape + (n_max - n_start + 1, m_max), dtype=dtype,
                       device=a.device)
    if v_start is None:
        v = _v_first_row(m_max, dtype, a.device, a.shape)
    else:
        v = v_start.to(dtype=dtype, device=a.device)
    vtab[..., 0, :] = v
    for n in range(n_start + 1, n_max + 1):
        v = _v_step(v, n, mvec, av)
        vtab[..., n - n_start, :] = v
    if not with_srel:
        return vtab, None, v
    # Srel(n, m) = sum_{j=2..m} log V(n, j); log V(n, 1) = log(+inf) is
    # replaced by 0, and log 0 = -inf above the diagonal propagates along m.
    # The start row follows the same rule: [0, -inf, ...] for a fresh fill,
    # the recomputed prefix sum of log v_start for a resumed one.
    srel = torch.log(vtab)
    srel[..., 0] = 0.0
    srel.cumsum_(dim=-1)
    return vtab, srel, v


def _result_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def s_asympt(a, lga1, n, m, a_sign: str = "any"):
    """log S^n_{m,a} asymptote for n beyond table bounds.

    a>0: Hutter's  Gamma(n) / (Gamma(1-a) Gamma(m) a^{m-1} n^a) with the
    (m-1)log(1-n^-a) refinement (stable.c:1066-1083); a==0: Hwang 2001
    (stable.c:1059-1065).  ``lga1`` = lgamma(1-a) precomputed.
    ``a_sign``: "pos"/"zero" selects the branch when the sign of ``a`` is
    known (tables store it); "any" evaluates both and selects per element.
    """
    n = _result_float(n)
    m = torch.as_tensor(m, dtype=n.dtype, device=n.device)
    a = torch.as_tensor(a, dtype=n.dtype, device=n.device)
    ln = torch.log(n)
    if a_sign != "pos":
        hwang = (torch.lgamma(n) + (m - 1.0) * torch.log(ln)
                 - torch.lgamma(m) - torch.lgamma(1.0 + (m - 1.0) / ln))
        if a_sign == "zero":
            return hwang
    safe_a = torch.where(a > 0, a, 1.0) if a_sign != "pos" else a
    npow = torch.exp(-safe_a * ln)
    base = (torch.lgamma(n) - lga1 - torch.lgamma(m)
            - (m - 1.0) * torch.log(safe_a) - safe_a * ln)
    small = npow < 1e-5
    corr = torch.where(
        small,
        -(m - 1.0) * npow * (1.0 + npow * (0.5 + npow / 3.0)),
        (m - 1.0) * torch.log1p(-torch.where(small, 0.0, npow)),
    )
    if a_sign == "pos":
        return base + corr
    return torch.where(a > 0, base + corr, hwang)


def v_asympt(a, n, m, a_sign: str = "any"):
    """V ratio asymptote for n > maxN (stable.c:905-912); ``a_sign`` as
    in s_asympt."""
    n = _result_float(n)
    m = torch.as_tensor(m, dtype=n.dtype, device=n.device)
    a = torch.as_tensor(a, dtype=n.dtype, device=n.device)
    if a_sign == "pos":
        return (1.0 - torch.exp(-a * torch.log(n))) / a / (m - 1.0)
    ln = torch.log(n)
    zero = ln / (m - 1.0) * torch.exp(
        torch.lgamma(1.0 + (m - 2.0) / ln) - torch.lgamma(1.0 + (m - 1.0) / ln))
    if a_sign == "zero":
        return zero
    safe_a = torch.where(a > 0, a, 1.0)
    pos = (1.0 - torch.exp(-safe_a * torch.log(n))) / safe_a / (m - 1.0)
    return torch.where(a > 0, pos, zero)


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StirlingTable:
    """Immutable Stirling table (the stable_t analog, stable.h:62-113).

    ``s1_hi + s1_lo`` reconstructs the f64 S1 for f32 tables (the host f64
    column split into a hi/lo pair; lo is 0 for f64 tables).

    Two layouts, chosen by the fill:

    * ``cols = False``: natural (N, M) row-major vtab/srel, [i, j] holding
      n = i+1, m = j+1 (the row-walk fills, CPU and kernel K2);
    * ``cols = True``: column-major (M, N), [j, i] holding the same cell --
      what the column-scan kernel K3 writes, so its column stores stay
      contiguous.  Queries index either layout through ``_cell``.
    """
    a: torch.Tensor                       # 0-dim, the discount (table dtype)
    lga1: torch.Tensor                    # 0-dim, lgamma(1-a)
    s1_hi: torch.Tensor                   # (N,)
    s1_lo: torch.Tensor                   # (N,)
    vtab: Optional[torch.Tensor]          # ratio table, or None
    srel: Optional[torch.Tensor]          # log S - S1, or None
    n_max: int
    m_max: int
    max_n: int                            # hard bound (maxN)
    max_m: int                            # hard bound (maxM)
    use_asympt: bool
    cols: bool = False
    # debugging tag carried into reports and error messages (S_tag,
    # stable.h:137-138; stable.c:105-108, 915-917)
    tag: str = ""
    # sign of the discount at make time: selects the Hutter or Hwang
    # asymptote branch (None = unknown, evaluate both)
    a_pos: Optional[bool] = None

    @property
    def device(self) -> torch.device:
        return self.s1_hi.device

    @property
    def _a_sign(self) -> str:
        if self.a_pos is None:
            return "any"
        return "pos" if self.a_pos else "zero"

    def _cell(self, tab, i, j):
        """tab[natural row i, natural col j] under either layout."""
        return tab[j, i] if self.cols else tab[i, j]

    def _int(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- queries ------------------------------------------------------------
    def S1(self, n):
        """log S^n_{1,a} (S_S1, stable.c:822-873). n may be an int tensor."""
        n = self._int(n)
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        in_tab = (n >= 1) & (n <= self.n_max)
        val = self.s1_hi[i] + self.s1_lo[i]
        dt = val.dtype
        # beyond the table: the exact formula via lgamma
        beyond = torch.lgamma(n.to(dt) - self.a.to(dt)) - self.lga1.to(dt)
        out = torch.where(in_tab, val, beyond)
        return torch.where(n >= 1, out, -torch.inf)

    def S(self, n, m):
        """log S^n_{m,a} (S_S, stable.c:941-974) as a total function.

        Identities: n==m -> 0, m==1 -> S1, m==0 or n<m -> -inf.  Beyond
        (n_max, m_max) the asymptote when ``use_asympt`` else -inf (the
        S_QUITONBOUND death is a host-level policy, see ensure())."""
        n, m = self._int(n), self._int(m)
        dt = self.s1_hi.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        in_tab = (n >= 1) & (n <= self.n_max) & (m >= 1) & (m <= self.m_max)
        if self.srel is not None:
            body = (self.s1_hi[i] + self._cell(self.srel, i, j)) + self.s1_lo[i]
        else:
            body = torch.full(torch.broadcast_shapes(n.shape, m.shape),
                              -torch.inf, dtype=dt, device=self.device)
        if self.use_asympt:
            asy = s_asympt(self.a.to(dt), self.lga1.to(dt),
                           torch.clamp(n, min=1).to(dt),
                           torch.clamp(m, min=1).to(dt), a_sign=self._a_sign)
            body = torch.where(in_tab, body, asy.to(dt))
        else:
            body = torch.where(in_tab, body, -torch.inf)
        body = torch.where(n == m, 0.0, body)
        body = torch.where(m == 1, self.S1(n).to(dt), body)
        return torch.where((m < 1) | (n < m), -torch.inf, body)

    def Srel(self, n, m):
        """log S^n_{m,a} - log S^n_{1,a}: the cancellation-free form for
        within-row differences (test/check.c:877-931)."""
        n, m = self._int(n), self._int(m)
        dt = self.s1_hi.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        body = self._cell(self.srel, i, j)
        body = torch.where(n == m, -(self.s1_hi[i] + self.s1_lo[i]).to(dt),
                           body)
        body = torch.where(m == 1, 0.0, body)
        return torch.where((m < 1) | (n < m), -torch.inf, body)

    def V(self, n, m):
        """V^n_{m,a} = S^n_m / S^n_{m-1} (S_V, stable.c:900-939), m>=2.

        0 for illegal/out-of-bound inputs (the reference convention)
        unless beyond max_n with the asymptote enabled."""
        n, m = self._int(n), self._int(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        j = torch.clamp(m - 1, 0, self.m_max - 1)
        if self.vtab is not None:
            body = self._cell(self.vtab, i, j)
        else:
            body = torch.zeros(torch.broadcast_shapes(n.shape, m.shape),
                               dtype=dt, device=self.device)
        in_tab = (n <= self.n_max) & (m <= self.m_max)
        if self.use_asympt:
            asy = v_asympt(self.a.to(dt), torch.clamp(n, min=2).to(dt),
                           torch.clamp(m, min=2).to(dt),
                           a_sign=self._a_sign).to(dt)
            body = torch.where(in_tab, body,
                               torch.where(n > self.max_n, asy, 0.0))
        else:
            body = torch.where(in_tab, body, 0.0)
        return torch.where((m < 2) | (n < m), 0.0, body)

    def _rows(self, tab, n, m_sel: int):
        """tab[n[p]-1, :m_sel] as a (P, m_sel) gather under either layout."""
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        if self.cols:
            return tab[:m_sel, i].T
        return tab[i, :m_sel]

    def V_rows(self, n, m_sel: int):
        """V(n[p], m) for m = 1..m_sel as a dense (P, m_sel) block, equal
        to V() cell by cell.  Requires n <= n_max and m_sel <= m_max.

        The JAX package extracts the rows by a one-hot matmul because TPU
        gathers are slow; here it is one row gather, and the mask
        selects, so the +inf of column 1 never meets arithmetic."""
        if self.vtab is None:
            raise ValueError("V_rows needs a vtab")
        n = self._int(n)
        rows = self._rows(self.vtab, n, m_sel)
        mvec = torch.arange(1, m_sel + 1, device=self.device)
        ok = (mvec[None, :] >= 2) & (mvec[None, :] <= n[:, None])
        return torch.where(ok, rows, 0.0)

    def Srel_rows(self, n, m_sel: int):
        """Srel(n[p], m) for m = 1..m_sel as a dense (P, m_sel) block (the
        V_rows analog), with Srel()'s identities in its order: the exact
        diagonal -S1(n), m == 1 -> 0, and the n < m mask last (for n = 0
        every column is out of domain, m = 1 included)."""
        if self.srel is None:
            raise ValueError("Srel_rows needs srel")
        n = self._int(n)
        dt = self.srel.dtype
        rows = self._rows(self.srel, n, m_sel)
        i = torch.clamp(n - 1, 0, self.n_max - 1)
        s1 = (self.s1_hi[i] + self.s1_lo[i]).to(dt)
        mvec = torch.arange(1, m_sel + 1, device=self.device)
        rows = torch.where(mvec[None, :] == n[:, None], -s1[:, None], rows)
        rows = torch.where(mvec[None, :] == 1, 0.0, rows)
        return torch.where(mvec[None, :] > n[:, None], -torch.inf, rows)

    def U(self, n, m):
        """U^n_{m,a} = S^{n+1}_m / S^n_m  (S_U, stable.c:875-883)."""
        n, m = self._int(n), self._int(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        v = self.V(n, m)
        safe = torch.where(v > 0, v, 1.0)
        gen = n.to(dt) - m.to(dt) * self.a.to(dt) + 1.0 / safe
        return torch.where(m == 1, n.to(dt) - self.a.to(dt),
                           torch.where(v > 0, gen, 0.0))

    def UV(self, n, m):
        """U*V with the m==n+1 / m==n identities (S_UV, stable.c:885-897)."""
        n, m = self._int(n), self._int(m)
        dt = self.vtab.dtype if self.vtab is not None else self.s1_hi.dtype
        v = self.V(n, m)
        gen = (n.to(dt) - m.to(dt) * self.a.to(dt)) * v + 1.0
        out = torch.where(m == n + 1, 1.0, gen)
        out = torch.where(m == n, (n.to(dt) + 1.0) / (n.to(dt) - 1.0), out)
        return torch.where(m == 1, -torch.inf, out)

    def report(self) -> str:
        """One-line stats string (S_report, stable.c:1025-1055)."""
        nbytes = sum(x.numel() * x.element_size()
                     for x in (self.vtab, self.srel, self.s1_hi, self.s1_lo)
                     if x is not None)
        name = f" '{self.tag}'" if self.tag else ""
        return (f"S-table{name}: a={float(self.a):f}, "
                f"N={self.n_max}/{self.max_n}, "
                f"M={self.m_max}/{self.max_m}, "
                f"{'+S' if self.srel is not None else ''}"
                f"{'+U/V' if self.vtab is not None else ''} "
                f"{str(self.s1_hi.dtype).replace('torch.', '')} "
                f"mem={nbytes // 1024}k")


# ---------------------------------------------------------------------------
# Construction / growth (S_make / S_remake / S_extend semantics)
# ---------------------------------------------------------------------------

# On a CUDA device a table takes the column-scan kernel K3 once it has at
# least COLS_MIN_RATIO rows per column (up to stirling_cuda.COLS_MAX_N),
# the row walk K2 below that, whether or not V is kept: K3 computes V on
# its way to Srel either way.  The ratio is the crossover measured on an
# H100 (chip_smoke.py phase 8, tools/k3_compare_torch.py --crossover): K2
# costs about one row step (~0.25 us) per row plus one per column (its
# wavefront), K3 about 1.3-1.5 us, five row steps, per column below 2^16
# rows, so the two meet near n + m = 5 m: at n = 4 m K3 is within 3% of
# K2 either way for m = 64-4096, at 5 m ahead by 15-22%.
COLS_MIN_RATIO = 4


def fill_route(device, n: int, m: int, build_v: bool = True) -> str:
    """Which fill ``make`` runs for an (n, m) table on ``device``:
    "fill_rows" (the plain fill) on the CPU; on a CUDA device the kernel
    "fill_table_cols" (K3) for COLS_MIN_RATIO * m <= n < 2^24, and for any
    table wider than K2 takes; otherwise "fill_table" (K2).  ``build_v``
    (whether the table keeps V) does not move the route.  The plain fill
    never runs on a CUDA device."""
    from ..ops import stirling_cuda

    device = torch.device(device)
    if device.type == "cpu":
        return "fill_rows"
    if n < stirling_cuda.COLS_MAX_N and (
            m > stirling_cuda.TABLE_MAX_M
            or n >= COLS_MIN_RATIO * m):
        return "fill_table_cols"
    return "fill_table"


# Long f32 tables on a CUDA device take the anchored S1 (s1_anchored) from
# this many rows, as the JAX package's make does on its accelerator.
S1_ANCHORED_MIN_N = 1 << 16


def s1_route(device, dtype, n: int) -> str:
    """Which S1 pair ``make`` builds for an n-row table of ``dtype`` on
    ``device``: "anchored" (s1_anchored: f64 anchors every _S1_CHUNK rows,
    the rest filled on the card) on a CUDA device for f32 tables with n %
    _S1_CHUNK == 0 and n >= S1_ANCHORED_MIN_N, the JAX package's condition
    with the card standing for its kernels; "host" (the f64 s1_host
    column, split into hi/lo for f32) everywhere else."""
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and n % _S1_CHUNK == 0 and n >= S1_ANCHORED_MIN_N):
        return "anchored"
    return "host"


def _norm_dims(init_n, init_m, max_n, max_m):
    """Dimension clamping identical to S_make (stable.c:118-129)."""
    max_m = max(max_m, 10)
    max_n = max(max_n, max_m)
    init_m = max(init_m, 10)
    init_n = max(init_n, init_m)
    init_n = min(init_n, max_n)
    init_m = min(init_m, max_m, init_n)
    return init_n, init_m, max_n, max_m


def _s1_pair(a: float, n: int, dtype, device):
    """The host f64 S1 column on ``device``: (s1, 0) for f64 tables, the
    (hi, lo) f32 split otherwise."""
    s1 = s1_host(a, n)
    if dtype == torch.float64:
        with metrics.span("make.s1_upload"):
            hi = torch.as_tensor(s1, device=device)
        return hi, torch.zeros_like(hi)
    hi, lo = _split_hi_lo(s1)
    with metrics.span("make.s1_upload"):
        return (torch.as_tensor(hi, device=device),
                torch.as_tensor(lo, device=device))


def make(init_n: int, init_m: int, max_n: int, max_m: int, a: float,
         build_s: bool = True, build_v: bool = True,
         use_asympt: bool = False, dtype=torch.float32, *, device,
         tag: str = "") -> StirlingTable:
    """Build a table on ``device`` (S_make, stable.c:110-312).

    The fill follows ``fill_route``: K3 (column-major table) or K2 on a
    CUDA device, where a kernel that cannot build or launch raises;
    fill_rows on the CPU.  S1 follows ``s1_route``: the anchored pair
    (s1_anchored) for long f32 tables on a card, else the host f64
    column.  Either is computed after the fill is launched, so the host
    work runs under the kernel."""
    from ..ops import stirling_cuda

    init_n, init_m, max_n, max_m = _norm_dims(init_n, init_m, max_n, max_m)
    if not (build_s or build_v):
        raise ValueError(f"make({tag or 'S-table'}): need at least one of "
                         "build_s/build_v (stable.c:131, 105-108)")
    from scipy.special import gammaln

    with metrics.span("make"):
        with metrics.span("make.launch"):
            a = float(a)
            device = torch.device(device)
            route = fill_route(device, init_n, init_m, build_v)
            a_t = torch.tensor(a, dtype=dtype, device=device)
            if route == "fill_table_cols":
                vtab, srel = stirling_cuda.fill_table_cols(
                    a_t, init_n, init_m, with_srel=build_s)
            else:
                vtab, srel = stirling_cuda.fill_table(a_t, init_n, init_m,
                                                      with_srel=build_s)
        with metrics.span("make.s1"):
            if s1_route(device, dtype, init_n) == "anchored":
                s1_hi, s1_lo = s1_anchored(a, init_n, device=device)
            else:
                s1_hi, s1_lo = _s1_pair(a, init_n, dtype, device)
        return StirlingTable(
            a=a_t, lga1=torch.tensor(float(gammaln(1.0 - a)), dtype=dtype,
                                     device=device),
            s1_hi=s1_hi, s1_lo=s1_lo,
            vtab=vtab if build_v else None,
            srel=srel if build_s else None,
            n_max=init_n, m_max=init_m, max_n=max_n, max_m=max_m,
            use_asympt=use_asympt, cols=route == "fill_table_cols", tag=tag,
            a_pos=a > 0.0)


def remake(table: StirlingTable, a: float) -> StirlingTable:
    """Refill for a new discount (S_remake, stable.c:549-554)."""
    return make(table.n_max, table.m_max, table.max_n, table.max_m, a,
                build_s=table.srel is not None, build_v=table.vtab is not None,
                use_asympt=table.use_asympt, dtype=table.s1_hi.dtype,
                device=table.device, tag=table.tag)


def _grow_dim(used: int, want: int, hard: int) -> int:
    """Growth hysteresis of S_extend (stable.c:590-630): at least +10% and
    +50, then rounded up to a power-of-two-ish bucket."""
    want = max(want, used)
    if want > used:
        want = max(want, int(used * 1.1), used + 50)
    want = min(want, hard)
    # bucket: next value of form {1,1.25,1.5,1.75} * 2^k
    if want > used:
        k = int(np.floor(np.log2(max(want, 64))))
        for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
            b = int(frac * 2 ** k)
            if b >= want:
                return min(b, hard)
    return want


def ensure(table: StirlingTable, n: int, m: int,
           quit_on_bound: bool = False) -> StirlingTable:
    """Host-level growth (S_extend semantics, stable.c:564-815): returns a
    table covering (n, m).

    On the CPU, pure N-growth of a natural-layout table resumes the fill
    from its last row (the frontier path, stable.c:357-368).  On a CUDA
    device every growth refills at the new size through make(), so it runs
    a kernel, as the JAX package refills through its kernels on the TPU.

    ``quit_on_bound``: the S_QUITONBOUND policy (stable.h:32-33) -- raise
    LibstbError naming the table's tag (stable.c:915-917) instead of
    clamping at the hard bounds; queries past them fall back to the
    asymptote / -inf / 0 conventions regardless."""
    if quit_on_bound and (int(n) + 1 > table.max_n
                          or int(m) + 1 > table.max_m):
        yaps.quit("S-table%s: ensure(%d,%d) hit hard bounds (%d,%d) "
                  "(stable.c:915-917)",
                  f" '{table.tag}'" if table.tag else "",
                  int(n), int(m), table.max_n, table.max_m)
    n = min(int(n) + 1, table.max_n)
    m = min(int(m) + 1, table.max_m)
    if n <= table.n_max and m <= table.m_max:
        return table
    new_n = _grow_dim(table.n_max, max(n, table.n_max), table.max_n)
    new_m = _grow_dim(table.m_max, max(m, table.m_max), table.max_m)
    new_m = min(new_m, new_n)
    a = float(table.a)
    dtype = table.s1_hi.dtype
    if (new_m == table.m_max and new_n > table.n_max
            and table.vtab is not None and not table.cols
            and table.device.type == "cpu"):
        v_last = table.vtab[-1]
        vext, srelext, _ = fill_rows(a, new_n, new_m, dtype=dtype,
                                     with_srel=table.srel is not None,
                                     device=table.device, v_start=v_last,
                                     n_start=table.n_max)
        vtab = torch.cat([table.vtab, vext[1:]], dim=0)
        srel = (torch.cat([table.srel, srelext[1:]], dim=0)
                if table.srel is not None else None)
        s1_hi, s1_lo = _s1_pair(a, new_n, dtype, table.device)
        return dataclasses.replace(
            table, s1_hi=s1_hi, s1_lo=s1_lo, vtab=vtab, srel=srel,
            n_max=new_n)
    # M growth (or mixed), or any growth on a CUDA device: full refill
    return make(new_n, new_m, table.max_n, table.max_m, a,
                build_s=table.srel is not None, build_v=table.vtab is not None,
                use_asympt=table.use_asympt, dtype=dtype,
                device=table.device, tag=table.tag)
