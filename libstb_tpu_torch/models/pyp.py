"""Pitman-Yor process models: data generation and the Gibbs sweeps.

Port of libstb_tpu/models/pyp.py (see its docstring): the host-side numpy
data generation and pair layouts (copied, so the port runs without JAX;
tests/test_torch_pyp.py and tests/test_torch_sweeps.py hold the copies
array-equal to the originals) and every sweep of the check.c samplers,
batched over chains:

* TI: ``ti_sweep`` / ``ti_sweep_blocked`` (item order or a schedule; on
  a CUDA device all of a sweep's steps are one launch of
  ops/ti_cuda.py's kernel, which on a grid that holds the counts reads V
  from the grid itself (``ti_route``), on the CPU the plain loop
  ``_ti_run_ref``)
  and the pair-major ``ti_sweep_pairs`` family (check.c scale);
* CT / CTW: ``ct_sweep`` over the full candidate range (with a window,
  the check.c '-c' bound, or per-chain counts and base for HPYP) and
  ``ctw_sweep_rel`` over a relative window;
* HSA: the item-sequential ``hsa_sweep`` (the small-scale oracle) and the
  pair-major ``hsa_sweep_pairs`` family.

The sweeps read V(n, t+1; a) and Srel(n, t; a) from a discount grid or
from one discount's ``StirlingTable`` (``_vq`` / ``_srelq``).  The TI
sweeps evaluate the V rows of the occupied pairs once and gather from
them (the kernel's grid route interpolates from the grid instead); the
pair-major sweeps on a ``StirlingTable`` gather from its rows
(``V_rows`` / ``Srel_rows``) where the JAX package selects by a dense
compare-reduce, which only suits the TPU.  Each sweep draws its random
numbers as one block (one per stage for the staged sweeps), in the order
the JAX sweep's keys would, so ``rng.Replay`` can hand the JAX draws over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import agrid, rng, stirling
from ..ops import ti_cuda
from ..utils import metrics, yaps

_warned_cat_mode = False
_warned_hsa_pairs = False

# what ctw_sweep_rel has done, counted on the host from its shapes (it
# never reads the device): sweeps, and candidates = rows x K x categories
CTW_COUNTS = {"sweeps": 0, "candidates": 0}

__all__ = ["PYPData", "TIPlan", "base_distribution", "crp_generate",
           "from_counts", "init_state", "item_schedule", "ti_plan",
           "ti_route", "ti_schedule", "ti_sweep", "ti_sweep_blocked",
           "ti_pair_layout", "ti_pair_stages", "ti_sweep_pairs",
           "ti_sweep_pairs_state", "ti_sweep_pairs_staged", "ti_pair_m_sel",
           "ct_sweep", "ctw_sweep", "ctw_m_sel", "ctw_sweep_rel", "CTW_COUNTS",
           "init_hsa", "hsa_sweep", "init_hsa_pairs", "hsa_sweep_pairs",
           "hsa_sweep_pairs_staged"]


Table = Union[agrid.AGridTable, stirling.StirlingTable]


def _vq(tab: Table, n, m, a):
    """V(n, m) at the chains' discounts ``a`` from a grid, or at the
    table's own discount from a StirlingTable (``a`` is then unused)."""
    if isinstance(tab, agrid.AGridTable):
        return tab.V(n, m, a)
    return tab.V(n, m)


def _srelq(tab: Table, n, m, a):
    """Srel(n, m), dispatched like ``_vq``."""
    if isinstance(tab, agrid.AGridTable):
        return tab.Srel(n, m, a)
    return tab.Srel(n, m)


class PYPData(NamedTuple):
    """Fixed data for a J-group PYP workload (demo.c globals analog)."""
    data_cat: np.ndarray   # (L,) item categories, concatenated groups
    data_grp: np.ndarray   # (L,) item group index
    first: np.ndarray      # (L,) True if item is the group-category first
    n: np.ndarray          # (J, D) category counts
    N: np.ndarray          # (J,) totals
    H: np.ndarray          # (D,) base distribution


def base_distribution(kind: str, dim: int, b: float = 1.0,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The 4 base-distribution types of check.c (check.c:88-89, 546-576):
    uniform, linear ramp (H_i prop. to D-i), slow linear ramp
    (prop. to 1.5D-i), and a truncated stick-breaking draw with
    Beta(1, b) sticks ("dirichlet")."""
    kind = kind.lower()
    if kind == "uniform":
        H = np.ones(dim)
    elif kind == "linear":
        H = (dim - np.arange(dim)).astype(np.float64)
    elif kind == "slowlinear":
        H = 1.5 * dim - np.arange(dim)
    elif kind == "dirichlet":
        if rng is None:
            rng = np.random.default_rng(0)
        sticks = rng.beta(1.0, b, size=dim)
        left = np.concatenate([[1.0], np.cumprod(1.0 - sticks[:-1])])
        H = left * sticks
        H[-1] += left[-1] * (1.0 - sticks[-1])
    else:
        raise ValueError(f"unknown base type {kind}")
    return H / H.sum()


def crp_generate(seed: int, n_groups: int, dim: int, n_per_group: int,
                 a: float, b: float, H: Optional[np.ndarray] = None) -> PYPData:
    """CRP simulation (demo.c:284-311): sequential seating, counts only."""
    rng = np.random.default_rng(seed)
    if H is None:
        H = np.full(dim, 1.0 / dim)
    cats, grps, firsts = [], [], []
    n = np.zeros((n_groups, dim), np.int32)
    for j in range(n_groups):
        t = np.zeros(dim, np.int32)
        T = 0
        seen = np.zeros(dim, bool)
        for c in range(n_per_group):
            if c == 0:
                i = rng.choice(dim, p=H)
                t[i] += 1
                T += 1
            else:
                val = (c + b) * rng.random() - (T * a + b)
                if val <= 0:
                    i = rng.choice(dim, p=H)
                    t[i] += 1
                    T += 1
                else:
                    for i in range(dim):
                        val -= n[j, i] - t[i] * a
                        if val < 0:
                            break
            n[j, i] += 1
            cats.append(i)
            grps.append(j)
            firsts.append(not seen[i])
            seen[i] = True
    return PYPData(np.asarray(cats, np.int32), np.asarray(grps, np.int32),
                   np.asarray(firsts), n, n.sum(axis=1).astype(np.int32),
                   np.asarray(H, np.float64))


def from_counts(n: np.ndarray, H: Optional[np.ndarray] = None) -> PYPData:
    """Build a PYPData from given category counts (for oracle comparisons
    against the reference binary, which prints its n[] vector)."""
    n = np.atleast_2d(np.asarray(n, np.int32))
    J, D = n.shape
    cats, grps, firsts = [], [], []
    for j in range(J):
        for i in range(D):
            for c in range(n[j, i]):
                cats.append(i); grps.append(j); firsts.append(c == 0)
    if H is None:
        H = np.full(D, 1.0 / D)
    return PYPData(np.asarray(cats, np.int32), np.asarray(grps, np.int32),
                   np.asarray(firsts), n, n.sum(axis=1).astype(np.int32),
                   np.asarray(H, np.float64))


def init_state(data: PYPData, chains: int, device):
    """One table per occupied category (demo.c:391-403): t (C, J, D) and
    T (C, J), int32, on ``device``."""
    t0 = (data.n > 0).astype(np.int32)
    t = torch.as_tensor(t0, device=device).expand(
        (chains,) + t0.shape).contiguous()
    T = torch.as_tensor(t0.sum(axis=1, dtype=np.int32), device=device).expand(
        chains, t0.shape[0]).contiguous()
    return t, T


def ti_schedule(data: PYPData, mode: str = "group") -> np.ndarray:
    """Item schedule (S, W) of item indices (-1 = pad) for the parallel
    TI sweep.

    mode="group": step s holds the s-th item of every group -- an EXACT
    reordering of the sequential sweep, W = J, S = max group size.
    mode="cat": step s holds the s-th occurrence of every (group,
    category) pair; within a step the (b + T a) factor reads the
    block-start group total, so its stationary distribution is only
    APPROXIMATELY the posterior, and selecting it warns once.
    """
    grp = np.asarray(data.data_grp)
    cat = np.asarray(data.data_cat)
    if mode == "group":
        keys = grp.astype(np.int64)
    elif mode == "cat":
        global _warned_cat_mode
        if not _warned_cat_mode:
            _warned_cat_mode = True
            yaps.message(
                "ti_schedule(mode='cat'): within-step siblings read the "
                "block-start group total T -- an approximate kernel; do "
                "not use for acceptance runs (use mode='group' or "
                "ti_sweep)")
        D = data.n.shape[1]
        pair = grp.astype(np.int64) * D + cat
        uniq, keys = np.unique(pair, return_inverse=True)
    else:
        raise ValueError(f"unknown schedule mode {mode}")
    W = int(keys.max()) + 1
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=W)
    S = int(counts.max())
    sched = np.full((S, W), -1, np.int32)
    pos = 0
    for w in range(W):
        c = counts[w]
        sched[:c, w] = order[pos:pos + c]
        pos += c
    return sched


def item_schedule(data: PYPData) -> np.ndarray:
    """The reference's item order as an (L, 1) schedule: one item per
    step, which makes the blocked sweep the sequential ti_sweep."""
    L = np.asarray(data.data_cat).shape[0]
    return np.arange(L, dtype=np.int32)[:, None]


class TIPlan(NamedTuple):
    """An item schedule laid out on the device, built once per run so the
    sweep loop copies nothing from the host.  All (S, W) per step/slot;
    pad slots point at item 0 and are never live."""
    flat: torch.Tensor     # j * D + i: the (group, category) cell of t
    grp: torch.Tensor      # j
    cnt: torch.Tensor      # n[j, i]
    vbase: torch.Tensor    # row offset of the item's pair in the V block
    free: torch.Tensor     # valid slot with n > 1 (may be resampled)
    first: torch.Tensor    # first occurrence of (j, i)
    H: torch.Tensor        # base probability H[i], f64
    pair_n: torch.Tensor   # (P,) counts of the occupied pairs
    mq: int                # V block width: m = 1..max n + 1


def ti_plan(data: PYPData, sched: np.ndarray, device) -> TIPlan:
    """Device tables of schedule ``sched`` (from ti_schedule)."""
    sched = np.asarray(sched)
    valid = sched >= 0
    safe = np.maximum(sched, 0)
    i = np.asarray(data.data_cat)[safe].astype(np.int64)
    j = np.asarray(data.data_grp)[safe].astype(np.int64)
    J, D = data.n.shape
    cnt = data.n[j, i].astype(np.int64)
    jv, iv = np.nonzero(data.n)
    pair_id = np.full((J, D), -1, np.int64)
    pair_id[jv, iv] = np.arange(jv.size)
    mq = int(data.n.max()) + 1

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return TIPlan(flat=dev(j * D + i), grp=dev(j), cnt=dev(cnt),
                  vbase=dev(pair_id[j, i] * mq), free=dev(valid & (cnt > 1)),
                  first=dev(np.asarray(data.first)[safe]),
                  H=dev(np.asarray(data.H, np.float64)[i]),
                  pair_n=dev(data.n[jv, iv].astype(np.int64)), mq=mq)


def ti_route(tab: Table, plan: TIPlan, dtype) -> str:
    """Where the sweep's kernel reads V(n, t+1): "grid" where it can
    interpolate it from the grid's own vtab bitwise as AGridTable.V does,
    i.e. a grid whose V and S1 tables are in the sweep's ``dtype`` and hold
    every V the plan reads (n up to its largest count, mq - 1, and m up to
    mq), so that V's clamps and asymptote never apply; "rows", the V rows
    ti.prepare builds, for anything else (a StirlingTable, a grid too
    small for the counts or of another dtype)."""
    if (isinstance(tab, agrid.AGridTable) and tab.vtab is not None
            and tab.vtab.dtype == dtype and tab.s1_hi.dtype == dtype
            and tab.n_max >= plan.mq - 1 and tab.m_max >= plan.mq):
        return "grid"
    return "rows"


def _ti_prepare(gen, t, a, tab: Table, plan: TIPlan, skip_first: bool,
                rows: bool = True):
    """What every step of a sweep reads besides the state: the live slots,
    n and H in the sweep's dtype, the V rows of the occupied pairs (None
    unless ``rows``) and the sweep's one block of uniforms."""
    dt = a.dtype
    C = t.shape[0]
    S, W = plan.flat.shape
    live = plan.free & ~plan.first if skip_first else plan.free
    nf = plan.cnt.to(dt)
    H = plan.H.to(dt)
    vrows = None
    if rows:
        mvec = torch.arange(1, plan.mq + 1, device=t.device)
        # (C, P * mq) from a grid; one (1, P * mq) block from a single
        # table, which every chain reads through an expanded view
        vrows = _vq(tab, plan.pair_n[None, :, None], mvec[None, None, :],
                    a[:, None, None]).to(dt)
        vrows = vrows.reshape(vrows.shape[0], -1).expand(C, -1)
    u = rng.uniform(gen, (S, 2, C, W), dt, t.device)
    return live, nf, H, vrows, u


def _ti_run(gen, t, T, a, b, tab: Table, plan: TIPlan,
            skip_first: bool, legacy_odds: bool):
    """The TI conditional updates of ``plan``'s steps in order: the plain
    loop (``_ti_run_ref``) on the CPU, one launch of the sweep's kernel
    (ops/ti_cuda.py) on a CUDA device, which it equals bitwise for the
    same draws.  On the grid route (``ti_route``) ti.prepare builds no V
    rows: the kernel reads the grid."""
    if t.device.type == "cpu":
        return _ti_run_ref(gen, t, T, a, b, tab, plan, skip_first,
                           legacy_odds)
    grid = ti_route(tab, plan, a.dtype) == "grid"
    with metrics.span("ti.sweep"):
        with metrics.span("ti.prepare"):
            live, nf, H, vrows, u = _ti_prepare(gen, t, a, tab, plan,
                                                skip_first, rows=not grid)
        with metrics.span("ti.kernel"):
            return ti_cuda.ti_sweep(t, T, a, b, vrows, u, plan, live, nf, H,
                                    legacy_odds, grid=tab if grid else None)


def _ti_run_ref(gen, t, T, a, b, tab: Table, plan: TIPlan,
                skip_first: bool, legacy_odds: bool):
    """The plain version of the sweep: its steps as a loop of PyTorch
    operations, on any device.

    Acceptance odds H_i (b + T a) V(n, t+1) t / (n - t) after removal of
    the item's indicator, or the reference's t / (n - t + 1) with
    ``legacy_odds`` (see libstb_tpu/models/pyp.ti_sweep for the
    derivation and the measured bias of the legacy form)."""
    dt = a.dtype
    C = t.shape[0]
    S = plan.flat.shape[0]
    with metrics.span("ti.sweep"):
        with metrics.span("ti.prepare"):
            t = t.clone()
            T = T.clone()
            tf = t.view(C, -1)
            live, nf, H, vrows, u = _ti_prepare(gen, t, a, tab, plan,
                                                skip_first)
            a2 = a[:, None]
            b2 = b[:, None]
        for s in range(S):
            with metrics.span("ti.step"):
                flat, j, ni, nif, ls = (plan.flat[s], plan.grp[s],
                                        plan.cnt[s], nf[s], live[s])
                ti = tf[:, flat]                          # (C, W)
                Tj = T[:, j]                              # block-start totals
                dec = ((ti > 1) & ((nif - 1.0) * u[s, 0] < (ti - 1).to(dt))
                       & ls)
                ti2 = ti - dec.to(ti.dtype)
                Tj2 = Tj - dec.to(Tj.dtype)
                # V(n, t+1): m > n reads the block's last column, which is
                # 0 like V
                idx = plan.vbase[s] + torch.clamp(ti2, max=plan.mq - 1)
                v = torch.gather(vrows, 1, idx)
                ti2f = ti2.to(dt)
                denom = (nif - ti2f + 1.0) if legacy_odds else torch.clamp(
                    nif - ti2f, min=1.0)
                one = H[s] * (b2 + Tj2.to(dt) * a2) * ti2f / denom * v
                inc = (u[s, 1] < one / (one + 1.0)) & ls & (ti2 < ni)
                delta = inc.to(t.dtype) - dec.to(t.dtype)
                # (j, i) cells are distinct within a step except pad slots,
                # whose delta is 0; T adds may repeat j (cat mode) and
                # accumulate
                tf.index_add_(1, flat, delta)
                T.index_add_(1, j, delta)
    return t, T


def ti_sweep(gen, t, T, a, b, tab: Table, data: PYPData,
             skip_first: bool = True, legacy_odds: bool = False):
    """Table-indicator Gibbs sweep in item order (demo.c:405-434,
    check.c:843-867): the oracle for the blocked sweep.

    t: (C, J, D) int32; T: (C, J) int32; a, b: (C,).  Draws two (C,)
    uniforms per item, as one (L, 2, C, 1) block."""
    plan = ti_plan(data, item_schedule(data), t.device)
    return _ti_run(gen, t, T, a, b, tab, plan, skip_first, legacy_odds)


def ti_sweep_blocked(gen, t, T, a, b, tab: Table, data: PYPData,
                     sched=None, mode: str = "group",
                     skip_first: bool = True, legacy_odds: bool = False):
    """Parallel table-indicator sweep over an item schedule.

    mode="group" processes one item of every group per step -- an exact
    reordering of ti_sweep; mode="cat" parallelises over categories with
    block-start group totals (approximate, see ti_schedule).  ``sched``:
    a schedule from ti_schedule or, to amortise the host-to-device copy
    across sweeps, a TIPlan from ti_plan.  Draws one (S, 2, C, W) block of
    uniforms."""
    if not isinstance(sched, TIPlan):
        if sched is None:
            sched = ti_schedule(data, mode)
        sched = ti_plan(data, sched, t.device)
    return _ti_run(gen, t, T, a, b, tab, sched, skip_first, legacy_odds)


# ---------------------------------------------------------------------------
# Pair-major TI (check.c scale)
# ---------------------------------------------------------------------------

def ti_pair_layout(data: PYPData):
    """Host-side pair extraction for the pair-major TI sweep: occupied
    (group, category) pairs as index vectors (jvec, ivec, counts)."""
    j_idx, i_idx = np.nonzero(data.n)
    return (j_idx.astype(np.int32), i_idx.astype(np.int32),
            data.n[j_idx, i_idx].astype(np.int32))


def ti_pair_stages(nvec, skip_first: bool = True, min_pairs: int = 512):
    """Host-side round staging for the pair-major sweeps: ``(order,
    stages)``, ``order`` sorting the pairs by descending count so the
    active set of round ``s`` is a prefix, ``stages`` the ``(pairs,
    r_start, r_stop)`` triples over shrinking prefixes, cut where the
    active count halves (libstb_tpu/models/pyp.ti_pair_stages).  The sweep
    must be called with the same ``skip_first``."""
    nvec = np.asarray(nvec)
    order = np.argsort(-nvec, kind="stable").astype(np.int32)
    c = nvec[order]
    P = int(len(c))
    max_c = int(c[0]) if P else 0
    r = 1 if skip_first else 0
    stages = []
    while r < max_c:
        p_act = int((c > r).sum())
        if p_act == 0:
            break
        if p_act <= min_pairs:
            stages.append((p_act, r, max_c))
            break
        k = p_act // 2
        # c sorted desc: #(c > c[k]) <= k, so the active set has halved
        r2 = int(c[k]) if k < P else max_c
        r2 = min(max(r2, r + 1), max_c)
        stages.append((p_act, r, r2))
        r = r2
    return order, tuple(stages)


def _dev_vec(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).long()


def _pairs_rounds(u, tp, T, tab, H, nvec, jvec, a_c, b_c, r0: int,
                  skip_first: bool, legacy_odds: bool, vsel=None):
    """Rounds r0, r0+1, ... of the pair-major TI sweep over the pairs of
    ``tp`` (C, p), one per leading entry of the uniforms ``u`` (rounds, 2,
    C, p).  Every pair with s < n_p updates its table count once a round,
    reading its group's total T as it stood at the start of the round.

    ``vsel``: (flat V rows, row offsets) from ``StirlingTable.V_rows``: V
    (n_p, t+1) is then a gather from the pair's row instead of a point
    query of the table (the same cells, so the same values)."""
    dt = a_c.dtype
    nif = nvec.to(dt)[None]
    multi = nvec > 1
    for k in range(u.shape[0]):
        s = r0 + k
        valid = (s < nvec) & multi
        if skip_first and s < 1:
            valid = torch.zeros_like(valid)
        Tj = T[:, jvec].to(dt)                        # round-start totals
        dec = (tp > 1) & ((nif - 1.0) * u[k, 0] < (tp - 1).to(dt)) & valid
        ti2 = tp - dec.to(tp.dtype)
        if vsel is not None:
            vflat, vbase = vsel
            v = vflat[vbase + ti2.long()].to(dt)      # V(n_p, ti2 + 1)
        else:
            v = _vq(tab, nvec[None], ti2 + 1, a_c).to(dt)
        ti2f = ti2.to(dt)
        denom = (nif - ti2f + 1.0) if legacy_odds else torch.clamp(
            nif - ti2f, min=1.0)
        one = H[None] * (b_c + (Tj - dec.to(dt)) * a_c) * ti2f / denom * v
        inc = (u[k, 1] < one / (one + 1.0)) & valid & (ti2 < nvec[None])
        delta = inc.to(tp.dtype) - dec.to(tp.dtype)
        tp = tp + delta
        T = T.index_add(1, jvec, delta.to(T.dtype))
    return tp, T


def _vsel(tab, nvec, m_sel: int):
    if not m_sel:
        return None
    rows = tab.V_rows(nvec, m_sel)                    # (P, m_sel)
    base = torch.arange(rows.shape[0], device=rows.device)[None] * m_sel
    return rows.reshape(-1), base


def ti_sweep_pairs_staged(gen, tp, T, a, b, tab: Table, data: PYPData,
                          jvec, ivec, nvec, stages,
                          skip_first: bool = True,
                          legacy_odds: bool = False, m_sel: int = 0):
    """Staged pair-major TI sweep (libstb_tpu/models/pyp
    .ti_sweep_pairs_staged): ``tp`` (C, P) holds the table counts of the
    pairs in ``ti_pair_stages`` order, and stage (p, r0, r1) runs rounds
    r0..r1-1 over the first p pairs.  Approximate like the cat-mode
    schedule: a round's same-group pairs read the round-start total T.

    ``m_sel`` > 0 (from ``ti_pair_m_sel``): V from the pairs' table rows
    by gather.  Draws one (r1 - r0, 2, C, p) block of uniforms a stage.
    Returns (tp, T) in the sorted order."""
    if stages and stages[0][1] != (1 if skip_first else 0):
        raise ValueError(
            f"stages built with skip_first={stages[0][1] == 1}, sweep "
            f"called with skip_first={skip_first}: rebuild stages via "
            f"ti_pair_stages(nvec, skip_first={skip_first})")
    dt, dev = a.dtype, tp.device
    jvec, ivec, nvec = (_dev_vec(x, dev) for x in (jvec, ivec, nvec))
    H = torch.as_tensor(data.H, dtype=dt, device=dev)[ivec]
    vsel = _vsel(tab, nvec, m_sel)
    a_c, b_c = a[:, None], b[:, None]
    C = tp.shape[0]
    tp = tp.clone()
    for (p, r0, r1) in stages:
        u = rng.uniform(gen, (r1 - r0, 2, C, p), dt, dev)
        ps = None if vsel is None else (vsel[0], vsel[1][:, :p])
        tps, T = _pairs_rounds(u, tp[:, :p], T, tab, H[:p], nvec[:p],
                               jvec[:p], a_c, b_c, r0, skip_first,
                               legacy_odds, ps)
        tp[:, :p] = tps
    return tp, T


def ti_sweep_pairs_state(gen, tp, T, a, b, tab: Table, data: PYPData,
                         jvec, ivec, nvec, steps: int,
                         skip_first: bool = True,
                         legacy_odds: bool = False, m_sel: int = 0):
    """Flat pair-major TI sweep: ``steps`` (= max count) rounds over all
    pairs in layout order (libstb_tpu/models/pyp.ti_sweep_pairs_state).
    Draws one (steps, 2, C, P) block of uniforms.  Returns (tp, T)."""
    dt, dev = a.dtype, tp.device
    jvec, ivec, nvec = (_dev_vec(x, dev) for x in (jvec, ivec, nvec))
    H = torch.as_tensor(data.H, dtype=dt, device=dev)[ivec]
    u = rng.uniform(gen, (steps, 2) + tuple(tp.shape), dt, dev)
    return _pairs_rounds(u, tp, T, tab, H, nvec, jvec, a[:, None],
                         b[:, None], 0, skip_first, legacy_odds,
                         _vsel(tab, nvec, m_sel))


def ti_pair_m_sel(tab: Table, nvec, cap: int = 4096) -> int:
    """m_sel for the row-gather V route of the pair-major TI sweeps, or 0
    (the point-query route): a ``StirlingTable`` with V, in either layout,
    that holds every (n_p, t+1) in-table, rows at most ``cap`` wide."""
    nvec = np.asarray(nvec)
    if (not isinstance(tab, stirling.StirlingTable) or tab.vtab is None
            or len(nvec) == 0):
        return 0
    maxc = int(nvec.max())
    if maxc + 1 > min(tab.m_max, cap) or maxc > tab.n_max:
        return 0
    return maxc + 1


def ti_sweep_pairs(gen, t, T, a, b, tab: Table, data: PYPData,
                   layout=None, skip_first: bool = True,
                   legacy_odds: bool = False, staged: bool = True,
                   min_pairs: int = 512):
    """Dense-state wrapper of the pair-major TI sweeps: (C, J, D) t to
    pair-major and back, the staged schedule by default, the flat one with
    ``staged=False``.  ``layout``: a precomputed ``ti_pair_layout``."""
    if layout is None:
        layout = ti_pair_layout(data)
    jvec, ivec, nvec = layout
    m_sel = ti_pair_m_sel(tab, nvec)
    dev = t.device
    if staged and len(nvec):
        order, stages = ti_pair_stages(nvec, skip_first=skip_first,
                                       min_pairs=min_pairs)
        jvec, ivec, nvec = jvec[order], ivec[order], nvec[order]
    jv, iv = _dev_vec(jvec, dev), _dev_vec(ivec, dev)
    tp = t[:, jv, iv]
    if staged and len(nvec):
        tp, T = ti_sweep_pairs_staged(gen, tp, T, a, b, tab, data, jv, iv,
                                      nvec, stages, skip_first=skip_first,
                                      legacy_odds=legacy_odds, m_sel=m_sel)
    else:
        steps = int(nvec.max()) if len(nvec) else 0
        tp, T = ti_sweep_pairs_state(gen, tp, T, a, b, tab, data, jv, iv,
                                     nvec, steps, skip_first=skip_first,
                                     legacy_odds=legacy_odds, m_sel=m_sel)
    t = t.clone()
    t[:, jv, iv] = tp
    return t, T


# ---------------------------------------------------------------------------
# Collapsed-table sweeps (CT, CTW)
# ---------------------------------------------------------------------------

def _ct_conditional(srel, ni, ti, Tj, a, b, Hi, tmax: int, window,
                    ti_off=None, maxrel=None):
    """Masked log-weights over the candidates t = 1..tmax (check.c:877-895;
    libstb_tpu/models/pyp._ct_conditional for the derivation):
    Srel(n, t) + sum_{k=1}^{t-1} log(H_i (b + (T - t_i + k) a)).

    ``srel``: (R, tmax) Srel(n_i, t) of the rows; ``ni`` / ``Hi``: (R,);
    ``ti_off`` (default ``ti``) is the stored count subtracted from Tj.
    ``window`` keeps |t - t_i| <= w; ``maxrel`` masks every candidate from
    the first t > t_i + 3 whose weight fell maxrel-fold below the running
    peak (check.c's '-c')."""
    dt, dev = a.dtype, a.device
    if ti_off is None:
        ti_off = ti
    tts = torch.arange(1, tmax + 1, device=dev)
    ks = tts.to(dt)                                   # k = 1..tmax
    tiny = 1e-300 if dt == torch.float64 else 1e-30
    base = torch.log(torch.clamp(Hi[:, None], min=1e-30)) + torch.log(
        torch.clamp(b[:, None] + (Tj - ti_off)[:, None].to(dt) * a[:, None]
                    + ks[None, :] * a[:, None], min=tiny))
    cum = torch.cumsum(base, dim=-1)
    hterm = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    lw = hterm + srel
    ok = tts[None, :] <= ni[:, None]
    if window is not None:
        ok = ok & ((tts[None, :] - ti[:, None]).abs() <= window)
    lw = torch.where(ok, lw, -torch.inf)
    if maxrel is not None:
        run_peak = torch.cummax(lw, dim=-1).values
        cut = ((tts[None, :] > ti[:, None] + 3)
               & (run_peak - lw > torch.log(torch.tensor(
                   maxrel, dtype=lw.dtype, device=dev))))
        dead = torch.cumsum(cut.to(torch.int32), dim=-1) > 0
        lw = torch.where(dead, -torch.inf, lw)
    return lw


def ct_srel_pos(n, tmax: int, device) -> torch.Tensor:
    """The flat positions (j, i, t - 1) of the (J, D, tmax) Srel block at
    which t <= n[j, i], for the host counts ``n`` (J, D): the candidates
    a CT sweep of these counts can draw.  Made on the host, so it waits
    for nothing on the device."""
    tts = np.arange(1, tmax + 1)
    pos = np.flatnonzero(tts <= np.asarray(n)[..., None])
    return torch.as_tensor(pos, device=device)


def _ct_srel(tab: Table, n_all, tmax: int, a, pos=None):
    """The Srel block a CT sweep reads: Srel(n, t) for every count of
    ``n_all`` ((C or 1, J, D)) and candidate t = 1..tmax, at each chain's
    discount ``a`` (C,) on a grid; (C, J, D, tmax), expanded over the
    chains where the counts are shared and the table has one discount.

    Counts shared by the chains on a grid, with ``pos`` their
    ``ct_srel_pos``: the grid is read only at the candidates t <= n, the
    only ones a sweep can draw, and the rest of the block is -inf, as
    ``Srel`` gives it there; each value is the one the whole block's
    query gives."""
    with metrics.span("ct.srel"):
        dev = n_all.device
        tts = torch.arange(1, tmax + 1, device=dev)
        shape = (a.shape[0],) + tuple(n_all.shape[1:]) + (tmax,)
        if pos is not None:
            srel = torch.full((shape[0], math.prod(shape[1:])), -torch.inf,
                              dtype=tab.srel.dtype, device=dev)
            srel[:, pos] = tab.Srel(n_all.flatten()[pos // tmax],
                                    tts[pos % tmax], a[:, None])
            return srel.view(shape)
        srel = _srelq(tab, n_all[..., None], tts, a[:, None, None, None])
        return srel.expand(shape)


def ct_sweep(gen, t, T, a, b, tab: Table, data: PYPData, tmax: int,
             window: Optional[int] = None, n_arr=None, H_arr=None,
             maxrel: Optional[float] = None, srel_pos=None):
    """Collapsed-table sweep (check.c:868-904; ``window``: check.c:905-943):
    each category in turn resamples t for every (chain, group) by a
    Gumbel-max draw over 1..tmax.

    ``n_arr`` (C, J, D) / ``H_arr`` (C, D) override the data's counts and
    base with per-chain values (the hierarchical case).  Srel(n_ji, t) is
    the same for the whole sweep, so it is evaluated once, as one (C, J,
    D, tmax) block (``_ct_srel``, the span ``stb/ct.srel``; one chain's
    for a single table with the data's counts; on a grid with the data's
    counts only their candidates, ``srel_pos`` = ``ct_srel_pos(data.n,
    tmax)``, made here unless a caller that sweeps the same counts again
    made it once).  Draws one (D, C*J, tmax) block of Gumbels; the loop
    over the categories is ``stb/ct.scan``."""
    dt, dev = a.dtype, t.device
    n = torch.as_tensor(data.n, device=dev)
    H = torch.as_tensor(data.H, dtype=dt, device=dev)
    J, D = data.n.shape
    C = t.shape[0]
    a_f = a[:, None].expand(C, J).reshape(-1)
    b_f = b[:, None].expand(C, J).reshape(-1)
    n_all = n[None] if n_arr is None else n_arr
    if n_arr is not None or not isinstance(tab, agrid.AGridTable):
        srel_pos = None
    elif srel_pos is None:
        srel_pos = ct_srel_pos(data.n, tmax, dev)
    srel = _ct_srel(tab, n_all, tmax, a, srel_pos)
    g = rng.gumbel(gen, (D, C * J, tmax), dt, dev)
    t = t.clone()
    with metrics.span("ct.scan"):
        for i in range(D):
            ni = n_all[:, :, i].expand(C, J).reshape(-1)
            if H_arr is None:
                Hi = H[i].expand(C * J)
            else:
                Hi = H_arr[:, i, None].expand(C, J).reshape(-1)
            ti_stored = t[:, :, i].reshape(-1)
            Tj = T.reshape(-1)
            # the dyn-n guard; Tj still counts the stored t during a
            # dynamic-n transient, so the other-categories offset subtracts
            # the stored value
            ti = torch.minimum(ti_stored, ni.to(ti_stored.dtype))
            lw = _ct_conditional(srel[:, :, i].reshape(C * J, tmax), ni, ti,
                                 Tj, a_f, b_f, Hi, tmax, window,
                                 ti_off=ti_stored, maxrel=maxrel)
            tt = 1 + torch.argmax(lw + g[i], dim=-1).to(t.dtype)
            tt = torch.where(ni > 0, tt, torch.zeros_like(ti))
            T = (Tj + tt - ti_stored).reshape(C, J)
            t[:, :, i] = tt.reshape(C, J)
    return t, T


def ctw_sweep(gen, t, T, a, b, tab: Table, data: PYPData, tmax: int,
              window: int = 10):
    """Windowed collapsed sweep (check.c:905-943, TWINDOW default 10)."""
    return ct_sweep(gen, t, T, a, b, tab, data, tmax, window=window)


def ctw_m_sel(tab: Table, data: PYPData, window: int = 10,
              cap: int = 4096) -> int:
    """m_sel for ctw_sweep_rel's row-gather Srel route, or 0 (the point-
    query route), gated as ti_pair_m_sel on ``srel``; ``window`` does not
    move it (candidates past n_i are masked whatever the rows hold)."""
    del window
    maxc = int(np.asarray(data.n).max()) if data.n.size else 0
    if (not isinstance(tab, stirling.StirlingTable) or tab.srel is None
            or maxc == 0):
        return 0
    if maxc + 1 > min(tab.m_max, cap) or maxc > tab.n_max:
        return 0
    return maxc + 1


def _window_product(base, tts, log_ha):
    """log prod_{k=1}^{tt-1} (H a (base + k)) over each row's window ``tts``
    (R, K) = lo..lo+K-1, relative to its value at tt = lo (a constant of
    the row, which the Gumbel-max ignores): (tt - lo) log(H a) +
    sum_{k=lo}^{tt-1} log(base + k).  The JAX sweep takes (tt - 1) log(H
    a) + lgamma(base + tt) - lgamma(base + 1), the same up to that
    constant, whose two large terms cost ~1e-4 of absolute error in f32
    at check.c's bases.

    The running sum is taken over the leading axis of the (K - 1, R)
    terms: PyTorch's scan along a short innermost axis took ~5 ms on the
    card for check.c's 819,200 rows of 20, as long as the rest of a
    category, where one along the outer axis reads the terms once."""
    dt = base.dtype
    terms = torch.log(base[None, :] + tts[:, :-1].T.to(dt)).contiguous()
    rel = torch.cumsum(terms, dim=0).T
    return ((tts - tts[:, :1]).to(dt) * log_ha[:, None]
            + torch.cat([torch.zeros_like(rel[:, :1]), rel], dim=-1))


def _ctw_window(ti, ni, window: int):
    """(R, K) the candidates of each row: t_i + [-w, w], K = 2w + 1,
    shifted to stay inside [1, n_i] (check.c:915-918); a row with n_i < K
    takes 1..K, the candidates past n_i masked by ``_ctw_weights``."""
    K = 2 * window + 1
    lo = torch.minimum(torch.clamp(ti - window, min=1),
                       torch.clamp(ni - K + 1, min=1))
    return lo[:, None] + torch.arange(K, device=ti.device)[None, :]


def _ctw_in_table(tab: Table, data: PYPData) -> Table:
    """A grid that holds every count of the data queried without its
    asymptote: the candidates 1 <= t <= n_i all lie in the grid, and
    those past n_i are masked, so no value a sweep reads changes, and the
    ~25 operations a candidate of the asymptote (Hutter's and Hwang's
    forms, both where the grid holds a = 0) are not evaluated."""
    maxc = int(np.asarray(data.n).max()) if data.n.size else 0
    if (isinstance(tab, agrid.AGridTable) and tab.use_asympt
            and maxc <= min(tab.n_max, tab.m_max)):
        return dataclasses.replace(tab, use_asympt=False)
    return tab


def _ctw_srel(tab: Table, ni, tts, a_f):
    """(R, K) Srel(n_i, t) at the candidates ``tts`` by point queries, at
    each row's discount ``a_f`` on a grid."""
    return _srelq(tab, ni[:, None], tts, a_f[:, None])


def _ctw_weights(srel, ni, ti, Tj, a_f, b_f, hlog, tts):
    """(R, K) the windowed CT log weights of the candidates ``tts``
    (check.c:905-943): Srel(n_i, t) + log prod_{k=1}^{t-1} H_i (b + (T_j -
    t_i + k) a), the product relative to its value at the window's first
    candidate (a constant of the row, which the Gumbel-max ignores);
    candidates outside [1, n_i] are -inf.  ``srel``: (R, K) Srel at
    ``tts``; ``hlog``: log H_i."""
    dt = a_f.dtype
    safe_a = torch.clamp(a_f, min=1e-12)
    # log prod_{k=1}^{tt-1} H (b + (T - ti + k) a): base = (b + (T - ti)
    # a) / a; a == 0: (tt - lo) log(H b), both relative to tt = lo
    base = (b_f + (Tj - ti).to(dt) * a_f) / safe_a
    cum = _window_product(base, tts, hlog + torch.log(safe_a))
    cum0 = (tts - tts[:, :1]).to(dt) * (
        hlog + torch.log(torch.clamp(b_f, min=1e-30)))[:, None]
    cum = torch.where(a_f[:, None] > 0, cum, cum0)
    lw = cum + srel
    ok = (tts >= 1) & (tts <= ni[:, None])
    return torch.where(ok, lw, -torch.inf)


def ctw_sweep_rel(gen, t, T, a, b, tab: Table, data: PYPData,
                  window: int = 10, m_sel: int = 0):
    """Windowed collapsed sweep over RELATIVE candidates t_i + [-w, w],
    shifted to stay inside [1, n_i] (check.c:905-943, 915-918;
    libstb_tpu/models/pyp.ctw_sweep_rel): O(2w+1) work a (chain, group)
    whatever the counts.  The product term is summed over the window
    only (``_window_product``), which keeps f32 on the card within a few
    ulps.

    ``m_sel`` > 0 (from ``ctw_m_sel``): Srel from the (group, category)
    rows of a ``StirlingTable`` (``Srel_rows``, once a sweep) by gather;
    0: point queries (``_ctw_srel``; on a grid at each chain's a).
    Draws one (D, C*J, 2w+1) block of Gumbels.  Spans: ``ctw.sweep``;
    inside it ``ctw.scan``, the loop over the categories, and in that
    each category's Srel query, ``ctw.srel``.  ``CTW_COUNTS`` counts the
    sweeps and their candidates from the shapes."""
    with metrics.span("ctw.sweep"):
        dt, dev = a.dtype, t.device
        n = torch.as_tensor(data.n, device=dev)
        H = torch.as_tensor(data.H, dtype=dt, device=dev)
        J, D = data.n.shape
        C = t.shape[0]
        a_f = a[:, None].expand(C, J).reshape(-1)
        b_f = b[:, None].expand(C, J).reshape(-1)
        K = 2 * window + 1
        CTW_COUNTS["sweeps"] += 1
        CTW_COUNTS["candidates"] += C * J * K * D
        if m_sel:
            srows = tab.Srel_rows(n.T.reshape(-1), m_sel).reshape(D, J,
                                                                  m_sel)
        tab = _ctw_in_table(tab, data)
        g = rng.gumbel(gen, (D, C * J, K), dt, dev)
        t = t.clone()
        with metrics.span("ctw.scan"):
            for i in range(D):
                ni = n[None, :, i].expand(C, J).reshape(-1)
                hlog = torch.log(torch.clamp(H[i], min=1e-30))
                ti = t[:, :, i].reshape(-1)
                Tj = T.reshape(-1)
                tts = _ctw_window(ti, ni, window)
                with metrics.span("ctw.srel"):
                    if m_sel:
                        # tts past the row are > ni, masked by the weights
                        idx = torch.clamp(tts - 1, max=m_sel - 1).reshape(
                            C, J, K)
                        srel = torch.gather(
                            srows[i][None].expand(C, J, m_sel), 2, idx)
                        srel = srel.reshape(C * J, K)
                    else:
                        srel = _ctw_srel(tab, ni, tts, a_f)
                lw = _ctw_weights(srel, ni, ti, Tj, a_f, b_f, hlog, tts)
                pick = torch.argmax(lw + g[i], dim=-1)
                tt = torch.gather(tts, 1, pick[:, None])[:, 0].to(t.dtype)
                tt = torch.where(ni > 0, tt, torch.zeros_like(ti))
                T = (Tj + tt - ti).reshape(C, J)
                t[:, :, i] = tt.reshape(C, J)
        return t, T


# ---------------------------------------------------------------------------
# Histogrammed seating arrangements (HSA)
# ---------------------------------------------------------------------------

def init_hsa(data: PYPData, chains: int, device, smax: Optional[int] = None):
    """Histogram seating state, one table of size n per occupied category:
    hist (C, J, D, S+1) and T (C, J), int32, on ``device``; hist[c, j, i,
    s] counts the tables of size s of category i in group j."""
    if smax is None:
        smax = int(data.n.max())
    J, D = data.n.shape
    h0 = np.zeros((J, D, smax + 1), np.int32)
    jv, iv = np.nonzero(data.n)
    h0[jv, iv, data.n[jv, iv]] = 1
    hist = torch.as_tensor(h0, device=device).expand(
        (chains,) + h0.shape).contiguous()
    T = torch.as_tensor((data.n > 0).sum(axis=1).astype(np.int32),
                        device=device).expand(chains, J).contiguous()
    return hist, T


def hsa_sweep(gen, hist, T, a, b, data: PYPData):
    """Histogrammed seating-arrangement sweep, item by item (check.c's
    SA/HSA samplers, check.c:716-842): unseat a customer of the item's
    category (a table of size s with probability prop. to s h_s), reseat
    it at an existing table (prop. to (s - a) h_s) or a new one (prop. to
    (b + T a) H_i).

    hist: (C, J, D, S+1) int32; T: (C, J).  The small-scale oracle, ~50
    ops an item; ``hsa_sweep_pairs`` is the scale route.  Draws a (L, C,
    S+1) and a (L, C, S+2) block of Gumbels.  Returns (hist, T)."""
    dt, dev = a.dtype, hist.device
    C = hist.shape[0]
    S = hist.shape[-1] - 1
    cats, grps = np.asarray(data.data_cat), np.asarray(data.data_grp)
    L = cats.shape[0]
    H = torch.as_tensor(data.H, dtype=dt, device=dev)
    sf = torch.arange(S + 1, device=dev).to(dt)[None]
    ge1 = sf >= 1
    wjoin = sf - a[:, None]                  # (s - a), the join weight a table
    rows = torch.arange(C, device=dev)
    g1 = rng.gumbel(gen, (L, C, S + 1), dt, dev)
    g2 = rng.gumbel(gen, (L, C, S + 2), dt, dev)
    hist = hist.clone()
    T = T.clone()
    for l in range(L):
        i, j = int(cats[l]), int(grps[l])
        if data.n[j, i] <= 0:
            continue
        h = hist[:, j, i, :].clone()
        # unseat: P(table size s) prop. to s h_s (>= 0, so no clamp)
        lw = torch.where(ge1 & (h > 0), torch.log(sf * h), -torch.inf)
        s_rm = torch.argmax(lw + g1[l], dim=-1)
        h[rows, s_rm] -= 1
        h[rows, torch.clamp(s_rm - 1, min=0)] += (s_rm > 1).to(h.dtype)
        Tj = T[:, j] - (s_rm == 1).to(T.dtype)         # size-1 table gone
        # reseat: existing prop. to (s - a) h_s, new prop. to (b + T a) H_i
        lw2 = torch.where(ge1 & (h > 0), torch.log(torch.clamp(
            wjoin * h, min=0.0)), -torch.inf)
        lnew = torch.log(torch.clamp((b + Tj.to(dt) * a) * H[i], min=1e-30))
        pick = torch.argmax(torch.cat([lw2, lnew[:, None]], dim=-1) + g2[l],
                            dim=-1)
        is_new = pick == S + 1
        old = (~is_new).to(h.dtype)
        s_join = torch.where(is_new, 0, pick)
        h[rows, s_join] -= old
        h[rows, torch.clamp(s_join + 1, max=S)] += old
        h[:, 1] += is_new.to(h.dtype)
        hist[:, j, i, :] = h
        T[:, j] = Tj + is_new.to(T.dtype)
    return hist, T


def init_hsa_pairs(data: PYPData, chains: int, device, order=None,
                   s_max: Optional[int] = None):
    """Pair-major histogram state hp (C, P, s_max+1) with one table of size
    n_p per occupied pair, and T (C, J), int32, on ``device``; ``order``
    (from ti_pair_stages) sorts the pair axis for the staged sweep."""
    jvec, ivec, nvec = ti_pair_layout(data)
    if order is not None:
        nvec = nvec[order]
    if s_max is None:
        s_max = int(nvec.max()) if len(nvec) else 1
    P = len(nvec)
    h0 = np.zeros((P, s_max + 1), np.int32)
    h0[np.arange(P), nvec] = 1
    hp = torch.as_tensor(h0, device=device).expand(
        chains, P, s_max + 1).contiguous()
    T = torch.as_tensor((data.n > 0).sum(axis=1).astype(np.int32),
                        device=device).expand(chains, data.n.shape[0])
    return hp, T.contiguous()


def _hsa_pairs_rounds(u, hp, T, nvec, jvec, Hp, a_c, b_c, r0: int):
    """Rounds r0, r0+1, ... of the pair-major HSA sweep over the pairs of
    ``hp`` (C, p, S+1), one per leading entry of ``u`` (rounds, 2, C, p):
    every pair with s < n_p unseats one customer and reseats it, each
    categorical drawn by inverse CDF over a size-axis cumsum; same-group
    pairs read the round-start total T for the new-table weight."""
    dt = a_c.dtype
    s_max = hp.shape[-1] - 1
    svec = torch.arange(s_max + 1, device=hp.device).to(dt)
    wexist = torch.clamp(svec[None, None, :] - a_c[:, :, None], min=0.0)
    live = nvec >= 1
    for k in range(u.shape[0]):
        valid = ((r0 + k < nvec) & live)[None]          # (1, p)
        # unseat: P(size s) = s h_s / n_p
        c1 = torch.cumsum(svec * hp.to(dt), dim=-1)
        v1 = (u[k, 0] * c1[..., -1])[..., None]
        s_rm = torch.clamp(torch.searchsorted(c1, v1)[..., 0], 1, s_max)
        single = s_rm == 1                              # the table vanished
        T_loc = T[:, jvec].to(dt) - single.to(dt)
        # reseat: existing P(s) prop. to (s - a) h_s, new prop. to
        # (b + T a) H_p, on the histogram after the unseat
        # (a pair that is not valid keeps its histogram: its deltas are 0)
        vi = valid.expand_as(s_rm)
        h2 = hp.scatter_add(-1, s_rm[..., None], -vi.to(hp.dtype)[..., None])
        h2.scatter_add_(-1, torch.clamp(s_rm - 1, min=0)[..., None],
                        ((s_rm > 1) & vi).to(hp.dtype)[..., None])
        c2 = torch.cumsum(wexist * h2.to(dt), dim=-1)
        tot2 = c2[..., -1]
        wnew = (b_c + T_loc * a_c) * Hp[None, :]
        v2 = u[k, 1] * (tot2 + wnew)
        is_new = v2 >= tot2
        s_jn = torch.clamp(torch.searchsorted(c2, v2[..., None])[..., 0],
                           1, s_max - 1)
        ex = (~is_new & valid).to(hp.dtype)[..., None]
        h2.scatter_add_(-1, s_jn[..., None], -ex)
        h2.scatter_add_(-1, (s_jn + 1)[..., None], ex)
        h2[..., 1] += (is_new & valid).to(hp.dtype)
        hp = h2
        dT = (is_new.to(T.dtype) - single.to(T.dtype)) * valid.to(T.dtype)
        T = T.index_add(1, jvec, dT)
    return hp, T


def hsa_sweep_pairs_staged(gen, hp, T, a, b, data: PYPData, jvec, ivec,
                           nvec, stages):
    """Staged pair-major HSA sweep (check.c:766-842 semantics;
    libstb_tpu/models/pyp.hsa_sweep_pairs_staged): ``hp`` (C, P, s_max+1)
    in ``ti_pair_stages(skip_first=False)`` order; stage (p, r0, r1) runs
    rounds r0..r1-1 over the first p pairs; the size axis of ``hp`` is
    JAX's static ``s_max``.  sum_s s h_s = n_p holds exactly.  Draws one
    (r1 - r0, 2, C, p) block of Uniform[1e-6, 1) a stage.  Returns (hp,
    T)."""
    if stages and stages[0][1] != 0:
        raise ValueError(
            "hsa stages must be built with ti_pair_stages(skip_first="
            "False) -- HSA resamples every item")
    dt, dev = a.dtype, hp.device
    jvec, ivec, nvec = (_dev_vec(x, dev) for x in (jvec, ivec, nvec))
    Hp = torch.as_tensor(data.H, dtype=dt, device=dev)[ivec]
    C = hp.shape[0]
    hp = hp.clone()
    for (p, r0, r1) in stages:
        u = rng.uniform_min(gen, 1e-6, (r1 - r0, 2, C, p), dt, dev)
        hps, T = _hsa_pairs_rounds(u, hp[:, :p], T, nvec[:p], jvec[:p],
                                   Hp[:p], a[:, None], b[:, None], r0)
        hp[:, :p] = hps
    return hp, T


def hsa_sweep_pairs(gen, hp, T, a, b, data: PYPData, layout=None,
                    order=None, stages=None, min_pairs: int = 512):
    """Wrapper building the count-sorted layout and stages for
    hsa_sweep_pairs_staged; ``hp``'s pair axis must already be in
    ``order`` (init_hsa_pairs with the same order).  Approximate (the
    round-start T, as the cat-mode schedule), so it warns once."""
    global _warned_hsa_pairs
    if not _warned_hsa_pairs:
        _warned_hsa_pairs = True
        yaps.message(
            "hsa_sweep_pairs: same-group pairs of a round read the "
            "round-start group total T -- an approximate kernel; do not "
            "use for acceptance runs (use hsa_sweep)")
    if layout is None:
        layout = ti_pair_layout(data)
    jvec, ivec, nvec = layout
    if order is None or stages is None:
        order, stages = ti_pair_stages(nvec, skip_first=False,
                                       min_pairs=min_pairs)
    return hsa_sweep_pairs_staged(gen, hp, T, a, b, data, jvec[order],
                                  ivec[order], nvec[order], stages)
