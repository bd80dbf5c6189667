"""Pitman-Yor process models: data generation and the TI Gibbs sweeps.

Port of the main-path parts of libstb_tpu/models/pyp.py (see its
docstring): the host-side numpy data generation (copied, so the port runs
without JAX; tests/test_torch_pyp.py holds the copies array-equal to the
originals) and the table-indicator sweeps, batched over chains.

The sweeps read V(n, t+1; a) from a discount grid or from one discount's
``StirlingTable`` (``_vq``).  Within one sweep every query is V(n_p, m,
a_c) for an occupied (group, category) pair p, m = 1..max n + 1 and the
chain's current discount a_c, so the sweep evaluates those rows once (the
table's ``V`` on the whole block, the same values elementwise) and each
step gathers from them; a single table's block is shared by the chains.
The uniforms of a sweep are drawn as one (steps, 2, chains, width) block.
The CT, CTW and HSA samplers and the pair-major sweeps are not ported yet
(ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import agrid, rng, stirling
from ..utils import yaps

_warned_cat_mode = False

__all__ = ["PYPData", "TIPlan", "base_distribution", "crp_generate",
           "from_counts", "init_state", "item_schedule", "ti_plan",
           "ti_schedule", "ti_sweep", "ti_sweep_blocked"]


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


def _ti_run(gen, t, T, a, b, tab: Table, plan: TIPlan,
            skip_first: bool, legacy_odds: bool):
    """The TI conditional updates of ``plan``'s steps in order.

    Acceptance odds H_i (b + T a) V(n, t+1) t / (n - t) after removal of
    the item's indicator, or the reference's t / (n - t + 1) with
    ``legacy_odds`` (see libstb_tpu/models/pyp.ti_sweep for the
    derivation and the measured bias of the legacy form)."""
    dt = a.dtype
    C = t.shape[0]
    S, W = plan.flat.shape
    t = t.clone()
    T = T.clone()
    tf = t.view(C, -1)
    live = plan.free & ~plan.first if skip_first else plan.free
    nf = plan.cnt.to(dt)
    H = plan.H.to(dt)
    mvec = torch.arange(1, plan.mq + 1, device=t.device)
    # (C, P * mq) from a grid; one (1, P * mq) block from a single table,
    # which every chain reads through an expanded view
    vrows = _vq(tab, plan.pair_n[None, :, None], mvec[None, None, :],
                a[:, None, None]).to(dt)
    vrows = vrows.reshape(vrows.shape[0], -1).expand(C, -1)
    u = rng.uniform(gen, (S, 2, C, W), dt, t.device)
    a2 = a[:, None]
    b2 = b[:, None]
    for s in range(S):
        flat, j, ni, nif, ls = (plan.flat[s], plan.grp[s], plan.cnt[s],
                                nf[s], live[s])
        ti = tf[:, flat]                              # (C, W)
        Tj = T[:, j]                                  # block-start totals
        dec = (ti > 1) & ((nif - 1.0) * u[s, 0] < (ti - 1).to(dt)) & ls
        ti2 = ti - dec.to(ti.dtype)
        Tj2 = Tj - dec.to(Tj.dtype)
        # V(n, t+1): m > n reads the block's last column, which is 0 like V
        idx = plan.vbase[s] + torch.clamp(ti2, max=plan.mq - 1)
        v = torch.gather(vrows, 1, idx)
        ti2f = ti2.to(dt)
        denom = (nif - ti2f + 1.0) if legacy_odds else torch.clamp(
            nif - ti2f, min=1.0)
        one = H[s] * (b2 + Tj2.to(dt) * a2) * ti2f / denom * v
        inc = (u[s, 1] < one / (one + 1.0)) & ls & (ti2 < ni)
        delta = inc.to(t.dtype) - dec.to(t.dtype)
        # (j, i) cells are distinct within a step except pad slots, whose
        # delta is 0; T adds may repeat j (cat mode) and accumulate
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
