"""Explicit seating-arrangement (SA) Gibbs sampler -- the host oracle.

A numpy copy of libstb_tpu/models/sa.py (tests/test_torch_sa.py holds it
equal to the original under one numpy generator), so the port's check.c
analog (cli/check_torch.py) runs its SA column without JAX.

The reference's check.c runs five mathematically equivalent PYP samplers
side by side; SA (check.c:716-765) is the exact explicit-seating baseline
the others are validated against.  HSA (models/pyp.hsa_sweep) is its
exact histogram collapse and is the device-scale variant; this module keeps
the *explicit* per-table representation as a small-scale numpy oracle so
the framework has the same independent reference column check.c had.

Semantics per item of category i in group j (check.c:716-765):
  1. unseat: choose one of the category's tables with prob proportional
     to its size; a table emptied by the removal disappears;
  2. reseat: join an existing table with prob proportional to
     (size - a), or open a new one with prob proportional to
     (b + T a) H_i.

State is kept as per-(group, category) size arrays; this is a fresh
array-oriented implementation of those semantics, not a transliteration.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import pyp

__all__ = ["SAState", "sa_init", "sa_sweep", "sa_run"]


class SAState:
    """Explicit seating state: sizes[j][i] = int array of table sizes."""

    def __init__(self, data: pyp.PYPData):
        J, D = data.n.shape
        self.sizes = [[np.zeros(0, np.int64) for _ in range(D)]
                      for _ in range(J)]
        self.T = np.zeros(J, np.int64)
        self.data = data

    def t(self) -> np.ndarray:
        J, D = self.data.n.shape
        out = np.zeros((J, D), np.int64)
        for j in range(J):
            for i in range(D):
                out[j, i] = self.sizes[j][i].size
        return out


def sa_init(data: pyp.PYPData) -> SAState:
    """One table per occupied category (init_state's convention)."""
    st = SAState(data)
    J, D = data.n.shape
    for j in range(J):
        for i in range(D):
            if data.n[j, i] > 0:
                st.sizes[j][i] = np.array([data.n[j, i]], np.int64)
        st.T[j] = (data.n[j] > 0).sum()
    return st


def sa_sweep(rng: np.random.Generator, st: SAState, a: float, b: float):
    """One Gibbs sweep over all items (check.c:716-765 semantics)."""
    data = st.data
    H = data.H
    n = data.n
    for c in range(data.data_cat.size):
        i = int(data.data_cat[c])
        j = int(data.data_grp[c])
        sizes = st.sizes[j][i]
        ni = int(n[j, i])
        # -- unseat: P(table) proportional to its size --------------------
        cum = np.cumsum(sizes)
        tt = int(np.searchsorted(cum, rng.random() * ni, side="right"))
        sizes[tt] -= 1
        if sizes[tt] == 0:
            sizes = np.delete(sizes, tt)
            st.T[j] -= 1
        # -- reseat: existing proportional to (size - a), new to (b+Ta)H --
        w_new = (st.T[j] * a + b) * H[i]
        w_old = sizes - a
        val = rng.random() * (w_new + (ni - 1) - sizes.size * a)
        val -= np.sum(w_old)         # total existing weight first
        if val > 0 or sizes.size == 0:
            sizes = np.append(sizes, 1)
            st.T[j] += 1
        else:
            cumw = np.cumsum(w_old)
            tt = int(np.searchsorted(cumw, rng.random() * cumw[-1],
                                     side="right"))
            tt = min(tt, sizes.size - 1)
            sizes[tt] += 1
        st.sizes[j][i] = sizes


def sa_run(data: pyp.PYPData, iters: int, a: float, b: float,
           burnin: Optional[int] = None, seed: int = 0):
    """Run the SA oracle; returns dict(tave, Tave) time-averaged after
    burn-in (default iters//2), matching check.c's statistics."""
    if burnin is None:
        burnin = iters // 2
    rng = np.random.default_rng(seed)
    st = sa_init(data)
    J, D = data.n.shape
    tave = np.zeros((J, D))
    Tave = np.zeros(J)
    cnt = 0
    for it in range(iters):
        sa_sweep(rng, st, a, b)
        if it >= burnin:
            tave += st.t()
            Tave += st.T
            cnt += 1
    return {"tave": tave / cnt, "Tave": Tave / cnt}
