"""Carry the JAX package's tables, data and chain state into the port.

Every function takes plain numpy arrays and Python values (what
``np.asarray`` gives for a JAX array), so this module needs no JAX.  The
parity tests use it to hand both packages identical inputs, which
separates the query and sampler arithmetic from the fill.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core import agrid, stirling
from .models import pyp

__all__ = ["grid_from_numpy", "table_from_numpy", "data_from_numpy",
           "state_from_numpy", "hist_from_numpy"]

GRID_ARRAYS = ("avec", "s1_hi", "s1_lo", "vtab", "srel")
GRID_STATICS = ("a0", "da", "g_max", "n_max", "m_max", "max_n", "max_m",
                "use_asympt")


def grid_from_numpy(arrays: Mapping, statics: Mapping,
                    device) -> agrid.AGridTable:
    """An AGridTable from a JAX AGridTable's arrays (``GRID_ARRAYS``; vtab
    or srel may be None) and static fields (``GRID_STATICS``)."""
    def dev(x):
        return None if x is None else torch.as_tensor(np.array(x),
                                                      device=device)

    return agrid.AGridTable(
        a0=float(statics["a0"]), da=float(statics["da"]),
        g_max=int(statics["g_max"]), n_max=int(statics["n_max"]),
        m_max=int(statics["m_max"]),
        **{k: dev(arrays[k]) for k in GRID_ARRAYS},
        max_n=int(statics["max_n"]), max_m=int(statics["max_m"]),
        use_asympt=bool(statics["use_asympt"]))


TABLE_ARRAYS = ("a", "lga1", "s1_hi", "s1_lo", "vtab", "srel")
TABLE_STATICS = ("n_max", "m_max", "max_n", "max_m", "use_asympt",
                 "scan_chunks", "tag", "a_pos", "fold")


def _unfold(tab, n_max: int, scan_chunks: int, fold: int):
    """A JAX table array in its natural (n_max, m_max) layout.

    fold > 0: (N, fold, M // fold), column j at [:, j // L, j % L], so a
    reshape restores it.  scan_chunks > 0: the column-major n-permuted
    (M, H, S, 128) layout, natural row i of column j at
    [j, i % H, (i // H) // 128, (i // H) % 128] -- unfolded with the
    arithmetic of stirling_pallas.unfold_cols."""
    tab = np.array(tab)
    if fold:
        return tab.reshape(tab.shape[0], -1)
    if scan_chunks:
        m = tab.shape[0]
        tab = tab.reshape(m, -1)
        h = tab.shape[1] // scan_chunks
        return tab.reshape(m, h, scan_chunks).transpose(2, 1, 0).reshape(
            -1, m)[:n_max]
    return tab


def table_from_numpy(arrays: Mapping, statics: Mapping,
                     device) -> stirling.StirlingTable:
    """The port's natural-layout StirlingTable from a JAX StirlingTable's
    arrays (``TABLE_ARRAYS``; vtab or srel may be None) and static fields
    (``TABLE_STATICS``), in any of the JAX layouts (natural, fold,
    scan_chunks)."""
    def dev(x):
        if x is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(_unfold(
            x, int(statics["n_max"]), int(statics["scan_chunks"]),
            int(statics["fold"]))), device=device)

    def scalar(x):
        return torch.as_tensor(np.array(x), device=device)

    return stirling.StirlingTable(
        a=scalar(arrays["a"]), lga1=scalar(arrays["lga1"]),
        s1_hi=torch.as_tensor(np.array(arrays["s1_hi"]), device=device),
        s1_lo=torch.as_tensor(np.array(arrays["s1_lo"]), device=device),
        vtab=dev(arrays["vtab"]), srel=dev(arrays["srel"]),
        n_max=int(statics["n_max"]), m_max=int(statics["m_max"]),
        max_n=int(statics["max_n"]), max_m=int(statics["max_m"]),
        use_asympt=bool(statics["use_asympt"]), tag=str(statics["tag"]),
        a_pos=statics["a_pos"])


def data_from_numpy(data) -> pyp.PYPData:
    """The port's PYPData from any object with PYPData's fields."""
    return pyp.PYPData(*(np.array(getattr(data, f))
                         for f in pyp.PYPData._fields))


def state_from_numpy(t, T, a, b, device):
    """Chain state (t (C, J, D), T (C, J) as int32; a, b (C,) in their own
    float dtype) on ``device``."""
    def dev(x, dtype=None):
        return torch.as_tensor(np.array(x, dtype), device=device)

    return dev(t, np.int32), dev(T, np.int32), dev(a), dev(b)


def hist_from_numpy(hist, T, device):
    """HSA state as int32 on ``device``: hist (C, J, D, S+1) from init_hsa
    or hp (C, P, S+1) from init_hsa_pairs, and T (C, J)."""
    return (torch.as_tensor(np.array(hist, np.int32), device=device),
            torch.as_tensor(np.array(T, np.int32), device=device))
