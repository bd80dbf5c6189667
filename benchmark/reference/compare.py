"""The comparison of a program's Stirling table with the plain reference,
column by column, so that neither side is ever held whole in f64.

Four numbers, over every cell of every table compared:

* ``v_rel``: max |V - V_ref| / V_ref over the cells where V_ref is finite
  and above 0 (2 <= m <= n);
* ``srel_abs``: max |Srel - Srel_ref| over the cells where Srel_ref is
  finite (m <= n);
* ``s1_abs``: max |(s1_hi + s1_lo) - S1_ref| over the rows;
* ``pattern``: the cells whose sentinel differs from the reference's: V
  = +inf in column 1, V = 0 and Srel = -inf above the diagonal, finite
  elsewhere.  NaN counts as a differing sentinel.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import stirling_ref

__all__ = ["table_errors", "merge"]


def table_errors(a: torch.Tensor, n: int, m: int,
                 v_col: Callable[[int], torch.Tensor],
                 srel_col: Callable[[int], torch.Tensor],
                 s1_sum: torch.Tensor, dtype=torch.float64) -> dict:
    """The four numbers of the table(s) for discounts ``a`` (shape (...)),
    n rows and m columns.  ``v_col(j)`` / ``srel_col(j)``: column j (m = j
    + 1) of the table under test, shape (..., n); ``s1_sum``: its S1 as
    one f64 tensor (..., n).  ``dtype``: the reference's precision."""
    f64 = torch.float64
    dev = a.device
    v_rel = torch.zeros((), dtype=f64, device=dev)
    srel_abs = torch.zeros((), dtype=f64, device=dev)
    pattern = torch.zeros((), dtype=torch.int64, device=dev)
    for j, v_r, s_r in stirling_ref.columns(a, n, m, dtype):
        v_r, s_r = v_r.to(f64), s_r.to(f64)
        v, s = v_col(j).to(f64), srel_col(j).to(f64)
        ok_v = torch.isfinite(v_r) & (v_r > 0)
        err = torch.where(ok_v, (v - v_r).abs() / torch.where(ok_v, v_r, 1.0),
                          0.0)
        v_rel = torch.maximum(v_rel, err.max())
        ok_s = torch.isfinite(s_r)
        err = torch.where(ok_s, (s - torch.where(ok_s, s_r, 0.0)).abs(), 0.0)
        srel_abs = torch.maximum(srel_abs, err.max())
        bad = ((torch.isposinf(v) != torch.isposinf(v_r))
               | ((v == 0) != (v_r == 0)) | torch.isnan(v)
               | (torch.isneginf(s) != torch.isneginf(s_r))
               | (torch.isfinite(s) != ok_s))
        pattern += bad.sum()
    s1_ref = stirling_ref.s1(a, n, dtype).to(f64)
    s1_abs = (s1_sum.to(f64) - s1_ref).abs().max()
    return {"v_rel": v_rel, "srel_abs": srel_abs, "s1_abs": s1_abs,
            "pattern": pattern}


def merge(parts) -> dict:
    """The worst of each number over several tables, as plain floats (a
    NaN anywhere makes that number NaN)."""
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            v, prev = float(v), out.get(k)
            out[k] = v if prev is None or v != v or v > prev else prev
    return out
