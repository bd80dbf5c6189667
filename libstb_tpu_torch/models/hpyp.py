"""Two-level hierarchical Pitman-Yor process (HPYP) model family, in
PyTorch.

Port of libstb_tpu/models/hpyp.py -- the application pattern libstb exists
to serve (hierarchical PYP topic / n-gram models, arXiv:1007.0296): J
group-level PYP(a1, b1) restaurants whose base measure is itself a
PYP(a0, b0) over the base distribution H.

  level 1 (groups):   counts n[j, i]  -> table counts t1[j, i]
  level 0 (shared):   counts n0[i] = sum_j t1[j, i] -> table counts t0[i]
  base for level 1:   the level-0 posterior predictive
      p0[i] = (n0[i] - a0 t0[i] + (b0 + a0 T0) H[i]) / (b0 + N0)

Gibbs cycle: CT sweep at level 1 with per-chain base p0 -> recompute n0
-> CT sweep at level 0 with per-chain dynamic counts -> every
``hyper_cycle`` iterations the (b, a) moves of level 1, then of level 0.
Everything is chain-batched.  Where the JAX package scans the iterations
in one program, here they are a Python loop that enqueues each step on the
grid's device; the draws are taken in the order JAX's split keys hand them
out (level-1 sweep, level-0 sweep, then b1, a1, b0, a0), so a recorded
JAX run can be replayed through ``rng.Replay``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import agrid
from ..samplers import hyper
from . import pyp

__all__ = ["HPYPConfig", "run_hpyp"]


@dataclasses.dataclass(frozen=True)
class HPYPConfig:
    """A copy of libstb_tpu.models.hpyp.HPYPConfig
    (tests/test_torch_hpyp.py holds the two equal)."""
    iters: int = 200
    burnin: int = 0
    hyper_cycle: int = 0       # 0 = fixed hyperparameters
    shape: float = 1.1         # Gamma prior on both concentrations
    scale: float = 20.0

    def resolved_burnin(self) -> int:
        return self.burnin if self.burnin > 0 else self.iters // 2


def _predictive(n0, t0, T0, a0, b0, H):
    """Level-0 PYP posterior predictive over categories, (C, D)."""
    dt = a0.dtype
    N0 = torch.sum(n0, dim=-1).to(dt)
    num = (n0.to(dt) - a0[:, None] * t0.to(dt)
           + (b0 + a0 * T0.to(dt))[:, None] * H[None, :])
    return num / (b0.to(dt) + N0)[:, None]


def _level0_data(data: pyp.PYPData) -> pyp.PYPData:
    """The level-0 skeleton: 1 group x D categories (its counts are the
    per-chain n0, handed to the sweep as ``n_arr``)."""
    D = data.n.shape[1]
    return pyp.PYPData(
        data_cat=np.arange(D, dtype=np.int32),
        data_grp=np.zeros(D, np.int32),
        first=np.ones(D, bool),
        n=np.zeros((1, D), np.int32),
        N=np.zeros(1, np.int32),
        H=np.asarray(data.H))


def run_hpyp(gen, data: pyp.PYPData, grid: agrid.AGridTable, chains: int,
             a1: float, b1: float, a0: float, b0: float, cfg: HPYPConfig):
    """Run the 2-level HPYP Gibbs ensemble on the grid's device (the card,
    unless the caller made the grid on the CPU); returns posterior stats.

    Returns a dict with the time-averaged (post burn-in) level-1 / level-0
    table counts ``t1ave``, ``T1ave``, ``t0ave``, ``T0ave``, the
    hyperparameter averages ``a1ave``, ``b1ave``, ``a0ave``, ``b0ave``,
    the final states ``t1``, ``T1``, ``t0``, ``T0``, and the ensemble
    means ``T1ave_mean``, ``T0ave_mean`` -- the JAX function's keys.
    ``gen``: a torch.Generator on the grid's device.

    Grid growth: level-0 counts are dynamic (n0[i] = sum_j t1[j, i]), so a
    grid sized from the level-1 data alone under-covers the hierarchy.  The
    reachable bound is n0[i] <= sum_j n[j, i]; the grid is grown to it up
    front within its hard bounds (``ensure_grid``; on a CUDA device the
    refill is the kernel K1).
    """
    n0_bound = int(np.asarray(data.n).sum(axis=0).max())
    n_req, m_req = agrid.required_dims(data.n)
    grid = agrid.ensure_grid(grid, max(n_req, n0_bound + 1),
                             max(m_req, n0_bound + 1))
    dt, dev = grid.srel.dtype, grid.device
    t1, T1 = pyp.init_state(data, chains, dev)

    def full(x):
        return torch.full((chains,), x, dtype=dt, device=dev)

    a1v, b1v, a0v, b0v = full(a1), full(b1), full(a0), full(b0)
    # level-0 init: counts = current t1 sums, one table per used category
    n0 = t1.sum(1, dtype=torch.int32)
    t0 = (n0 > 0).to(t1.dtype)
    T0 = t0.sum(1, dtype=torch.int32)
    tmax = int(data.n.max()) + 1
    tmax0 = n0_bound + 1
    data0 = _level0_data(data)
    H = torch.as_tensor(data.H, dtype=dt, device=dev)
    N1 = torch.as_tensor(data.N, dtype=dt, device=dev)
    ns_flat1 = torch.as_tensor(data.n.reshape(-1), device=dev)
    burnin = cfg.resolved_burnin()
    sums = [torch.zeros(v.shape, dtype=dt, device=dev)
            for v in (t1, T1, t0, T0, a1v, b1v, a0v, b0v)]
    for it in range(cfg.iters):
        n0 = t1.sum(1, dtype=torch.int32)                 # (C, D)
        # level-1 sweep with the level-0 predictive as base
        p0 = _predictive(n0, t0, T0, a0v, b0v, H)
        t1, T1 = pyp.ct_sweep(gen, t1, T1, a1v, b1v, grid, data, tmax,
                              H_arr=p0)
        # level-0 sweep on the fresh t1 sums (dynamic counts, 1 group)
        n0 = t1.sum(1, dtype=torch.int32)
        t0g, T0g = pyp.ct_sweep(gen, t0[:, None, :], T0[:, None], a0v, b0v,
                                grid, data0, tmax0, n_arr=n0[:, None, :],
                                H_arr=H[None].expand(n0.shape))
        t0, T0 = t0g[:, 0, :], T0g[:, 0]

        if cfg.hyper_cycle > 0 and it % cfg.hyper_cycle == 0:
            b1v = hyper.sample_b(gen, b1v, N1, T1.to(dt), a1v, cfg.shape,
                                 cfg.scale)[0]
            a1v = hyper.sample_a(gen, a1v, grid, ns_flat1,
                                 t1.reshape(chains, -1), T1.to(dt),
                                 b1v[:, None].expand(T1.shape))[0]
            N0 = n0.sum(1, keepdim=True).to(dt)
            b0v = hyper.sample_b(gen, b0v, N0, T0[:, None].to(dt), a0v,
                                 cfg.shape, cfg.scale)[0]
            a0v = hyper.sample_a(gen, a0v, grid, n0, t0, T0[:, None].to(dt),
                                 b0v[:, None].expand(chains, 1))[0]

        if it >= burnin:
            for s, v in zip(sums, (t1, T1, t0, T0, a1v, b1v, a0v, b0v)):
                s += v

    cnt = float(max(cfg.iters - burnin, 0))
    names = ("t1ave", "T1ave", "t0ave", "T0ave", "a1ave", "b1ave", "a0ave",
             "b0ave")
    out = {k: s / cnt for k, s in zip(names, sums)}
    out.update(t1=t1, T1=T1, t0=t0, T0=T0,
               T1ave_mean=out["T1ave"].mean(dim=0),
               T0ave_mean=out["T0ave"].mean())
    return out
