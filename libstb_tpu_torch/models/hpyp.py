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

Gibbs cycle, one function a step: ``_level1`` (n0, the predictive p0 and
the CT sweep at level 1 with per-chain base p0) -> ``_level0`` (the fresh
n0 and the CT sweep at level 0 with per-chain dynamic counts) -> every
``hyper_cycle`` iterations ``_hyper`` (the (b, a) moves of level 1, then
of level 0).  Everything is chain-batched.  Where the JAX package scans
the iterations in one program, here they are a Python loop
(``_run_chunk``) that enqueues each step on the grid's device; the draws
are taken in the order JAX's split keys hand them out (level-1 sweep,
level-0 sweep, then b1, a1, b0, a0), so a recorded JAX run can be replayed
through ``rng.Replay``.  ``run_hpyp`` runs a fixed count of iterations,
``run_hpyp_timed`` chunks of them until a wall-clock budget is spent.

Spans (``utils/metrics``): ``stb/hpyp.iter`` an iteration, inside it
``stb/hpyp.level1``, ``stb/hpyp.level0`` and ``stb/hpyp.hyper``;
``stb/hpyp.chunk_end`` a timed chunk's ``synchronize``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import agrid
from ..samplers import hyper
from ..utils import metrics
from . import driver, pyp

__all__ = ["HPYPConfig", "grow_grid", "run_hpyp", "run_hpyp_timed"]


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


def grow_grid(data: pyp.PYPData, grid: agrid.AGridTable) -> agrid.AGridTable:
    """The grid grown to cover every query of a run over ``data``.

    Level-0 counts are dynamic (n0[i] = sum_j t1[j, i]), so a grid sized
    from the level-1 data alone under-covers the hierarchy.  The reachable
    bound is n0[i] <= sum_j n[j, i]; the grid is grown to it within its
    hard bounds (``ensure_grid``; on a CUDA device the refill is the kernel
    K1).  A grid that already covers it is returned as it is."""
    n0_bound = int(np.asarray(data.n).sum(axis=0).max())
    n_req, m_req = agrid.required_dims(data.n)
    return agrid.ensure_grid(grid, max(n_req, n0_bound + 1),
                             max(m_req, n0_bound + 1))


class _Plan(NamedTuple):
    """What a run builds once from its data, on the grid's device."""
    data0: pyp.PYPData              # the level-0 skeleton
    H: torch.Tensor                 # (D,) base distribution
    N1: torch.Tensor                # (J,) level-1 group totals, sample_b
    ns_flat1: torch.Tensor          # (J * D,) level-1 counts, sample_a
    tmax: int                       # level-1 CT candidates 1..max n + 1
    tmax0: int                      # level-0 candidates 1..n0 bound + 1
    srel_pos1: torch.Tensor         # level 1's pyp.ct_srel_pos


_STATE = ("t1", "T1", "t0", "T0", "a1", "b1", "a0", "b0")


def _prepare(data: pyp.PYPData, grid: agrid.AGridTable):
    """The grid grown to the level-0 bound, and the run's plan."""
    grid = grow_grid(data, grid)
    dt, dev = grid.srel.dtype, grid.device
    tmax = int(data.n.max()) + 1
    return grid, _Plan(
        data0=_level0_data(data),
        H=torch.as_tensor(data.H, dtype=dt, device=dev),
        N1=torch.as_tensor(data.N, dtype=dt, device=dev),
        ns_flat1=torch.as_tensor(data.n.reshape(-1), device=dev),
        tmax=tmax,
        tmax0=int(np.asarray(data.n).sum(axis=0).max()) + 1,
        srel_pos1=pyp.ct_srel_pos(data.n, tmax, dev))


def _init(data: pyp.PYPData, grid: agrid.AGridTable, chains: int,
          a1: float, b1: float, a0: float, b0: float) -> dict:
    """The starting state: one table per occupied category at level 1;
    at level 0 counts n0 = the sums of t1 and one table per used
    category; the four hyperparameters."""
    dt, dev = grid.srel.dtype, grid.device
    t1, T1 = pyp.init_state(data, chains, dev)

    def full(x):
        return torch.full((chains,), x, dtype=dt, device=dev)

    n0 = t1.sum(1, dtype=torch.int32)
    t0 = (n0 > 0).to(t1.dtype)
    return dict(t1=t1, T1=T1, t0=t0, T0=t0.sum(1, dtype=torch.int32), n0=n0,
                a1=full(a1), b1=full(b1), a0=full(a0), b0=full(b0))


def _level1(gen, s: dict, grid: agrid.AGridTable, data: pyp.PYPData,
            plan: _Plan):
    """n0 from the state's t1, the level-0 predictive p0, and the level-1
    CT sweep with p0 as the base; returns (t1, T1)."""
    with metrics.span("hpyp.level1"):
        n0 = s["t1"].sum(1, dtype=torch.int32)            # (C, D)
        p0 = _predictive(n0, s["t0"], s["T0"], s["a0"], s["b0"], plan.H)
        return pyp.ct_sweep(gen, s["t1"], s["T1"], s["a1"], s["b1"], grid,
                            data, plan.tmax, H_arr=p0,
                            srel_pos=plan.srel_pos1)


def _level0(gen, t1, t0, T0, a0, b0, grid: agrid.AGridTable, plan: _Plan):
    """The level-0 CT sweep on the fresh sums of ``t1`` (dynamic counts, one
    group, base H); returns (t0, T0, n0), n0 the counts it swept."""
    with metrics.span("hpyp.level0"):
        n0 = t1.sum(1, dtype=torch.int32)
        t0g, T0g = pyp.ct_sweep(gen, t0[:, None, :], T0[:, None], a0, b0,
                                grid, plan.data0, plan.tmax0,
                                n_arr=n0[:, None, :],
                                H_arr=plan.H[None].expand(n0.shape))
        return t0g[:, 0, :], T0g[:, 0], n0


def _hyper(gen, s: dict, grid: agrid.AGridTable, plan: _Plan,
           cfg: HPYPConfig):
    """The moves of b1, a1, b0 and a0, in this order; returns them."""
    with metrics.span("hpyp.hyper"):
        dt = grid.srel.dtype
        t1, T1, t0, T0, n0 = s["t1"], s["T1"], s["t0"], s["T0"], s["n0"]
        chains = t1.shape[0]
        b1 = hyper.sample_b(gen, s["b1"], plan.N1, T1.to(dt), s["a1"],
                            cfg.shape, cfg.scale)[0]
        a1 = hyper.sample_a(gen, s["a1"], grid, plan.ns_flat1,
                            t1.reshape(chains, -1), T1.to(dt),
                            b1[:, None].expand(T1.shape))[0]
        N0 = n0.sum(1, keepdim=True).to(dt)
        b0 = hyper.sample_b(gen, s["b0"], N0, T0[:, None].to(dt), s["a0"],
                            cfg.shape, cfg.scale)[0]
        a0 = hyper.sample_a(gen, s["a0"], grid, n0, t0, T0[:, None].to(dt),
                            b0[:, None].expand(chains, 1))[0]
        return a1, b1, a0, b0


def _run_chunk(gen, data: pyp.PYPData, grid: agrid.AGridTable, plan: _Plan,
               cfg: HPYPConfig, state: dict, sums: list, it0: int,
               iters: int, burnin: int):
    """Iterations it0 .. it0 + iters - 1 from ``state`` (the hyper cycle's
    phase counted from iteration 0 of the run); the state of every
    iteration >= ``burnin`` is added to ``sums`` (in ``_STATE``'s order,
    in place).  Returns the new state."""
    s = dict(state)
    for it in range(it0, it0 + iters):
        with metrics.span("hpyp.iter"):
            s["t1"], s["T1"] = _level1(gen, s, grid, data, plan)
            s["t0"], s["T0"], s["n0"] = _level0(gen, s["t1"], s["t0"],
                                                s["T0"], s["a0"], s["b0"],
                                                grid, plan)
            if cfg.hyper_cycle > 0 and it % cfg.hyper_cycle == 0:
                s["a1"], s["b1"], s["a0"], s["b0"] = _hyper(gen, s, grid,
                                                             plan, cfg)
            if it >= burnin:
                for acc, k in zip(sums, _STATE):
                    acc += s[k]
    return s


def _zero_sums(state: dict, dt) -> list:
    return [torch.zeros(state[k].shape, dtype=dt, device=state[k].device)
            for k in _STATE]


def _outputs(state: dict, sums: list, cnt: float) -> dict:
    """run_hpyp's keys: the averages, the final state, the ensemble means."""
    names = ("t1ave", "T1ave", "t0ave", "T0ave", "a1ave", "b1ave", "a0ave",
             "b0ave")
    out = {k: s / cnt for k, s in zip(names, sums)}
    out.update(t1=state["t1"], T1=state["T1"], t0=state["t0"],
               T0=state["T0"], T1ave_mean=out["T1ave"].mean(dim=0),
               T0ave_mean=out["T0ave"].mean())
    return out


def run_hpyp(gen, data: pyp.PYPData, grid: agrid.AGridTable, chains: int,
             a1: float, b1: float, a0: float, b0: float, cfg: HPYPConfig):
    """Run the 2-level HPYP Gibbs ensemble on the grid's device (the card,
    unless the caller made the grid on the CPU); returns posterior stats.

    Returns a dict with the time-averaged (post burn-in) level-1 / level-0
    table counts ``t1ave``, ``T1ave``, ``t0ave``, ``T0ave``, the
    hyperparameter averages ``a1ave``, ``b1ave``, ``a0ave``, ``b0ave``,
    the final states ``t1``, ``T1``, ``t0``, ``T0``, and the ensemble
    means ``T1ave_mean``, ``T0ave_mean`` -- the JAX function's keys.
    ``gen``: a torch.Generator on the grid's device.  The grid is grown up
    front to the level-0 bound (``grow_grid``).
    """
    grid, plan = _prepare(data, grid)
    state = _init(data, grid, chains, a1, b1, a0, b0)
    burnin = cfg.resolved_burnin()
    sums = _zero_sums(state, grid.srel.dtype)
    state = _run_chunk(gen, data, grid, plan, cfg, state, sums, 0, cfg.iters,
                       burnin)
    return _outputs(state, sums, float(max(cfg.iters - burnin, 0)))


def run_hpyp_timed(gen, data: pyp.PYPData, grid: agrid.AGridTable,
                   chains: int, a1: float, b1: float, a0: float, b0: float,
                   cfg: HPYPConfig, iter_ms: Optional[float] = None,
                   chunk: int = 10):
    """Wall-clock-bounded HPYP run, the counterpart of
    ``driver.run_gibbs_timed`` (check.c's '-C Nms' mode).

    The grid is grown up front (``grow_grid``).  Runs chunks of ``chunk``
    iterations (rounded up to a multiple of ``cfg.hyper_cycle``), carrying
    the state and the running sums across chunks, with a ``synchronize``
    after each.  One chunk runs off the clock first from the starting state
    and is discarded (its draws are taken); the run then starts again from
    the starting state.  The first ``cfg.resolved_burnin()`` iterations are
    burn-in; sampling stops once ``iter_ms`` has elapsed (else after
    ``cfg.iters``, the last chunk clamped).  In count mode the state and
    averages equal those of ``run_hpyp`` of ``cfg.iters`` iterations that
    starts where the off-clock chunk left the generator.

    Returns run_hpyp's keys, the final ``n0`` (the counts the last level-0
    sweep read) and ``a1``, ``b1``, ``a0``, ``b0``, and ``iters_done``,
    ``burnin_done`` (iterations of burn-in run) and ``elapsed_ms``.  A
    budget spent inside burn-in keeps nothing: the averages are then the
    final state's.
    """
    grid, plan = _prepare(data, grid)
    dev, dt = grid.device, grid.srel.dtype
    if cfg.hyper_cycle > 0:
        chunk = math.ceil(chunk / cfg.hyper_cycle) * cfg.hyper_cycle
    start_state = _init(data, grid, chains, a1, b1, a0, b0)
    _run_chunk(gen, data, grid, plan, cfg, start_state,
               _zero_sums(start_state, dt), 0, chunk, 0)     # off the clock
    driver._sync(dev)

    burnin = cfg.resolved_burnin()
    state, sums = start_state, _zero_sums(start_state, dt)
    done = 0
    start = time.perf_counter()
    while iter_ms is not None or done < cfg.iters:
        n = chunk if iter_ms is not None else min(chunk, cfg.iters - done)
        state = _run_chunk(gen, data, grid, plan, cfg, state, sums, done, n,
                           burnin)
        with metrics.span("hpyp.chunk_end"):
            driver._sync(dev)
            done += n
            el_ms = (time.perf_counter() - start) * 1e3
        if iter_ms is not None and el_ms > iter_ms:
            break
    burnin_done = min(burnin, done)
    kept = done - burnin_done
    if kept == 0:
        sums = [state[k].to(dt) for k in _STATE]
    out = _outputs(state, sums, float(max(kept, 1)))
    out.update({k: state[k] for k in ("n0", "a1", "b1", "a0", "b0")})
    out.update(iters_done=done, burnin_done=burnin_done,
               elapsed_ms=(time.perf_counter() - start) * 1e3)
    return out
