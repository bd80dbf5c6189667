"""Gibbs-run driver: the main-loop analog of test/demo.c:405-519 and
test/check.c:715-1054, batched over chains, in PyTorch.

Port of libstb_tpu/models/driver.py: ``run_gibbs`` with the TI, CT, CTW
and HSA samplers and either 1-D kernel (slice or ARS) for the (a, b)
moves, and ``run_gibbs_timed``, check.c's wall-clock-bounded mode.
CTW sweeps by default as the JAX driver does (``ct_sweep`` with a
window: the full 1..tmax block, masked); ``ctw_rel=True`` routes it to
``pyp.ctw_sweep_rel`` (2w + 1 candidates a count, the window shifted
into [1, n] as check.c:915-918 does), the route for check.c-sized
counts.  The
JAX package compiles a run into one program (a lax.scan over
iterations); here the iterations are a Python loop that enqueues each
step's kernels on the device.  On a card the host waits on the device
once a batch of K tries in the moves of a and b (the count of chains
still live, ops/slice_cuda) and at the end of each ``run_gibbs_timed``
chunk; on the CPU, in the slice sampler's per-try exit test.  Statistics
accumulate on the device after burn-in; with ``collect_traces`` the
per-iteration (a, b) traces and their split-R-hat / ESS come back too.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import torch

from ..core import agrid
from ..parallel import mesh
from ..samplers import hyper
from ..utils import metrics
from . import pyp

__all__ = ["GibbsConfig", "run_gibbs", "run_gibbs_timed"]

SAMPLERS = ("TI", "CT", "CTW", "HSA")


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """demo.c getopt flags as a config object (a copy of
    libstb_tpu.models.driver.GibbsConfig; tests/test_torch_driver.py
    holds the two equal)."""
    iters: int = 200          # -C
    burnin: int = 0           # -B (0 -> iters//2, demo.c:222-226)
    bcycle: int = 0           # -H
    acycle: int = 0           # -I
    sampler: str = "TI"       # -S (TI | CT | CTW | HSA)
    window: int = 10          # -w
    maxrel: float = 0.0       # -c: CT candidate early-stop bound
    shape: float = 1.1        # PB_shape (demo.c:73)
    scale: float = 20.0       # PB_scale = DIM (demo.c:74)
    b_groups: int = 1         # demo.c passes I=1 to sampleb (demo.c:454)
    ti_legacy: bool = False   # reproduce demo.c:427's t/(n-t+1) odds
    ti_skip_first: bool = True  # False = demo.c resamples first indicators
    ti_blocked: bool = True   # TI as the exact group-major reordering
    collect_traces: bool = False  # keep (a, b) per-iter traces + R-hat/ESS
    kernel: str = "slice"     # 1-D MCMC kernel for (a, b): "slice" | "ars"
    quit_on_bound: bool = False  # S_QUITONBOUND: raise when preflight
                              # growth hits the grid's hard bounds

    def resolved_burnin(self) -> int:
        return self.burnin if self.burnin > 0 else self.iters // 2


class _Plan(NamedTuple):
    """What a run builds once from its data, on the grid's device."""
    sampler: str
    tmax: int                       # CT candidates 1..max n + 1
    ti: Optional[pyp.TIPlan]        # the TI item schedule
    ns_flat: torch.Tensor           # (J * D,) counts for sample_a
    N_b: torch.Tensor               # group totals for sample_b
    ctw_rel: bool = False           # CTW by ctw_sweep_rel


def _prepare(data: pyp.PYPData, grid: agrid.AGridTable, cfg: GibbsConfig,
             ctw_rel: bool = False):
    """The grid grown to cover every query the run can make, and the
    run's plan."""
    if cfg.sampler.upper() not in SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.sampler}")
    if ctw_rel and cfg.sampler.upper() != "CTW":
        raise ValueError(f"ctw_rel routes the CTW sampler, not "
                         f"{cfg.sampler}")
    n_req, m_req = agrid.required_dims(data.n)
    grid = agrid.ensure_grid(grid, n_req, m_req,
                             quit_on_bound=cfg.quit_on_bound)
    dt, dev = grid.srel.dtype, grid.device
    sampler = cfg.sampler.upper()
    ti = None
    if sampler == "TI":
        sched = (pyp.ti_schedule(data, "group") if cfg.ti_blocked
                 else pyp.item_schedule(data))
        ti = pyp.ti_plan(data, sched, dev)
    return grid, _Plan(
        sampler=sampler, tmax=int(data.n.max()) + 1, ti=ti,
        ns_flat=torch.as_tensor(data.n.reshape(-1), device=dev),
        N_b=torch.as_tensor(data.N[: cfg.b_groups], dtype=dt, device=dev),
        ctw_rel=ctw_rel)


def _init(data: pyp.PYPData, grid: agrid.AGridTable, chains: int,
          a0: float, b0: float, plan: _Plan) -> dict:
    """The starting state: t, T (one table per occupied category), the
    HSA histogram (None for the other samplers), a and b."""
    dt, dev = grid.srel.dtype, grid.device
    t, T = pyp.init_state(data, chains, dev)
    hist = (pyp.init_hsa(data, chains, dev)[0] if plan.sampler == "HSA"
            else None)
    return dict(t=t, T=T, hist=hist,
                a=torch.full((chains,), a0, dtype=dt, device=dev),
                b=torch.full((chains,), b0, dtype=dt, device=dev))


def _sweep(gen, data, grid, state, cfg: GibbsConfig, plan: _Plan):
    """One sweep of the configured sampler; returns (t, T, hist)."""
    t, T, a, b = state["t"], state["T"], state["a"], state["b"]
    if plan.sampler == "TI":
        # exact group-major reordering (see GibbsConfig.ti_blocked)
        t, T = pyp.ti_sweep_blocked(gen, t, T, a, b, grid, data,
                                    sched=plan.ti,
                                    skip_first=cfg.ti_skip_first,
                                    legacy_odds=cfg.ti_legacy)
        return t, T, None
    if plan.sampler == "HSA":
        hist, T = pyp.hsa_sweep(gen, state["hist"], T, a, b, data)
        return hist.sum(-1, dtype=torch.int32), T, hist
    if plan.ctw_rel:
        # grid point queries at each chain's a (m_sel 0)
        t, T = pyp.ctw_sweep_rel(gen, t, T, a, b, grid, data,
                                 window=cfg.window)
        return t, T, None
    window = cfg.window if plan.sampler == "CTW" else None
    t, T = pyp.ct_sweep(gen, t, T, a, b, grid, data, plan.tmax,
                        window=window, maxrel=cfg.maxrel or None)
    return t, T, None


def _run_chunk(gen, data: pyp.PYPData, grid: agrid.AGridTable, state: dict,
               cfg: GibbsConfig, plan: _Plan, burnin: int) -> dict:
    """``cfg.iters`` iterations from ``state`` (the cycle phases counted
    from 0), the statistics of iterations >= ``burnin`` averaged; with
    ``cfg.collect_traces`` also the (iters, C) traces of a and b and the
    split-R-hat and ESS of their part from ``burnin`` on.  The traces
    draw nothing, so every other output is the same without them."""
    dt = grid.srel.dtype
    C = state["t"].shape[0]
    t_sum = torch.zeros(state["t"].shape, dtype=dt, device=grid.device)
    T_sum = torch.zeros(state["T"].shape, dtype=dt, device=grid.device)
    a_sum = torch.zeros_like(state["a"])
    b_sum = torch.zeros_like(state["b"])
    a_tr, b_tr = [], []
    for it in range(cfg.iters):
        with metrics.span("driver.iter"):
            t, T, hist = _sweep(gen, data, grid, state, cfg, plan)
            a, b = state["a"], state["b"]
            if cfg.bcycle > 0 and it % cfg.bcycle == 0:
                b = hyper.sample_b(gen, b, plan.N_b,
                                   T[:, : cfg.b_groups].to(dt), a, cfg.shape,
                                   cfg.scale, kernel=cfg.kernel)[0]
            if cfg.acycle > 0 and it % cfg.acycle == 0:
                a = hyper.sample_a(gen, a, grid, plan.ns_flat,
                                   t.reshape(C, -1), T.to(dt),
                                   b[:, None].expand(T.shape),
                                   kernel=cfg.kernel)[0]
            state = dict(t=t, T=T, hist=hist, a=a, b=b)
            if cfg.collect_traces:
                a_tr.append(a)
                b_tr.append(b)
            if it >= burnin:
                t_sum += t
                T_sum += T
                a_sum += a
                b_sum += b
    cnt = float(max(cfg.iters - burnin, 0))
    tave, Tave, aave, bave = (x / cnt for x in (t_sum, T_sum, a_sum, b_sum))
    out = dict(
        tave=tave, Tave=Tave, aave=aave, bave=bave,
        tave_mean=tave.mean(dim=0), Tave_mean=Tave.mean(dim=0),
        aave_mean=aave.mean(), bave_mean=bave.mean(), **state)
    if cfg.collect_traces:
        a_tr, b_tr = torch.stack(a_tr), torch.stack(b_tr)
        out.update(a_trace=a_tr, b_trace=b_tr,
                   a_rhat=mesh.rhat(a_tr[burnin:]),
                   b_rhat=mesh.rhat(b_tr[burnin:]),
                   a_ess=mesh.ess(a_tr[burnin:]),
                   b_ess=mesh.ess(b_tr[burnin:]))
    return out


def run_gibbs(gen, data: pyp.PYPData, grid: agrid.AGridTable,
              chains: int, a0: float, b0: float, cfg: GibbsConfig,
              ctw_rel: bool = False):
    """Run the full Gibbs chain ensemble on the grid's device; returns
    posterior-mean stats (demo.c:493-519): time-averaged t, T (post
    burn-in) per chain, a/b averages, and their ensemble means in the
    "*_mean" entries, plus the final state (t, T, a, b, and the HSA
    histogram ``hist``, None for the other samplers).  With
    ``cfg.collect_traces``: ``a_trace`` / ``b_trace`` (iters, C) and
    ``a_rhat``, ``b_rhat``, ``a_ess``, ``b_ess`` over the kept part
    ``[burnin:]`` (parallel.mesh).

    The grid is grown up front (ensure_grid) to cover every query the run
    can make, as the JAX driver does.  ``gen``: a torch.Generator on the
    grid's device.  ``ctw_rel`` (``cfg.sampler`` "CTW" only): sweep with
    ``pyp.ctw_sweep_rel`` in place of the masked ``ct_sweep``.
    """
    grid, plan = _prepare(data, grid, cfg, ctw_rel)
    return _run_chunk(gen, data, grid, _init(data, grid, chains, a0, b0,
                                             plan),
                      cfg, plan, cfg.resolved_burnin())


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gibbs_timed(gen, data: pyp.PYPData, grid: agrid.AGridTable,
                    chains: int, a0: float, b0: float, cfg: GibbsConfig,
                    iter_ms: Optional[float] = None,
                    burnin_ms: Optional[float] = None,
                    chunk: int = 16, progress=None, ctw_rel: bool = False):
    """Wall-clock-bounded Gibbs run (check.c's '-C Nms' / '-B Nms' modes,
    check.c:380-393, 1028-1054; libstb_tpu/models/driver.run_gibbs_timed).

    Runs chunks of ``chunk`` iterations (rounded up to a multiple of
    lcm(bcycle, acycle), so the cycle phases match one long run), carrying
    the state across chunks.  Burn-in ends when ``burnin_ms`` has elapsed
    (else after cfg's burn-in count); sampling stops when ``iter_ms`` has
    elapsed (else after cfg.iters, the last chunk clamped).  One chunk runs
    off the clock first and is discarded, as check.c starts its timer after
    S_make.  Returns run_gibbs-style statistics plus ``iters_done``,
    ``burnin_done`` and ``elapsed_ms``.

    ``progress``: optional callable, called after every post-burn-in chunk
    with (iters_done, elapsed_ms, running means dict) -- check.c's '-p
    repcyc' report (check.c:996-1010).  ``ctw_rel``: as ``run_gibbs``.
    """
    grid, plan = _prepare(data, grid, cfg, ctw_rel)
    dev = grid.device
    cycles = [c for c in (cfg.bcycle, cfg.acycle) if c > 0]
    if cycles:
        period = math.lcm(*cycles)
        chunk = math.ceil(chunk / period) * period
    state = _init(data, grid, chains, a0, b0, plan)

    def one_chunk(state, iters):
        return _run_chunk(gen, data, grid, state,
                          dataclasses.replace(cfg, iters=iters,
                                              collect_traces=False), plan, 0)

    out = one_chunk(state, chunk)            # off the clock, discarded
    _sync(dev)

    sums = None
    kept = 0
    done = 0
    step_iters = chunk          # the loop may not run at all (iters == 0)
    burnin_done = None
    start = time.perf_counter()
    max_iters = cfg.iters if iter_ms is None else 10 ** 9
    burnin = cfg.resolved_burnin() if burnin_ms is None else None
    keys = ("tave", "Tave", "aave", "bave")
    while done < max_iters:
        # count mode: clamp the last chunk so iters_done == cfg.iters
        step_iters = chunk if iter_ms is not None else min(
            chunk, max_iters - done)
        out = one_chunk(state, step_iters)
        state = {k: out[k] for k in ("t", "T", "hist", "a", "b")}
        with metrics.span("driver.chunk_end"):
            _sync(dev)
            done += step_iters
            el_ms = (time.perf_counter() - start) * 1e3
            in_burn = (el_ms <= burnin_ms if burnin_ms is not None
                       else done <= burnin)
            if not in_burn:
                if burnin_done is None:
                    burnin_done = done - step_iters
                # out[*ave] are chunk means: weight by the chunk's length
                # so a clamped last chunk does not skew the average
                vals = [out[k] * step_iters for k in keys]
                sums = vals if sums is None else [s + v for s, v in
                                                  zip(sums, vals)]
                kept += step_iters
                if progress is not None:
                    rm = [s / kept for s in sums]
                    progress(done, el_ms, dict(
                        Tave_mean=float(rm[1].sum(-1).mean()),
                        aave_mean=float(rm[2].mean()),
                        bave_mean=float(rm[3].mean())))
        if iter_ms is not None and el_ms > iter_ms:
            break
    if sums is None:         # the budget ran out inside burn-in
        sums = [out[k] for k in keys]
        kept = 1
        burnin_done = done - step_iters
    tave, Tave, aave, bave = (s / kept for s in sums)
    return dict(tave=tave, Tave=Tave, aave=aave, bave=bave,
                tave_mean=tave.mean(dim=0), Tave_mean=Tave.mean(dim=0),
                aave_mean=aave.mean(), bave_mean=bave.mean(),
                t=state["t"], T=state["T"], a=state["a"], b=state["b"],
                iters_done=done, burnin_done=burnin_done,
                elapsed_ms=(time.perf_counter() - start) * 1e3)
