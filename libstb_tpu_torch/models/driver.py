"""Gibbs-run driver: the main-loop analog of test/demo.c:405-519, batched
over chains, in PyTorch.

Port of the TI path of libstb_tpu/models/driver.py, with either 1-D
kernel (slice or ARS) for the (a, b) moves.  The JAX package
compiles the whole run into one program (a lax.scan over iterations);
here the iterations are a Python loop that enqueues each step's kernels
on the device, and the host waits on the device only inside the slice
sampler's per-try exit test.  Statistics accumulate on the device after
burn-in.  CT/CTW/HSA, per-iteration traces and ``run_gibbs_timed`` are
not ported yet (ROADMAP Queue 1, items 6 and 9).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import agrid
from ..samplers import hyper
from . import pyp

__all__ = ["GibbsConfig", "run_gibbs"]


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


def _check_ported(cfg: GibbsConfig):
    if cfg.sampler.upper() != "TI":
        raise NotImplementedError(
            f"sampler={cfg.sampler!r}: only TI is ported; CT/CTW/HSA are "
            "ROADMAP Queue 1, item 9")
    if cfg.collect_traces:
        raise NotImplementedError(
            "collect_traces: traces, R-hat and ESS are ROADMAP Queue 1, "
            "items 6 and 11")


def run_gibbs(gen, data: pyp.PYPData, grid: agrid.AGridTable,
              chains: int, a0: float, b0: float, cfg: GibbsConfig):
    """Run the full Gibbs chain ensemble on the grid's device; returns
    posterior-mean stats (demo.c:493-519): time-averaged t, T (post
    burn-in) per chain, a/b averages, and their ensemble means in the
    "*_mean" entries, plus the final state.

    The grid is grown up front (ensure_grid) to cover every query the run
    can make, as the JAX driver does.  ``gen``: a torch.Generator on the
    grid's device.
    """
    _check_ported(cfg)
    n_req, m_req = agrid.required_dims(data.n)
    grid = agrid.ensure_grid(grid, n_req, m_req,
                             quit_on_bound=cfg.quit_on_bound)
    dt, dev = grid.srel.dtype, grid.device
    t, T = pyp.init_state(data, chains, dev)
    a = torch.full((chains,), a0, dtype=dt, device=dev)
    b = torch.full((chains,), b0, dtype=dt, device=dev)
    sched = (pyp.ti_schedule(data, "group") if cfg.ti_blocked
             else pyp.item_schedule(data))
    plan = pyp.ti_plan(data, sched, dev)
    ns_flat = torch.as_tensor(data.n.reshape(-1), device=dev)
    N_b = torch.as_tensor(data.N[: cfg.b_groups], dtype=dt, device=dev)
    burnin = cfg.resolved_burnin()

    t_sum = torch.zeros(t.shape, dtype=dt, device=dev)
    T_sum = torch.zeros(T.shape, dtype=dt, device=dev)
    a_sum = torch.zeros_like(a)
    b_sum = torch.zeros_like(b)
    for it in range(cfg.iters):
        t, T = pyp.ti_sweep_blocked(gen, t, T, a, b, grid, data, sched=plan,
                                    skip_first=cfg.ti_skip_first,
                                    legacy_odds=cfg.ti_legacy)
        if cfg.bcycle > 0 and it % cfg.bcycle == 0:
            b = hyper.sample_b(gen, b, N_b, T[:, : cfg.b_groups].to(dt), a,
                               cfg.shape, cfg.scale, kernel=cfg.kernel)[0]
        if cfg.acycle > 0 and it % cfg.acycle == 0:
            a = hyper.sample_a(gen, a, grid, ns_flat, t.reshape(chains, -1),
                               T.to(dt), b[:, None].expand(T.shape),
                               kernel=cfg.kernel)[0]
        if it >= burnin:
            t_sum += t
            T_sum += T
            a_sum += a
            b_sum += b
    cnt = float(max(cfg.iters - burnin, 0))
    tave, Tave, aave, bave = (x / cnt for x in (t_sum, T_sum, a_sum, b_sum))
    return dict(
        tave=tave, Tave=Tave, aave=aave, bave=bave,
        tave_mean=tave.mean(dim=0), Tave_mean=Tave.mean(dim=0),
        aave_mean=aave.mean(), bave_mean=bave.mean(),
        t=t, T=T, a=a, b=b, hist=None)
