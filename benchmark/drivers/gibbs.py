"""The Gibbs cells: the discount-grid Gibbs run of upstream libstb's
test/demo.c over a batch of chains, driven through the port's
``models/driver.run_gibbs_timed``.

Set-up makes the counts from the seed (``datagen.crp_generate``), fills
the discount grid through ``core/agrid.make_grid`` (K1 on a card) and
warms the loop with ``acycle`` iterations of ``run_gibbs``, which reach
the TI sweep and both hyperparameter moves.  The window is one call of
``run_gibbs_timed`` with a budget of the window's length: it runs one
chunk off its own clock, then chunks until the budget is spent, the first
``burnin_iters`` iterations discarded from its averages.

``gibbs_updates_per_s`` = chains x items x iterations / the call's wall
time; the iterations are the call's ``iters_done`` and its off-clock
chunk (``chunk`` rounded up to a multiple of lcm(bcycle, acycle), as the
driver documents), so all the work and all the time of the call count.

The check (reference/pyp_posterior.py, reference/stirling_ref.py):

* the grid that set-up filled, V, Srel and S1 at every discount, row and
  column, against the f64 reference at the configuration's discounts;
* the state after the window: every chain's t within [1, n] where n > 0
  and 0 elsewhere, T the sum of t, a and b and their averages inside the
  samplers' bounds (``invalid_chains``, limit 0);
* the ensemble mean of the chains' averages of T_j against the exact
  posterior mean of the model (``T_gap``, relative, the worst group);
* the chains' a and b after the window against the exact posterior
  marginals of a and of b (``a_ks``, ``b_ks``: the Kolmogorov distance).
  Every chain starts at (a0, b0), so a move of a or of b that returns its
  input leaves a point mass there, at a distance of 1/2 or more;
* the window's kept iterations: ``kept_short`` is how many it kept fewer
  than the mix's ``min_kept`` (limit 0), so that every window judged
  averages at least that many iterations past burn-in.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import datagen, stats
from benchmark.reference import compare, pyp_posterior

SPANS = {
    "ti_sweep": ("libstb_tpu_torch.models.pyp", "ti_sweep_blocked"),
    "sample_b": ("libstb_tpu_torch.samplers.hyper", "sample_b"),
    "sample_a": ("libstb_tpu_torch.samplers.hyper", "sample_a"),
}
STEP = "ti_sweep"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log):
        from libstb_tpu_torch.core import agrid
        from libstb_tpu_torch.models import driver, pyp

        self.config, self.traffic, self.device = config, traffic, device
        self.limits = {**config.get("limits", {}),
                       **traffic.get("limits", {})}
        d = datagen.crp_generate(seed, config["groups"], config["dim"],
                                 config["items_per_group"], config["gen_a"],
                                 config["gen_b"])
        self.counts = d
        self.data = pyp.PYPData(d.cat, d.grp, d.first, d.n, d.N, d.H)
        log("data")
        g = config["grid"]
        self.grid = agrid.make_grid(
            g["n"], g["m"], g=g["g"], a_lo=g["a_lo"], a_hi=g["a_hi"],
            dtype=_DTYPES[config["dtype"]], device=device)
        log("grid")
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.chains = traffic["chains"]
        self.cfg = driver.GibbsConfig(
            iters=config["acycle"], burnin=traffic["burnin_iters"],
            bcycle=config["bcycle"], acycle=config["acycle"],
            sampler=config["sampler"], shape=config["b_shape"],
            scale=config["b_scale"], b_groups=config["groups"],
            kernel=config["kernel"])
        driver.run_gibbs(self.gen, self.data, self.grid, self.chains,
                         config["a0"], config["b0"], self.cfg)
        log("warm")
        self.out = None

    def window(self, seconds: float) -> dict:
        from libstb_tpu_torch.models import driver

        c = self.config
        t0 = time.perf_counter()
        self.out = driver.run_gibbs_timed(
            self.gen, self.data, self.grid, self.chains, c["a0"], c["b0"],
            self.cfg, iter_ms=seconds * 1e3, chunk=self.traffic["chunk"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        period = math.lcm(c["bcycle"], c["acycle"])
        off_clock = math.ceil(self.traffic["chunk"] / period) * period
        iterations = self.out["iters_done"] + off_clock
        items = int(self.counts.N.sum())
        print(f"window ran {self.out['iters_done']} iterations, kept "
              f"{self._kept()}", file=sys.stderr, flush=True)
        return {"gibbs_updates_per_s": stats.rate(
            self.chains * items * iterations, wall)}

    def _kept(self) -> int:
        return int(self.out["iters_done"] - self.out["burnin_done"])

    def _invalid_chains(self, c: dict) -> int:
        o = self.out
        n = torch.as_tensor(self.counts.n, device=self.device)
        t, T = o["t"].to(torch.int64), o["T"].to(torch.int64)
        occ = n > 0
        bad_t = ((occ & ((t < 1) | (t > n))) | (~occ & (t != 0))).flatten(1)
        bad = bad_t.any(1) | (T != t.sum(-1)).any(1)
        for key, lo, hi in (("a", c["a_lo"], c["a_hi"]),
                            ("aave", c["a_lo"], c["a_hi"]),
                            ("b", c["b_lo"], c["b_hi"]),
                            ("bave", c["b_lo"], c["b_hi"])):
            x = o[key].to(torch.float64)
            bad |= ~torch.isfinite(x) | (x < lo) | (x > hi)
        Tave = o["Tave"].to(torch.float64)
        bad |= (~torch.isfinite(Tave) | (Tave < occ.sum(-1))
                | (Tave > n.sum(-1))).any(1)
        return int(bad.sum())

    def check(self):
        c, g = self.config, self.config["grid"]
        o, grid = self.out, self.grid
        dev = self.device
        invalid = self._invalid_chains(c)
        # the grid against the f64 reference at the configuration's
        # discounts, worked out here and not read from the grid
        avec = torch.as_tensor(np.linspace(g["a_lo"], g["a_hi"], g["g"]),
                               dtype=torch.float64, device=dev)
        s1 = grid.s1_hi.to(torch.float64) + grid.s1_lo.to(torch.float64)
        errs = compare.merge([compare.table_errors(
            avec, g["n"], g["m"], lambda j: grid.vtab[..., j],
            lambda j: grid.srel[..., j], s1)])
        ex = pyp_posterior.posterior_moments(
            self.counts.n, self.counts.H, a_lo=c["a_lo"], a_hi=c["a_hi"],
            b_lo=c["b_lo"], b_hi=c["b_hi"], shape=c["b_shape"],
            scale=c["b_scale"])
        T_mean = o["Tave"].to(torch.float64).mean(0).cpu().numpy()
        a_end = o["a"].to(torch.float64).cpu().numpy()
        logb_end = np.log(o["b"].to(torch.float64).cpu().numpy())
        kept_short = max(0, self.traffic["min_kept"] - self._kept())
        self.out = self.grid = None
        lim = self.limits
        checks = {
            "grid_v_rel": (errs["v_rel"], lim["grid_v_rel"]),
            "grid_srel_abs": (errs["srel_abs"], lim["grid_srel_abs"]),
            "grid_s1_abs": (errs["s1_abs"], lim["grid_s1_abs"]),
            "grid_pattern": (errs["pattern"], 0),
            "invalid_chains": (invalid, 0),
            "T_gap": (float(np.max(np.abs(T_mean - np.asarray(ex["T"]))
                                   / np.asarray(ex["T"]))), lim["T_gap"]),
            "a_ks": (pyp_posterior.ks_distance(a_end, ex["a_grid"],
                                               ex["a_cdf"]), lim["a_ks"]),
            "b_ks": (pyp_posterior.ks_distance(logb_end, ex["logb_grid"],
                                               ex["logb_cdf"]), lim["b_ks"]),
            "kept_short": (kept_short, 0),
        }
        return checks, self.chains, invalid

