"""The table cells: one Stirling table refilled for a new discount again
and again, as upstream libstb's demo.c calls S_remake after every a-move
(demo.c:467-489), driven through the port's ``core/stirling.remake``.

Set-up draws the discount walk from the seed (``datagen.discount_walk``),
makes the first table with ``core/stirling.make`` (building or loading
the kernels) and warms one remake.  The window remakes the table for the
walk's next discount, one call at a time, each timed on the host clock
from the call to a ``synchronize`` (the caller reads the table next),
until the window's seconds are spent:

* ``table_cells_per_s`` = n x m x remakes / the window's wall time;
* ``remake_ms_p95`` = the 95th percentile of every remake's time.

The check (reference/compare.py): a reservoir sample of ``keep`` of the
window's tables, drawn with the seed, and the last one, are held as the
program returned them; once the window has closed each is compared with
the f64 reference at its discount, every row and column of V and Srel
and the S1 pair.
"""
from __future__ import annotations

import random
import time

import torch

from benchmark import datagen, stats
from benchmark.reference import compare

SPANS = {"remake": ("libstb_tpu_torch.core.stirling", "remake")}
STEP = "remake"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log):
        from libstb_tpu_torch.core import stirling

        self.config, self.traffic, self.device = config, traffic, device
        self.limits = {**config.get("limits", {}),
                       **traffic.get("limits", {})}
        w = traffic["walk"]
        self.walk = datagen.discount_walk(seed, w["steps"], w["start"],
                                          w["step"], config["a_lo"],
                                          config["a_hi"])
        self.pick = random.Random(seed)
        log("walk")
        self.n, self.m = traffic["n"], config["m"]
        self.table = stirling.make(
            self.n, self.m, config["max_n"], config["max_m"],
            float(self.walk[0]), dtype=_DTYPES[config["dtype"]],
            device=device)
        self._sync()
        log("make")
        self.table = stirling.remake(self.table, float(self.walk[1]))
        self._sync()
        log("warm")
        self.kept = []
        self.last = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        from libstb_tpu_torch.core import stirling

        keep = self.traffic["keep"]
        lat = []
        k = 2
        t_end = None
        start = time.perf_counter()
        while t_end is None or t_end - start < seconds:
            a = float(self.walk[k % len(self.walk)])
            t0 = time.perf_counter()
            self.table = stirling.remake(self.table, a)
            self._sync()
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            # reservoir sample of the window's tables (Algorithm R)
            i = len(lat)
            if i <= keep:
                self.kept.append((a, self.table))
            else:
                r = self.pick.randrange(i)
                if r < keep:
                    self.kept[r] = (a, self.table)
            self.last = (a, self.table)
            k += 1
        self.remakes = len(lat)
        return {"table_cells_per_s": stats.rate(
                    self.n * self.m * len(lat), t_end - start),
                "remake_ms_p95": stats.percentile(lat, 95) * 1e3}

    def check(self):
        dev = self.device
        tables = self.kept + ([self.last] if all(
            t is not self.last[1] for _, t in self.kept) else [])
        self.table = self.kept = self.last = None
        parts = []
        for a, tab in tables:
            if tab.cols:
                v_col, s_col = (lambda j, t=tab: t.vtab[j]), \
                    (lambda j, t=tab: t.srel[j])
            else:
                v_col, s_col = (lambda j, t=tab: t.vtab[:, j]), \
                    (lambda j, t=tab: t.srel[:, j])
            s1 = tab.s1_hi.to(torch.float64) + tab.s1_lo.to(torch.float64)
            parts.append(compare.table_errors(
                torch.tensor(a, dtype=torch.float64, device=dev),
                tab.n_max, tab.m_max, v_col, s_col, s1))
        errs = compare.merge(parts)
        lim = self.limits
        checks = {name: (errs[name], lim[name])
                  for name in ("v_rel", "srel_abs", "s1_abs")}
        checks["pattern"] = (errs["pattern"], 0)
        failed = sum(1 for p in parts
                     if any(float(p[k]) > lim[k]
                            for k in ("v_rel", "srel_abs", "s1_abs"))
                     or float(p["pattern"]) > 0)
        return checks, self.remakes, failed
