"""The check.c cells: upstream libstb's test/check.c run as ``-S CTW``, the
windowed collapsed-table sampler (TWINDOW, check.c:905-943), over a batch
of chains on the discount grid, driven through the port's
``models/driver.run_gibbs_timed`` with ``ctw_rel=True``: each sweep is
``models/pyp.ctw_sweep_rel`` (2w + 1 candidates a count, the window
shifted into [1, n], Srel by grid point queries at each chain's a), then
the slice moves of b and a as the TI path runs them.

Set-up makes the counts from the seed (``datagen.crp_generate``), fills
the discount grid through ``core/agrid.make_grid`` (K1 on a card), grows
it where the seed's largest count needs it (``agrid.ensure_grid``) and
warms the loop with ``acycle`` iterations of ``run_gibbs``, which reach
the sweep and both moves.  The window is one call of ``run_gibbs_timed``
with a budget of the window's length: one chunk off its own clock, then
chunks until the budget is spent, the first ``burnin_iters`` iterations
discarded from its averages.  A program without the route fails at once,
before set-up.

``gibbs_updates_per_s`` = chains x items x iterations / the call's wall
time, the iterations being the call's ``iters_done`` and its off-clock
chunk (``chunk`` rounded up to a multiple of lcm(bcycle, acycle)).

The traced window's view keeps the trace's raw events, as
``benchmark/program_spans.py``'s does, and the sweep's shape, so that the
readers can tell the device operations that a sweep launched from the
moves' by their launches' correlation ids (``ctw_roofline``).

The check (reference/ctw_ref.py, reference/hpyp_ref.py,
reference/stirling_ref.py):

* the grown grid's V, Srel and S1 at a seeded sample of its discounts,
  every row and column, against the f64 reference (``grid_*``);
* the state after the window (``invalid_chains``, limit 0): every t in
  [1, n] where n > 0 and 0 elsewhere, T the sum of t, a, b and their
  averages finite and inside the samplers' bounds, the averages of T
  inside [occupied categories, N];
* ``ctw_tv``: for a seeded sample of chains at the window's end state,
  the worst total variation, over every (group, category) with n > 0,
  between the windowed conditional the port builds (``pyp._ctw_window``,
  ``_ctw_srel`` off the grid, ``_ctw_weights``) and the reference's with
  exact Stirling numbers at each chain's own discount, both laid on t =
  1..max n, so that windows that differ compare;
* the replay (``replay_*``): one more iteration of the timed path at
  every chain from the window's end state, the sweep and both moves, its
  draws recorded as it takes them.  The reference replays each stage on
  a seeded sample of chains with those draws from the port's own input
  to it: ``replay_t_differ`` is the share of sampled counts with n > 0
  whose new t differs from the reference's; ``replay_move_gap`` the
  larger, over the two moves, of the median over the chains of the
  relative gap between the port's value and the reference's.
  ``replay(low)`` reads the same numbers with the reference computed in
  ``low`` in the port's place (the control);
* ``hyper_frozen``: the chains whose a or b still equals its start value
  (limit 0): a move that returns its input leaves it there;
* ``kept_short``: how many iterations the window kept fewer than the
  mix's ``min_kept`` (limit 0).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import sys
import time

import numpy as np
import torch

from benchmark import datagen, stats, tracing
from benchmark.reference import compare, ctw_ref, hpyp_ref

# the draws the timed path takes (core/rng), and the moves whose first
# draw the replay marks (samplers/hyper)
_DRAWS = ("gumbel", "uniform", "loggamma", "gamma")
_MOVES = ("sample_b", "sample_a")

SPANS = {
    "ctw_sweep": ("libstb_tpu_torch.models.pyp", "ctw_sweep_rel"),
    "sample_b": ("libstb_tpu_torch.samplers.hyper", "sample_b"),
    "sample_a": ("libstb_tpu_torch.samplers.hyper", "sample_a"),
}
STEP = "ctw_sweep"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
F64 = torch.float64


def _keep_raw_events(shape: dict):
    """Swap ``tracing.TraceView`` for a subclass whose views keep the
    window's raw events (``events``) and ``shape`` (``ctw_shape``);
    returns the class it replaced.  The subclass extends whatever class
    is in place, so ``program_spans``' own keeps working."""
    from benchmark import program_spans

    base = tracing.TraceView

    class View(base):
        def __init__(self, events, params=None):
            super().__init__(events, params)
            if not hasattr(self, "events"):
                self.events = program_spans.window_events(events, self.t0,
                                                          self.t1)
            self.ctw_shape = dict(shape)

    tracing.TraceView = View
    return base


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log):
        from libstb_tpu_torch.core import agrid
        from libstb_tpu_torch.models import driver, pyp

        if "ctw_rel" not in inspect.signature(
                driver.run_gibbs_timed).parameters:
            raise RuntimeError("the program's run_gibbs_timed has no CTW "
                               "route over relative candidates (ctw_rel)")
        self.config, self.traffic, self.device = config, traffic, device
        self.seed = seed
        self.limits = {**config.get("limits", {}),
                       **traffic.get("limits", {})}
        d = datagen.crp_generate(seed, config["groups"], config["dim"],
                                 config["items_per_group"], config["gen_a"],
                                 config["gen_b"])
        self.counts = d
        self.data = pyp.PYPData(d.cat, d.grp, d.first, d.n, d.N, d.H)
        log("data")
        g = config["grid"]
        start = agrid.make_grid(
            g["n"], g["m"], g=g["g"], a_lo=g["a_lo"], a_hi=g["a_hi"],
            dtype=_DTYPES[config["dtype"]], device=device,
            max_n=g["max_n"], max_m=g["max_m"])
        self.grid = agrid.ensure_grid(start, *agrid.required_dims(d.n))
        del start
        log(f"grid ({self.grid.n_max}, {self.grid.m_max})")
        print(f"grid {self.grid.g_max} x {self.grid.n_max} x "
              f"{self.grid.m_max}, largest count {int(d.n.max())}",
              file=sys.stderr, flush=True)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.chains = traffic["chains"]
        self.window_w = config["window"]
        self.cfg = driver.GibbsConfig(
            iters=config["acycle"], burnin=traffic["burnin_iters"],
            bcycle=config["bcycle"], acycle=config["acycle"],
            sampler=config["sampler"], window=self.window_w,
            shape=config["b_shape"], scale=config["b_scale"],
            b_groups=config["b_groups"], kernel=config["kernel"])
        driver.run_gibbs(self.gen, self.data, self.grid, self.chains,
                         config["a0"], config["b0"], self.cfg, ctw_rel=True)
        log("warm")
        self.out = None
        self._view_class = None

    def window(self, seconds: float) -> dict:
        from libstb_tpu_torch.models import driver

        c = self.config
        J, D = self.counts.n.shape
        self._view_class = _keep_raw_events(dict(
            chains=self.chains, groups=J, dim=D,
            occupied=int((self.counts.n > 0).sum()),
            candidates=2 * self.window_w + 1))
        t0 = time.perf_counter()
        self.out = driver.run_gibbs_timed(
            self.gen, self.data, self.grid, self.chains, c["a0"], c["b0"],
            self.cfg, iter_ms=seconds * 1e3, chunk=self.traffic["chunk"],
            ctw_rel=True)
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
            x = o[key].to(F64)
            bad |= ~torch.isfinite(x) | (x < lo) | (x > hi)
        Tave = o["Tave"].to(F64)
        bad |= (~torch.isfinite(Tave) | (Tave < occ.sum(-1))
                | (Tave > n.sum(-1))).any(1)
        return int(bad.sum())

    def _sample(self, count: int, stream: int) -> torch.Tensor:
        rs = np.random.default_rng([self.seed, stream])
        return torch.as_tensor(np.sort(rs.choice(
            self.chains, min(count, self.chains), replace=False)),
            device=self.device)

    def _grid_errors(self) -> dict:
        """The grown grid against the f64 reference at a seeded sample of
        its discounts, worked out from the configuration."""
        g, grid = self.config["grid"], self.grid
        avec = np.linspace(g["a_lo"], g["a_hi"], g["g"])
        rs = np.random.default_rng([self.seed, 1])
        pick = np.sort(rs.choice(g["g"], self.traffic["check_discounts"],
                                 replace=False))
        idx = torch.as_tensor(pick, device=self.device)
        a = torch.as_tensor(avec[pick], dtype=F64, device=self.device)
        s1 = grid.s1_hi[idx].to(F64) + grid.s1_lo[idx].to(F64)
        return compare.merge([compare.table_errors(
            a, grid.n_max, grid.m_max, lambda j: grid.vtab[idx, :, j],
            lambda j: grid.srel[idx, :, j], s1)])

    def _ctw_tv(self) -> float:
        """The worst total variation between the port's windowed
        conditional and the reference's, at the end state of a seeded
        sample of chains."""
        from libstb_tpu_torch.models import pyp

        o, grid, dev, w = self.out, self.grid, self.device, self.window_w
        dt = grid.srel.dtype
        sel = self._sample(self.traffic["check_chains"], 2)
        t, T, a, b = (o[k][sel] for k in ("t", "T", "a", "b"))
        C, J, D = t.shape
        n = torch.as_tensor(self.counts.n, device=dev)
        H = torch.as_tensor(self.counts.H, device=dev)
        tmax = max(1, int(self.counts.n.max()))
        rows = ctw_ref.srel_rows(a.to(F64), n)
        a_f = a[:, None].expand(C, J).reshape(-1)
        b_f = b[:, None].expand(C, J).reshape(-1)
        worst = 0.0
        for i in range(D):
            ni = n[None, :, i].expand(C, J).reshape(-1)
            ti, Tj = t[:, :, i].reshape(-1), T.reshape(-1)
            # the port: its window, the grid's Srel, its weights, its dtype
            tts = pyp._ctw_window(ti, ni, w)
            hlog = torch.log(torch.clamp(H[i].to(dt), min=1e-30))
            lw = pyp._ctw_weights(pyp._ctw_srel(grid, ni, tts, a_f), ni, ti,
                                  Tj, a_f, b_f, hlog, tts)
            # the reference: exact Stirling numbers, f64
            rt = ctw_ref.window(ti, ni, w)
            lr = ctw_ref.log_weights(
                ctw_ref.srel_at(rows[:, :, i].reshape(C * J, -1), ni, rt),
                ni, ti, Tj, a_f, b_f, H[i].expand(C * J), rt)
            tv = hpyp_ref.total_variation(ctw_ref.probs_on(lw, tts, tmax),
                                          ctw_ref.probs_on(lr, rt, tmax))
            worst = max([worst] + tv[ni > 0].tolist())
        return worst

    def _port_iteration(self):
        """(state before, state after, draws, marks): one iteration of the
        timed path from the window's end state, the moves included, its
        draws and the index of each move's first draw recorded."""
        from libstb_tpu_torch.core import rng
        from libstb_tpu_torch.models import driver
        from libstb_tpu_torch.samplers import hyper

        before = {k: self.out[k] for k in ("t", "T", "a", "b")}
        draws, marks = [], []

        def record(real):
            def draw(*args, **kw):
                x = real(*args, **kw)
                draws.append(x)
                return x
            return draw

        def mark(real):
            def move(*args, **kw):
                marks.append(len(draws))
                return real(*args, **kw)
            return move

        saved = [(rng, k, getattr(rng, k)) for k in _DRAWS] + \
            [(hyper, k, getattr(hyper, k)) for k in _MOVES]
        for mod, k, real in saved:
            setattr(mod, k, (record if mod is rng else mark)(real))
        try:
            cfg = dataclasses.replace(self.cfg, iters=1)
            grid, plan = driver._prepare(self.data, self.grid, cfg,
                                         ctw_rel=True)
            # iteration 0 of a chunk runs both moves; burn-in 1 sums nothing
            after = driver._run_chunk(self.gen, self.data, grid,
                                      dict(before, hist=None), cfg, plan, 1)
        finally:
            for mod, k, real in saved:
                setattr(mod, k, real)
        return before, after, draws, marks

    def _reference_stages(self, S, P, draws, marks, sel, low):
        """The reference's t, b, a at the chains ``sel``, each stage from
        the port's input to it (``S`` before, ``P`` after the port's
        iteration), computed in ``low``; NaN for a chain whose move needed
        more draws than the port took."""
        dev, k = self.device, sel.shape[0]
        C, J, D = self.out["t"].shape
        c, w = self.config, self.window_w
        n = torch.as_tensor(self.counts.n, device=dev)
        H = torch.as_tensor(self.counts.H, device=dev)
        S = {key: v[sel] for key, v in S.items()}
        P = {key: P[key][sel] for key in ("t", "T", "a", "b")}
        g = draws[0].view(D, C, J, -1)[:, sel].reshape(D, k * J, -1)
        out = {}
        out["t"], _ = ctw_ref.sweep(S["t"], S["T"], S["a"].to(F64),
                                    S["b"].to(F64), n, H, g, w, low=low)
        T = P["T"].to(F64)
        N = torch.as_tensor(self.counts.N[:c["b_groups"]], dtype=F64,
                            device=dev)
        moves = {
            "b": lambda d: hpyp_ref.sample_b(
                d, S["b"], N[None].expand(k, -1), T[:, :c["b_groups"]],
                S["a"], c["b_shape"], c["b_scale"], low),
            "a": lambda d: hpyp_ref.sample_a(
                d, S["a"], n.reshape(1, -1), P["t"].reshape(k, -1), T,
                P["b"][:, None], low),
        }
        ends = marks[1:] + [len(draws)]
        for i, (key, move) in enumerate(moves.items()):
            nan = torch.full((k,), torch.nan, dtype=F64, device=dev)
            if len(marks) != len(moves):
                out[key] = nan
                continue
            try:
                out[key] = move(iter([x[sel] for x in
                                      draws[marks[i]:ends[i]]]))
            except StopIteration:             # the port's move drew nothing
                out[key] = nan
        return out, P

    def replay(self, low=None):
        """(replay_t_differ, replay_move_gap): the port's next iteration
        against the reference's replay of it; with ``low`` the reference
        computed in ``low`` stands in the port's place."""
        t0_clock = time.perf_counter()
        S, P, draws, marks = self._port_iteration()
        sel = self._sample(self.traffic["replay_chains"], 3)
        ref, port = self._reference_stages(S, P, draws, marks, sel, F64)
        prog = port if low is None else self._reference_stages(
            S, P, draws, marks, sel, low)[0]
        del draws
        n = torch.as_tensor(self.counts.n, device=self.device)
        live = (n[None] > 0).expand(prog["t"].shape)
        diff = prog["t"].to(torch.int64) != ref["t"].to(torch.int64)
        t_differ = float((diff & live).sum()) / max(1, int(live.sum()))
        gaps, parted = {}, {}
        for key in ("b", "a"):
            r = ref[key].to(F64)
            gap = torch.nan_to_num((prog[key].to(F64) - r).abs() / r.abs(),
                                   nan=torch.inf)
            srt, m = gap.sort().values, gap.numel()  # halfway at an even m
            gaps[key] = float((srt[(m - 1) // 2] + srt[m // 2]) / 2)
            parted[key] = float((gap > 1e-4).to(F64).mean())
        print(f"replay at {sel.shape[0]} chains in "
              f"{time.perf_counter() - t0_clock:.2f} s: counts differ "
              f"{t_differ}, median gaps {gaps}, chains parted {parted}",
              file=sys.stderr, flush=True)
        return t_differ, max(gaps.values())

    def check(self):
        if self._view_class is not None:
            tracing.TraceView = self._view_class
        o, c = self.out, self.config
        invalid = self._invalid_chains(c)
        errs = self._grid_errors()
        ctw_tv = self._ctw_tv()
        t_differ, move_gap = self.replay()
        frozen = torch.zeros(self.chains, dtype=torch.bool,
                             device=self.device)
        for k, start in (("a", c["a0"]), ("b", c["b0"])):
            frozen |= o[k] == torch.as_tensor(start, dtype=o[k].dtype,
                                              device=self.device)
        kept_short = max(0, self.traffic["min_kept"] - self._kept())
        ends = {k: [round(float(v), 4) for v in torch.quantile(
            o[k].to(F64), torch.tensor([0.0, 0.5, 1.0], dtype=F64,
                                       device=self.device))]
            for k in ("a", "b")}
        print(f"end state min / median / max: {ends}", file=sys.stderr,
              flush=True)
        self.out = self.grid = None
        lim = self.limits
        checks = {
            "grid_v_rel": (errs["v_rel"], lim["grid_v_rel"]),
            "grid_srel_abs": (errs["srel_abs"], lim["grid_srel_abs"]),
            "grid_s1_abs": (errs["s1_abs"], lim["grid_s1_abs"]),
            "grid_pattern": (errs["pattern"], 0),
            "invalid_chains": (invalid, 0),
            "ctw_tv": (ctw_tv, lim["ctw_tv"]),
            "replay_t_differ": (t_differ, lim["replay_t_differ"]),
            "replay_move_gap": (move_gap, lim["replay_move_gap"]),
            "hyper_frozen": (int(frozen.sum()), 0),
            "kept_short": (kept_short, 0),
        }
        return checks, self.chains, invalid
