"""The HPYP cells: the two-level hierarchical Pitman-Yor process of
arXiv:1007.0296 over a batch of chains, driven through the port's
``models/hpyp.run_hpyp_timed``.

Set-up makes the counts from the seed (``datagen.crp_generate``), fills
the discount grid at the configuration's start size through
``core/agrid.make_grid`` (K1 on a card), grows it to the level-0 bound
(``hpyp.grow_grid``: K1 again, at the size the run reads) and warms the
loop with one hyper cycle of ``run_hpyp`` on the grown grid, which reaches
both CT sweeps and all four moves.  The window is one call of
``run_hpyp_timed`` with a budget of the window's length: one chunk off its
own clock, then chunks until the budget is spent, the first
``burnin_iters`` iterations discarded from its averages.

``gibbs_updates_per_s`` = chains x level-1 items x iterations / the call's
wall time, the iterations being the call's ``iters_done`` and its
off-clock chunk (``chunk`` rounded up to a multiple of ``hyper_cycle``).

The check (reference/hpyp_ref.py, reference/stirling_ref.py):

* the grown grid's V, Srel and S1 at a seeded sample of its discounts,
  every row and column, against the f64 reference at the configuration's
  discounts (``grid_*``);
* the state after the window (``invalid_chains``, limit 0): every t1 in
  [1, n] where n > 0 and 0 elsewhere, T1 the sum of t1, the counts n0 that
  the last level-0 sweep read equal to the sums of t1, every t0 in [1, n0]
  where n0 > 0 and 0 elsewhere, T0 the sum of t0, the hyperparameters and
  the averages finite and inside the samplers' bounds;
* ``ct1_tv``, ``ct0_tv``: for a seeded sample of chains at the window's
  end state, the worst total-variation distance, over every (group,)
  category, between the CT conditional the port builds (the grid's Srel
  through ``pyp._ct_srel``, ``pyp._ct_conditional``, the level-1 base from
  ``hpyp._predictive``) and the reference's with exact Stirling numbers at
  each chain's own discount.  They compare distributions, not draws;
* the replay (``replay_*``): one more iteration of the timed path, the
  moves included, at every chain from the window's end state, its draws
  recorded as it takes them (``rng``'s draws; each move's first draw
  marked by wrapping ``hyper.sample_b`` / ``sample_a``).  The reference
  replays each stage on a seeded sample of chains with those draws, from
  the port's own input to that stage (its t1 for level 0, its sweeps and
  earlier moves for each move), so that one stage's rare different draw
  does not run on into the next.  ``replay_t1_differ`` and
  ``replay_t0_differ`` are the shares of sampled (group,) categories with
  a count whose new table count differs from the reference's;
  ``replay_move_gap`` the largest, over the four moves, of the median over
  the chains of the relative gap between the port's value and the
  reference's.  Where the grid's interpolation or f32 moves a slice
  decision the two walks part and that chain's gap is large, so the
  median is taken: a move with the wrong target parts most chains.
  ``replay(low)`` reads the same numbers with the reference computed in
  ``low`` (the control) in the port's place;
* ``hyper_frozen``: the chains whose a1, b1, a0 or b0 still equals its
  start value: a move that returns its input leaves it there (limit 0);
* ``kept_short``: how many iterations the window kept fewer than the mix's
  ``min_kept`` (limit 0).
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import datagen, stats
from benchmark.reference import compare, hpyp_ref

# the draws the timed path takes (core/rng), and the moves whose first
# draw the replay marks (samplers/hyper)
_DRAWS = ("gumbel", "uniform", "loggamma", "gamma")
_MOVES = ("sample_b", "sample_a")

SPANS = {
    "hpyp_level1": ("libstb_tpu_torch.models.hpyp", "_level1"),
    "hpyp_level0": ("libstb_tpu_torch.models.hpyp", "_level0"),
    "hpyp_hyper": ("libstb_tpu_torch.models.hpyp", "_hyper"),
    "ct_srel": ("libstb_tpu_torch.models.pyp", "_ct_srel"),
}
STEP = "hpyp_level1"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_HYPER = ("a1", "b1", "a0", "b0")
_STATE = ("t1", "T1", "t0", "T0") + _HYPER


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log):
        from libstb_tpu_torch.core import agrid
        from libstb_tpu_torch.models import hpyp, pyp

        # a program without the timed HPYP run fails here, before set-up
        self._timed = hpyp.run_hpyp_timed
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
        self.grid = hpyp.grow_grid(self.data, start)
        del start
        log(f"grid grown to ({self.grid.n_max}, {self.grid.m_max})")
        print(f"grid {self.grid.g_max} x {self.grid.n_max} x "
              f"{self.grid.m_max}", file=sys.stderr, flush=True)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.chains = traffic["chains"]
        self.start = {k: config[k + "_start"] for k in _HYPER}
        self.cfg = hpyp.HPYPConfig(
            burnin=traffic["burnin_iters"], hyper_cycle=config["hyper_cycle"],
            shape=config["b_shape"], scale=config["b_scale"])
        hpyp.run_hpyp(self.gen, self.data, self.grid, self.chains,
                      *self._starts(),
                      hpyp.HPYPConfig(iters=config["hyper_cycle"],
                                      hyper_cycle=config["hyper_cycle"],
                                      shape=config["b_shape"],
                                      scale=config["b_scale"]))
        log("warm")
        self.out = None

    def _starts(self):
        return tuple(self.start[k] for k in _HYPER)

    def window(self, seconds: float) -> dict:
        hc = self.config["hyper_cycle"]
        t0 = time.perf_counter()
        self.out = self._timed(
            self.gen, self.data, self.grid, self.chains, *self._starts(),
            self.cfg, iter_ms=seconds * 1e3, chunk=self.traffic["chunk"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        off_clock = math.ceil(self.traffic["chunk"] / hc) * hc
        iterations = self.out["iters_done"] + off_clock
        items = int(self.counts.N.sum())
        print(f"window ran {self.out['iters_done']} iterations, kept "
              f"{self._kept()}", file=sys.stderr, flush=True)
        return {"gibbs_updates_per_s": stats.rate(
            self.chains * items * iterations, wall)}

    def _kept(self) -> int:
        return int(self.out["iters_done"] - self.out["burnin_done"])

    def _invalid_chains(self, c: dict) -> int:
        o, dev = self.out, self.device
        n = torch.as_tensor(self.counts.n, device=dev).to(torch.int64)
        t1, T1 = o["t1"].to(torch.int64), o["T1"].to(torch.int64)
        t0, T0 = o["t0"].to(torch.int64), o["T0"].to(torch.int64)
        n0 = t1.sum(1)

        def outside(t, cnt):
            return (((cnt > 0) & ((t < 1) | (t > cnt)))
                    | ((cnt == 0) & (t != 0))).flatten(1).any(1)

        bad = outside(t1, n[None]) | (T1 != t1.sum(-1)).any(1)
        bad |= (o["n0"].to(torch.int64) != n0).any(1)
        bad |= outside(t0, n0) | (T0 != t0.sum(-1))
        for key, lo, hi in (("a1", c["a_lo"], c["a_hi"]),
                            ("a0", c["a_lo"], c["a_hi"]),
                            ("b1", c["b_lo"], c["b_hi"]),
                            ("b0", c["b_lo"], c["b_hi"])):
            for x in (o[key], o[key + "ave"]):
                x = x.to(torch.float64)
                bad |= ~torch.isfinite(x) | (x < lo) | (x > hi)
        occ = (n > 0).sum(-1)
        T1ave = o["T1ave"].to(torch.float64)
        bad |= (~torch.isfinite(T1ave) | (T1ave < occ)
                | (T1ave > n.sum(-1))).any(1)
        T0ave = o["T0ave"].to(torch.float64)
        bad |= ~torch.isfinite(T0ave) | (T0ave < 1) | (T0ave > n.sum())
        return int(bad.sum())

    def _sample(self, count: int, stream: int) -> torch.Tensor:
        rs = np.random.default_rng([self.seed, stream])
        return torch.as_tensor(np.sort(rs.choice(
            self.chains, min(count, self.chains), replace=False)),
            device=self.device)

    def _port_iteration(self):
        """(state before, state after, draws, marks): one iteration of the
        timed path from the window's end state, the moves included, its
        draws and the index of each move's first draw recorded."""
        from libstb_tpu_torch.core import rng
        from libstb_tpu_torch.models import hpyp
        from libstb_tpu_torch.samplers import hyper

        before = {k: self.out[k] for k in _STATE}
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
            grid, plan = hpyp._prepare(self.data, self.grid)
            # iteration 0 of a chunk runs the moves; burn-in 1 sums nothing
            after = hpyp._run_chunk(self.gen, self.data, grid, plan,
                                    self.cfg, before, [], 0, 1, 1)
        finally:
            for mod, k, real in saved:
                setattr(mod, k, real)
        return before, after, draws, marks

    def _reference_stages(self, S, P, draws, marks, sel, low):
        """The reference's t1, t0, b1, a1, b0, a0 at the chains ``sel``,
        each stage from the port's input to it (``S`` before, ``P`` after
        the port's iteration), computed in ``low``; NaN for a chain whose
        move needed more draws than the port took."""
        dev, k = self.device, sel.shape[0]
        C, J, D = self.out["t1"].shape
        n = torch.as_tensor(self.counts.n, device=dev)
        H = torch.as_tensor(self.counts.H, device=dev)
        S = {key: v[sel] for key, v in S.items()}
        P = {key: P[key][sel] for key in _STATE}
        c = self.config
        out = {}
        g1 = draws[0].view(D, C, J, -1)[:, sel].reshape(D, k * J, -1)
        p0 = hpyp_ref.predictive(S["t1"].sum(1), S["t0"], S["T0"], S["a0"],
                                 S["b0"], H)
        out["t1"], _ = hpyp_ref.ct_sweep(S["t1"], S["T1"], S["a1"], S["b1"],
                                         n[None], p0, g1, low=low)
        n0 = P["t1"].sum(1)
        g0 = draws[1].view(D, C, -1)[:, sel]
        t0, _ = hpyp_ref.ct_sweep(S["t0"][:, None], S["T0"][:, None],
                                  S["a0"], S["b0"], n0[:, None],
                                  H[None].expand(k, -1), g0, block=k,
                                  low=low)
        out["t0"] = t0[:, 0]
        T1, T0 = P["T1"].to(torch.float64), P["T0"].to(torch.float64)
        moves = {
            "b1": lambda d: hpyp_ref.sample_b(
                d, S["b1"], n.sum(-1)[None].expand(k, -1), T1, S["a1"],
                c["b_shape"], c["b_scale"], low),
            "a1": lambda d: hpyp_ref.sample_a(
                d, S["a1"], n.reshape(1, -1), P["t1"].reshape(k, -1), T1,
                P["b1"][:, None], low),
            "b0": lambda d: hpyp_ref.sample_b(
                d, S["b0"], n0.sum(-1, keepdim=True), T0[:, None], S["a0"],
                c["b_shape"], c["b_scale"], low),
            "a0": lambda d: hpyp_ref.sample_a(
                d, S["a0"], n0, P["t0"], T0[:, None], P["b0"][:, None], low),
        }
        ends = marks[1:] + [len(draws)]
        for i, (key, move) in enumerate(moves.items()):
            nan = torch.full((k,), torch.nan, dtype=torch.float64,
                             device=dev)
            if len(marks) != len(moves):
                out[key] = nan
                continue
            try:
                out[key] = move(iter([x[sel] for x in
                                      draws[marks[i]:ends[i]]]))
            except StopIteration:             # the port's move drew nothing
                out[key] = nan
        return out, P, n0

    def replay(self, low=None):
        """(replay_t1_differ, replay_t0_differ, replay_move_gap): the port's
        next iteration against the reference's replay of it; with ``low``
        the reference computed in ``low`` stands in the port's place."""
        t0_clock = time.perf_counter()
        S, P, draws, marks = self._port_iteration()
        sel = self._sample(self.traffic["replay_chains"], 3)
        ref, port, n0 = self._reference_stages(S, P, draws, marks, sel,
                                               torch.float64)
        prog = port if low is None else self._reference_stages(
            S, P, draws, marks, sel, low)[0]
        del draws
        n = torch.as_tensor(self.counts.n, device=self.device)

        def differ(key, cnt):
            live = (cnt > 0).expand(prog[key].shape)
            diff = prog[key].to(torch.int64) != ref[key].to(torch.int64)
            return float((diff & live).sum()) / max(1, int(live.sum()))

        gaps, parted = {}, {}
        for key in ("b1", "a1", "b0", "a0"):
            r = ref[key].to(torch.float64)
            gap = torch.nan_to_num(
                (prog[key].to(torch.float64) - r).abs() / r.abs(),
                nan=torch.inf)
            g, k = gap.sort().values, gap.numel()   # halfway at an even k
            gaps[key] = float((g[(k - 1) // 2] + g[k // 2]) / 2)
            parted[key] = float((gap > 1e-4).to(torch.float64).mean())
        print(f"replay at {sel.shape[0]} chains in "
              f"{time.perf_counter() - t0_clock:.2f} s: median gaps {gaps}, "
              f"chains parted {parted}", file=sys.stderr, flush=True)
        return (differ("t1", n[None]), differ("t0", n0),
                max(gaps.values()))

    def _grid_errors(self) -> dict:
        """The grown grid against the f64 reference at a seeded sample of
        its discounts, worked out from the configuration."""
        g, grid = self.config["grid"], self.grid
        avec = np.linspace(g["a_lo"], g["a_hi"], g["g"])
        rs = np.random.default_rng([self.seed, 1])
        pick = np.sort(rs.choice(g["g"], self.traffic["check_discounts"],
                                 replace=False))
        idx = torch.as_tensor(pick, device=self.device)
        a = torch.as_tensor(avec[pick], dtype=torch.float64,
                            device=self.device)
        s1 = (grid.s1_hi[idx].to(torch.float64)
              + grid.s1_lo[idx].to(torch.float64))
        return compare.merge([compare.table_errors(
            a, grid.n_max, grid.m_max, lambda j: grid.vtab[idx, :, j],
            lambda j: grid.srel[idx, :, j], s1)])

    def _ct_tv(self):
        """(ct1_tv, ct0_tv) at the end state of a seeded sample of chains."""
        from libstb_tpu_torch.models import hpyp, pyp

        o, grid, dev = self.out, self.grid, self.device
        dt = grid.srel.dtype
        sel = self._sample(self.traffic["check_chains"], 2)
        t1, T1, t0, T0 = (o[k][sel] for k in ("t1", "T1", "t0", "T0"))
        a1, b1, a0, b0 = (o[k][sel] for k in _HYPER)
        C, J, D = t1.shape
        n = torch.as_tensor(self.counts.n, device=dev)
        H = torch.as_tensor(self.counts.H, device=dev)
        n0 = t1.sum(1, dtype=torch.int32)
        tmax = int(self.counts.n.max()) + 1
        tmax0 = int(self.counts.n.sum(axis=0).max()) + 1

        # the port: the grid's Srel block and its conditional, in its dtype
        p0 = hpyp._predictive(n0, t0, T0, a0, b0, H.to(dt))
        srel1 = pyp._ct_srel(grid, n[None], tmax, a1,
                             pyp.ct_srel_pos(self.counts.n, tmax, dev))
        srel0 = pyp._ct_srel(grid, n0[:, None, :], tmax0, a0)
        # the reference: exact Stirling numbers, f64
        q0 = hpyp_ref.predictive(n0, t0, T0, a0, b0, H)
        ref1 = hpyp_ref.srel_exact(a1, n.reshape(1, -1),
                                   tmax).reshape(C, J, D, tmax)
        ref0 = hpyp_ref.srel_exact(a0, n0, tmax0)
        tv1 = tv0 = 0.0

        def rows(x):
            return x[:, None].expand(C, J).reshape(-1)

        for i in range(D):
            ni = n[:, i].expand(C, J).reshape(-1)
            ti, Tj = t1[:, :, i].reshape(-1), T1.reshape(-1)
            lw = pyp._ct_conditional(
                srel1[:, :, i].reshape(-1, tmax), ni, ti, Tj, rows(a1),
                rows(b1), rows(p0[:, i]), tmax, None, ti_off=ti)
            lr = hpyp_ref.ct_log_weights(
                ref1[:, :, i].reshape(-1, tmax), ni, ti, Tj, rows(a1),
                rows(b1), rows(q0[:, i]))
            tv = hpyp_ref.total_variation(
                hpyp_ref.ct_probs(lw.to(torch.float64)),
                hpyp_ref.ct_probs(lr))
            tv1 = max([tv1] + tv[ni > 0].tolist())
            lw = pyp._ct_conditional(
                srel0[:, 0, i], n0[:, i], t0[:, i], T0, a0, b0,
                H[i].to(dt).expand(C), tmax0, None, ti_off=t0[:, i])
            lr = hpyp_ref.ct_log_weights(ref0[:, i], n0[:, i], t0[:, i], T0,
                                         a0, b0, H[i].expand(C))
            tv = hpyp_ref.total_variation(
                hpyp_ref.ct_probs(lw.to(torch.float64)),
                hpyp_ref.ct_probs(lr))
            tv0 = max([tv0] + tv[n0[:, i] > 0].tolist())
        return tv1, tv0

    def check(self):
        o, c = self.out, self.config
        invalid = self._invalid_chains(c)
        errs = self._grid_errors()
        ct1_tv, ct0_tv = self._ct_tv()
        t1_differ, t0_differ, move_gap = self.replay()
        frozen = torch.zeros(self.chains, dtype=torch.bool,
                             device=self.device)
        for k in _HYPER:
            frozen |= o[k] == torch.as_tensor(self.start[k], dtype=o[k].dtype,
                                              device=self.device)
        kept_short = max(0, self.traffic["min_kept"] - self._kept())
        ends = {k: [round(float(v), 4) for v in torch.quantile(
            o[k].to(torch.float64), torch.tensor(
                [0.0, 0.5, 1.0], dtype=torch.float64, device=self.device))]
            for k in _HYPER}
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
            "ct1_tv": (ct1_tv, lim["ct1_tv"]),
            "ct0_tv": (ct0_tv, lim["ct0_tv"]),
            "replay_t1_differ": (t1_differ, lim["replay_t1_differ"]),
            "replay_t0_differ": (t0_differ, lim["replay_t0_differ"]),
            "replay_move_gap": (move_gap, lim["replay_move_gap"]),
            "hyper_frozen": (int(frozen.sum()), 0),
            "kept_short": (kept_short, 0),
        }
        return checks, self.chains, invalid
