"""Port parity for the whole slice: libstb_tpu_torch's run_gibbs against
libstb_tpu's on the CPU in f64, with tools/oracle_compare.py's settings.

The two runs use different random streams, so they are compared the way
the acceptance gate compares against the reference binary: per-chain
posterior means as replicates, |difference| within 2 combined Monte-Carlo
SE plus floors of 0.05 (E[T_j]), 0.01 (E[a]) and 0.05 (E[b])
(oracle_compare.py:79-89)."""
import contextlib
import dataclasses
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import agrid as jag
from libstb_tpu.models import driver as jdriver
from libstb_tpu.models import pyp as jpyp
from libstb_tpu_torch import convert, entry
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.models import driver as tdriver
from libstb_tpu_torch.models import pyp as tpyp
from libstb_tpu_torch.samplers import hyper as thyper
from test_torch_samplers import _sample_b_draws, _slice_draws
from test_torch_sweeps import _cat_gumbels

torch.set_num_threads(1)

ORACLE = dict(iters=400, bcycle=2, acycle=5, sampler="TI", ti_legacy=True,
              ti_skip_first=False, scale=20.0)


def _within_bands(ref, ours, floor):
    se = [x.std(0, ddof=1) / np.sqrt(len(x)) for x in (ref, ours)]
    band = 2 * np.sqrt(se[0] ** 2 + se[1] ** 2) + floor
    diff = np.abs(ref.mean(0) - ours.mean(0))
    assert np.all(diff <= band), (ref.mean(0), ours.mean(0), band)


def test_run_gibbs_matches_jax_moments():
    data = tpyp.crp_generate(7, 2, 20, 40, 0.5, 1.0)
    n_max = max(int(data.N.max()) + 2, 16)
    jout = jdriver.run_gibbs(
        jax.random.key(8), data,
        jag.make_grid(n_max, n_max, g=96, dtype=jnp.float64), 64, 0.5, 1.0,
        jdriver.GibbsConfig(**ORACLE))
    tout = tdriver.run_gibbs(
        rng.generator(8, "cpu"), data,
        tag.make_grid(n_max, n_max, g=96, dtype=torch.float64, device="cpu"),
        64, 0.5, 1.0, tdriver.GibbsConfig(**ORACLE))
    for k in ("tave", "Tave", "aave", "bave", "t", "T", "a", "b"):
        assert tuple(tout[k].shape) == tuple(np.shape(jout[k])), k
        assert tout[k].dtype in (torch.float64, torch.int32), k
    _within_bands(np.asarray(jout["Tave"]), tout["Tave"].numpy(), 0.05)
    _within_bands(np.asarray(jout["aave"]), tout["aave"].numpy(), 0.01)
    _within_bands(np.asarray(jout["bave"]), tout["bave"].numpy(), 0.05)
    T = tout["T"].numpy()
    assert ((T >= (data.n > 0).sum(1)) & (T <= data.N)).all()
    np.testing.assert_array_equal(tout["t"].numpy().sum(-1), T)


def test_run_gibbs_ars_matches_jax_moments():
    """kernel="ars" for both (a, b) moves, 200 iterations of 64 chains:
    the port's moments inside the gate's bands of the JAX driver's run
    with the same kernel, and of the port's own slice run (two transition
    kernels, one posterior)."""
    cfg = dict(ORACLE, iters=200, kernel="ars")
    data = tpyp.crp_generate(7, 2, 20, 40, 0.5, 1.0)
    n_max = max(int(data.N.max()) + 2, 16)
    jout = jdriver.run_gibbs(
        jax.random.key(8), data,
        jag.make_grid(n_max, n_max, g=96, dtype=jnp.float64), 64, 0.5, 1.0,
        jdriver.GibbsConfig(**cfg))
    grid = tag.make_grid(n_max, n_max, g=96, dtype=torch.float64,
                         device="cpu")
    tout = tdriver.run_gibbs(rng.generator(8, "cpu"), data, grid, 64, 0.5,
                             1.0, tdriver.GibbsConfig(**cfg))
    sout = tdriver.run_gibbs(rng.generator(9, "cpu"), data, grid, 64, 0.5,
                             1.0, tdriver.GibbsConfig(**dict(cfg,
                                                             kernel="slice")))
    for k, floor in (("Tave", 0.05), ("aave", 0.01), ("bave", 0.05)):
        _within_bands(np.asarray(jout[k]), tout[k].numpy(), floor)
        _within_bands(sout[k].numpy(), tout[k].numpy(), floor)
    T = tout["T"].numpy()
    assert ((T >= (data.n > 0).sum(1)) & (T <= data.N)).all()
    a, b = tout["a"].numpy(), tout["b"].numpy()
    assert ((a >= 0.01) & (a <= 0.98)).all() and ((b >= 0.01)
                                                  & (b <= 2000)).all()


def test_item_order_sweep_and_fixed_hypers():
    """ti_blocked=False sweeps items in order; no (a, b) cycles keeps the
    starts; burn-in and averaging as in the JAX driver."""
    data = tpyp.crp_generate(2, 2, 8, 20, 0.5, 2.0)
    grid = tag.make_grid(24, 24, g=16, dtype=torch.float64, device="cpu")
    out = tdriver.run_gibbs(rng.generator(0, "cpu"), data, grid, 6, 0.3, 4.0,
                            tdriver.GibbsConfig(iters=12, burnin=4,
                                                ti_blocked=False))
    assert torch.all(out["aave"] == 0.3) and torch.all(out["bave"] == 4.0)
    assert torch.all(out["Tave"] >= torch.tensor((data.n > 0).sum(1)))


def test_grid_grows_to_cover_data():
    data = tpyp.crp_generate(1, 1, 5, 60, 0.2, 3.0)
    grid = tag.make_grid(16, 8, g=16, dtype=torch.float64, device="cpu")
    out = tdriver.run_gibbs(rng.generator(1, "cpu"), data, grid, 4, 0.5, 3.0,
                            tdriver.GibbsConfig(iters=4, bcycle=1, acycle=1))
    assert torch.isfinite(out["aave"]).all() and torch.isfinite(
        out["bave"]).all()


def test_gibbs_config_is_a_copy():
    jf = {f.name: f.default for f in dataclasses.fields(jdriver.GibbsConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tdriver.GibbsConfig)}
    assert tf == jf
    for burnin in (0, 7):
        assert (tdriver.GibbsConfig(iters=30, burnin=burnin)
                .resolved_burnin() == jdriver.GibbsConfig(
                    iters=30, burnin=burnin).resolved_burnin())


# -- collect_traces ----------------------------------------------------------

class _JaxKeys:
    """The keys a JAX run hands its sweeps and (a, b) moves, in call order
    for each kind ("sweep", "b", "a"); the port's functions are wrapped so
    that each call replays the draws its JAX counterpart made from its
    key (tests/test_torch_sweeps.py, test_torch_samplers.py)."""

    def __init__(self, **keys):
        self._q = {k: iter(v) for k, v in keys.items()}

    def next(self, kind):
        return next(self._q[kind])

    def patch(self, monkeypatch):
        ct, sb, sa = tpyp.ct_sweep, thyper.sample_b, thyper.sample_a

        def ct_sweep(gen, t, T, a, b, tab, data, tmax, **kw):
            shape = (t.shape[0] * t.shape[1], tmax)
            g = _cat_gumbels(self.next("sweep"), data.n.shape[1], shape)
            return ct(rng.Replay([g]), t, T, a, b, tab, data, tmax, **kw)

        def sample_b(gen, b0, N, T, a, shape, scale, **kw):
            NC = np.broadcast_to(np.asarray(N), tuple(T.shape))
            draws = _sample_b_draws(self.next("b"), b0.numpy(), NC,
                                    T.numpy(), shape)
            return sb(rng.Replay(draws), b0, N, T, a, shape, scale, **kw)

        def sample_a(gen, a0, *args, **kw):
            draws = _slice_draws(self.next("a"), tuple(a0.shape))
            return sa(rng.Replay(draws), a0, *args, **kw)

        monkeypatch.setattr(tpyp, "ct_sweep", ct_sweep)
        monkeypatch.setattr(thyper, "sample_b", sample_b)
        monkeypatch.setattr(thyper, "sample_a", sample_a)


def _gibbs_keys(key, cfg):
    """run_gibbs's keys: split(key, 4) an iteration into (carry, sweep, b,
    a); the b and a keys are used on their cycles only."""
    keys = dict(sweep=[], b=[], a=[])
    for it in range(cfg.iters):
        key, ks, kb, ka = jax.random.split(key, 4)
        keys["sweep"].append(ks)
        if it % cfg.bcycle == 0:
            keys["b"].append(kb)
        if it % cfg.acycle == 0:
            keys["a"].append(ka)
    return _JaxKeys(**keys)


TRACED = dict(iters=24, burnin=6, bcycle=2, acycle=3, sampler="CT",
              scale=20.0, collect_traces=True)


def test_collect_traces_equal_under_jax_draws(monkeypatch):
    """CT with (a, b) moves under the JAX run's own draws: t and T exactly
    equal, the (iters, C) traces of a and b equal to f64 rounding (1e-10),
    and split-R-hat and ESS of the kept part equal to 1e-10."""
    data = tpyp.crp_generate(3, 2, 10, 30, 0.5, 5.0)
    n_max = max(int(data.N.max()) + 2, 16)
    cfg = jdriver.GibbsConfig(**TRACED)
    key = jax.random.key(21)
    jg = jag.make_grid(n_max, n_max, g=32, dtype=jnp.float64)
    jout = jdriver.run_gibbs(key, data, jg, 6, 0.5, 5.0, cfg)
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")
    _gibbs_keys(key, cfg).patch(monkeypatch)
    tout = tdriver.run_gibbs(None, data, tg, 6, 0.5, 5.0,
                             tdriver.GibbsConfig(**TRACED))
    for k in ("t", "T"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    for k in ("a_trace", "b_trace", "a_rhat", "b_rhat", "a_ess", "b_ess",
              "aave", "bave", "Tave"):
        assert tuple(tout[k].shape) == np.shape(jout[k]), k
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-10, err_msg=k)
    assert tout["a_trace"].shape == (24, 6)
    # the moves happened: a changes on its cycle only
    a = tout["a_trace"].numpy()
    assert not np.array_equal(a[0], a[3]) and np.array_equal(a[1], a[2])


@pytest.mark.parametrize("sampler", ["TI", "HSA"])
def test_traces_change_nothing_else(sampler):
    """Traces draw nothing: every other output is bitwise the same with
    and without them; run_gibbs_timed drops them, as JAX's does."""
    data = tpyp.crp_generate(1, 2, 8, 20, 0.5, 5.0)
    grid = tag.make_grid(24, 24, g=24, dtype=torch.float64, device="cpu")
    cfg = tdriver.GibbsConfig(iters=20, bcycle=1, acycle=2, sampler=sampler)
    outs = [tdriver.run_gibbs(rng.generator(4, "cpu"), data, grid, 4, 0.5,
                              5.0, dataclasses.replace(
                                  cfg, collect_traces=traced))
            for traced in (False, True)]
    for k, v in outs[0].items():
        if v is None:
            assert outs[1][k] is None
        else:
            assert torch.equal(v, outs[1][k]), k
    assert set(outs[1]) - set(outs[0]) == {"a_trace", "b_trace", "a_rhat",
                                           "b_rhat", "a_ess", "b_ess"}
    assert torch.equal(outs[1]["a_trace"][-1], outs[1]["a"])
    timed = tdriver.run_gibbs_timed(
        rng.generator(4, "cpu"), data, grid, 4, 0.5, 5.0,
        dataclasses.replace(cfg, collect_traces=True), chunk=4)
    assert "a_trace" not in timed and timed["iters_done"] == 20


def test_collect_traces_diagnostics():
    """tests/test_resume.py's diagnostic checks, on the port."""
    data = tpyp.crp_generate(1, 1, 10, 20, 0.5, 5.0)
    grid = tag.make_grid(24, 21, g=24, dtype=torch.float64, device="cpu")
    cfg = tdriver.GibbsConfig(iters=60, burnin=10, bcycle=1, acycle=1,
                              collect_traces=True)
    out = tdriver.run_gibbs(rng.generator(1, "cpu"), data, grid, 8, 0.5, 5.0,
                            cfg)
    assert out["a_trace"].shape == (60, 8) == out["b_trace"].shape
    assert np.isfinite(float(out["a_rhat"]))
    assert 0 < float(out["b_ess"]) <= 60 * 8 * 1.5


def test_unknown_sampler_raises():
    data = tpyp.crp_generate(0, 1, 4, 6, 0.5, 1.0)
    grid = tag.make_grid(16, 16, g=8, device="cpu")
    for run in (tdriver.run_gibbs, tdriver.run_gibbs_timed):
        with pytest.raises(ValueError, match="unknown sampler"):
            run(rng.generator(0, "cpu"), data, grid, 2, 0.5, 1.0,
                tdriver.GibbsConfig(iters=2, sampler="XY"))


# the check.c samplers at the gate's data and hyper cycles (exact odds:
# the pair of runs compares CT, CTW and HSA, which have no legacy form)
CHECK = dict(iters=300, bcycle=2, acycle=5, scale=20.0)


@pytest.mark.parametrize("sampler", ["CT", "CTW", "HSA"])
def test_check_samplers_match_jax_moments(sampler):
    """run_gibbs(sampler=CT | CTW | HSA) with (a, b) moves: the port's
    moments inside the gate's bands of the JAX driver's run, the state's
    invariants, and the HSA histogram returned (None otherwise)."""
    cfg = dict(CHECK, sampler=sampler, window=3)
    data = tpyp.crp_generate(7, 2, 20, 40, 0.5, 1.0)
    n_max = max(int(data.N.max()) + 2, 16)
    jout = jdriver.run_gibbs(
        jax.random.key(8), data,
        jag.make_grid(n_max, n_max, g=96, dtype=jnp.float64), 64, 0.5, 1.0,
        jdriver.GibbsConfig(**cfg))
    tout = tdriver.run_gibbs(
        rng.generator(8, "cpu"), data,
        tag.make_grid(n_max, n_max, g=96, dtype=torch.float64, device="cpu"),
        64, 0.5, 1.0, tdriver.GibbsConfig(**cfg))
    for k in ("tave", "Tave", "aave", "bave", "t", "T", "a", "b"):
        assert tuple(tout[k].shape) == tuple(np.shape(jout[k])), k
    _within_bands(np.asarray(jout["Tave"]), tout["Tave"].numpy(), 0.05)
    _within_bands(np.asarray(jout["aave"]), tout["aave"].numpy(), 0.01)
    _within_bands(np.asarray(jout["bave"]), tout["bave"].numpy(), 0.05)
    t, T = tout["t"].numpy(), tout["T"].numpy()
    np.testing.assert_array_equal(t.sum(-1), T)
    assert ((t >= (data.n > 0)) & (t <= data.n)).all()
    if sampler == "HSA":
        hist = tout["hist"].numpy()
        assert hist.shape == np.shape(jout["hist"])
        np.testing.assert_array_equal(hist.sum(-1), t)
        np.testing.assert_array_equal(
            (hist * np.arange(hist.shape[-1])).sum(-1),
            np.broadcast_to(data.n, t.shape))
    else:
        assert tout["hist"] is None and jout["hist"] is None


def test_hsa_matches_ct_posterior():
    """tests/test_hsa.py: HSA and CT at fixed (a, b) agree on E[T] within
    3 combined SE + 0.05 (port against port)."""
    data = tpyp.crp_generate(1, 1, 15, 40, 0.5, 10.0)
    grid = tag.make_grid(44, 44, g=48, dtype=torch.float64, device="cpu")
    means = {}
    for s in ("CT", "HSA"):
        out = tdriver.run_gibbs(rng.generator(2, "cpu"), data, grid, 24, 0.5,
                                10.0, tdriver.GibbsConfig(iters=240,
                                                          sampler=s))
        Tave = out["Tave"].numpy()[:, 0]
        means[s] = (Tave.mean(), Tave.std(ddof=1) / np.sqrt(len(Tave)))
    band = 3 * np.hypot(means["CT"][1], means["HSA"][1]) + 0.05
    assert abs(means["CT"][0] - means["HSA"][0]) < band, (means, band)


def test_run_gibbs_timed_count_mode_and_alignment():
    """Count mode: iters_done == iters with the last chunk clamped; the
    chunk rounds up to lcm(bcycle, acycle) = 6 (4 asked); progress reports
    every post-burn-in chunk; the posterior mean agrees loosely with
    run_gibbs's (tests/test_models.py's rtol 0.15)."""
    data = tpyp.crp_generate(7, 2, 5, 25, 0.5, 1.0)
    grid = tag.make_grid(64, 32, g=100, dtype=torch.float64, device="cpu")
    cfg = tdriver.GibbsConfig(iters=40, burnin=10, sampler="CT", bcycle=2,
                              acycle=3, scale=5.0)
    seen = []
    out = tdriver.run_gibbs_timed(
        rng.generator(0, "cpu"), data, grid, 64, 0.5, 1.0, cfg, chunk=4,
        progress=lambda done, ms, rm: seen.append((done, ms, rm)))
    assert out["iters_done"] == 40 and out["burnin_done"] == 6
    assert [d for d, _, _ in seen] == [12, 18, 24, 30, 36, 40]
    assert all(ms >= 0 and set(rm) == {"Tave_mean", "aave_mean",
                                       "bave_mean"} for _, ms, rm in seen)
    np.testing.assert_allclose(seen[-1][2]["Tave_mean"],
                               float(out["Tave_mean"].sum()), rtol=1e-12)
    assert 0.01 <= float(out["aave_mean"]) <= 0.98
    ref = tdriver.run_gibbs(rng.generator(1, "cpu"), data, grid, 64, 0.5,
                            1.0, cfg)
    np.testing.assert_allclose(float(out["Tave_mean"].sum()),
                               float(ref["Tave_mean"].sum()), rtol=0.15)


@pytest.mark.parametrize("sampler", ["CT", "HSA", "TI"])
def test_run_gibbs_timed_budget_mode(sampler):
    """'-C Nms' / '-B Nms': the clock stops the run; the state carried
    across chunks (the HSA histogram included) keeps its invariants."""
    data = tpyp.crp_generate(7, 2, 5, 25, 0.5, 1.0)
    grid = tag.make_grid(64, 32, g=100, dtype=torch.float64, device="cpu")
    cfg = tdriver.GibbsConfig(iters=10 ** 6, sampler=sampler, bcycle=2,
                              acycle=2, scale=5.0)
    out = tdriver.run_gibbs_timed(rng.generator(0, "cpu"), data, grid, 16,
                                  0.5, 1.0, cfg, iter_ms=300.0,
                                  burnin_ms=60.0, chunk=8)
    assert 8 <= out["iters_done"] < 10 ** 6 and out["iters_done"] % 8 == 0
    assert out["elapsed_ms"] >= 300.0
    assert out["burnin_done"] is not None
    assert out["burnin_done"] < out["iters_done"]
    assert torch.isfinite(out["Tave_mean"]).all()
    t, T = out["t"], out["T"]
    assert torch.equal(t.sum(-1, dtype=torch.int32), T)
    assert ((t >= torch.as_tensor(data.n > 0).int())
            & (t <= torch.as_tensor(data.n))).all()


def test_run_gibbs_timed_budget_in_burnin():
    """A budget spent inside burn-in reports the last chunk's means."""
    data = tpyp.crp_generate(7, 1, 5, 20, 0.5, 1.0)
    grid = tag.make_grid(32, 32, g=16, dtype=torch.float64, device="cpu")
    out = tdriver.run_gibbs_timed(
        rng.generator(0, "cpu"), data, grid, 4, 0.5, 1.0,
        tdriver.GibbsConfig(iters=10 ** 6, sampler="CT"), iter_ms=1.0,
        burnin_ms=10 ** 7, chunk=2)
    assert out["iters_done"] == 2 and out["burnin_done"] == 0
    assert torch.isfinite(out["Tave"]).all()


def test_entry_step_runs():
    import __graft_entry__
    step, args = entry.entry("cpu")
    t, T, a, b = step(*args)
    _, jargs = __graft_entry__.entry()
    for x, y in zip((t, T, a, b), jargs[1:5]):
        assert tuple(x.shape) == tuple(y.shape)
    assert t.dtype == T.dtype == torch.int32
    assert torch.equal(t.sum(-1, dtype=torch.int32), T)
    assert bool(((a > 0) & (a < 1)).all()) and bool((b > 0).all())


def test_convert_data_and_state():
    jd = jpyp.crp_generate(4, 2, 6, 15, 0.5, 1.0)
    td = convert.data_from_numpy(jd)
    for f in jd._fields:
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    jt, jT = jpyp.init_state(jd, 3)
    t, T, a, b = convert.state_from_numpy(jt, jT, np.full(3, 0.4),
                                          np.full(3, 2.0, np.float32), "cpu")
    assert t.dtype == T.dtype == torch.int32
    assert a.dtype == torch.float64 and b.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("argv", [
    ["-C", "40", "-R", "2", "--samplers", "SA,TI,CT,CTW,HSA", "-v"],
    ["-C", "250ms", "-B", "50ms", "-R", "2", "--samplers", "SA,CT,HSA"],
    ["-C", "24", "-R", "1", "-H", "2", "-I", "4", "-A", "-p", "8",
     "--samplers", "HSA,CTW"]])
def test_check_cli_runs(argv):
    """cli/check_torch.py on the CPU: one report line a sampler with E[T]
    and its stderr, in count and in wall-clock mode; the running means
    (-p) and the ARS telemetry (-A with -H)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "cli"))
    import check_torch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check_torch.main(["--device", "cpu", "-N", "20", "--chains", "8",
                          *argv])
    text = buf.getvalue()
    names = argv[argv.index("--samplers") + 1].split(",")
    for name in names:
        m = re.search(rf"^  {name} *: E\[T\] = *([0-9.]+) \+- ([0-9.]+)", text,
                      re.M)
        assert m and 1.0 <= float(m.group(1)) <= 20.0, text
    if "ms" in argv[1]:
        assert len(re.findall(r"iters in \d+ms\]", text)) == len(names)
    if "-A" in argv:
        assert "ARS neval/call" in text and "p: iter" in text


def test_rhat_check_tool_runs_both_packages():
    """tools/torch_rhat_check.py (the R-hat / ESS of a and b of both
    packages at the gate's configuration) at a tiny size: one row a package,
    each diagnostic finite, R-hat >= ~1 and 0 < ESS <= 1.5 x the kept
    draws, E[a] inside (0, 1)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    try:
        import torch_rhat_check
    finally:
        sys.path.pop(0)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = torch_rhat_check.main(["--seeds", "7", "--iters", "60",
                                      "--chains", "4"])
    assert [r["package"] for r in rows] == ["jax", "port"]
    for r in rows:
        assert r["seed"] == 7 and r["iters"] == 60 and r["chains"] == 4
        for x in ("a", "b"):
            assert np.isfinite(r[f"{x}_rhat"]) and r[f"{x}_rhat"] > 0.9
            assert 0 < r[f"{x}_ess"] <= 1.5 * 30 * 4
        assert 0 < r["a_mean"] < 1
