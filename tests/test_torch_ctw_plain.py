"""The Gibbs driver's CTW route over relative candidates
(``run_gibbs(..., ctw_rel=True)``: ``models/pyp.ctw_sweep_rel``) against
the plain float64 reference of the benchmark's CTW cell
(benchmark/reference/ctw_ref.py), on the CPU at a small size: 3 groups x
60 items over DIM 20, 4 chains, an f64 grid.  No JAX: the reference is
the benchmark's own.

* Sweeps under the port's own Gumbels (recorded as the port draws them
  and handed to the reference), the discounts on grid nodes: t and T
  equal to the reference's, which shifts its own window and reads exact
  Stirling numbers where the port interpolates the grid.
* Between the nodes the grid's interpolation moves each candidate's log
  weight by some d_t; the conditional's total-variation distance to the
  reference is then at most tanh(R / 4), R the spread max d_t - min d_t
  over the window's candidates.  The test holds it to that bound and to
  1e-4.
* ``sampler="CTW"`` without the keyword draws as before: ``ct_sweep``
  with the window, bitwise.
* ``run_gibbs_timed`` in count mode equals ``run_gibbs``; the
  ``stb/ctw.*`` spans nest; ``pyp.CTW_COUNTS`` counts as the shapes
  say."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import ctw_ref, hpyp_ref
from libstb_tpu_torch.core import agrid, rng
from libstb_tpu_torch.models import driver, pyp
from libstb_tpu_torch.utils import metrics

torch.set_num_threads(1)

C = 4
F64 = torch.float64


def _data(seed=0):
    return pyp.crp_generate(seed, 3, 20, 60, 0.5, 5.0)


def _grid(data, g=100):
    n = int(data.n.max()) + 2
    return agrid.make_grid(n, n, g=g, dtype=F64, device="cpu")


def _gumbels(monkeypatch) -> list:
    """Every Gumbel block the port draws, in order."""
    blocks = []
    real = rng.gumbel

    def rec(*args, **kw):
        x = real(*args, **kw)
        blocks.append(x.clone())
        return x
    monkeypatch.setattr(rng, "gumbel", rec)
    return blocks


def _start(data, grid, nodes):
    """The starting state with each chain at a grid node's discount."""
    t, T = pyp.init_state(data, C, "cpu")
    a = torch.stack([grid.avec[k] for k in nodes]).to(F64)
    b = torch.linspace(2.0, 9.0, C, dtype=F64)
    return t, T, a, b


@pytest.mark.parametrize("window", [1, 2, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_route_on_grid_nodes_equals_reference(monkeypatch, seed, window):
    """Four sweeps, no moves: the port's route and the reference's sweep
    under the same Gumbels draw the same t and T."""
    data = _data(seed)
    grid = _grid(data)
    t, T, a, b = _start(data, grid, [10, 30, 50, 70])
    g = _gumbels(monkeypatch)
    cfg = driver.GibbsConfig(iters=4, burnin=2, sampler="CTW",
                             window=window)
    gen = rng.generator(seed, "cpu")
    grid_, plan = driver._prepare(data, grid, cfg, ctw_rel=True)
    out = driver._run_chunk(gen, data, grid_, dict(t=t, T=T, hist=None, a=a,
                                                   b=b), cfg, plan, 2)
    assert len(g) == 4 and g[0].shape == (20, C * 3, 2 * window + 1)
    n, H = torch.as_tensor(data.n), torch.as_tensor(data.H)
    rt, rT = t, T
    for block in g:
        rt, rT = ctw_ref.sweep(rt, rT, a, b, n, H, block, window, block=3)
    assert torch.equal(out["t"].to(torch.int64), rt.to(torch.int64))
    assert torch.equal(out["T"].to(torch.int64), rT.to(torch.int64))
    assert int(rt.max()) > 2 * window + 1 or window == 10  # the window moved


def _windowed(grid, data, t, T, a, b, w):
    """Per category: the port's and the reference's conditionals laid on
    t = 1..max n, and the rows with a count, and the spread R of the
    port's log weights less the reference's over each window."""
    n, H = torch.as_tensor(data.n), torch.as_tensor(data.H)
    Cn, J, D = t.shape
    tmax = int(data.n.max())
    rows = ctw_ref.srel_rows(a, n)
    a_f = a[:, None].expand(Cn, J).reshape(-1)
    b_f = b[:, None].expand(Cn, J).reshape(-1)
    for i in range(D):
        ni = n[None, :, i].expand(Cn, J).reshape(-1)
        ti, Tj = t[:, :, i].reshape(-1), T.reshape(-1)
        tts = pyp._ctw_window(ti, ni, w)
        assert torch.equal(tts, ctw_ref.window(ti, ni, w))
        hlog = torch.log(torch.clamp(H[i], min=1e-30))
        lw = pyp._ctw_weights(pyp._ctw_srel(grid, ni, tts, a_f), ni, ti, Tj,
                              a_f, b_f, hlog, tts)
        lr = ctw_ref.log_weights(
            ctw_ref.srel_at(rows[:, :, i].reshape(Cn * J, -1), ni, tts), ni,
            ti, Tj, a_f, b_f, H[i].expand(Cn * J), tts)
        live = torch.isfinite(lr)
        d = torch.where(live, lw - torch.where(live, lr, 0.0), torch.nan)
        R = (torch.nan_to_num(d, nan=-torch.inf).amax(-1)
             - torch.nan_to_num(d, nan=torch.inf).amin(-1))
        yield (ctw_ref.probs_on(lw, tts, tmax),
               ctw_ref.probs_on(lr, tts, tmax), ni > 0, R)


@pytest.mark.parametrize("g", [32, 100])
def test_conditional_between_nodes_within_tolerance(g):
    """A run's end state, its discounts moved off the grid's nodes: every
    category's windowed conditional within tanh(R / 4) of the reference's
    and within 1e-4."""
    data = _data(3)
    grid = _grid(data, g)
    cfg = driver.GibbsConfig(iters=10, burnin=5, sampler="CTW", window=3,
                             bcycle=2, acycle=2, b_groups=3)
    out = driver.run_gibbs(rng.generator(3, "cpu"), data, grid, C, 0.5, 5.0,
                           cfg, ctw_rel=True)
    pos = (out["a"] - grid.a0) / grid.da
    assert ((pos - pos.round()).abs() > 0.1).any()    # off the nodes
    worst = 0.0
    for p, q, has, R in _windowed(grid, data, out["t"], out["T"], out["a"],
                                  out["b"], 3):
        tv = hpyp_ref.total_variation(p, q)[has]
        assert (tv <= torch.tanh(R[has] / 4) + 1e-12).all()
        worst = max([worst] + tv.tolist())
    assert 0 < worst < 1e-4, worst


def test_default_ctw_route_draws_as_before():
    """Without the keyword, sampler CTW sweeps with ct_sweep(window): the
    draws of a loop of ct_sweep calls, bitwise, and no CTW_COUNTS."""
    data = _data(1)
    grid = _grid(data)
    cfg = driver.GibbsConfig(iters=3, burnin=1, sampler="CTW", window=2)
    before = dict(pyp.CTW_COUNTS)
    out = driver.run_gibbs(rng.generator(5, "cpu"), data, grid, C, 0.5, 5.0,
                           cfg)
    assert pyp.CTW_COUNTS == before
    gen = rng.generator(5, "cpu")
    t, T = pyp.init_state(data, C, "cpu")
    a = torch.full((C,), 0.5, dtype=F64)
    b = torch.full((C,), 5.0, dtype=F64)
    for _ in range(3):
        t, T = pyp.ct_sweep(gen, t, T, a, b, grid, data,
                            int(data.n.max()) + 1, window=2)
    assert torch.equal(out["t"], t) and torch.equal(out["T"], T)
    rel = driver.run_gibbs(rng.generator(5, "cpu"), data, grid, C, 0.5, 5.0,
                           cfg, ctw_rel=True)
    assert not torch.equal(rel["t"], t)              # another route


def test_route_needs_the_ctw_sampler():
    data = _data(0)
    with pytest.raises(ValueError, match="ctw_rel"):
        driver.run_gibbs(rng.generator(0, "cpu"), data, _grid(data), C, 0.5,
                         5.0, driver.GibbsConfig(iters=1, sampler="CT"),
                         ctw_rel=True)


CFG = driver.GibbsConfig(iters=20, burnin=10, sampler="CTW", window=10,
                         bcycle=2, acycle=5, b_groups=3)


@pytest.mark.parametrize("chunk", [5, 10])
def test_timed_count_mode_equals_run_gibbs(chunk):
    """The off-clock chunk (10 iterations: chunks round up to lcm(2, 5))
    taken first from the same generator, then the run of one call: the
    same end state bitwise, the same averages."""
    data = _data(1)
    grid = _grid(data)
    timed = driver.run_gibbs_timed(rng.generator(4, "cpu"), data, grid, C,
                                   0.5, 5.0, CFG, chunk=chunk, ctw_rel=True)
    gen = rng.generator(4, "cpu")
    driver.run_gibbs(gen, data, grid, C, 0.5, 5.0,
                     dataclasses.replace(CFG, iters=10), ctw_rel=True)
    ref = driver.run_gibbs(gen, data, grid, C, 0.5, 5.0, CFG, ctw_rel=True)
    for k in ("t", "T", "a", "b"):
        assert torch.equal(timed[k], ref[k]), k
    for k in ("Tave", "aave", "bave"):
        np.testing.assert_allclose(timed[k].numpy(), ref[k].numpy(),
                                   rtol=1e-12, err_msg=k)
    assert timed["iters_done"] == 20 and timed["burnin_done"] == 10
    assert (timed["a"] != 0.5).all() and (timed["b"] != 5.0).all()


def _stb_spans(logdir):
    """(name, start, end, thread) of every stb/ span of a trace."""
    with open(os.path.join(logdir, "trace.json")) as f:
        ev = json.load(f)["traceEvents"]
    return [(e["name"][len("stb/"):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]), e["tid"]) for e in ev
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("stb/")]


def _parent_names(spans):
    """{name: (count, the set of the innermost other spans holding it)}."""
    out = {}
    for i, (name, t0, t1, tid) in enumerate(spans):
        holding = [(b - a, n) for k, (n, a, b, th) in enumerate(spans)
                   if k != i and th == tid and a <= t0 and t1 <= b]
        count, parents = out.get(name, (0, set()))
        parents.add(min(holding)[1] if holding else None)
        out[name] = (count + 1, parents)
    return out


def test_spans_nest(tmp_path):
    """Each sweep's ``ctw.sweep`` inside its ``driver.iter``, the category
    loop ``ctw.scan`` inside the sweep, each category's ``ctw.srel``
    inside the loop; the traced run's outputs equal the untraced one's."""
    data = _data(1)
    grid = _grid(data)
    cfg = dataclasses.replace(CFG, iters=3, burnin=1)

    def run():
        return driver.run_gibbs(rng.generator(6, "cpu"), data, grid, C, 0.5,
                                5.0, cfg, ctw_rel=True)

    with metrics.trace(str(tmp_path)):
        traced = run()
    plain = run()
    for k in ("t", "T", "a", "b", "Tave"):
        assert torch.equal(traced[k], plain[k]), k
    got = _parent_names(_stb_spans(str(tmp_path)))
    assert got["ctw.sweep"] == (3, {"driver.iter"})
    assert got["ctw.scan"] == (3, {"ctw.sweep"})
    assert got["ctw.srel"] == (3 * 20, {"ctw.scan"})


def test_ctw_counts_count_the_shapes(monkeypatch):
    """sweeps and candidates = chains x groups x (2w + 1) x categories,
    counted on the host a sweep."""
    monkeypatch.setattr(pyp, "CTW_COUNTS", {"sweeps": 0, "candidates": 0})
    data = _data(2)
    grid = _grid(data)
    cfg = driver.GibbsConfig(iters=5, burnin=1, sampler="CTW", window=4)
    driver.run_gibbs(rng.generator(7, "cpu"), data, grid, C, 0.5, 5.0, cfg,
                     ctw_rel=True)
    assert pyp.CTW_COUNTS == {"sweeps": 5, "candidates": 5 * C * 3 * 9 * 20}


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_grid_that_holds_the_counts_skips_only_unread_values(dtype):
    """On a grid that holds every count the sweep queries without the
    asymptote: each candidate 1 <= t <= n reads the same Srel bitwise,
    the rest -inf; a grid too small keeps it."""
    data = pyp.crp_generate(3, 4, 20, 200, 0.5, 5.0)
    n_top = int(data.n.max())
    grid = agrid.make_grid(n_top + 2, n_top + 2, g=32, dtype=dtype,
                           device="cpu")
    lean = pyp._ctw_in_table(grid, data)
    assert grid.use_asympt and not lean.use_asympt
    small = agrid.make_grid(n_top - 5, n_top - 5, g=32, dtype=dtype,
                            device="cpu")
    assert pyp._ctw_in_table(small, data) is small
    J, D = data.n.shape
    ni = torch.as_tensor(data.n)[None].expand(6, J, D).reshape(-1)
    r = np.random.default_rng(0)
    ti = torch.as_tensor(r.integers(1, np.maximum(ni.numpy(), 1) + 1),
                         dtype=torch.int32)
    a = torch.as_tensor(r.uniform(0.01, 0.98, ni.numel()), dtype=dtype)
    tts = pyp._ctw_window(ti, ni, 10)
    full, got = (pyp._ctw_srel(g, ni, tts, a) for g in (grid, lean))
    read = (tts >= 1) & (tts <= ni[:, None])
    assert torch.equal(full[read], got[read])
    assert torch.isneginf(got[~read]).all()
