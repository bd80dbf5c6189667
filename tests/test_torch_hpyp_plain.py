"""The port's two-level HPYP (models/hpyp) against the plain float64
reference of the benchmark's HPYP cell (benchmark/reference/hpyp_ref.py),
on the CPU at a small size: 3 groups x 30 items over DIM 5, 4 chains, an
f64 grid.  No JAX: the reference is the benchmark's own.

* One iteration under the port's own draws (recorded as the port takes
  them and handed to the reference in that order), the discounts on grid
  nodes: t1, T1, t0, T0 equal to the reference's, which reads exact
  Stirling numbers where the port interpolates the grid; with the moves
  on, the four hyperparameters equal too.
* Between the nodes the grid's interpolation moves each candidate's log
  weight by some d_t; the conditional's total-variation distance to the
  reference is then at most tanh(R / 4), R the spread max d_t - min d_t
  over the candidates.  The test holds it to that bound and to 1e-4: the
  worst category reads 2.8e-6 on 32 nodes, 9.8e-8 on 100.
* ``run_hpyp_timed`` in count mode equals ``run_hpyp`` of the same length
  bitwise (its off-clock chunk taken first from the same generator); its
  wall-clock mode keeps its burn-in and its keys; its spans nest."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import hpyp_ref
from libstb_tpu_torch.core import agrid, rng
from libstb_tpu_torch.models import hpyp, pyp
from libstb_tpu_torch.utils import metrics
from test_torch_utils import _parents, _stb_spans

torch.set_num_threads(1)

C = 4
KEYS = ("t1", "T1", "t0", "T0")


def _data(seed=0):
    return pyp.crp_generate(seed, 3, 5, 30, 0.5, 5.0)


def _grid(data, g=100):
    n = int(data.n.sum(axis=0).max()) + 2      # the level-0 bound: no growth
    return agrid.make_grid(n, n, g=g, dtype=torch.float64, device="cpu")


def _record(monkeypatch) -> list:
    """Every draw the port takes, in order, as it takes it."""
    draws = []
    for name in ("gumbel", "uniform", "loggamma", "gamma"):
        real = getattr(rng, name)

        def rec(*args, _real=real, **kw):
            x = _real(*args, **kw)
            draws.append(x.clone())
            return x
        monkeypatch.setattr(rng, name, rec)
    return draws


def _one_iteration(monkeypatch, seed, hyper_cycle):
    data = _data(seed)
    grid = _grid(data)
    a1, a0 = float(grid.avec[50]), float(grid.avec[30])   # grid nodes
    start = hpyp._init(data, grid, C, a1, 5.0, a0, 8.0)
    draws = _record(monkeypatch)
    out = hpyp.run_hpyp(rng.generator(seed, "cpu"), data, grid, C, a1, 5.0,
                        a0, 8.0, hpyp.HPYPConfig(iters=1,
                                                 hyper_cycle=hyper_cycle))
    it = iter(draws)
    ref = hpyp_ref.iteration(start, torch.as_tensor(data.n),
                             torch.as_tensor(data.H), it, hyper_cycle > 0,
                             block=3)
    assert next(it, None) is None, "the reference took fewer draws"
    return out, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iteration_on_grid_nodes_equals_reference(monkeypatch, seed):
    out, ref = _one_iteration(monkeypatch, seed, 0)
    for k in KEYS:
        assert torch.equal(out[k].to(torch.int64), ref[k].to(torch.int64)), k
    assert int(ref["t0"].max()) >= 2      # the level-0 draw is no formality


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iteration_with_the_moves_equals_reference(monkeypatch, seed):
    """The moves draw their proposals from the same uniforms; with the same
    accept decisions a move lands on the same proposal, bitwise.  A grid
    of 100 f64 nodes moves the a-move's log posterior by far less than the
    gaps the decisions turn on, so no decision differs."""
    out, ref = _one_iteration(monkeypatch, seed, 1)
    for k in KEYS:
        assert torch.equal(out[k].to(torch.int64), ref[k].to(torch.int64)), k
    for k in ("a1", "b1", "a0", "b0"):
        np.testing.assert_allclose(out[k + "ave"].numpy(), ref[k].numpy(),
                                   rtol=1e-13, err_msg=k)
        assert (ref[k] != ref[k][0]).any(), k      # the chains moved apart


def _conditionals(grid, data, s, tmax, tmax0):
    """Per category, (port log weights, reference log weights, rows with
    a count) of every chain's level-1 and level-0 conditional at ``s``."""
    n = torch.as_tensor(data.n)
    H = torch.as_tensor(data.H)
    t1, T1, t0, T0 = (s[k] for k in KEYS)
    a1, b1, a0, b0 = (s[k] for k in ("a1", "b1", "a0", "b0"))
    Cn, J, D = t1.shape
    n0 = t1.sum(1, dtype=torch.int32)
    p0 = hpyp._predictive(n0, t0, T0, a0, b0, H)
    srel1 = pyp._ct_srel(grid, n[None], tmax, a1)
    srel0 = pyp._ct_srel(grid, n0[:, None, :], tmax0, a0)
    ref1 = hpyp_ref.srel_exact(a1, n.reshape(1, -1),
                               tmax).reshape(Cn, J, D, tmax)
    ref0 = hpyp_ref.srel_exact(a0, n0, tmax0)

    def rows(x):
        return x[:, None].expand(Cn, J).reshape(-1)

    for i in range(D):
        ni, ti, Tj = n[:, i].expand(Cn, J).reshape(-1), \
            t1[:, :, i].reshape(-1), T1.reshape(-1)
        yield (pyp._ct_conditional(srel1[:, :, i].reshape(-1, tmax), ni, ti,
                                   Tj, rows(a1), rows(b1), rows(p0[:, i]),
                                   tmax, None),
               hpyp_ref.ct_log_weights(ref1[:, :, i].reshape(-1, tmax), ni,
                                       ti, Tj, rows(a1), rows(b1),
                                       rows(p0[:, i])), ni > 0)
        yield (pyp._ct_conditional(srel0[:, 0, i], n0[:, i], t0[:, i], T0,
                                   a0, b0, H[i].expand(Cn), tmax0, None),
               hpyp_ref.ct_log_weights(ref0[:, i], n0[:, i], t0[:, i], T0,
                                       a0, b0, H[i].expand(Cn)),
               n0[:, i] > 0)


@pytest.mark.parametrize("g", [32, 100])
def test_conditional_between_nodes_within_tolerance(g):
    """A run's end state, its discounts moved off the grid's nodes: every
    category's conditional, level 1 and level 0, within tanh(R / 4) of the
    reference's and within 1e-4."""
    data = _data(3)
    grid = _grid(data, g)
    out = hpyp.run_hpyp_timed(rng.generator(3, "cpu"), data, grid, C, 0.5,
                              5.0, 0.5, 8.0,
                              hpyp.HPYPConfig(iters=10, hyper_cycle=2),
                              chunk=2)
    s = {k: out[k] for k in KEYS + ("a1", "b1", "a0", "b0")}
    pos = (s["a1"] - grid.a0) / grid.da
    assert ((pos - pos.round()).abs() > 0.1).any()    # off the nodes
    worst = 0.0
    for lw, lr, has in _conditionals(grid, data, s, int(data.n.max()) + 1,
                                     int(data.n.sum(axis=0).max()) + 1):
        p, q = hpyp_ref.ct_probs(lw), hpyp_ref.ct_probs(lr)
        tv = hpyp_ref.total_variation(p, q)[has]
        live = torch.isfinite(lr)
        d = torch.where(live, lw - torch.where(live, lr, 0.0), torch.nan)
        R = (torch.nan_to_num(d, nan=-torch.inf).amax(-1)
             - torch.nan_to_num(d, nan=torch.inf).amin(-1))[has]
        assert (tv <= torch.tanh(R / 4) + 1e-12).all()
        worst = max([worst] + tv.tolist())
    assert 0 < worst < 1e-4, worst


@pytest.mark.parametrize("seed", [0, 1])
def test_ct_srel_positions_read_the_whole_blocks_values(seed):
    """The Srel block a sweep of shared counts reads at the candidates
    t <= n (``ct_srel_pos``, made on the host) equals the whole block's
    query, -inf beyond them, at discounts on and off the nodes."""
    data = _data(seed)
    grid = _grid(data, 32)
    tmax = int(data.n.max()) + 1
    n = torch.as_tensor(data.n)[None]
    a = torch.tensor([0.0, 0.25, float(grid.avec[7]), 0.9731],
                     dtype=torch.float64)
    pos = pyp.ct_srel_pos(data.n, tmax, "cpu")
    assert pos.numel() == int(data.n.sum())     # every t in 1..n, each n
    packed = pyp._ct_srel(grid, n, tmax, a, pos)
    whole = pyp._ct_srel(grid, n, tmax, a)
    assert packed.shape == whole.shape == (4,) + data.n.shape + (tmax,)
    assert torch.equal(packed, whole)


CFG = hpyp.HPYPConfig(iters=12, burnin=5, hyper_cycle=2)


@pytest.mark.parametrize("chunk,off_clock", [(2, 2), (3, 4), (4, 4), (5, 6)])
def test_timed_count_mode_equals_run_hpyp(chunk, off_clock):
    """Chunks rounded up to the hyper cycle (5 -> 6 also clamps the last
    chunk: 6 + 6), burn-in inside a chunk: bitwise the run of one call."""
    data = _data(1)
    grid = _grid(data)
    timed = hpyp.run_hpyp_timed(rng.generator(4, "cpu"), data, grid, C, 0.5,
                                5.0, 0.5, 8.0, CFG, chunk=chunk)
    gen = rng.generator(4, "cpu")
    hpyp.run_hpyp(gen, data, grid, C, 0.5, 5.0, 0.5, 8.0,
                  dataclasses.replace(CFG, iters=off_clock))
    ref = hpyp.run_hpyp(gen, data, grid, C, 0.5, 5.0, 0.5, 8.0, CFG)
    assert set(ref) < set(timed)
    for k, v in ref.items():
        assert torch.equal(timed[k], v), k
    assert timed["iters_done"] == 12 and timed["burnin_done"] == 5
    assert torch.equal(timed["n0"], timed["t1"].sum(1, dtype=torch.int32))
    np.testing.assert_array_equal(timed["a1"].numpy() != 0.5, True)


def test_timed_wall_clock_mode():
    """A budget: whole chunks until it is spent, burn-in counted in
    iterations; a budget spent inside burn-in keeps the final state."""
    data = _data(1)
    grid = _grid(data)
    cfg = dataclasses.replace(CFG, burnin=4)
    out = hpyp.run_hpyp_timed(rng.generator(5, "cpu"), data, grid, C, 0.5,
                              5.0, 0.5, 8.0, cfg, iter_ms=300.0, chunk=2)
    assert out["iters_done"] % 2 == 0 and out["iters_done"] > 4
    assert out["burnin_done"] == 4 and out["elapsed_ms"] > 300.0
    short = hpyp.run_hpyp_timed(rng.generator(5, "cpu"), data, grid, C,
                                0.5, 5.0, 0.5, 8.0,
                                dataclasses.replace(cfg, burnin=10 ** 6),
                                iter_ms=0.0, chunk=2)
    assert short["iters_done"] == 2 and short["burnin_done"] == 2
    assert torch.equal(short["T1ave"], short["T1"].to(torch.float64))


def test_timed_spans_nest(tmp_path):
    """Every iteration's spans sit inside its ``hpyp.iter``, each CT
    sweep's Srel block and category loop inside its level, the moves
    inside ``hpyp.hyper`` on the cycle's iterations; the traced run's
    outputs equal the untraced one's."""
    data = _data(1)
    grid = _grid(data)
    cfg = dataclasses.replace(CFG, iters=4, burnin=2)

    def run():
        return hpyp.run_hpyp_timed(rng.generator(6, "cpu"), data, grid, C,
                                   0.5, 5.0, 0.5, 8.0, cfg, chunk=2)

    with metrics.trace(str(tmp_path)):
        traced = run()
    plain = run()
    for k in KEYS + ("T1ave", "a1ave", "b0ave"):
        assert torch.equal(traced[k], plain[k]), k
    pairs = _parents(_stb_spans(str(tmp_path)))
    count = {}
    parents = {}
    for name, parent in pairs:
        count[name] = count.get(name, 0) + 1
        parents.setdefault(name, set()).add(parent)
    iters = 2 + 4                             # the off-clock chunk, then 4
    assert count["hpyp.iter"] == iters and parents["hpyp.iter"] == {None}
    assert count["hpyp.chunk_end"] == 2
    assert count["hpyp.level1"] == count["hpyp.level0"] == iters
    assert count["hpyp.hyper"] == 1 + 2       # iterations 0; 0 and 2
    assert count["ct.srel"] == count["ct.scan"] == 2 * iters
    assert parents["ct.srel"] == parents["ct.scan"] == {"hpyp.level1",
                                                        "hpyp.level0"}
    for name in ("hpyp.level1", "hpyp.level0", "hpyp.hyper"):
        assert parents[name] == {"hpyp.iter"}, name
    assert parents["hyper.sample_a"] == parents["hyper.sample_b"] == {
        "hpyp.hyper"}
