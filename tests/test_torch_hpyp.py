"""Port parity: libstb_tpu_torch.models.hpyp vs libstb_tpu.models.hpyp on
the CPU in f64.

_predictive equal to 1e-12; run_hpyp
under the JAX run's own draws (rebuilt from its keys and replayed through
rng.Replay, tests/test_torch_driver.py's _JaxKeys): t1, T1, t0, T0 exactly
equal and every average (a, b included) to 1e-10, with and without the
(a, b) moves.  Then the ports of tests/test_hpyp.py (invariants; the b0 ->
inf flat limit against the port's own CT run_gibbs, 3 combined SE + 0.05)
and of tests/test_models.py's grid-growth check for the dynamic level 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import agrid as jag
from libstb_tpu.models import hpyp as jhpyp
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.models import driver as tdriver
from libstb_tpu_torch.models import hpyp as thpyp
from libstb_tpu_torch.models import pyp as tpyp
from test_torch_driver import _JaxKeys

torch.set_num_threads(1)


def test_predictive_equal():
    r = np.random.default_rng(0)
    C, D = 6, 9
    n0 = r.integers(0, 40, (C, D)).astype(np.int32)
    t0 = np.where(n0 > 0, np.minimum(r.integers(1, 6, (C, D)), n0), 0)
    t0 = t0.astype(np.int32)
    T0 = t0.sum(-1).astype(np.int32)
    a0, b0 = r.uniform(0.05, 0.9, C), r.uniform(0.5, 50.0, C)
    H = r.dirichlet(np.ones(D))
    want = np.asarray(jhpyp._predictive(*(jnp.asarray(x) for x in
                                          (n0, t0, T0, a0, b0, H))))
    got = thpyp._predictive(*(torch.as_tensor(x) for x in
                              (n0, t0, T0, a0, b0, H)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)


def _hpyp_keys(key, cfg):
    """run_hpyp's keys: split(key, 4) an iteration into (carry, level-1
    sweep, level-0 sweep, hyper); split(hyper, 4) into (b1, a1, b0, a0),
    used on the hyper cycle only."""
    keys = dict(sweep=[], b=[], a=[])
    for it in range(cfg.iters):
        key, k1, k0, kh = jax.random.split(key, 4)
        keys["sweep"] += [k1, k0]
        if cfg.hyper_cycle > 0 and it % cfg.hyper_cycle == 0:
            kb1, ka1, kb0, ka0 = jax.random.split(kh, 4)
            keys["b"] += [kb1, kb0]
            keys["a"] += [ka1, ka0]
    return _JaxKeys(**keys)


@pytest.mark.parametrize("hyper_cycle", [0, 2])
def test_run_hpyp_equal_under_jax_draws(monkeypatch, hyper_cycle):
    data = tpyp.crp_generate(2, 3, 8, 20, 0.5, 5.0)
    cfg = dict(iters=6, hyper_cycle=hyper_cycle)
    key = jax.random.key(5)
    n0_bound = int(data.n.sum(0).max())
    jg = jag.make_grid(n0_bound + 2, n0_bound + 2, g=32, dtype=jnp.float64)
    jout = jhpyp.run_hpyp(key, data, jg, 5, 0.4, 3.0, 0.6, 8.0,
                          jhpyp.HPYPConfig(**cfg))
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")
    _hpyp_keys(key, jhpyp.HPYPConfig(**cfg)).patch(monkeypatch)
    tout = thpyp.run_hpyp(None, data, tg, 5, 0.4, 3.0, 0.6, 8.0,
                          thpyp.HPYPConfig(**cfg))
    assert set(tout) == set(jout)
    for k in ("t1", "T1", "t0", "T0"):
        assert tout[k].dtype == torch.int32, k
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    for k in ("t1ave", "T1ave", "t0ave", "T0ave", "a1ave", "b1ave", "a0ave",
              "b0ave", "T1ave_mean", "T0ave_mean"):
        assert tuple(tout[k].shape) == np.shape(jout[k]), k
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-10, err_msg=k)
    moved = not np.allclose(tout["a1ave"].numpy(), 0.4)
    assert moved == (hyper_cycle > 0)


def test_invariants():
    data = tpyp.crp_generate(0, 3, 10, 20, 0.5, 5.0)
    grid = tag.make_grid(70, 30, g=32, dtype=torch.float64, device="cpu")
    out = thpyp.run_hpyp(rng.generator(0, "cpu"), data, grid, 8, 0.5, 5.0,
                         0.5, 2.0, thpyp.HPYPConfig(iters=40, hyper_cycle=3))
    t1, t0 = out["t1"].numpy(), out["t0"].numpy()
    n0 = t1.sum(axis=1)
    assert (t1 <= data.n[None]).all() and (t1 >= (data.n > 0)[None]).all()
    assert (t0 <= n0).all()
    assert ((t0 >= 1) | (n0 == 0)).all()
    np.testing.assert_array_equal(out["T0"].numpy(), t0.sum(-1))
    np.testing.assert_array_equal(out["T1"].numpy(), t1.sum(-1))
    for k in ("a1ave", "a0ave"):
        assert ((out[k] >= 0.01) & (out[k] <= 0.98)).all(), k


def test_flat_limit_matches_pyp():
    """b0 -> inf, a0 -> 0: the level-0 predictive is H, so level 1 is the
    flat PYP model (the port's CT run_gibbs)."""
    data = tpyp.crp_generate(1, 2, 10, 30, 0.5, 5.0)
    grid = tag.make_grid(70, 35, g=48, dtype=torch.float64, device="cpu")
    C = 24
    outh = thpyp.run_hpyp(rng.generator(2, "cpu"), data, grid, C, 0.5, 5.0,
                          0.01, 2000.0, thpyp.HPYPConfig(iters=200))
    outf = tdriver.run_gibbs(rng.generator(3, "cpu"), data, grid, C, 0.5,
                             5.0, tdriver.GibbsConfig(iters=200,
                                                      sampler="CT"))
    Th, Tf = outh["T1ave"].numpy(), outf["Tave"].numpy()
    for j in range(Th.shape[1]):
        d = abs(Th[:, j].mean() - Tf[:, j].mean())
        se = np.hypot(Th[:, j].std(ddof=1), Tf[:, j].std(ddof=1)) / np.sqrt(C)
        assert d < 3 * se + 0.05, (j, Th[:, j].mean(), Tf[:, j].mean())


@pytest.mark.parametrize("hard", [0, 512])
def test_grid_grows_for_dynamic_level0(monkeypatch, hard):
    """Level-0 counts (sums of t1) exceed any per-category count; the grid
    is asked for the reachable bound sum_j n[j, i] + 1 and grown to it
    within its hard bounds (none: it stays, and the queries beyond it take
    the asymptote, as in the JAX package); T0 stays finite either way."""
    data = tpyp.crp_generate(3, 6, 4, 20, 0.5, 1.0)
    n0_bound = int(data.n.sum(axis=0).max())
    small = tag.make_grid(int(data.n.max()) + 2, int(data.n.max()) + 2,
                          g=64, dtype=torch.float64, device="cpu",
                          max_n=hard, max_m=hard)
    seen = []
    ensure = tag.ensure_grid

    def spy(grid, n, m, **kw):
        seen.append((n, m))
        out = ensure(grid, n, m, **kw)
        seen.append((out.n_max, out.m_max))
        return out

    monkeypatch.setattr(tag, "ensure_grid", spy)
    out = thpyp.run_hpyp(rng.generator(0, "cpu"), data, small, 8, 0.5, 1.0,
                         0.5, 1.0, thpyp.HPYPConfig(iters=40, hyper_cycle=2))
    assert seen[0] == (n0_bound + 1, n0_bound + 1)
    if hard:
        assert seen[1][0] >= n0_bound + 2 and seen[1][1] >= n0_bound + 2
    else:
        assert seen[1] == (small.n_max, small.m_max)
    assert torch.isfinite(out["T0ave"]).all()
    assert int(out["t0"].max()) <= n0_bound
    assert torch.isfinite(out["a0ave"]).all()
