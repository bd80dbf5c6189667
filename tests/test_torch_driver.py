"""Port parity for the whole slice: libstb_tpu_torch's run_gibbs against
libstb_tpu's on the CPU in f64, with tools/oracle_compare.py's settings.

The two runs use different random streams, so they are compared the way
the acceptance gate compares against the reference binary: per-chain
posterior means as replicates, |difference| within 2 combined Monte-Carlo
SE plus floors of 0.05 (E[T_j]), 0.01 (E[a]) and 0.05 (E[b])
(oracle_compare.py:79-89)."""
import dataclasses

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


@pytest.mark.parametrize("kw,item", [
    (dict(sampler="CT"), "item 9"), (dict(sampler="CTW"), "item 9"),
    (dict(sampler="HSA"), "item 9"),
    (dict(collect_traces=True), "items 6 and 11")])
def test_unported_options_raise(kw, item):
    data = tpyp.crp_generate(0, 1, 4, 6, 0.5, 1.0)
    grid = tag.make_grid(16, 16, g=8, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        tdriver.run_gibbs(rng.generator(0, "cpu"), data, grid, 2, 0.5, 1.0,
                          tdriver.GibbsConfig(iters=2, **kw))


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
