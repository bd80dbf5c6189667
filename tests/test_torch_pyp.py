"""Port parity: libstb_tpu_torch.models.pyp vs libstb_tpu.models.pyp.

The host-side data code must be array-equal.  The TI sweeps run in f64 on
identical tables with the uniforms JAX draws (rebuilt by replaying the
sweep's ``split(key, 3)`` per step, pyp.py:187-205 and :276-300) handed
to the port through rng.Replay; the integer state (t, T) must then be
equal after every sweep."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import agrid as jag
from libstb_tpu.core import stirling as jst
from libstb_tpu.models import pyp as jpyp
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.models import pyp as tpyp

torch.set_num_threads(1)


def _data_equal(x, y):
    assert x._fields == y._fields
    for f in x._fields:
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)
        assert np.asarray(getattr(x, f)).dtype == np.asarray(
            getattr(y, f)).dtype, f


@pytest.mark.parametrize("seed,groups,dim,per,a,b", [
    (0, 4, 20, 100, 0.5, 10.0), (7, 2, 20, 40, 0.5, 1.0),
    (11, 2, 20, 40, 0.5, 10.0), (23, 3, 7, 55, 0.8, 0.3)])
def test_crp_generate_equal(seed, groups, dim, per, a, b):
    _data_equal(tpyp.crp_generate(seed, groups, dim, per, a, b),
                jpyp.crp_generate(seed, groups, dim, per, a, b))


@pytest.mark.parametrize("kind", ["uniform", "linear", "slowlinear",
                                  "dirichlet"])
def test_base_distribution_and_given_H(kind):
    H_t = tpyp.base_distribution(kind, 12, 3.0, np.random.default_rng(1))
    H_j = jpyp.base_distribution(kind, 12, 3.0, np.random.default_rng(1))
    np.testing.assert_array_equal(H_t, H_j)
    _data_equal(tpyp.crp_generate(5, 2, 12, 30, 0.3, 2.0, H=H_t),
                jpyp.crp_generate(5, 2, 12, 30, 0.3, 2.0, H=H_j))


def test_from_counts_equal():
    n = np.array([[3, 0, 5, 1], [0, 2, 2, 7]])
    _data_equal(tpyp.from_counts(n), jpyp.from_counts(n))
    _data_equal(tpyp.from_counts(n[0], H=np.full(4, 0.25)),
                jpyp.from_counts(n[0], H=np.full(4, 0.25)))


@pytest.mark.parametrize("seed", [0, 3, 9])
@pytest.mark.parametrize("mode", ["group", "cat"])
def test_ti_schedule_equal(seed, mode):
    data = tpyp.crp_generate(seed, 3, 10, 30 + seed, 0.5, 5.0)
    np.testing.assert_array_equal(tpyp.ti_schedule(data, mode),
                                  jpyp.ti_schedule(data, mode))


def test_init_state_equal():
    data = tpyp.crp_generate(2, 3, 10, 20, 0.5, 5.0)
    t, T = tpyp.init_state(data, 5, "cpu")
    jt, jT = jpyp.init_state(data, 5)
    assert t.dtype == T.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jT))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _step_uniforms(key, steps, chains, width):
    """The (u1, u2) pairs JAX's TI sweeps draw: one split(key, 3) per
    step.  Shape (steps, 2, chains, width); width 0 = per-item (C,)."""
    shape = (chains, width) if width else (chains,)

    def step(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        return key, jnp.stack([jax.random.uniform(k1, shape, jnp.float64),
                               jax.random.uniform(k2, shape, jnp.float64)])

    return jax.lax.scan(step, key, None, length=steps)[1]


@pytest.fixture(scope="module")
def setup():
    data = tpyp.crp_generate(3, 3, 10, 30, 0.5, 5.0)
    n_max = max(int(data.N.max()) + 2, 16)
    jg = jag.make_grid(n_max, n_max, g=32, dtype=jnp.float64)
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")
    C = 8
    a = np.linspace(0.15, 0.85, C)
    b = np.linspace(0.5, 20.0, C)
    return data, jg, tg, a, b


def _run_both(setup, sweep_j, sweep_t, uniforms, sweeps=5):
    data, jg, tg, a, b = setup
    jt, jT = jpyp.init_state(data, len(a))
    t, T, ta, tb = convert.state_from_numpy(jt, jT, a, b, "cpu")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    moved = False
    for k in range(sweeps):
        key = jax.random.key(100 + k)
        jt2, jT2 = sweep_j(key, jt, jT, ja, jb, jg, data)
        t2, T2 = sweep_t(rng.Replay([uniforms(key)]), t, T, ta, tb, tg, data)
        np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
        np.testing.assert_array_equal(T2.numpy(), np.asarray(jT2))
        moved |= not np.array_equal(np.asarray(jt2), np.asarray(jt))
        jt, jT, t, T = jt2, jT2, t2, T2
    assert moved


@pytest.mark.parametrize("legacy,skip_first", [(False, True), (True, False)])
@pytest.mark.parametrize("mode", ["group", "cat"])
def test_ti_sweep_blocked_equal(setup, legacy, skip_first, mode):
    data = setup[0]
    sched = jpyp.ti_schedule(data, mode)
    S, W = sched.shape
    kw = dict(mode=mode, skip_first=skip_first, legacy_odds=legacy)
    _run_both(
        setup,
        lambda *args: jpyp.ti_sweep_blocked(*args, sched=sched, **kw),
        lambda *args: tpyp.ti_sweep_blocked(*args, sched=sched, **kw),
        lambda key: _step_uniforms(key, S, len(setup[3]), W))


def test_ti_sweep_blocked_with_plan(setup):
    """A TIPlan built once gives the same sweep as the schedule."""
    data, _, tg, a, b = setup
    t, T = tpyp.init_state(data, len(a), "cpu")
    ta, tb = torch.tensor(a), torch.tensor(b)
    sched = tpyp.ti_schedule(data)
    plan = tpyp.ti_plan(data, sched, "cpu")
    r1 = tpyp.ti_sweep_blocked(rng.generator(4, "cpu"), t, T, ta, tb, tg,
                               data, sched=plan)
    r2 = tpyp.ti_sweep_blocked(rng.generator(4, "cpu"), t, T, ta, tb, tg,
                               data)
    assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])
    assert torch.equal(t, tpyp.init_state(data, len(a), "cpu")[0])


@pytest.mark.parametrize("legacy,skip_first", [(False, True), (True, False)])
def test_ti_sweep_equal(setup, legacy, skip_first):
    data = setup[0]
    L = data.data_cat.shape[0]
    kw = dict(skip_first=skip_first, legacy_odds=legacy)
    _run_both(
        setup,
        lambda *args: jpyp.ti_sweep(*args, **kw),
        lambda *args: tpyp.ti_sweep(*args, **kw),
        lambda key: np.asarray(_step_uniforms(key, L, len(setup[3]),
                                              0))[..., None])


@pytest.fixture(scope="module")
def table_setup():
    """One discount's StirlingTable from each package's own make, for all
    chains (b varies); the JAX sweeps take either kind of table through
    ``_vq`` (tests/test_models.py:374-441)."""
    data = tpyp.crp_generate(9, 4, 8, 30, 0.5, 5.0)
    n = int(data.n.max()) + 2
    jt = jst.make(n, n, n + 32, n + 32, 0.5, dtype=jnp.float64)
    tt = tst.make(n, n, n + 32, n + 32, 0.5, dtype=torch.float64,
                  device="cpu")
    C = 8
    return data, jt, tt, np.full(C, 0.5), np.linspace(0.5, 20.0, C)


@pytest.mark.parametrize("legacy,skip_first", [(False, True), (True, False)])
@pytest.mark.parametrize("mode", ["group", "cat"])
def test_ti_sweep_blocked_on_stirling_table(table_setup, legacy, skip_first,
                                            mode):
    data = table_setup[0]
    sched = jpyp.ti_schedule(data, mode)
    S, W = sched.shape
    kw = dict(mode=mode, skip_first=skip_first, legacy_odds=legacy)
    _run_both(
        table_setup,
        lambda *args: jpyp.ti_sweep_blocked(*args, sched=sched, **kw),
        lambda *args: tpyp.ti_sweep_blocked(*args, sched=sched, **kw),
        lambda key: _step_uniforms(key, S, len(table_setup[3]), W))


@pytest.mark.parametrize("legacy,skip_first", [(False, True), (True, False)])
def test_ti_sweep_on_stirling_table(table_setup, legacy, skip_first):
    data = table_setup[0]
    L = data.data_cat.shape[0]
    kw = dict(skip_first=skip_first, legacy_odds=legacy)
    _run_both(
        table_setup,
        lambda *args: jpyp.ti_sweep(*args, **kw),
        lambda *args: tpyp.ti_sweep(*args, **kw),
        lambda key: np.asarray(_step_uniforms(key, L, len(table_setup[3]),
                                              0))[..., None])


def test_table_queries_dispatch(setup, table_setup):
    """_vq / _srelq: the grid at the chains' discounts, a single table at
    its own; the single table's V block is one row shared by the chains."""
    _, _, tg, a, _ = setup
    _, _, tt, _, _ = table_setup
    n = torch.tensor([[5, 9, 12]])
    m = torch.tensor([[2, 4, 12]])
    ta = torch.tensor(a)[:, None]
    assert torch.equal(tpyp._vq(tg, n, m, ta), tg.V(n, m, ta))
    assert torch.equal(tpyp._srelq(tg, n, m, ta), tg.Srel(n, m, ta))
    assert torch.equal(tpyp._vq(tt, n, m, ta), tt.V(n, m))
    assert torch.equal(tpyp._srelq(tt, n, m, ta), tt.Srel(n, m))
    assert tpyp._vq(tt, n, m, ta).shape == (1, 3)
