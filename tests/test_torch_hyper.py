"""Port parity: the hyperparameter layer beyond the slice main path
(libstb_tpu_torch.samplers.hyper with kernel="ars", the table-
configuration route, the rebuild oracle, AGridTable.data_curve_sparse) vs
libstb_tpu.samplers.hyper and libstb_tpu.core.agrid, on the CPU in f64.

Inputs come from a numpy seed; the JAX functions' draws are rebuilt from
their key and handed to the port through rng.Replay.  Tolerances:
``_bmax`` rtol 1e-10; ``sample_b`` / ``sample_a`` with kernel="ars",
``sample_a_m`` and ``sample_a_rebuild`` rtol 1e-9 with ``ok`` (and the
ARS ``neval``) equal; ``sample_table_config``'s histogram exactly equal,
on a discount grid and on a single table; ``data_curve_sparse`` rtol 1e-12
against ``data_curve`` and the JAX function.  The distribution-level
tests use a real torch.Generator and Monte-Carlo bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import agrid as jag
from libstb_tpu.core import stirling as jst
from libstb_tpu.samplers import hyper as jhyper
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.samplers import hyper as thyper
from test_torch_ars import _ars_draws
from test_torch_samplers import _sample_b_draws, _slice_draws

torch.set_num_threads(1)


def _port_grid(jg):
    return convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")


def _port_table(jt):
    return convert.table_from_numpy(
        {k: (None if getattr(jt, k) is None else np.asarray(getattr(jt, k)))
         for k in convert.TABLE_ARRAYS},
        {k: getattr(jt, k) for k in convert.TABLE_STATICS}, "cpu")


@pytest.fixture(scope="module")
def grid():
    jg = jag.make_grid(40, 12, g=48, dtype=jnp.float64)
    return jg, _port_grid(jg)


@pytest.fixture(scope="module")
def pairs():
    """tests/test_samplea_m.py's workload: 8 chains x 12 pairs."""
    r = np.random.default_rng(0)
    C, P = 8, 12
    ns = r.integers(1, 30, size=(C, P)).astype(np.int32)
    ts = np.minimum(r.integers(1, 6, size=(C, P)), ns).astype(np.int32)
    T = ts.sum(axis=1, keepdims=True).astype(np.float64)
    return ns, ts, T


# -- sample_b: the Newton mode and the ARS branch ----------------------------

def _b_inputs(C=16):
    r = np.random.default_rng(2)
    a = np.where(np.arange(C) % 5 == 0, 0.0, np.linspace(0.05, 0.9, C))
    b0 = np.exp(r.uniform(np.log(0.02), np.log(400.0), C))
    N = np.array([200.0, 150.0, 0.0])
    T = np.minimum(r.integers(1, 60, (C, 3)), N).astype(np.float64)
    return a, b0, N, T


def test_bmax_equal():
    a, b0, _, T = _b_inputs()
    Q = np.linspace(0.2, 6.0, len(a))
    want = jhyper._bmax(jnp.asarray(b0), jnp.asarray(Q), jnp.asarray(T), 1.1,
                        jnp.asarray(a))
    got = thyper._bmax(torch.tensor(b0), torch.tensor(Q), torch.tensor(T), 1.1,
                       torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    assert ((got >= thyper.B_MIN) & (got <= thyper.B_MAX)).all()


def _sample_b_ars_draws(key, b0, N, T, shape_):
    """sample_b's draws with kernel="ars": the auxiliary and conjugate
    draws, then ars_sample's on the fourth key (hyper.py:334)."""
    it = _sample_b_draws(key, b0, N, T, shape_)
    for _ in range(3):
        yield next(it)
    yield from _ars_draws(jax.random.split(key, 4)[3], b0.shape)


def test_sample_b_ars_equal():
    a, b0, N, T = _b_inputs()
    C = len(a)
    key = jax.random.key(6)
    jb, jok, jnev = jhyper.sample_b(
        key, jnp.asarray(b0), jnp.asarray(N), jnp.asarray(T), jnp.asarray(a),
        1.1, 20.0, kernel="ars", with_info=True)
    NC = np.broadcast_to(N, (C, 3))
    tb, tok, tnev = thyper.sample_b(
        rng.Replay(_sample_b_ars_draws(key, b0, NC, T, 1.1)),
        torch.tensor(b0), torch.tensor(N), torch.tensor(T), torch.tensor(a),
        1.1, 20.0, kernel="ars", with_info=True)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tnev.numpy(), np.asarray(jnev))
    assert (tnev[torch.tensor(a) == 0] == 0).all() and tnev.max() >= 7
    # without with_info: the same two values
    tb2, tok2 = thyper.sample_b(
        rng.Replay(_sample_b_ars_draws(key, b0, NC, T, 1.1)),
        torch.tensor(b0), torch.tensor(N), torch.tensor(T), torch.tensor(a),
        1.1, 20.0, kernel="ars")
    assert torch.equal(tb, tb2) and torch.equal(tok, tok2)


def test_sample_b_slice_with_info():
    a, b0, N, T = _b_inputs()
    out = thyper.sample_b(rng.generator(0, "cpu"), torch.tensor(b0),
                          torch.tensor(N), torch.tensor(T), torch.tensor(a),
                          1.1, 20.0, with_info=True)
    ref = thyper.sample_b(rng.generator(0, "cpu"), torch.tensor(b0),
                          torch.tensor(N), torch.tensor(T), torch.tensor(a),
                          1.1, 20.0)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert out[2].dtype == torch.int32 and not out[2].any()


def test_unknown_kernel_raises():
    a, b0, N, T = _b_inputs(4)
    with pytest.raises(ValueError, match="hmc"):
        thyper.sample_b(rng.generator(0, "cpu"), torch.tensor(b0),
                        torch.tensor(N), torch.tensor(T), torch.tensor(a),
                        1.1, 20.0, kernel="hmc")


# -- sample_a: ARS and the streamed curve ------------------------------------

def _a_inputs(pairs, shared):
    ns, ts, T = pairs
    C = ns.shape[0]
    a0 = np.linspace(0.005, 0.99, C)
    b = np.linspace(0.5, 30.0, C)[:, None]
    return (ns[0] if shared else ns), ts, T, a0, b


@pytest.mark.parametrize("shared", [True, False])
def test_sample_a_ars_equal(grid, pairs, shared):
    jg, tg = grid
    ns, ts, T, a0, b = _a_inputs(pairs, shared)
    ts = np.minimum(ts, ns)
    key = jax.random.key(11)
    ja, jok = jhyper.sample_a(key, jnp.asarray(a0), jg, jnp.asarray(ns),
                              jnp.asarray(ts), jnp.asarray(T), jnp.asarray(b),
                              kernel="ars")
    ta, tok = thyper.sample_a(rng.Replay(_ars_draws(key, a0.shape)),
                              torch.tensor(a0), tg, torch.tensor(ns),
                              torch.tensor(ts), torch.tensor(T),
                              torch.tensor(b), kernel="ars")
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.all() and not np.allclose(ta.numpy(), a0)


@pytest.mark.parametrize("kernel", ["slice", "ars"])
def test_sample_a_sparse_chunk_equal(grid, pairs, kernel):
    """A forced chunk that does not divide the 12 pairs: equal to the JAX
    sampler on its scan route and to the port's dense route."""
    jg, tg = grid
    ns, ts, T, a0, b = _a_inputs(pairs, True)
    ts = np.minimum(ts, ns)
    key = jax.random.key(12)
    draws = _slice_draws if kernel == "slice" else _ars_draws
    ja, _ = jhyper.sample_a(key, jnp.asarray(a0), jg, jnp.asarray(ns),
                            jnp.asarray(ts), jnp.asarray(T), jnp.asarray(b),
                            kernel=kernel, sparse_chunk=5)
    args = (torch.tensor(a0), tg, torch.tensor(ns), torch.tensor(ts),
            torch.tensor(T), torch.tensor(b))
    ta, _ = thyper.sample_a(rng.Replay(draws(key, a0.shape)), *args,
                            kernel=kernel, sparse_chunk=5)
    td, _ = thyper.sample_a(rng.Replay(draws(key, a0.shape)), *args,
                            kernel=kernel)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_allclose(ta.numpy(), td.numpy(), rtol=1e-9)


@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("batched,weighted", [(False, False), (True, False),
                                              (True, True)])
def test_data_curve_sparse_equal(grid, chunk, batched, weighted):
    jg, tg = grid
    r = np.random.default_rng(4)
    P = 203
    ns = r.integers(0, 41, P)
    ts = np.minimum(r.integers(0, 13, (5, P) if batched else (P,)),
                    np.maximum(ns, 1))
    w = r.uniform(0.0, 2.0, ts.shape) if weighted else None
    got = tg.data_curve_sparse(torch.tensor(ns), torch.tensor(ts),
                               None if w is None else torch.tensor(w),
                               chunk=chunk)
    dense = tg.data_curve(torch.tensor(ns), torch.tensor(ts),
                          None if w is None else torch.tensor(w))
    want = jg.data_curve_sparse(jnp.asarray(ns), jnp.asarray(ts),
                                None if w is None else jnp.asarray(w),
                                chunk=chunk)
    assert got.shape == dense.shape == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_sample_a_streams_from_2_18_pairs(grid, monkeypatch):
    """From 2^18 pairs sample_a takes the streamed curve in chunks of
    2^16 (hyper.py:105-108); below, the dense one."""
    _, tg = grid
    calls = []
    sparse = tag.AGridTable.data_curve_sparse

    def spy(self, ns, ts, weights=None, chunk=65536):
        calls.append((ns.shape[-1], chunk))
        return sparse(self, ns, ts, weights, chunk)

    monkeypatch.setattr(tag.AGridTable, "data_curve_sparse", spy)
    r = np.random.default_rng(5)
    for P in ((1 << 18) - 1, 1 << 18):
        ns = torch.tensor(r.integers(2, 41, P))
        ts = torch.minimum(torch.tensor(r.integers(1, 13, P)), ns)
        a, ok = thyper.sample_a(rng.generator(0, "cpu"),
                                torch.full((2,), 0.5, dtype=torch.float64),
                                tg, ns, ts, torch.full((2, 1), 9.0), [2.0])
        assert ok.all()
    assert calls == [(1 << 18, 1 << 16)]


# -- the table-configuration route -------------------------------------------

def _config_draws(key, shape, steps):
    """sample_table_config's Gumbel blocks: one split per peel step
    (hyper.py:226-227)."""
    for _ in range(steps):
        key, kg = jax.random.split(key)
        yield np.asarray(jax.random.gumbel(kg, shape, jnp.float64))


def _check_bookkeeping(hist, ns, ts):
    """tests/test_samplea_m.py:24-53: customers and tables per chain."""
    hist = np.asarray(hist)
    active = (ts > 1) & (ts < ns)
    t1 = ts == 1
    sizes = np.arange(hist.shape[1])
    np.testing.assert_array_equal((hist * sizes).sum(1),
                                  (ns * (active | t1)).sum(1))
    np.testing.assert_array_equal(hist.sum(1),
                                  (ts * active).sum(1) + t1.sum(1))


@pytest.mark.parametrize("a_val", [0.5, 0.3])
def test_table_config_equal_on_a_grid(grid, pairs, a_val):
    jg, tg = grid
    ns, ts, _ = pairs
    C, P = ns.shape
    a = np.linspace(a_val - 0.2, a_val + 0.2, C)
    key = jax.random.key(0)
    want = jhyper.sample_table_config(key, jg, jnp.asarray(ns),
                                      jnp.asarray(ts), jnp.asarray(a),
                                      max_t=8, max_n=40)
    got = thyper.sample_table_config(
        rng.Replay(_config_draws(key, (C, P, 40), 7)), tg, torch.tensor(ns),
        torch.tensor(ts), torch.tensor(a), max_t=8, max_n=40)
    assert got.dtype == torch.float64 and got.shape == (C, 41)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_bookkeeping(got.numpy(), ns, ts)


def test_table_config_equal_on_a_single_table(pairs):
    """A StirlingTable at one discount, carried over from the JAX make."""
    ns, ts, _ = pairs
    C, P = ns.shape
    jt = jst.make(40, 12, 64, 16, 0.4, dtype=jnp.float64)
    tt = _port_table(jt)
    a = np.full(C, 0.4)
    key = jax.random.key(1)
    want = jhyper.sample_table_config(key, jt, jnp.asarray(ns),
                                      jnp.asarray(ts), jnp.asarray(a),
                                      max_t=8, max_n=40)
    got = thyper.sample_table_config(
        rng.Replay(_config_draws(key, (C, P, 40), 7)), tt, torch.tensor(ns),
        torch.tensor(ts), torch.tensor(a), max_t=8, max_n=40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_bookkeeping(got.numpy(), ns, ts)
    # the port's own make gives the same table, so the same configuration
    own = tst.make(40, 12, 64, 16, 0.4, dtype=torch.float64, device="cpu")
    got2 = thyper.sample_table_config(
        rng.Replay(_config_draws(key, (C, P, 40), 7)), own, torch.tensor(ns),
        torch.tensor(ts), torch.tensor(a), max_t=8, max_n=40)
    assert torch.equal(got, got2)


def test_table_config_checks_its_bounds(grid, pairs):
    _, tg = grid
    ns, ts, _ = pairs
    a = torch.full((ns.shape[0],), 0.5, dtype=torch.float64)
    gen = rng.generator(0, "cpu")
    with pytest.raises(ValueError, match="max_t=5"):
        thyper.sample_table_config(gen, tg, torch.tensor(ns),
                                   torch.tensor(ts), a, max_t=5, max_n=40)
    with pytest.raises(ValueError, match="max_n=20"):
        thyper.sample_table_config(gen, tg, torch.tensor(ns),
                                   torch.tensor(ts), a, max_t=8, max_n=20)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_table_config_bookkeeping_with_a_generator(grid, pairs, dtype):
    """Real draws: the closed forms hold for every chain in f64 and f32
    (counts below 2^24 are exact in f32)."""
    _, tg = grid
    ns, ts, _ = pairs
    if dtype == torch.float32:
        tg = tag.make_grid(40, 12, g=48, dtype=dtype, device="cpu")
    a = torch.linspace(0.1, 0.9, ns.shape[0], dtype=dtype)
    hist = thyper.sample_table_config(rng.generator(3, "cpu"), tg,
                                      torch.tensor(ns), torch.tensor(ts), a,
                                      max_t=8, max_n=40)
    assert hist.dtype == dtype
    _check_bookkeeping(hist.double().numpy(), ns, ts)


@pytest.mark.parametrize("table", ["grid", "single"])
def test_sample_a_m_equal(grid, pairs, table):
    ns, ts, T = pairs
    C, P = ns.shape
    b = np.full((C, 1), 5.0)
    if table == "grid":
        jt, tt = grid
        a0 = np.linspace(0.2, 0.8, C)
    else:
        jt = jst.make(40, 12, 64, 16, 0.45, dtype=jnp.float64)
        tt = _port_table(jt)
        a0 = np.full(C, 0.45)
    key = jax.random.key(2)
    kc, ks = jax.random.split(key)

    def draws():
        yield from _config_draws(kc, (C, P, 40), 7)
        yield from _slice_draws(ks, (C,))

    ja, jok = jhyper.sample_a_m(key, jnp.asarray(a0), jt, jnp.asarray(ns),
                                jnp.asarray(ts), jnp.asarray(T),
                                jnp.asarray(b), max_t=8, max_n=40)
    ta, tok = thyper.sample_a_m(rng.Replay(draws()), torch.tensor(a0), tt,
                                torch.tensor(ns), torch.tensor(ts),
                                torch.tensor(T), torch.tensor(b), max_t=8,
                                max_n=40)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not np.allclose(ta.numpy(), a0)


def test_sample_a_rebuild_equal():
    r = np.random.default_rng(7)
    ns = r.integers(1, 30, 14)
    ts = np.minimum(r.integers(1, 7, 14), ns)
    C = 6
    a0 = np.linspace(0.1, 0.9, C)
    T = np.full((C, 1), float(ts.sum()))
    b = np.full((C, 1), 3.0)
    key = jax.random.key(3)
    ja, jok = jhyper.sample_a_rebuild(key, jnp.asarray(a0), jnp.asarray(ns),
                                      jnp.asarray(ts), jnp.asarray(T),
                                      jnp.asarray(b), n_max=32, m_max=8)
    ta, tok = thyper.sample_a_rebuild(rng.Replay(_slice_draws(key, (C,))),
                                      torch.tensor(a0), torch.tensor(ns),
                                      torch.tensor(ts), torch.tensor(T),
                                      torch.tensor(b), n_max=32, m_max=8)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # a single chain given as a number
    t1, _ = thyper.sample_a_rebuild(rng.generator(0, "cpu"), 0.5,
                                    torch.tensor(ns), torch.tensor(ts),
                                    [float(ts.sum())], [3.0], n_max=32,
                                    m_max=8)
    assert t1.shape == (1,) and t1.dtype == torch.float64


# -- distribution level: two kernels, two routes, one posterior --------------

def test_sample_b_ars_matches_slice():
    """tests/test_samplers.py:139-162 with torch generators: 8 moves of
    2048 chains by either kernel, means within 4 SE + 0.02."""
    C = 2048
    N = torch.tensor([200.0, 150.0], dtype=torch.float64)
    T = torch.tensor([40.0, 35.0], dtype=torch.float64)
    a = torch.full((C,), 0.5, dtype=torch.float64)
    outs = {}
    for seed, kernel in ((4, "slice"), (3, "ars")):
        gen = rng.generator(seed, "cpu")
        b = torch.full((C,), 5.0, dtype=torch.float64)
        for _ in range(8):
            b, ok = thyper.sample_b(gen, b, N, T, a, 1.1, 20.0, kernel=kernel)
        assert ok.all()
        outs[kernel] = b.numpy()
    se = np.hypot(outs["slice"].std() / np.sqrt(C),
                  outs["ars"].std() / np.sqrt(C))
    assert abs(outs["slice"].mean() - outs["ars"].mean()) < 4 * se + 0.02


def test_sample_a_ars_matches_slice():
    """tests/test_samplers.py:165-191 with torch generators."""
    r = np.random.default_rng(0)
    C, P = 1024, 10
    ns = r.integers(2, 28, P)
    ts = np.maximum(1, (ns * 0.4).astype(np.int64))
    T = torch.full((C, 1), float(ts.sum()), dtype=torch.float64)
    b = torch.full((C, 1), 5.0, dtype=torch.float64)
    g = tag.make_grid(32, 12, g=48, dtype=torch.float64, device="cpu")
    outs = {}
    for seed, kernel in ((8, "slice"), (7, "ars")):
        gen = rng.generator(seed, "cpu")
        a = torch.full((C,), 0.5, dtype=torch.float64)
        for _ in range(8):
            a, ok = thyper.sample_a(gen, a, g, torch.tensor(ns),
                                    torch.tensor(ts), T, b, kernel=kernel)
        outs[kernel] = a.numpy()
    se = np.hypot(outs["slice"].std() / np.sqrt(C),
                  outs["ars"].std() / np.sqrt(C))
    assert abs(outs["slice"].mean() - outs["ars"].mean()) < 4 * se + 0.005


@pytest.mark.parametrize("table", ["grid", "single"])
def test_config_route_agrees_with_grid_route(table):
    """tests/test_samplea_m.py:56-87: sample_a_m (on the grid, or on a
    single table remade at the chains' common discount each step) and
    sample_a on the grid converge to one posterior over a."""
    r = np.random.default_rng(3)
    C, P = 64, 16
    ns = r.integers(2, 25, P)
    ts = np.maximum(1, (ns * 0.4).astype(np.int64))
    nsb = torch.tensor(np.broadcast_to(ns, (C, P)).copy())
    tsb = torch.tensor(np.broadcast_to(ts, (C, P)).copy())
    T = torch.full((C, 1), float(ts.sum()), dtype=torch.float64)
    b = torch.full((C, 1), 5.0, dtype=torch.float64)
    g = tag.make_grid(32, 12, g=64, dtype=torch.float64, device="cpu")

    gen = rng.generator(10, "cpu")
    a_grid = torch.full((C,), 0.5, dtype=torch.float64)
    for _ in range(15):
        a_grid, _ = thyper.sample_a(gen, a_grid, g, torch.tensor(ns),
                                    torch.tensor(ts), T, b)
    gen = rng.generator(20, "cpu")
    a_m = torch.full((C,), 0.5, dtype=torch.float64)
    tab = tst.make(32, 12, 32, 12, 0.5, dtype=torch.float64, device="cpu")
    for _ in range(15):
        if table == "grid":
            a_m, _ = thyper.sample_a_m(gen, a_m, g, nsb, tsb, T, b, max_t=12,
                                       max_n=32)
        else:
            # a single table serves one discount: remade at each chain's
            tabs = [tst.remake(tab, float(x)) for x in a_m]
            a_m = torch.cat([thyper.sample_a_m(
                gen, a_m[c:c + 1], tabs[c], nsb[c:c + 1], tsb[c:c + 1],
                T[c:c + 1], b[c:c + 1], max_t=12, max_n=32)[0]
                for c in range(C)])
    a_grid, a_m = a_grid.numpy(), a_m.numpy()
    se = np.sqrt(a_grid.var() / C + a_m.var() / C)
    assert abs(a_grid.mean() - a_m.mean()) < 3 * se + 0.01
