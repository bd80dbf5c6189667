"""Port parity: libstb_tpu_torch.core.agrid vs libstb_tpu.core.agrid.

make_grid is compared elementwise (both f64 fills); the queries run on
identical tables carried across by convert.grid_from_numpy, so only the
query arithmetic is compared.  In-table queries are pure arithmetic in
the same order (rtol 1e-12); asymptote branches go through lgamma, which
differs between XLA and torch in the last bits (rtol 1e-11)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import agrid as jag
from libstb_tpu.utils.yaps import LibstbError as JaxLibstbError
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.parallel import mesh as pmesh
from libstb_tpu_torch.utils.yaps import LibstbError

torch.set_num_threads(1)


def _carry(jgrid):
    arrays = {k: None if getattr(jgrid, k) is None
              else np.asarray(getattr(jgrid, k))
              for k in convert.GRID_ARRAYS}
    statics = {k: getattr(jgrid, k) for k in convert.GRID_STATICS}
    return convert.grid_from_numpy(arrays, statics, "cpu")


@pytest.fixture(scope="module")
def grids():
    jg = jag.make_grid(200, 60, g=100, dtype=jnp.float64)
    return jg, _carry(jg)


def _queries():
    rng = np.random.default_rng(11)
    n = rng.integers(-1, 320, 400)              # beyond n_max=200 too
    m = rng.integers(-1, 90, 400)               # beyond m_max=60 too
    m[:40] = n[:40]                             # n == m identities
    m[40:80] = 1                                # S1 column
    a = rng.uniform(0.01, 0.98, 400)
    return n, m, a


@pytest.mark.parametrize("q", ["S", "Srel", "V", "U"])
def test_queries_match_jax(grids, q):
    jg, tg = grids
    n, m, a = _queries()
    want = np.asarray(getattr(jg, q)(jnp.asarray(n), jnp.asarray(m),
                                     jnp.asarray(a)))
    got = getattr(tg, q)(torch.tensor(n), torch.tensor(m),
                         torch.tensor(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    inside = (n >= 1) & (n <= 200) & (m <= 60)
    np.testing.assert_allclose(got[fin & inside], want[fin & inside],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-11, atol=1e-12)


def test_s1_matches_jax(grids):
    jg, tg = grids
    n, _, a = _queries()
    want = np.asarray(jg.S1(jnp.asarray(n), jnp.asarray(a)))
    got = tg.S1(torch.tensor(n), torch.tensor(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-11)


def test_per_chain_broadcast(grids):
    """(C, 1) discounts against (W,) queries, as the sweeps call V."""
    jg, tg = grids
    a = np.array([[0.11], [0.42], [0.73]])
    n = np.array([50, 80, 120, 7])
    m = np.array([8, 2, 40, 7])
    want = np.asarray(jg.V(jnp.asarray(n), jnp.asarray(m), jnp.asarray(a)))
    got = tg.V(torch.tensor(n), torch.tensor(m), torch.tensor(a)).numpy()
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_make_grid_matches_jax():
    jg = jag.make_grid(120, 40, g=24, dtype=jnp.float64, max_n=256,
                       max_m=64, tag="t")
    tg = tag.make_grid(120, 40, g=24, dtype=torch.float64, device="cpu",
                       max_n=256, max_m=64, tag="t")
    for k in ("a0", "da", "g_max", "n_max", "m_max", "max_n", "max_m",
              "use_asympt", "tag"):
        assert getattr(tg, k) == getattr(jg, k), k
    for k in ("avec", "s1_hi", "s1_lo"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)))
    for k in ("vtab", "srel"):
        x, y = getattr(tg, k).numpy(), np.asarray(getattr(jg, k))
        np.testing.assert_array_equal(np.isinf(x), np.isinf(y))
        fin = np.isfinite(y)
        np.testing.assert_allclose(x[fin], y[fin], rtol=1e-12, atol=1e-12)
    assert tg.report().split(" mem=")[0] == jg.report().split(" mem=")[0]


def test_make_grid_f32_split():
    """f32 tables keep S1 as an f64-accurate hi/lo pair."""
    jg = jag.make_grid(64, 16, g=8, dtype=jnp.float32)
    tg = tag.make_grid(64, 16, g=8, device="cpu")
    assert tg.vtab.dtype == tg.s1_lo.dtype == torch.float32
    np.testing.assert_array_equal(tg.s1_hi.numpy(), np.asarray(jg.s1_hi))
    np.testing.assert_array_equal(tg.s1_lo.numpy(), np.asarray(jg.s1_lo))
    fin = np.isfinite(np.asarray(jg.vtab)) & (np.asarray(jg.vtab) > 0)
    np.testing.assert_allclose(tg.vtab.numpy()[fin],
                               np.asarray(jg.vtab)[fin], rtol=2e-5)


def test_data_curve_matches_both_jax_routes(grids):
    """The port's gather route against JAX's gather and one-hot-matmul
    routes: shared ns with per-chain ts, t == n beyond m_max, n <= 1."""
    jg, tg = grids
    rng = np.random.default_rng(2)
    P, C = 30, 5
    ns = rng.integers(0, 150, P)
    ts = np.minimum(rng.integers(1, 60, (C, P)), np.maximum(ns, 1)[None])
    ns[0], ts[:, 0] = 90, 90                  # all-singleton pair, n > m_max
    got = tg.data_curve(torch.tensor(ns), torch.tensor(ts)).numpy()
    gather = np.asarray(jg._data_curve_gather(jnp.asarray(ns),
                                              jnp.asarray(ts)))
    mm = np.asarray(jg._data_curve_mm(jnp.asarray(ns), jnp.asarray(ts)))
    assert got.shape == gather.shape == mm.shape == (C, 100)
    np.testing.assert_allclose(got, gather, rtol=1e-12)
    np.testing.assert_allclose(got, mm, rtol=1e-10)
    w = rng.uniform(0.5, 2.0, (C, P))
    np.testing.assert_allclose(
        tg.data_curve(torch.tensor(ns), torch.tensor(ts),
                      torch.tensor(w)).numpy(),
        np.asarray(jg.data_curve(jnp.asarray(ns), jnp.asarray(ts),
                                 jnp.asarray(w))), rtol=1e-10)
    one = tg.data_curve(torch.tensor(ns), torch.tensor(ts[0])).numpy()
    np.testing.assert_allclose(one, np.asarray(jg.data_curve(
        jnp.asarray(ns), jnp.asarray(ts[0]))), rtol=1e-12)


def _mm_inputs(case, rng):
    """Shared (P,) counts and (C, P) tables with t == n beyond m_max
    (60), an all-singleton pair past it, n <= 1 and t == 1; ``case``
    "weights" adds (C, P) weights, "single" takes one (P,) row of ts."""
    P, C = 37, 6
    ns = rng.integers(0, 190, P)
    ts = np.minimum(rng.integers(1, 60, (C, P)), np.maximum(ns, 1)[None])
    ns[:4] = [90, 150, 1, 0]
    ts[:, 0], ts[:, 1], ts[:, 2], ts[:, 3] = 90, 1, 1, 0
    ts[0, 4:8] = ns[4:8]                       # t == n, some past m_max
    w = rng.uniform(0.5, 2.0, (C, P)) if case == "weights" else None
    return ns, (ts[1] if case == "single" else ts), w


@pytest.mark.parametrize("case", ["chains", "weights", "single"])
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10),
                                        ("float32", 1e-5)])
def test_data_curve_mm_matches_jax(case, dtype, rtol):
    """The port's one-hot route against JAX's _data_curve_mm (and the
    gather route) on identical tables."""
    jg = jag.make_grid(200, 60, g=40, dtype=getattr(jnp, dtype))
    tg = _carry(jg)
    ns, ts, w = _mm_inputs(case, np.random.default_rng(8))
    want = np.asarray(jg._data_curve_mm(
        jnp.asarray(ns), jnp.asarray(ts), None if w is None
        else jnp.asarray(w, getattr(jnp, dtype))))
    args = (torch.tensor(ns), torch.tensor(ts),
            None if w is None else torch.tensor(w, dtype=tg.srel.dtype))
    got = tg._data_curve_mm(*args)
    assert got.dtype == tg.srel.dtype
    assert tuple(got.shape) == want.shape == ts.shape[:-1] + (40,)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    np.testing.assert_allclose(got.numpy(), tg._data_curve_gather(
        *args).numpy(), rtol=rtol)


def test_data_curve_mm_chunks_sum_to_one_chunk(grids, monkeypatch):
    """A byte budget that forces many chunks, the last one short, gives
    the one-chunk result."""
    _, tg = grids
    ns, ts, w = _mm_inputs("weights", np.random.default_rng(9))
    args = (torch.tensor(ns), torch.tensor(ts), torch.tensor(w))
    whole = tg._data_curve_mm(*args)
    C, G, M = ts.shape[0], tg.g_max, tg.m_max
    assert tag.MM_BUDGET // (8 * M * max(C, G)) >= ns.shape[0]
    monkeypatch.setattr(tag, "MM_BUDGET", 8 * M * max(C, G) * 5)
    assert ns.shape[0] % 5
    chunked = tg._data_curve_mm(*args)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="counts the chains share"):
        tg._data_curve_mm(torch.tensor(ts), torch.tensor(ts))


def test_data_curve_sparse_takes_the_gather_route(grids, monkeypatch):
    """data_curve_sparse sums _data_curve_gather over its chunks, as the
    JAX function's scan does, and never goes through data_curve."""
    jg, tg = grids
    rng = np.random.default_rng(10)
    ns = rng.integers(0, 150, 50)
    ts = np.minimum(rng.integers(1, 60, (3, 50)), np.maximum(ns, 1)[None])
    calls = []
    gather = tag.AGridTable._data_curve_gather

    def spy(self, ns, ts, weights=None):
        calls.append(ns.shape[-1])
        return gather(self, ns, ts, weights)

    def refuse(self, *args, **kw):
        raise AssertionError("data_curve_sparse called data_curve")

    monkeypatch.setattr(tag.AGridTable, "_data_curve_gather", spy)
    monkeypatch.setattr(tag.AGridTable, "data_curve", refuse)
    got = tg.data_curve_sparse(torch.tensor(ns), torch.tensor(ts), chunk=16)
    assert calls == [16, 16, 16, 2]
    want = np.asarray(jg.data_curve_sparse(jnp.asarray(ns), jnp.asarray(ts),
                                           chunk=16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_curve_at_matches_jax(grids):
    jg, tg = grids
    rng = np.random.default_rng(4)
    curve = rng.normal(size=(6, 100)) * 50
    a = rng.uniform(0.01, 0.98, 6)
    np.testing.assert_allclose(
        tg.curve_at(torch.tensor(curve), torch.tensor(a)).numpy(),
        np.asarray(jg.curve_at(jnp.asarray(curve), jnp.asarray(a))),
        rtol=1e-12)
    np.testing.assert_allclose(
        float(tg.curve_at(torch.tensor(curve[0]), 0.437)),
        float(jg.curve_at(jnp.asarray(curve[0]), 0.437)), rtol=1e-12)


def test_identities_and_out_of_grid(grids):
    """tests/test_agrid.py:49-80 on the port: identities, the asymptote
    past n_max, exact S1 past the rows, never a clamped value."""
    jg, tg = grids
    assert float(tg.S(6, 6, 0.3)) == 0.0
    assert np.isneginf(float(tg.S(4, 9, 0.3)))
    assert float(tg.V(10, 1, 0.3)) == 0.0
    from scipy.special import gammaln
    np.testing.assert_allclose(float(tg.S(9, 1, 0.42)),
                               gammaln(9 - 0.42) - gammaln(1 - 0.42),
                               rtol=1e-7)
    for q, n, m in (("S", 500, 40), ("V", 500, 40), ("S", 150, 90)):
        np.testing.assert_allclose(float(getattr(tg, q)(n, m, 0.5)),
                                   float(getattr(jg, q)(n, m, 0.5)),
                                   rtol=1e-11)
    assert abs(float(tg.S(500, 40, 0.5)) - float(tg.S(200, 40, 0.5))) > 100
    assert float(tg.S(150, 90, 0.5)) != float(tg.S(150, 60, 0.5))
    np.testing.assert_allclose(float(tg.S1(500, 0.42)),
                               gammaln(500 - 0.42) - gammaln(1 - 0.42),
                               rtol=1e-10)


def test_out_of_grid_without_asymptote():
    jg = jag.make_grid(64, 16, g=32, dtype=jnp.float64, use_asympt=False)
    tg = _carry(jg)
    assert np.isneginf(float(tg.S(200, 8, 0.3)))
    assert float(tg.V(200, 8, 0.3)) == 0.0
    assert float(tg.S(200, 200, 0.3)) == 0.0
    assert float(tg.S(200, 1, 0.3)) != -np.inf
    np.testing.assert_allclose(float(tg.S(200, 1, 0.3)),
                               float(jg.S(200, 1, 0.3)), rtol=1e-12)


def test_positive_a0_branch():
    """a0 > 0 selects the a > 0 asymptote statically, as in JAX."""
    jg = jag.make_grid(64, 16, g=32, a_lo=0.05, a_hi=0.95,
                       dtype=jnp.float64)
    tg = _carry(jg)
    assert tg._a_sign == jg._a_sign == "pos"
    for q in ("S", "Srel", "V"):
        np.testing.assert_allclose(float(getattr(tg, q)(300, 9, 0.41)),
                                   float(getattr(jg, q)(300, 9, 0.41)),
                                   rtol=1e-11)


def test_grow_bucket_and_required_dims():
    for used in (16, 32, 48, 100, 512, 1000):
        for want in (1, used, used + 1, used + 49, 2 * used, 7 * used + 3):
            assert tag._grow_bucket(used, want) == jag._grow_bucket(used,
                                                                    want)
    n = np.array([[3, 0, 17], [5, 40, 1]])
    assert tag.required_dims(n) == jag.required_dims(n)
    assert tag.required_dims(n, np.array([[60]])) == jag.required_dims(
        n, np.array([[60]]))


def test_ensure_grid_matches_jax():
    jg = jag.make_grid(32, 16, g=32, dtype=jnp.float64, max_n=256, max_m=64)
    tg = tag.make_grid(32, 16, g=32, dtype=torch.float64, device="cpu",
                       max_n=256, max_m=64)
    for n, m in ((100, 40), (10_000, 10_000), (20, 10)):
        j2, t2 = jag.ensure_grid(jg, n, m), tag.ensure_grid(tg, n, m)
        assert (t2.n_max, t2.m_max) == (j2.n_max, j2.m_max)
        assert (t2.max_n, t2.max_m) == (256, 64)
        fin = np.isfinite(np.asarray(j2.srel))
        np.testing.assert_allclose(t2.srel.numpy()[fin],
                                   np.asarray(j2.srel)[fin], rtol=1e-12,
                                   atol=1e-12)
    assert tag.ensure_grid(tg, 20, 10) is tg
    with pytest.raises(LibstbError):
        tag.ensure_grid(tg, 10_000, 10, quit_on_bound=True)
    with pytest.raises(JaxLibstbError):
        jag.ensure_grid(jg, 10_000, 10, quit_on_bound=True)


@pytest.mark.parametrize("g,a_hi", [(64, 0.99), (48, 0.99), (100, 0.99)])
def test_ensure_grid_f32_refills_make_grids_discounts(g, a_hi):
    """An f32 grid grown by ensure_grid equals make_grid's at the grown
    size, and its host S1 within 1e-12: the refill is at the f64
    discounts (rebuilt from a0 and da, to an ulp), not at the grid's f32
    copy of them, which at a = 0.99 moves S1 by ~1e-6."""
    small = tag.make_grid(16, 16, g=g, a_hi=a_hi, dtype=torch.float32,
                          device="cpu", max_n=512, max_m=512)
    grown = tag.ensure_grid(small, 100, 60)
    fresh = tag.make_grid(grown.n_max, grown.m_max, g=g, a_hi=a_hi,
                          dtype=torch.float32, device="cpu", max_n=512,
                          max_m=512)
    assert (grown.n_max, grown.m_max) == (fresh.n_max, fresh.m_max)
    for k in ("avec", "s1_hi", "vtab", "srel"):
        assert torch.equal(getattr(grown, k), getattr(fresh, k)), k

    def s1(grid):
        return grid.s1_hi.to(torch.float64) + grid.s1_lo.to(torch.float64)
    assert (s1(grown) - s1(fresh)).abs().max() < 1e-12


def test_mesh_fill_equals_plain_fill():
    """The sharded fill is ported (tests/test_torch_parallel.py runs it
    under 2 and 4 processes): on a world of one process a mesh gives the
    plain grid bitwise, and a grid that does not divide by the processes
    raises, as JAX's does."""
    cm = pmesh.chain_mesh(device="cpu")
    a = tag.make_grid(32, 16, g=8, mesh=cm)
    b = tag.make_grid(32, 16, g=8, device="cpu")
    for k in ("avec", "s1_hi", "s1_lo", "vtab", "srel"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    with pytest.raises(ValueError, match="not divisible"):
        tag._fill_shard(np.linspace(0, 0.99, 9), 32, 16, True, True,
                        torch.float32, dataclasses.replace(cm, sizes=(2,)))
