"""Port parity: the check.c sweeps of libstb_tpu_torch.models.pyp (pair-
major TI, CT / CTW, relative-window CTW, item-sequential and pair-major
HSA) vs libstb_tpu.models.pyp on the CPU.

The host copies (ti_pair_layout, ti_pair_stages, init_hsa, init_hsa_pairs)
must be array-equal.  The sweeps run in f64 on identical tables (a
discount grid, and one discount's StirlingTable in the natural and in the
column-major layout) with the draws JAX makes, rebuilt from the sweep's
key by replaying its splits, handed to the port through rng.Replay; the
integer state must then be equal after every sweep.  The statistical
checks of tests/test_models.py and tests/test_hsa.py follow, port against
port with the same bands."""
import dataclasses
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
from libstb_tpu_torch.core import agrid as tag
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.models import pyp as tpyp
from libstb_tpu_torch.utils import yaps

torch.set_num_threads(1)

F64 = jnp.float64


# -- the JAX sweeps' draws, rebuilt from their keys ----------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _round_uniforms(key, rounds, shape, minval):
    """One split(key, 3) a round, two uniforms of ``shape`` from it, as the
    pair-major rounds draw them: ((rounds, 2) + shape, the carried key)."""
    def round_(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        return key, jnp.stack([
            jax.random.uniform(k1, shape, F64, minval=minval),
            jax.random.uniform(k2, shape, F64, minval=minval)])

    key, u = jax.lax.scan(round_, key, None, length=rounds)
    return u, key


def _stage_uniforms(key, stages, chains, minval=0.0):
    """The staged sweeps' draws: one block a stage, the key carried."""
    out = []
    for (p, r0, r1) in stages:
        u, key = _round_uniforms(key, r1 - r0, (chains, p), minval)
        out.append(np.asarray(u))
    return out


@functools.partial(jax.jit, static_argnums=(1, 2))
def _cat_gumbels(key, steps, shape):
    """ct_sweep / ctw_sweep_rel: one split(key) a category, a Gumbel block
    of ``shape`` from it."""
    def cat(key, _):
        key, kg = jax.random.split(key)
        return key, jax.random.gumbel(kg, shape, F64)

    return jax.lax.scan(cat, key, None, length=steps)[1]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _item_gumbels(key, steps, chains, width):
    """hsa_sweep: one split(key, 3) an item, Gumbels of (C, S+1) and (C,
    S+2) from it."""
    def item(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        return key, (jax.random.gumbel(k1, (chains, width), F64),
                     jax.random.gumbel(k2, (chains, width + 1), F64))

    return jax.lax.scan(item, key, None, length=steps)[1]


# -- inputs --------------------------------------------------------------------

def _jax_arrays(t):
    return ({k: (None if getattr(t, k) is None else np.asarray(getattr(t, k)))
             for k in convert.TABLE_ARRAYS},
            {k: getattr(t, k) for k in convert.TABLE_STATICS})


def _as_cols(t):
    """The same table in the port's column-major layout (K3's)."""
    return dataclasses.replace(t, vtab=t.vtab.T.contiguous(),
                               srel=t.srel.T.contiguous(), cols=True)


DATA = (3, 3, 10, 30, 0.5, 5.0)        # seed, groups, dim, items, a, b
C = 8


@pytest.fixture(scope="module")
def tables():
    """The same f64 tables in both packages: a discount grid (chains at
    their own a), one a = 0.5 StirlingTable natural and column-major."""
    data = tpyp.crp_generate(*DATA)
    n_max = max(int(data.N.max()) + 2, 16)
    jg = jag.make_grid(n_max, n_max, g=32, dtype=F64)
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")
    n = int(data.n.max()) + 2
    jt = jst.make(n, n, n + 32, n + 32, 0.5, dtype=F64)
    tt = convert.table_from_numpy(*_jax_arrays(jt), device="cpu")
    grid_ab = (np.linspace(0.15, 0.85, C), np.linspace(0.5, 20.0, C))
    tab_ab = (np.full(C, 0.5), np.linspace(0.5, 20.0, C))
    return data, {"grid": (jg, tg, grid_ab), "table": (jt, tt, tab_ab),
                  "cols": (jt, _as_cols(tt), tab_ab)}


def _state(data, ab):
    jt, jT = jpyp.init_state(data, C)
    t, T, a, b = convert.state_from_numpy(jt, jT, *ab, "cpu")
    return (jt, jT, jnp.asarray(ab[0]), jnp.asarray(ab[1])), (t, T, a, b)


def _equal(ours, theirs):
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# -- host copies ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 9])
def test_ti_pair_layout_equal(seed):
    data = tpyp.crp_generate(seed, 4, 12, 25 + seed, 0.5, 3.0)
    for x, y in zip(tpyp.ti_pair_layout(data), jpyp.ti_pair_layout(data)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype == np.int32


@pytest.mark.parametrize("skip_first", [True, False])
@pytest.mark.parametrize("min_pairs", [1, 4, 512])
def test_ti_pair_stages_equal(skip_first, min_pairs):
    for seed in (1, 5):
        nvec = tpyp.ti_pair_layout(tpyp.crp_generate(seed, 6, 20, 80, 0.5,
                                                     10.0))[2]
        o_t, s_t = tpyp.ti_pair_stages(nvec, skip_first, min_pairs)
        o_j, s_j = jpyp.ti_pair_stages(nvec, skip_first, min_pairs)
        np.testing.assert_array_equal(o_t, o_j)
        assert s_t == s_j and len(s_t) >= 1
    for nvec in (np.array([1, 1]), np.array([], np.int32)):
        o_t, s_t = tpyp.ti_pair_stages(nvec, skip_first)
        o_j, s_j = jpyp.ti_pair_stages(nvec, skip_first)
        np.testing.assert_array_equal(o_t, o_j)
        assert s_t == s_j


def test_init_hsa_equal():
    data = tpyp.crp_generate(*DATA)
    for smax in (None, 40):
        h, T = tpyp.init_hsa(data, 5, "cpu", smax=smax)
        jh, jT = jpyp.init_hsa(data, 5, smax=smax)
        assert h.dtype == T.dtype == torch.int32
        _equal((h, T), (jh, jT))
        h2, T2 = convert.hist_from_numpy(jh, jT, "cpu")
        assert torch.equal(h2, h) and torch.equal(T2, T)


@pytest.mark.parametrize("ordered", [False, True])
def test_init_hsa_pairs_equal(ordered):
    data = tpyp.crp_generate(*DATA)
    order = (tpyp.ti_pair_stages(tpyp.ti_pair_layout(data)[2], False)[0]
             if ordered else None)
    hp, T = tpyp.init_hsa_pairs(data, 4, "cpu", order=order)
    _equal((hp, T), jpyp.init_hsa_pairs(data, 4, order=order))
    assert hp.dtype == T.dtype == torch.int32


# -- pair-major TI -------------------------------------------------------------

def _pairs(data, skip_first, min_pairs=4):
    jvec, ivec, nvec = tpyp.ti_pair_layout(data)
    order, stages = tpyp.ti_pair_stages(nvec, skip_first, min_pairs)
    return jvec[order], ivec[order], nvec[order], stages


@pytest.mark.parametrize("legacy,skip_first", [(False, True), (True, False)])
@pytest.mark.parametrize("kind,route", [("grid", "query"),
                                        ("table", "query"),
                                        ("table", "rows"),
                                        ("cols", "query"),
                                        ("cols", "rows")])
def test_ti_sweep_pairs_staged_equal(tables, kind, route, legacy,
                                     skip_first):
    """Staged pair TI on a grid and on both layouts of a table, by the
    point-query route (m_sel = 0) and the row-gather route, against the
    JAX sweep by its point-query route (the same table cells)."""
    data, tabs = tables
    jtab, ttab, ab = tabs[kind]
    jv, iv, nv, stages = _pairs(data, skip_first)
    assert len(stages) >= 2
    m_sel = tpyp.ti_pair_m_sel(ttab, nv) if route == "rows" else 0
    assert (m_sel > 0) == (route == "rows")
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    tp, jtp = t[:, jv, iv], jt[:, jv, iv]
    kw = dict(skip_first=skip_first, legacy_odds=legacy)
    moved = False
    for k in range(3):
        key = jax.random.key(40 + k)
        jtp2, jT = jpyp.ti_sweep_pairs_staged(
            key, jtp, jT, ja, jb, jtab, data, jnp.asarray(jv),
            jnp.asarray(iv), jnp.asarray(nv), stages, **kw)
        tp, T = tpyp.ti_sweep_pairs_staged(
            rng.Replay(_stage_uniforms(key, stages, C)), tp, T, a, b, ttab,
            data, jv, iv, nv, stages, m_sel=m_sel, **kw)
        _equal((tp, T), (jtp2, jT))
        moved |= not np.array_equal(np.asarray(jtp2), np.asarray(jtp))
        jtp = jtp2
    assert moved
    assert torch.equal(torch.zeros_like(T).index_add_(
        1, torch.as_tensor(jv).long(), tp), T)


@pytest.mark.parametrize("kind", ["grid", "table", "cols"])
def test_ti_sweep_pairs_flat_equal(tables, kind):
    """ti_sweep_pairs(staged=False): max-count rounds over all pairs in
    layout order, the dense (C, J, D) state in and out."""
    data, tabs = tables
    jtab, ttab, ab = tabs[kind]
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    layout = tpyp.ti_pair_layout(data)
    steps = int(layout[2].max())
    for k in range(3):
        key = jax.random.key(60 + k)
        jt, jT = jpyp.ti_sweep_pairs(key, jt, jT, ja, jb, jtab, data,
                                     layout=layout, staged=False)
        t, T = tpyp.ti_sweep_pairs(
            rng.Replay([_stage_uniforms(key, [(len(layout[2]), 0, steps)],
                                        C)[0]]),
            t, T, a, b, ttab, data, layout=layout, staged=False)
        _equal((t, T), (jt, jT))


@pytest.mark.parametrize("kind", ["grid", "cols"])
def test_ti_sweep_pairs_wrapper_equal(tables, kind):
    """The staged dense-state wrapper (sorting, m_sel picked for itself)."""
    data, tabs = tables
    jtab, ttab, ab = tabs[kind]
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    stages = _pairs(data, True, 8)[3]
    for k in range(2):
        key = jax.random.key(70 + k)
        jt, jT = jpyp.ti_sweep_pairs(key, jt, jT, ja, jb, jtab, data,
                                     min_pairs=8)
        t, T = tpyp.ti_sweep_pairs(
            rng.Replay(_stage_uniforms(key, stages, C)), t, T, a, b, ttab,
            data, min_pairs=8)
        _equal((t, T), (jt, jT))
    assert (t.sum(-1) == T).all()


def test_stages_mismatch_raises(tables):
    data, tabs = tables
    _, tg, ab = tabs["grid"]
    jv, iv, nv, stages = _pairs(data, skip_first=False)
    _, (t, T, a, b) = _state(data, ab)
    with pytest.raises(ValueError, match="skip_first"):
        tpyp.ti_sweep_pairs_staged(rng.generator(0, "cpu"), t[:, jv, iv], T,
                                   a, b, tg, data, jv, iv, nv, stages,
                                   skip_first=True)
    with pytest.raises(ValueError, match="skip_first=False"):
        tpyp.hsa_sweep_pairs_staged(rng.generator(0, "cpu"), None, T, a, b,
                                    data, jv, iv, nv, _pairs(data, True)[3])


def test_m_sel_gates(tables):
    """ti_pair_m_sel / ctw_m_sel as the JAX gates on a natural table, the
    same on the column-major one (which JAX's scan_chunks layout is not),
    0 on a grid, on a table too short or too narrow, and past ``cap``."""
    data, tabs = tables
    jt, tt, _ = tabs["table"]
    nvec = tpyp.ti_pair_layout(data)[2]
    for tab in (tt, tabs["cols"][1]):
        assert tpyp.ti_pair_m_sel(tab, nvec) == jpyp.ti_pair_m_sel(
            jt, nvec) == int(nvec.max()) + 1
        assert tpyp.ctw_m_sel(tab, data) == jpyp.ctw_m_sel(jt, data)
        assert tpyp.ti_pair_m_sel(tab, nvec, cap=4) == 0
    assert tpyp.ti_pair_m_sel(tabs["grid"][1], nvec) == 0
    assert tpyp.ctw_m_sel(tabs["grid"][1], data) == 0
    small = tst.make(8, 8, 64, 64, 0.5, dtype=torch.float64, device="cpu")
    assert tpyp.ti_pair_m_sel(small, nvec) == tpyp.ctw_m_sel(small, data) == 0
    assert tpyp.ti_pair_m_sel(dataclasses.replace(tt, vtab=None), nvec) == 0
    assert tpyp.ctw_m_sel(dataclasses.replace(tt, srel=None), data) == 0


# -- collapsed-table sweeps ----------------------------------------------------

@pytest.mark.parametrize("window,maxrel", [(None, None), (3, None),
                                           (None, 1e30), (None, 1e6),
                                           (2, 1e6)])
@pytest.mark.parametrize("kind", ["grid", "table", "cols"])
def test_ct_sweep_equal(tables, kind, window, maxrel):
    data, tabs = tables
    jtab, ttab, ab = tabs[kind]
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    J, D = data.n.shape
    tmax = int(data.n.max()) + 1
    for k in range(3):
        key = jax.random.key(80 + k)
        jt, jT = jpyp.ct_sweep(key, jt, jT, ja, jb, jtab, data, tmax,
                               window=window, maxrel=maxrel)
        t, T = tpyp.ct_sweep(
            rng.Replay([_cat_gumbels(key, D, (C * J, tmax))]), t, T, a, b,
            ttab, data, tmax, window=window, maxrel=maxrel)
        _equal((t, T), (jt, jT))


def test_ct_sweep_per_chain_counts_equal(tables):
    """n_arr / H_arr (the hierarchical case): per-chain counts, some below
    the stored t (the dynamic-n guard), and per-chain base."""
    data, tabs = tables
    jtab, ttab, ab = tabs["grid"]
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    r = np.random.default_rng(4)
    J, D = data.n.shape
    tmax = int(data.n.max()) + 1
    for k in range(3):
        n_arr = np.maximum(data.n[None] - r.integers(0, 3, (C, J, D)), 0)
        H_arr = r.dirichlet(np.ones(D), C)
        key = jax.random.key(90 + k)
        jt, jT = jpyp.ct_sweep(key, jt, jT, ja, jb, jtab, data, tmax,
                               n_arr=jnp.asarray(n_arr, jnp.int32),
                               H_arr=jnp.asarray(H_arr))
        t, T = tpyp.ct_sweep(
            rng.Replay([_cat_gumbels(key, D, (C * J, tmax))]), t, T, a, b,
            ttab, data, tmax, n_arr=torch.as_tensor(n_arr, dtype=torch.int32),
            H_arr=torch.as_tensor(H_arr))
        _equal((t, T), (jt, jT))
        assert (t <= torch.as_tensor(n_arr)).all()


def test_ctw_sweep_is_windowed_ct(tables):
    data, tabs = tables
    _, tg, ab = tabs["grid"]
    _, (t, T, a, b) = _state(data, ab)
    tmax = int(data.n.max()) + 1
    r1 = tpyp.ctw_sweep(rng.generator(3, "cpu"), t, T, a, b, tg, data, tmax,
                        window=4)
    r2 = tpyp.ct_sweep(rng.generator(3, "cpu"), t, T, a, b, tg, data, tmax,
                       window=4)
    assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])


@pytest.mark.parametrize("window", [1, 3, 10])
@pytest.mark.parametrize("kind,route", [("grid", "query"),
                                        ("table", "query"),
                                        ("table", "rows"),
                                        ("cols", "query"),
                                        ("cols", "rows")])
def test_ctw_sweep_rel_equal(tables, kind, route, window):
    data, tabs = tables
    jtab, ttab, ab = tabs[kind]
    m_sel = tpyp.ctw_m_sel(ttab, data) if route == "rows" else 0
    assert (m_sel > 0) == (route == "rows")
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    J, D = data.n.shape
    for k in range(3):
        key = jax.random.key(100 + k)
        jt, jT = jpyp.ctw_sweep_rel(key, jt, jT, ja, jb, jtab, data,
                                    window=window)
        t, T = tpyp.ctw_sweep_rel(
            rng.Replay([_cat_gumbels(key, D, (C * J, 2 * window + 1))]), t,
            T, a, b, ttab, data, window=window, m_sel=m_sel)
        _equal((t, T), (jt, jT))


def test_ctw_sweep_rel_zero_discount(tables):
    """a == 0 chains take the m log b product (a Dirichlet process)."""
    data, tabs = tables
    jtab, ttab, _ = tabs["grid"]
    ab = (np.where(np.arange(C) % 2 == 0, 0.0, 0.4), np.linspace(1, 9, C))
    (jt, jT, ja, jb), (t, T, a, b) = _state(data, ab)
    J, D = data.n.shape
    for k in range(3):
        key = jax.random.key(110 + k)
        jt, jT = jpyp.ctw_sweep_rel(key, jt, jT, ja, jb, jtab, data, window=3)
        t, T = tpyp.ctw_sweep_rel(
            rng.Replay([_cat_gumbels(key, D, (C * J, 7))]), t, T, a, b, ttab,
            data, window=3)
        _equal((t, T), (jt, jT))


def test_window_product_is_the_lgamma_form():
    """ctw_sweep_rel's window sum equals the JAX sweep's lgamma difference
    (tt - 1) log(H a) + lgamma(base + tt) - lgamma(base + 1) up to a
    constant of the row, in f64, at check.c-sized bases."""
    r = np.random.default_rng(7)
    base = torch.as_tensor(r.uniform(1.0, 2000.0, 64))
    lo = torch.as_tensor(r.integers(1, 400, 64))
    tts = lo[:, None] + torch.arange(21)[None]
    log_ha = torch.as_tensor(np.log(r.uniform(0.01, 0.9, 64)))
    ours = tpyp._window_product(base, tts, log_ha)
    mm = (tts - 1).double()
    jax_form = (mm * log_ha[:, None] + torch.lgamma(base[:, None] + mm + 1.0)
                - torch.lgamma(base[:, None] + 1.0))
    shift = jax_form - ours
    assert torch.equal(ours[:, 0], torch.zeros(64, dtype=torch.float64))
    assert float((shift - shift[:, :1]).abs().max()) < 1e-9


@pytest.mark.parametrize("layout", ["table", "cols"])
def test_row_routes_equal_in_f32(layout):
    """Both m_sel routes give the same state under the same draws on an
    f32 table (the card's precision): a selection is exact."""
    data = tpyp.crp_generate(9, 6, 12, 60, 0.5, 2.0)
    n = int(data.n.max()) + 2
    tab = tst.make(n, n, n + 32, n + 32, 0.5, device="cpu")
    if layout == "cols":
        tab = _as_cols(tab)
    a = torch.full((16,), 0.5)
    b = torch.full((16,), 2.0)
    t0, T0 = tpyp.init_state(data, 16, "cpu")
    jv, iv, nv, stages = _pairs(data, True, 16)
    draws = [rng.uniform(rng.generator(5, "cpu"), (r1 - r0, 2, 16, p),
                         torch.float32, "cpu") for (p, r0, r1) in stages]
    tp0 = t0[:, jv, iv]
    out = [tpyp.ti_sweep_pairs_staged(rng.Replay(draws), tp0, T0, a, b, tab,
                                      data, jv, iv, nv, stages, m_sel=m)
           for m in (0, tpyp.ti_pair_m_sel(tab, nv))]
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                             out[1][1])
    g = [rng.gumbel(rng.generator(6, "cpu"), (12, 16 * 6, 11), torch.float32,
                    "cpu")]
    out = [tpyp.ctw_sweep_rel(rng.Replay(g), t0, T0, a, b, tab, data,
                              window=5, m_sel=m)
           for m in (0, tpyp.ctw_m_sel(tab, data))]
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                             out[1][1])


# -- HSA -----------------------------------------------------------------------

def test_hsa_sweep_equal(tables):
    data, tabs = tables
    ab = tabs["grid"][2]
    jh, jT = jpyp.init_hsa(data, C)
    h, T = convert.hist_from_numpy(jh, jT, "cpu")
    ja, jb = jnp.asarray(ab[0]), jnp.asarray(ab[1])
    a, b = torch.as_tensor(ab[0]), torch.as_tensor(ab[1])
    L, S = data.data_cat.shape[0], jh.shape[-1] - 1
    moved = False
    for k in range(3):
        key = jax.random.key(120 + k)
        jh2, jT = jpyp.hsa_sweep(key, jh, jT, ja, jb, data)
        h, T = tpyp.hsa_sweep(rng.Replay(_item_gumbels(key, L, C, S + 1)), h,
                              T, a, b, data)
        _equal((h, T), (jh2, jT))
        moved |= not np.array_equal(np.asarray(jh2), np.asarray(jh))
        jh = jh2
    assert moved


def test_hsa_sweep_pairs_equal(tables):
    data, tabs = tables
    ab = tabs["grid"][2]
    layout = tpyp.ti_pair_layout(data)
    order, stages = tpyp.ti_pair_stages(layout[2], skip_first=False,
                                        min_pairs=4)
    assert len(stages) >= 2
    jh, jT = jpyp.init_hsa_pairs(data, C, order=order)
    h, T = tpyp.init_hsa_pairs(data, C, "cpu", order=order)
    ja, jb = jnp.asarray(ab[0]), jnp.asarray(ab[1])
    a, b = torch.as_tensor(ab[0]), torch.as_tensor(ab[1])
    seen = []
    yaps.set_sink(seen.append)
    tpyp._warned_hsa_pairs = False
    try:
        for k in range(3):
            key = jax.random.key(130 + k)
            jh, jT = jpyp.hsa_sweep_pairs(key, jh, jT, ja, jb, data,
                                          layout=layout, order=order,
                                          stages=stages)
            h, T = tpyp.hsa_sweep_pairs(
                rng.Replay(_stage_uniforms(key, stages, C, 1e-6)), h, T, a, b,
                data, layout=layout, order=order, stages=stages)
            _equal((h, T), (jh, jT))
    finally:
        yaps.set_sink(None)
    assert len(seen) == 1 and "approximate" in seen[0]


def test_uniform_min_range():
    u = rng.uniform_min(rng.generator(0, "cpu"), 1e-6, (10000,),
                        torch.float64, "cpu")
    assert float(u.min()) >= 1e-6 and float(u.max()) < 1.0
    assert torch.equal(rng.uniform_min(rng.Replay([[0.25]]), 1e-6, (1,),
                                       torch.float64, "cpu"),
                       torch.tensor([0.25], dtype=torch.float64))


# -- statistics, port against port (tests/test_models.py, test_hsa.py) ---------

@pytest.fixture(scope="module")
def workload():
    data = tpyp.crp_generate(seed=7, n_groups=2, dim=5, n_per_group=25,
                             a=0.5, b=1.0)
    grid = tag.make_grid(64, 32, g=100, dtype=torch.float64, device="cpu")
    return data, grid


def _series(data, sweep, gen, chains, sweeps, init=tpyp.init_state):
    t, T = init(data, chains, "cpu")
    Ts = []
    for _ in range(sweeps):
        t, T = sweep(gen, t, T)
        Ts.append(T.sum(1).numpy())
    return np.asarray(Ts[sweeps // 2:]), t, T


def _agree(x, y, k, floor):
    mx, my = x.mean(), y.mean()
    se = np.sqrt(x.mean(0).std() ** 2 / x.shape[1]
                 + y.mean(0).std() ** 2 / y.shape[1])
    assert abs(mx - my) < k * se + floor, (mx, my, se)


def test_ctw_rel_matches_full_ct(workload):
    """A window covering every count makes the relative-window CTW draw
    from CT's full conditional (tests/test_models.py:157-182)."""
    data, grid = workload
    C_ = 256
    a = torch.full((C_,), 0.5, dtype=torch.float64)
    b = torch.full((C_,), 1.0, dtype=torch.float64)
    tmax = int(data.n.max()) + 1
    ct, _, _ = _series(data, lambda g, t, T: tpyp.ct_sweep(
        g, t, T, a, b, grid, data, tmax), rng.generator(4, "cpu"), C_, 60)
    ctw, t, T = _series(data, lambda g, t, T: tpyp.ctw_sweep_rel(
        g, t, T, a, b, grid, data, window=tmax), rng.generator(5, "cpu"),
        C_, 60)
    assert (T == t.sum(2)).all() and (t <= torch.as_tensor(data.n)).all()
    _agree(ct, ctw, 5, 0.05)


def test_state_invariants_ct(workload):
    data, grid = workload
    a = torch.full((64,), 0.5, dtype=torch.float64)
    b = torch.full((64,), 1.0, dtype=torch.float64)
    _, t, T = _series(data, lambda g, t, T: tpyp.ct_sweep(
        g, t, T, a, b, grid, data, int(data.n.max()) + 1),
        rng.generator(1, "cpu"), 64, 5)
    n = torch.as_tensor(data.n)[None]
    assert (T == t.sum(2)).all() and (t <= n).all()
    assert (t[:, n[0] > 0] >= 1).all()


def test_ct_maxrel_bound(workload):
    """check.c's '-c': 1e30 reproduces the unbounded sweep exactly under
    one seed; 1e6 agrees on posterior means (tests/test_models.py)."""
    data, grid = workload
    C_ = 128
    a = torch.full((C_,), 0.5, dtype=torch.float64)
    b = torch.full((C_,), 1.0, dtype=torch.float64)
    tmax = int(data.n.max()) + 1

    def run(maxrel, seed):
        return _series(data, lambda g, t, T: tpyp.ct_sweep(
            g, t, T, a, b, grid, data, tmax, maxrel=maxrel),
            rng.generator(seed, "cpu"), C_, 60)[0]

    free = run(None, 11)
    np.testing.assert_array_equal(free, run(1e30, 11))
    _agree(free, run(1e6, 12), 5, 0.1)


def test_ti_pairs_statistically_agrees(workload):
    """Pair-major TI (round-start T) against the sequential TI sweep
    (tests/test_models.py:276-305), with the state invariants."""
    data, grid = workload
    C_ = 256
    a = torch.full((C_,), 0.5, dtype=torch.float64)
    b = torch.full((C_,), 1.0, dtype=torch.float64)
    layout = tpyp.ti_pair_layout(data)
    par, t, T = _series(data, lambda g, t, T: tpyp.ti_sweep_pairs(
        g, t, T, a, b, grid, data, layout=layout), rng.generator(4, "cpu"),
        C_, 80)
    n = torch.as_tensor(data.n)[None]
    assert (T == t.sum(2)).all() and (t <= n).all()
    assert (t[:, n[0] > 0] >= 1).all()
    seq, _, _ = _series(data, lambda g, t, T: tpyp.ti_sweep(
        g, t, T, a, b, grid, data), rng.generator(5, "cpu"), C_, 80)
    _agree(seq, par, 5, 0.1)


def test_hsa_invariants_preserved():
    """tests/test_hsa.py: customers conserved, T = tables a group, at
    least one table an occupied category."""
    data = tpyp.crp_generate(0, 2, 12, 30, 0.5, 5.0)
    hist, T = tpyp.init_hsa(data, 8, "cpu")
    a = torch.full((8,), 0.5, dtype=torch.float64)
    b = torch.full((8,), 5.0, dtype=torch.float64)
    gen = rng.generator(0, "cpu")
    for _ in range(3):
        hist, T = tpyp.hsa_sweep(gen, hist, T, a, b, data)
    sizes = torch.arange(hist.shape[-1])
    assert torch.equal((hist * sizes).sum(-1), torch.as_tensor(
        data.n).expand(hist.shape[:-1]).to((hist * sizes).dtype))
    assert torch.equal(hist.sum(-1).sum(-1), T.to(torch.int64))
    assert ((hist.sum(-1) >= 1) | torch.as_tensor(data.n == 0)[None]).all()


def test_hsa_pairs_invariants_and_agreement():
    """tests/test_models.py:443-491: the staged pair-major HSA keeps the
    histogram invariants exactly and agrees with the item-sequential
    hsa_sweep within MC error."""
    data = tpyp.crp_generate(seed=5, n_groups=5, dim=8, n_per_group=40,
                             a=0.5, b=1.0)
    C_ = 192
    a = torch.full((C_,), 0.5)
    b = torch.full((C_,), 1.0)
    jvec, ivec, nvec = layout = tpyp.ti_pair_layout(data)
    order, stages = tpyp.ti_pair_stages(nvec, skip_first=False, min_pairs=16)

    def init_pairs(data, chains, dev):
        return tpyp.init_hsa_pairs(data, chains, dev, order=order)

    par, hp, T = _series(data, lambda g, hp, T: tpyp.hsa_sweep_pairs(
        g, hp, T, a, b, data, layout=layout, order=order, stages=stages),
        rng.generator(21, "cpu"), C_, 70, init=init_pairs)
    assert (hp >= 0).all()
    sizes = torch.arange(hp.shape[-1])
    assert torch.equal((hp * sizes).sum(-1), torch.as_tensor(
        nvec[order]).long().expand(hp.shape[:2]))
    tables = torch.zeros(T.shape, dtype=torch.int64).index_add_(
        1, torch.as_tensor(jvec[order]).long(), hp.sum(-1))
    assert torch.equal(tables, T.long())

    seq, _, _ = _series(data, lambda g, h, T: tpyp.hsa_sweep(
        g, h, T, a, b, data), rng.generator(22, "cpu"), C_, 70,
        init=lambda d, c, dev: tpyp.init_hsa(d, c, dev))
    _agree(seq, par, 5, 0.1)
