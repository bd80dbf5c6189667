"""Port parity: the single-table path (libstb_tpu_torch.core.stirling:
fill_rows' resume form, s1_ingraph, StirlingTable, make / remake / ensure,
cli/list_torch.py) vs libstb_tpu.core.stirling on the CPU.

Golden values come from exact rational arithmetic on the defining
recurrence (as tests/test_stirling.py); tolerances are stated per test."""
import dataclasses
import io
import math
import os
import sys
from contextlib import redirect_stdout
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import stirling as jst
from libstb_tpu.ops import stirling_pallas as sp
from libstb_tpu.utils.yaps import LibstbError as JaxLibstbError
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.utils.yaps import LibstbError

torch.set_num_threads(1)

CPU = torch.device("cpu")


def exact_logS(a_frac: Fraction, n_max: int):
    """Exact log S^n_{m,a} via Fractions; dict[(n, m)] -> float."""
    S = {(1, 1): Fraction(1)}
    for n in range(2, n_max + 1):
        for m in range(1, n + 1):
            prev = S.get((n - 1, m), Fraction(0))
            diag = S.get((n - 1, m - 1), Fraction(0))
            S[(n, m)] = diag + (Fraction(n - 1) - m * a_frac) * prev
    return {k: math.log(v.numerator) - math.log(v.denominator)
            for k, v in S.items() if v > 0}


NEX = 40
EXACT = exact_logS(Fraction(1, 2), NEX)
EX_N = np.array([k[0] for k in EXACT])
EX_M = np.array([k[1] for k in EXACT])
EX_LOGS = np.array(list(EXACT.values()))


def _jax_arrays(t):
    return ({k: (None if getattr(t, k) is None else np.asarray(getattr(t, k)))
             for k in convert.TABLE_ARRAYS},
            {k: getattr(t, k) for k in convert.TABLE_STATICS})


def _port(t):
    return convert.table_from_numpy(*_jax_arrays(t), device=CPU)


def _as_cols(t):
    """The same table in the port's column-major layout (K3's)."""
    return dataclasses.replace(
        t, vtab=t.vtab.T.contiguous(),
        srel=t.srel.T.contiguous() if t.srel is not None else None,
        cols=True)


# -- fill_rows resume form, s1_ingraph, host copies ---------------------------

@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 0.0)])
@pytest.mark.parametrize("a", [0.0, 0.37, 0.9])
def test_fill_rows_resume_equals_fresh(dtype, rtol, a):
    """Resuming from v_last at n_start continues the same row walk: V
    rows are identical; Srel of the start row is recomputed from
    v_start (f64 rtol 1e-12; f32 exact, the same ops in the same order),
    and the JAX resume form agrees in f64 to rtol 1e-12."""
    N0, N, M = 60, 150, 30
    v0, s0, last = tst.fill_rows(a, N0, M, dtype=dtype)
    vr, sr, lr = tst.fill_rows(a, N, M, dtype=dtype, v_start=last,
                               n_start=N0)
    vf, sf, lf = tst.fill_rows(a, N, M, dtype=dtype)
    assert vr.shape == (N - N0 + 1, M)
    assert torch.equal(vr, vf[N0 - 1:]) and torch.equal(lr, lf)
    fin = torch.isfinite(sf[N0 - 1:])
    torch.testing.assert_close(sr[fin], sf[N0 - 1:][fin], rtol=rtol,
                               atol=rtol)
    assert torch.equal(torch.isneginf(sr), torch.isneginf(sf[N0 - 1:]))
    if dtype == torch.float64:
        jv, js, _ = jst.fill_rows(a, N, M, dtype=jnp.float64,
                                  v_start=jnp.asarray(last.numpy()),
                                  n_start=N0)
        np.testing.assert_allclose(vr.numpy(), np.asarray(jv), rtol=1e-12)
        jfin = np.isfinite(np.asarray(js))
        np.testing.assert_array_equal(fin.numpy(), jfin)
        np.testing.assert_allclose(sr.numpy()[jfin], np.asarray(js)[jfin],
                                   rtol=1e-12, atol=1e-12)


def test_s1_ingraph_matches_jax():
    """torch vs XLA lgamma in f64: rtol 1e-12."""
    for a in (0.0, 0.25, 0.9):
        got = tst.s1_ingraph(torch.tensor(a, dtype=torch.float64), 500,
                             dtype=torch.float64).numpy()
        want = np.asarray(jst.s1_ingraph(a, 500, dtype=jnp.float64))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, tst.s1_host(a, 500), rtol=1e-12,
                                   atol=1e-12)


def test_host_copies_equal():
    """_norm_dims and _grow_dim are copies: equal on a grid of inputs."""
    vals = [0, 1, 5, 9, 10, 11, 40, 63, 64, 100, 1000, 10 ** 6]
    for args in zip(vals, vals[::-1], vals[3:] + vals[:3], vals[5:] + vals[:5]):
        assert tst._norm_dims(*args) == jst._norm_dims(*args)
    for used in (10, 64, 100, 999, 1000, 65536):
        for want in (5, 64, 101, 1200, 70001, 10 ** 6):
            for hard in (100, 4000, 10 ** 6):
                assert (tst._grow_dim(used, want, hard)
                        == jst._grow_dim(used, want, hard))


# -- StirlingTable queries vs the JAX table ------------------------------------

QUERIES = ("S", "Srel", "V", "U", "UV")


def _points(n_max, m_max, max_n, k=200, seed=0):
    """k (n, m) pairs from a numpy seed: in-table cells, identities,
    out-of-domain, and n past n_max (below and above max_n)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, n_max + 1, k)
    m = rng.integers(0, m_max + 1, k)
    n[:20] = rng.integers(n_max + 1, max(max_n, n_max + 1) + 1, 20)
    n[20:40] = rng.integers(max_n + 1, 3 * max_n, 20)
    m[40:50] = n[40:50]
    m[50:60] = 1
    return n, m


@pytest.fixture(scope="module")
def jax_tables():
    """JAX tables in every layout: natural f64 / f32 (fill_rows), fold
    (fill_table interpret), cols (fill_table_cols interpret)."""
    kw = dict(use_asympt=True, use_pallas=False)
    nat64 = jst.make(300, 40, 400, 64, 0.37, dtype=jnp.float64, **kw)
    nat32 = jst.make(300, 40, 400, 64, 0.37, **kw)
    cols = jst.make(300, 40, 400, 64, 0.37, use_cols=True, interpret=True,
                    **kw)
    nat256 = jst.make(256, 40, 400, 64, 0.37, **kw)
    vt3, sr3 = sp.fill_table(0.37, 256, 40, row_block=32, interpret=True,
                             fold_raw=True)
    fold = dataclasses.replace(nat256, vtab=vt3, srel=sr3, fold=8)
    noasy = jst.make(50, 20, 50, 20, 0.5, dtype=jnp.float64)
    return dict(nat64=nat64, nat32=nat32, cols=cols, fold=fold,
                nat256=nat256, noasy=noasy)


def _cmp(got, want, n, n_max, rtol_out):
    """In-table cells exactly (same arrays, same arithmetic); out-of-table
    (asymptote: torch vs XLA lgamma) within ``rtol_out``."""
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    inside = fin & (n <= n_max)
    np.testing.assert_array_equal(got[inside], want[inside])
    np.testing.assert_allclose(got[fin & ~inside], want[fin & ~inside],
                               rtol=rtol_out, atol=0)


@pytest.mark.parametrize("name,rtol_out", [
    ("nat64", 1e-11), ("nat32", 1e-5), ("cols", 1e-5), ("fold", 1e-5),
    ("noasy", 1e-11)])
def test_queries_match_jax(jax_tables, name, rtol_out):
    """Each JAX layout carried over by convert.table_from_numpy answers
    every query as the JAX table does, and the port's column-major copy
    of it answers identically."""
    jt = jax_tables[name]
    pt = _port(jt)
    assert pt.n_max == jt.n_max and pt.vtab.shape == (jt.n_max, jt.m_max)
    n, m = _points(jt.n_max, jt.m_max, jt.max_n)
    for q in QUERIES:
        want = np.asarray(getattr(jt, q)(jnp.asarray(n), jnp.asarray(m)))
        got = getattr(pt, q)(n, m).numpy()
        _cmp(got, want, n, jt.n_max, rtol_out)
        assert torch.equal(getattr(_as_cols(pt), q)(n, m),
                           getattr(pt, q)(n, m)), q
    _cmp(pt.S1(n).numpy(), np.asarray(jt.S1(jnp.asarray(n))), n, jt.n_max,
         rtol_out)


def test_layouts_agree(jax_tables):
    """fold and cols layouts (f32 Pallas fills) vs the natural table:
    rtol 2e-4 (tests/test_stirling.py:175-254)."""
    for name, ref in (("cols", "nat32"), ("fold", "nat256")):
        pt, nat = _port(jax_tables[name]), _port(jax_tables[ref])
        rng = np.random.default_rng(3)
        n = rng.integers(1, pt.n_max, 200)
        m = np.minimum(rng.integers(1, pt.m_max, 200), n)
        for q in QUERIES[:4]:
            a, b = getattr(nat, q)(n, m).numpy(), getattr(pt, q)(n, m).numpy()
            fin = np.isfinite(a)
            np.testing.assert_array_equal(np.isfinite(b), fin)
            np.testing.assert_allclose(b[fin], a[fin], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["nat64", "nat32"])
def test_rows_equal_point_queries(jax_tables, name):
    """V_rows / Srel_rows equal V() / Srel() cell by cell, exactly, in both
    of the port's layouts (the JAX one-hot rows are held at rtol 1e-6 by
    tests/test_models.py:403-440; the port's gathers are exact)."""
    pt = _port(jax_tables[name])
    rng = np.random.default_rng(7)
    n = np.concatenate([[0, 1, 2, 40, pt.n_max],
                        rng.integers(0, pt.n_max + 1, 60)])
    m_sel = pt.m_max
    ms = torch.arange(1, m_sel + 1)
    for t in (pt, _as_cols(pt)):
        nt = torch.as_tensor(n)
        assert torch.equal(t.V_rows(nt, m_sel), t.V(nt[:, None], ms[None]))
        assert torch.equal(t.Srel_rows(nt, m_sel),
                           t.Srel(nt[:, None], ms[None]))
        assert torch.equal(t.V_rows(nt, 7), t.V(nt[:, None], ms[None, :7]))
    jt = jax_tables[name]
    want = np.asarray(jt.Srel_rows(jnp.asarray(n), m_sel))
    got = pt.Srel_rows(torch.as_tensor(n), m_sel).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-5)


# -- the port's make / remake / ensure on the CPU ------------------------------

@pytest.fixture(scope="module")
def table64():
    return tst.make(NEX, NEX, 200, 100, 0.5, dtype=torch.float64, device=CPU)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 5e-4)])
def test_S_golden(dtype, atol):
    t = tst.make(NEX, NEX, 200, 100, 0.5, dtype=dtype, device=CPU)
    assert not t.cols and t.vtab.dtype == dtype
    np.testing.assert_allclose(t.S(EX_N, EX_M).numpy(), EX_LOGS, rtol=0,
                               atol=atol)


def test_V_S1_U_UV_golden(table64):
    ns, ms, want = [], [], []
    for (n, m), v in EXACT.items():
        if m >= 2 and (n, m - 1) in EXACT:
            ns.append(n)
            ms.append(m)
            want.append(math.exp(v - EXACT[(n, m - 1)]))
    np.testing.assert_allclose(table64.V(ns, ms).numpy(), want, rtol=1e-12)
    from scipy.special import gammaln
    n = np.arange(1, NEX + 1)
    np.testing.assert_allclose(table64.S1(n).numpy(),
                               gammaln(n - 0.5) - gammaln(0.5), rtol=1e-13)
    for (n, m) in [(10, 3), (20, 7), (30, 2)]:
        np.testing.assert_allclose(
            float(table64.U(n, m)),
            math.exp(EXACT[(n + 1, m)] - EXACT[(n, m)]), rtol=1e-10)
        np.testing.assert_allclose(
            float(table64.UV(n, m)),
            math.exp(EXACT[(n + 1, m)] - EXACT[(n, m - 1)]), rtol=1e-10)
    np.testing.assert_allclose(float(table64.U(5, 1)), 4.5, rtol=1e-14)
    assert float(table64.UV(5, 6)) == 1.0
    np.testing.assert_allclose(float(table64.UV(5, 5)), 1.5, rtol=1e-14)


def test_identities(table64):
    """n==m -> 0; m==1 -> S1; n<m -> -inf; m==0 -> -inf (stable.c:944-949)."""
    assert float(table64.S(7, 7)) == 0.0
    assert np.isneginf(float(table64.S(3, 5)))
    assert np.isneginf(float(table64.S(3, 0)))
    assert float(table64.S(9, 1)) == float(table64.S1(9))
    assert float(table64.Srel(9, 9)) == -float(table64.S1(9))
    assert float(table64.Srel(9, 1)) == 0.0
    assert float(table64.V(3, 5)) == 0.0 and float(table64.V(3, 1)) == 0.0


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("a", [0.0, 0.5, 0.77])
def test_make_matches_jax_make(dtype, rtol, a):
    """The port's CPU make vs the JAX make (fill_rows off the TPU): V
    within rtol (1e-12 f64, 2e-5 f32), Srel within 1e-12 / 1e-4, S1 pair
    identical, statics equal."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jt = jst.make(300, 50, 1000, 200, a, use_asympt=True, dtype=jdt)
    pt = tst.make(300, 50, 1000, 200, a, use_asympt=True, dtype=dtype,
                  device=CPU)
    for f in ("n_max", "m_max", "max_n", "max_m", "use_asympt", "a_pos"):
        assert getattr(pt, f) == getattr(jt, f), f
    np.testing.assert_array_equal(pt.s1_hi.numpy(), np.asarray(jt.s1_hi))
    np.testing.assert_array_equal(pt.s1_lo.numpy(), np.asarray(jt.s1_lo))
    assert float(pt.a) == float(jt.a) and float(pt.lga1) == float(jt.lga1)
    jv, js = np.asarray(jt.vtab), np.asarray(jt.srel)
    live = np.isfinite(jv) & (jv > 0)
    np.testing.assert_allclose(pt.vtab.numpy()[live], jv[live], rtol=rtol)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(pt.srel.numpy()), fin)
    np.testing.assert_allclose(pt.srel.numpy()[fin], js[fin],
                               rtol=1e-12 if rtol < 1e-10 else 0,
                               atol=1e-12 if rtol < 1e-10 else 1e-4)
    assert pt.report() == jt.report()


def test_asympt_and_bounds():
    t = tst.make(1000, 50, 1000, 50, 0.5, use_asympt=True,
                 dtype=torch.float64, device=CPU)
    f64 = dict(dtype=torch.float64)
    for m in (2, 5, 10):
        exact = float(t.S(1000, m))
        asy = float(tst.s_asympt(0.5, t.lga1, torch.tensor(1000.0, **f64), m))
        assert abs(asy - exact) / abs(exact) < 1e-2
    np.testing.assert_allclose(
        float(t.S(2000, 5)),
        float(tst.s_asympt(0.5, t.lga1, torch.tensor(2000.0, **f64), 5)),
        rtol=1e-12)
    t2 = tst.make(50, 20, 50, 20, 0.5, dtype=torch.float64, device=CPU)
    assert np.isneginf(float(t2.S(51, 5))) and float(t2.V(51, 5)) == 0.0


@pytest.mark.parametrize("want_n,want_m", [(200, 20), (80, 60), (300, 45)])
def test_growth_matches_fresh_and_jax(want_n, want_m):
    """N-growth (the resume frontier), M-growth and mixed growth equal a
    fresh table at the grown size (V rtol 1e-12, Srel 1e-9) and the JAX
    ensure (same sizes, V rtol 1e-12)."""
    t = tst.make(100, 30, 4000, 2000, 0.5, dtype=torch.float64, device=CPU)
    g = tst.ensure(t, want_n, want_m)
    assert g.n_max >= want_n + 1 and g.m_max >= want_m + 1
    fresh = tst.make(g.n_max, g.m_max, 4000, 2000, 0.5, dtype=torch.float64,
                     device=CPU)
    torch.testing.assert_close(g.vtab[1:, 1:], fresh.vtab[1:, 1:],
                               rtol=1e-12, atol=0)
    fin = torch.isfinite(fresh.srel)
    assert torch.equal(torch.isfinite(g.srel), fin)
    torch.testing.assert_close(g.srel[fin], fresh.srel[fin], rtol=1e-9,
                               atol=1e-9)
    if g.m_max == t.m_max:                  # the frontier path kept the rows
        assert torch.equal(g.vtab[:t.n_max], t.vtab)
    jt = jst.ensure(jst.make(100, 30, 4000, 2000, 0.5, dtype=jnp.float64),
                    want_n, want_m)
    assert (jt.n_max, jt.m_max) == (g.n_max, g.m_max)
    np.testing.assert_allclose(g.vtab[1:, 1:].numpy(),
                               np.asarray(jt.vtab)[1:, 1:], rtol=1e-12)
    assert tst.ensure(g, want_n, want_m) is g


def test_remake_and_a_zero(table64):
    t2 = tst.remake(table64, 0.25)
    ex = exact_logS(Fraction(1, 4), 20)
    for (n, m) in [(10, 3), (20, 7)]:
        np.testing.assert_allclose(float(t2.S(n, m)), ex[(n, m)], atol=1e-11)
    assert t2.s1_hi.dtype == torch.float64 and t2.max_n == table64.max_n
    ex0 = exact_logS(Fraction(0), 25)
    t0 = tst.make(25, 25, 50, 50, 0.0, dtype=torch.float64, device=CPU)
    assert t0.a_pos is False and t0._a_sign == "zero"
    for (n, m) in [(5, 2), (10, 4), (25, 7)]:
        np.testing.assert_allclose(float(t0.S(n, m)), ex0[(n, m)],
                                   atol=1e-11)


def test_tag_in_report_and_bound_errors():
    tab = tst.make(64, 16, 128, 32, 0.5, tag="doc-topic", device=CPU)
    jtab = jst.make(64, 16, 128, 32, 0.5, tag="doc-topic")
    assert "doc-topic" in tab.report() and tab.report() == jtab.report()
    assert tst.remake(tab, 0.3).tag == "doc-topic"
    assert tst.ensure(tab, 100, 16).tag == "doc-topic"
    with pytest.raises(LibstbError, match="doc-topic") as e:
        tst.ensure(tab, 10_000, 16, quit_on_bound=True)
    with pytest.raises(JaxLibstbError) as je:
        jst.ensure(jtab, 10_000, 16, quit_on_bound=True)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="untagged"):
        tst.make(64, 16, 128, 32, 0.5, build_s=False, build_v=False,
                 tag="untagged", device=CPU)


def test_build_flags():
    s_only = tst.make(80, 12, 100, 20, 0.4, build_v=False, device=CPU)
    assert s_only.vtab is None and s_only.srel is not None
    assert float(s_only.V(50, 3)) == 0.0
    v_only = tst.make(80, 12, 100, 20, 0.4, build_s=False, device=CPU)
    assert v_only.srel is None and np.isneginf(float(v_only.S(50, 3)))
    full = tst.make(80, 12, 100, 20, 0.4, device=CPU)
    assert float(v_only.V(50, 3)) == float(full.V(50, 3))
    assert float(s_only.S(50, 3)) == float(full.S(50, 3))


@pytest.mark.parametrize("n,m,route", [
    (4 * 1024 - 1, 1024, "fill_table"), (4 * 1024, 1024, "fill_table_cols"),
    (65535, 1024, "fill_table_cols"), (39, 10, "fill_table"),
    (40, 10, "fill_table_cols"), ((1 << 24) - 1, 64, "fill_table_cols"),
    (1 << 24, 64, "fill_table")])
def test_fill_route_ignores_build_v(n, m, route):
    """An S-only table takes the same kernel as a full one, on either side
    of n = 4 m: the column kernel computes V on its way to Srel, so a long
    S-only table has no reason to take the row walk."""
    for build_v in (True, False):
        assert tst.fill_route("cuda", n, m, build_v=build_v) == route
    assert tst.fill_route("cpu", n, m, build_v=False) == "fill_rows"


def test_cpu_make_keeps_the_host_s1():
    """On the CPU make's S1 pair stays the host column split in two, also
    at a length where a card would take the anchored route."""
    n = 1 << 16
    assert tst.s1_route(CPU, torch.float32, n) == "host"
    assert tst.s1_route("cuda", torch.float32, n) == "anchored"
    t = tst.make(n, 10, 2 * n, 20, 0.5, build_s=False, device=CPU)
    hi, lo = tst._split_hi_lo(tst.s1_host(0.5, n))
    np.testing.assert_array_equal(t.s1_hi.numpy(), hi)
    np.testing.assert_array_equal(t.s1_lo.numpy(), lo)


def test_list_torch_runs_on_cpu():
    """cli/list_torch.py at small N on the CPU prints what the port's
    table holds, and the grown S value agrees with the JAX table (f32,
    rtol 1e-5)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "cli"))
    try:
        import list_torch
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        list_torch.main(["--device", "cpu", "-N", "60", "-M", "10",
                         "--maxN", "400", "--asymptote"])
    out = buf.getvalue()
    t = tst.make(60, 10, 400, 100, 0.5, use_asympt=True, device=CPU)
    assert out.splitlines()[0] == t.report()
    assert "exact vs asymptote" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("  S(120,5) = ")
    jt = jst.ensure(jst.make(60, 10, 400, 100, 0.5, use_asympt=True), 120, 10)
    np.testing.assert_allclose(float(last.split("=")[1]),
                               float(jt.S(120, 5)), rtol=1e-5)
