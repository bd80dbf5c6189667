"""The plain reference against the port's CPU path and exact values at
tiny sizes (the port is read here only to judge the reference)."""
import itertools

import numpy as np
import pytest
import torch

from benchmark.reference import compare, pyp_posterior, stirling_ref

F64 = torch.float64


def _table(a, n, m):
    cols = list(stirling_ref.columns(torch.tensor(a, dtype=F64), n, m))
    return (torch.stack([c[1] for c in cols], -1),
            torch.stack([c[2] for c in cols], -1))


@pytest.mark.parametrize("a", [0.0, 0.3, 0.98])
def test_columns_equal_the_ports_f64_row_walk(a):
    from libstb_tpu_torch.core import stirling

    V, S, _ = stirling.fill_rows(a, 1500, 100, dtype=F64)
    v, s = _table(a, 1500, 100)
    ok = torch.isfinite(V) & (V > 0)
    assert float(((V - v).abs() / v)[ok].max()) < 1e-11
    assert torch.equal(V == 0, v == 0) and torch.equal(V.isinf(), v.isinf())
    fin = torch.isfinite(S)
    assert torch.equal(fin, torch.isfinite(s))
    assert float((S - s)[fin].abs().max()) < 1e-9


def test_columns_exact_small():
    """S(n, m; a) by the recurrence in exact fractions, a = 1/2."""
    from fractions import Fraction

    a, N = Fraction(1, 2), 12
    S = {(1, 1): Fraction(1)}
    for n in range(1, N):
        for m in range(1, n + 2):
            S[n + 1, m] = S.get((n, m - 1), 0) + (n - m * a) * S.get((n, m),
                                                                     0)
    v, s = _table(0.5, N, N)
    s1 = stirling_ref.s1(torch.tensor(0.5, dtype=F64), N)
    for n, m in itertools.product(range(1, N + 1), range(2, N + 1)):
        if m <= n:
            assert float(v[n - 1, m - 1]) == pytest.approx(
                float(S[n, m] / S[n, m - 1]), rel=1e-13)
            assert float(s[n - 1, m - 1] + s1[n - 1]) == pytest.approx(
                float(np.log(float(S[n, m]))), rel=1e-12, abs=1e-12)
        else:
            assert float(v[n - 1, m - 1]) == 0.0


def test_compare_reads_the_ports_f32_fill():
    """The port's f32 fill reads small but not zero errors; an exact copy
    of the reference reads zero."""
    from libstb_tpu_torch.core import stirling

    a = torch.tensor(0.6, dtype=F64)
    V, S, _ = stirling.fill_rows(0.6, 2048, 64, dtype=torch.float32)
    s1 = torch.as_tensor(stirling.s1_host(0.6, 2048))
    e = compare.merge([compare.table_errors(
        a, 2048, 64, lambda j: V[:, j], lambda j: S[:, j], s1)])
    assert 0 < e["v_rel"] < 1e-4 and 0 < e["srel_abs"] < 1e-2
    assert e["s1_abs"] < 1e-10 and e["pattern"] == 0
    v, s = _table(0.6, 2048, 64)
    e = compare.merge([compare.table_errors(
        a, 2048, 64, lambda j: v[:, j], lambda j: s[:, j],
        stirling_ref.s1(a, 2048))])
    assert e == {"v_rel": 0.0, "srel_abs": 0.0, "s1_abs": 0.0,
                 "pattern": 0.0}


def test_log_stirling_equals_the_ports_table():
    from libstb_tpu_torch.core import stirling

    L = pyp_posterior.log_stirling(np.array([0.3]), 60)[0]
    tab = stirling.make(60, 60, 60, 60, 0.3, dtype=F64, device="cpu")
    for n in range(1, 61):
        for t in range(1, n + 1):
            assert float(tab.S(n, t)) == pytest.approx(L[n, t], rel=1e-10,
                                                       abs=1e-10)


def test_posterior_by_enumeration():
    """Two groups over three categories, every table configuration summed
    by brute force on the same (a, b) grid."""
    n = np.array([[3, 0, 2], [1, 4, 0]])
    H = np.array([0.2, 0.3, 0.5])
    kw = dict(a_lo=0.05, a_hi=0.9, b_lo=0.1, b_hi=50.0, shape=1.1,
              scale=20.0, a_points=40, b_points=60)
    got = pyp_posterior.posterior_moments(n, H, **kw)
    from scipy.special import gammaln

    avec = np.linspace(kw["a_lo"], kw["a_hi"], kw["a_points"])
    lb = np.linspace(np.log(kw["b_lo"]), np.log(kw["b_hi"]), kw["b_points"])
    L = pyp_posterior.log_stirling(avec, 4)
    wa = np.full(len(avec), avec[1] - avec[0])
    wa[[0, -1]] /= 2
    wb = np.full(len(lb), lb[1] - lb[0])
    wb[[0, -1]] /= 2
    tot = ea = eb = 0.0
    eT = np.zeros(2)
    for ia, a in enumerate(avec):
        for ib, b in enumerate(np.exp(lb)):
            per = []
            for j in range(2):
                rng = [range(1, k + 1) if k else [0] for k in n[j]]
                z = zt = 0.0
                for t in itertools.product(*rng):
                    T = sum(t)
                    lw = sum(L[ia, k, tk] + tk * np.log(h)
                             for k, tk, h in zip(n[j], t, H) if k)
                    lw += sum(np.log(b + i * a) for i in range(T))
                    lw -= gammaln(b + n[j].sum()) - gammaln(b)
                    z += np.exp(lw)
                    zt += T * np.exp(lw)
                per.append((z, zt / z))
            w = (np.exp((1.1 - 1) * np.log(b) - b / 20.0) * b * wa[ia]
                 * wb[ib] * per[0][0] * per[1][0])
            tot += w
            ea += w * a
            eb += w * b
            eT += w * np.array([per[0][1], per[1][1]])
    assert got["a"] == pytest.approx(ea / tot, rel=1e-9)
    assert got["b"] == pytest.approx(eb / tot, rel=1e-9)
    assert got["T"] == pytest.approx(list(eT / tot), rel=1e-9)


def test_posterior_marginals_and_ks():
    """The marginal CDFs end at 1, give back E[a] and E[b] (E[x] = x_lo +
    the integral of 1 - F), and read a sample drawn from them as close
    and a point mass as 1/2 away or more."""
    n = np.array([[3, 0, 2], [1, 4, 0]])
    H = np.array([0.2, 0.3, 0.5])
    got = pyp_posterior.posterior_moments(
        n, H, a_lo=0.05, a_hi=0.9, b_lo=0.1, b_hi=50.0, shape=1.1,
        scale=20.0, a_points=80, b_points=120)
    for grid, cdf in ((got["a_grid"], got["a_cdf"]),
                      (got["logb_grid"], got["logb_cdf"])):
        assert cdf[0] == 0.0 and cdf[-1] == pytest.approx(1.0)
        assert np.all(np.diff(cdf) >= 0)
    x, y = got["a_grid"], 1.0 - got["a_cdf"]
    ea = 0.05 + np.sum(np.diff(x) * (y[1:] + y[:-1]) / 2.0)
    assert ea == pytest.approx(got["a"], rel=2e-3)
    rng = np.random.default_rng(5)
    u = rng.random(20000)
    draw = np.interp(u, got["a_cdf"], got["a_grid"])
    assert pyp_posterior.ks_distance(draw, got["a_grid"],
                                     got["a_cdf"]) < 0.015
    for x in (0.05, 0.3, 0.5, 0.9):
        assert pyp_posterior.ks_distance(np.full(1024, x), got["a_grid"],
                                         got["a_cdf"]) >= 0.5
    assert np.isnan(pyp_posterior.ks_distance(
        np.array([0.3, np.nan]), got["a_grid"], got["a_cdf"]))
