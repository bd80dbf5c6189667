"""Port parity: libstb_tpu_torch.core.ngg and core.quadrature vs
libstb_tpu.core.ngg / quadrature on the CPU in f64, then the oracle checks
of tests/test_ngg.py (scipy's incomplete gamma, the table against the
quadrature, the ratio table against table differences, the four-way
cross-check) ported against the port.

Tolerances.  Where the arithmetic is the same (the continued fraction, the
saddle-point iterations, the quadrature, the base row to n = 16) rtol 1e-10
or tighter.  The table and the recurrence ratio table sum an alternating
series that cancels (test_ngg.py: at a = 0.1 it loses ~12 digits by
(16, 10)), so one rounding of an exp or lgamma grows there by the cell's
condition number kappa (up to ~1e15 at (16, 10)) in either package; their
cells are held to |port - JAX| <= 16 x 2^-52 x (kappa + |S|) (relative for
the ratios), kappa from tools/torch_ngg_ref.py's table_kappa / ratio_kappa
(the CPU runs reach ~2 of the 16)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gamma as _gamma
from scipy.special import gammaincc

from libstb_tpu.core import ngg as jngg
from libstb_tpu.core import quadrature as jquad
from libstb_tpu_torch.core import ngg, quadrature
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.parallel import distributed

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from torch_ngg_ref import (EPS, KAPPA_ULPS, cli_points,  # noqa: E402
                           ratio_kappa, table_kappa, workload_points)

torch.set_num_threads(1)

A, M = 0.1, 10.0       # the reference's p_a, p_M (ngg_test.c:506)
F64 = torch.float64


# -- same arithmetic: rtol 1e-10 or tighter -----------------------------------

GAMMA_POINTS = [(2.5, 3.0), (0.5, 10.0), (5.0, 1.0), (1.0, 0.5),
                (-0.5, 10.0), (-3.7, 10.0), (-20.0, 10.0), (1 - 150 / A, M)]


def test_log_gamma_inc_upper_equal():
    s, x = (np.array(v) for v in zip(*GAMMA_POINTS))
    want = np.asarray(jngg.log_gamma_inc_upper(jnp.asarray(s),
                                               jnp.asarray(x)))
    got = ngg.log_gamma_inc_upper(torch.tensor(s), torch.tensor(x))
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    for si, xi in GAMMA_POINTS[:3]:           # scalars: f64
        v = ngg.log_gamma_inc_upper(si, xi, device="cpu")
        assert v.dtype == F64 and v.device.type == "cpu"


@pytest.mark.parametrize("n_max", [8, 16, 30])
def test_base_row_equal(n_max):
    """rtol 1e-10 to n = 16 (the reference's MAXN); at n = 30 the sum
    cancels and the bound applies."""
    want = np.asarray(jngg.ngg_base_row(A, M, n_max))
    got = ngg.ngg_base_row(A, M, n_max, device="cpu").numpy()
    np.testing.assert_allclose(got[:16], want[:16], rtol=1e-10)
    kap = table_kappa(A, M, n_max, 1)[0][0]
    assert (np.abs(got - want)
            <= KAPPA_ULPS * EPS * (kap + np.abs(want))).all()


@pytest.mark.parametrize("N,K", [(16, 10), (14, 7), (8, 8)])
def test_table_equal_within_cancellation_bound(N, K):
    kap, want = table_kappa(A, M, N, K)
    got = ngg.ngg_table(A, M, N, K, device="cpu").numpy()
    assert got.shape == (K, N)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    bound = KAPPA_ULPS * EPS * (kap + np.abs(want))
    assert (np.abs(got[fin] - want[fin]) <= bound[fin]).all()
    # no cancellation in the first rows at small n: plain rtol 1e-10
    np.testing.assert_allclose(got[:2, :8], want[:2, :8], rtol=1e-10)


@pytest.mark.parametrize("N,K", [(16, 10), (14, 7)])
def test_ratio_table_recurrence_equal(N, K):
    rho, want = ratio_kappa(A, M, N, K)
    got = ngg.ngg_ratio_table(A, M, N, K, method="recurrence",
                              device="cpu").numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    v = want != 0
    assert (np.abs(got[v] - want[v]) / np.abs(want[v])
            <= KAPPA_ULPS * EPS * rho[v]).all()
    # a table handed in is used as the K=1 row
    tab = ngg.ngg_table(A, M, N, 1, device="cpu")
    assert torch.equal(ngg.ngg_ratio_table(A, M, N, K, table=tab,
                                           method="recurrence", device="cpu"),
                       torch.as_tensor(got))


@pytest.mark.parametrize("N,K,method", [(200, 10, "quadrature"),
                                        (40, 4, "auto"), (20, 6, "auto")])
def test_ratio_table_methods_equal(N, K, method):
    want = np.asarray(jngg.ngg_ratio_table(A, M, N, K, method=method))
    got = ngg.ngg_ratio_table(A, M, N, K, method=method, device="cpu").numpy()
    assert got.shape == want.shape == (K, N - 1)
    np.testing.assert_array_equal(got == 0, want == 0)
    if N <= 32:          # auto -> recurrence: the cancellation bound
        rho = ratio_kappa(A, M, N, K)[0]
        v = want != 0
        assert (np.abs(got[v] - want[v]) / np.abs(want[v])
                <= KAPPA_ULPS * EPS * rho[v]).all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_t_l1_t_l2_equal():
    R = np.asarray(jngg.ngg_ratio_table(A, M, 14, 7))
    Rt = torch.tensor(R)
    for k in range(1, 8):
        for n in range(max(k + 1, 2), 14):
            assert float(ngg.t_l1(Rt, n, k)) == float(jngg.t_l1(
                jnp.asarray(R), n, k))
            np.testing.assert_allclose(
                float(ngg.t_l2(Rt, n, k, A)),
                float(jngg.t_l2(jnp.asarray(R), n, k, A)), rtol=1e-14)
    # batched lookups
    n, k = torch.tensor([5, 9, 13]), torch.tensor([1, 3, 7])
    np.testing.assert_array_equal(ngg.t_l1(Rt, n, k).numpy(),
                                  R[k.numpy() - 1, n.numpy() - 1])


SADDLES = ["umax_log", "smax_log", "hmax_log", "hmax2_log", "gmax_log",
           "ngg_quadrature_log"]


def _points(kind):
    if kind == "cli":
        n, k = (np.array(v, np.float64) for v in zip(*cli_points()))
        return n, k
    if kind == "large":
        return np.array([1000.0, 10000.0, 500.0]), np.array([50.0, 200.0,
                                                             5.0])
    return workload_points(64)


@pytest.mark.parametrize("kind", ["cli", "large", "workload"])
@pytest.mark.parametrize("fn", SADDLES)
def test_saddle_points_equal(fn, kind):
    N, K = _points(kind)
    a, m = np.full(N.shape, A), np.full(N.shape, M)
    want = np.asarray(getattr(jngg, fn)(*(jnp.asarray(x)
                                          for x in (a, m, N, K))))
    got = getattr(ngg, fn)(*(torch.tensor(x) for x in (a, m, N, K)))
    assert got.dtype == F64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_hmax_bounds_and_helpers_equal():
    N, K = _points("cli")
    args = (A, M, N, K)
    want = jngg.hmax_log(*(jnp.asarray(x) for x in args), with_bounds=True)
    got = ngg.hmax_log(*(torch.tensor(x, dtype=F64) for x in args),
                       with_bounds=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
    x = np.linspace(0.05, 0.95, 7)
    targs = [torch.tensor(v, dtype=F64) for v in (x, A, M, 12.0, 4.0)]
    jargs = [jnp.asarray(v) for v in (x, A, M, 12.0, 4.0)]
    for fn in ("_h", "_ddh"):
        np.testing.assert_allclose(getattr(ngg, fn)(*targs).numpy(),
                                   np.asarray(getattr(jngg, fn)(*jargs)),
                                   rtol=1e-12)


@pytest.mark.parametrize("call", [
    lambda: ngg.umax_log(A, M, 10.0, 3.0),
    lambda: ngg.ngg_table(A, M, 8, 3),
    lambda: ngg.ngg_ratio_table(A, M, 40, 3),
    lambda: tst.s1_ingraph(0.5, 10)])
def test_plain_numbers_go_to_the_card(call, monkeypatch):
    """A call with plain numbers and no ``device`` asks for the card: with
    none it raises (never runs on the CPU quietly); told that there are
    two, it builds its tensors on cuda:LOCAL_RANK % 2, which this CPU
    build of torch refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device() == torch.device("cuda", 1)
    assert distributed.local_device("cpu") == torch.device("cpu")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


def test_dtype_and_device_follow_the_arguments():
    """f64 from Python scalars; a float32 tensor argument sets the dtype;
    ``device`` places scalar-only calls."""
    assert ngg.umax_log(A, M, 10.0, 3.0, device="cpu").dtype == F64
    v = ngg.umax_log(A, M, torch.tensor([10.0, 12.0]), 3.0)
    assert v.dtype == torch.float32
    assert ngg.ngg_table(A, M, 8, 3, device="cpu").device.type == "cpu"
    assert ngg.gmax_log(A, M, 10.0, 3.0, device="cpu").dtype == F64


def test_quadrature_rules_equal():
    cases = [(lambda x: x * x, 0.0, 1.0, 10),
             (lambda x: (x.exp() if isinstance(x, torch.Tensor)
                         else jnp.exp(x)), -1.0, 2.0, 8)]
    for f, lo, hi, lv in cases:
        np.testing.assert_allclose(
            float(quadrature.tanh_sinh(f, lo, hi, lv)),
            float(jquad.tanh_sinh(f, lo, hi, lv)), rtol=1e-13)
    lo, hi = np.array([0.0, 1.0, -2.0]), np.array([5.0, 3.0, 2.0])
    got = quadrature.tanh_sinh_log(lambda x: -3.0 * x, torch.tensor(lo),
                                   torch.tensor(hi))
    want = jquad.tanh_sinh_log(lambda x: -3.0 * x, jnp.asarray(lo),
                               jnp.asarray(hi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


# -- the oracle checks of tests/test_ngg.py, on the port ----------------------

def test_gamma_inc_cf_vs_scipy():
    for s, x in GAMMA_POINTS[:4]:
        got = float(ngg.log_gamma_inc_upper(s, x, device="cpu"))
        np.testing.assert_allclose(got, np.log(gammaincc(s, x) * _gamma(s)),
                                   rtol=1e-12)


def test_gamma_inc_negative_s_recurrence():
    x = 10.0
    for s in [-0.5, -3.7, -20.0]:
        g1 = np.exp(float(ngg.log_gamma_inc_upper(s + 1.0, x, device="cpu")))
        gs = np.exp(float(ngg.log_gamma_inc_upper(s, x, device="cpu")))
        np.testing.assert_allclose(gs, (g1 - x ** s * np.exp(-x)) / s,
                                   rtol=1e-9, err_msg=f"s={s}")


def test_table_vs_quadrature():
    tab = ngg.ngg_table(A, M, 16, 10, device="cpu").numpy()
    for (n, k) in [(10, 3), (14, 5), (15, 1), (12, 8)]:
        q = float(ngg.ngg_quadrature_log(A, M, float(n), float(k),
                                         device="cpu"))
        np.testing.assert_allclose(tab[k - 1, n - 1], q, rtol=0, atol=2e-4,
                                   err_msg=f"n={n} k={k}")


def test_saddle_point_accuracy():
    tab = ngg.ngg_table(A, M, 16, 10, device="cpu").numpy()
    for (n, k) in [(10, 3), (14, 5), (12, 8)]:
        u = float(ngg.umax_log(A, M, float(n), float(k), device="cpu"))
        assert abs(u - tab[k - 1, n - 1]) < 0.1, (n, k)


def test_ratio_table_matches_diffs_and_helpers():
    N, K = 14, 7
    tab = ngg.ngg_table(A, M, N, K, device="cpu").numpy()
    R = ngg.ngg_ratio_table(A, M, N, K, device="cpu")
    for k in range(1, K + 1):
        for n in range(k, N):
            want = np.exp(tab[k - 1, n] - tab[k - 1, n - 1])
            np.testing.assert_allclose(float(R[k - 1, n - 1]), want,
                                       rtol=1e-7, err_msg=f"k={k} n={n}")
            if n >= max(k + 1, 2):
                np.testing.assert_allclose(float(ngg.t_l1(R, n, k)), want,
                                           rtol=1e-7)
                l2 = np.exp(tab[k - 1, n - 2] - tab[k - 1, n - 1]) + (
                    k - n / A)
                np.testing.assert_allclose(float(ngg.t_l2(R, n, k, A)), l2,
                                           rtol=2e-6, atol=1e-8)


def test_ratio_table_large_n_stable():
    R = ngg.ngg_ratio_table(0.3, 5.0, 200, 12, device="cpu").numpy()
    valid = R[:, 50:]
    assert np.isfinite(valid).all() and (valid[11][60:] > 0).all()
    Rs = ngg.ngg_ratio_table(0.3, 5.0, 20, 6, method="recurrence",
                             device="cpu").numpy()
    Rq = ngg.ngg_ratio_table(0.3, 5.0, 20, 6, method="quadrature",
                             device="cpu").numpy()
    for k in range(1, 7):
        np.testing.assert_allclose(Rq[k - 1, k - 1:14], Rs[k - 1, k - 1:14],
                                   rtol=1e-4, err_msg=f"k={k}")


def test_four_way_cross_check():
    tab = ngg.ngg_table(A, M, 16, 10, device="cpu").numpy()
    for (n, k) in ((3, 2), (6, 5), (10, 5), (15, 5)):
        t = tab[k - 1, n - 1]
        n_, k_ = float(n), float(k)
        q = float(ngg.ngg_quadrature_log(A, M, n_, k_, device="cpu"))
        u = float(ngg.umax_log(A, M, n_, k_, device="cpu"))
        h = float(ngg.hmax_log(A, M, n_, k_, device="cpu"))
        h2 = float(ngg.hmax2_log(A, M, n_, k_, iters=200, device="cpu"))
        g = float(ngg.gmax_log(A, M, n_, k_, device="cpu"))
        assert abs(q - t) < 1e-5 and abs(g - t) < 0.05, (n, k, q, g, t)
        assert abs(u - t) < 0.1 and abs(h - t) < 0.8, (n, k, u, h, t)
        assert abs(h2 - h) < 1e-4, (n, k, h2, h)
    for (n, k) in ((1000.0, 50.0), (10000.0, 200.0)):
        u = float(ngg.umax_log(A, M, n, k, device="cpu"))
        g = float(ngg.gmax_log(A, M, n, k, device="cpu"))
        h = float(ngg.hmax_log(A, M, n, k, device="cpu"))
        assert abs(u - g) < 1e-2 * abs(u), (n, k, u, g)
        assert abs(u - h) < 1e-2 * abs(u) + 1.5, (n, k, u, h)


def test_hmax_bounds_window_quadrature():
    tab = ngg.ngg_table(A, M, 16, 10, device="cpu").numpy()

    def windowed(n, k):
        _, _, lo, hi = ngg.hmax_log(A, M, float(n), float(k),
                                    with_bounds=True, device="cpu")
        a, m, nf, kf = (torch.tensor(v, dtype=F64) for v in (A, M, n, k))
        q = quadrature.tanh_sinh_log(
            lambda s: -ngg._h(s, a, m, nf, kf),
            torch.clamp(lo, min=1e-14)[None], hi[None], 11)[0]
        return float(q + k * np.log(M) + np.log(A))

    for (n, k) in ((3, 2), (10, 5), (15, 5)):
        assert abs(windowed(n, k) - tab[k - 1, n - 1]) < 1e-5
    n, k = 10000, 200
    full = float(ngg.ngg_quadrature_log(A, M, float(n), float(k),
                                        device="cpu"))
    win = windowed(n, k)
    u = float(ngg.umax_log(A, M, float(n), float(k), device="cpu"))
    assert abs(win - u) < 1e-2 * abs(u)
    assert abs(win - full) > 1.0


def test_hmax2_signals_divergence():
    assert torch.isnan(ngg.hmax2_log(0.1, 10.0, 1000.0, 50.0, device="cpu"))


def test_quadrature_batched_and_known_integrals():
    n = torch.tensor([5.0, 8.0, 12.0], dtype=F64)
    k = torch.tensor([2.0, 3.0, 4.0], dtype=F64)
    out = ngg.ngg_quadrature_log(torch.full((3,), A, dtype=F64),
                                 torch.full((3,), M, dtype=F64), n, k)
    for i in range(3):
        single = float(ngg.ngg_quadrature_log(A, M, float(n[i]),
                                              float(k[i]), device="cpu"))
        np.testing.assert_allclose(float(out[i]), single, rtol=1e-10)
    v = float(quadrature.tanh_sinh(lambda x: x * x, 0.0, 1.0))
    np.testing.assert_allclose(v, 1.0 / 3.0, rtol=1e-10)
    v2 = float(quadrature.tanh_sinh(lambda x: torch.exp(-50.0 * x * x),
                                    -1.0, 1.0, levels=11))
    np.testing.assert_allclose(v2, np.sqrt(np.pi / 50.0), rtol=1e-8)
    lv = float(quadrature.tanh_sinh_log(lambda x: -100.0 * x, 0.0, 5.0))
    np.testing.assert_allclose(lv, np.log(1.0 / 100.0), rtol=1e-6)
