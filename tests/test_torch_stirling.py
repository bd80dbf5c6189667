"""Port parity: libstb_tpu_torch.core.stirling vs libstb_tpu.core.stirling.

Same inputs through both packages on the CPU; tolerances are stated per
test (f64 arithmetic in the same order gives agreement to rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import stirling as jst
from libstb_tpu_torch.core import stirling as tst

torch.set_num_threads(1)

AVALS = [0.0, 0.3, 0.77, 0.95]


def _same_pattern(x, y):
    np.testing.assert_array_equal(np.isposinf(x), np.isposinf(y))
    np.testing.assert_array_equal(np.isneginf(x), np.isneginf(y))
    np.testing.assert_array_equal(x == 0, y == 0)


@pytest.mark.parametrize("a", AVALS)
def test_fill_rows_f64_matches_jax(a):
    N, M = 200, 60
    jv, js, jl = (np.asarray(x) for x in jst.fill_rows(a, N, M,
                                                         dtype=jnp.float64))
    tv, ts, tl = (x.numpy() for x in tst.fill_rows(a, N, M,
                                                     dtype=torch.float64))
    for x, y in ((tv, jv), (ts, js), (tl, jl)):
        _same_pattern(x, y)
        fin = np.isfinite(y)
        np.testing.assert_allclose(x[fin], y[fin], rtol=1e-12, atol=1e-12)


def test_fill_rows_batched_equals_scalar():
    v, s, last = tst.fill_rows(torch.tensor(AVALS, dtype=torch.float64),
                               90, 30, dtype=torch.float64)
    assert v.shape == (4, 90, 30) and s.shape == (4, 90, 30)
    for g, a in enumerate(AVALS):
        v1, s1, l1 = tst.fill_rows(a, 90, 30, dtype=torch.float64)
        assert torch.equal(v[g], v1) and torch.equal(s[g], s1)
        assert torch.equal(last[g], l1)


@pytest.mark.parametrize("a", AVALS)
def test_fill_rows_f32_within_f32_tolerance(a):
    """f32 port and f32 JAX held to the f64 fill with the same bounds:
    V rtol 2e-5 on live cells, |dSrel| < 1e-4, identical sentinels."""
    N, M = 160, 48
    v64, s64, _ = (np.asarray(x) for x in jst.fill_rows(a, N, M,
                                                         dtype=jnp.float64))
    live = np.isfinite(v64) & (v64 > 0)
    fin = np.isfinite(s64)
    j32 = [np.asarray(x) for x in jst.fill_rows(a, N, M,
                                                dtype=jnp.float32)[:2]]
    t32 = [x.numpy() for x in tst.fill_rows(a, N, M,
                                            dtype=torch.float32)[:2]]
    for v, s in (j32, t32):
        np.testing.assert_allclose(v[live], v64[live], rtol=2e-5)
        assert np.max(np.abs(s[fin] - s64[fin])) < 1e-4
        _same_pattern(v, v64)
        np.testing.assert_array_equal(np.isneginf(s), np.isneginf(s64))


def test_fill_rows_no_srel():
    v, s, _ = tst.fill_rows(0.4, 40, 12, dtype=torch.float64,
                            with_srel=False)
    assert s is None
    jv = np.asarray(jst.fill_rows(0.4, 40, 12, dtype=jnp.float64,
                                  with_srel=False)[0])
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-12)


@pytest.mark.parametrize("a", [0.0, 0.01, 0.42, 0.98])
def test_s1_host_and_split_equal(a):
    np.testing.assert_array_equal(tst.s1_host(a, 3000), jst.s1_host(a, 3000))
    x = jst.s1_host(a, 3000)
    for p, q in zip(tst._split_hi_lo(x), jst._split_hi_lo(x)):
        assert p.dtype == q.dtype == np.float32
        np.testing.assert_array_equal(p, q)


def _asympt_inputs(a_sign):
    rng = np.random.default_rng(5)
    n = rng.uniform(50, 5e5, 64)
    m = np.floor(rng.uniform(2, 400, 64))
    if a_sign == "pos":
        a = rng.uniform(0.01, 0.98, 64)
    else:                        # mixed signs: zeros exercise Hwang's branch
        a = np.where(np.arange(64) % 3 == 0, 0.0, rng.uniform(0.01, 0.98, 64))
    return n, m, a


@pytest.mark.parametrize("a_sign", ["any", "pos"])
def test_s_asympt_matches_jax(a_sign):
    """lgamma differs between XLA and torch in the last bits: rtol 1e-11."""
    n, m, a = _asympt_inputs(a_sign)
    from scipy.special import gammaln
    lga1 = gammaln(1.0 - a)
    want = np.asarray(jst.s_asympt(jnp.asarray(a), jnp.asarray(lga1),
                                   jnp.asarray(n), jnp.asarray(m),
                                   a_sign=a_sign))
    got = tst.s_asympt(torch.tensor(a), torch.tensor(lga1), torch.tensor(n),
                       torch.tensor(m), a_sign=a_sign).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11)


@pytest.mark.parametrize("a_sign", ["any", "pos"])
def test_v_asympt_matches_jax(a_sign):
    n, m, a = _asympt_inputs(a_sign)
    want = np.asarray(jst.v_asympt(jnp.asarray(a), jnp.asarray(n),
                                   jnp.asarray(m), a_sign=a_sign))
    got = tst.v_asympt(torch.tensor(a), torch.tensor(n), torch.tensor(m),
                       a_sign=a_sign).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11)


@pytest.mark.parametrize("a", [0.0, 0.05, 0.5, 0.9])
def test_s1_anchored_matches_jax(a):
    """The anchored S1 pair (f64 host anchors every 32 rows, f32 log
    prefix sums) at 2^17 rows, the JAX test's cases
    (tests/test_stirling.py:257-270): hi bitwise equal to JAX's (the same
    f64 anchors), lo within 2e-4 absolute (torch's cumsum may associate
    differently from XLA's: a few ulps of |prefix| <= ~430), hi + lo
    within JAX's 5e-4 of s1_host, and S1(1) == 0 exactly."""
    n = 1 << 17
    jhi, jlo = (np.asarray(x) for x in jst.s1_anchored(a, n))
    hi, lo = (x.numpy() for x in tst.s1_anchored(a, n, device="cpu"))
    assert hi.dtype == lo.dtype == np.float32 and hi.shape == (n,)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=2e-4)
    got = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.max(np.abs(got - tst.s1_host(a, n))) < 5e-4
    assert got[0] == 0.0


def test_s1_anchored_needs_whole_chunks():
    with pytest.raises(AssertionError):
        tst.s1_anchored(0.5, (1 << 16) + 1, device="cpu")


@pytest.mark.parametrize("device,dtype,n,route", [
    ("cuda", torch.float32, 1 << 16, "anchored"),
    ("cuda", torch.float32, 1 << 20, "anchored"),
    ("cuda:0", torch.float32, 81920, "anchored"),
    ("cuda", torch.float32, (1 << 16) + 1, "host"),
    ("cuda", torch.float32, 1 << 15, "host"),
    ("cuda", torch.float64, 1 << 20, "host"),
    ("cpu", torch.float32, 1 << 16, "host"),
    ("cpu", torch.float32, 1 << 20, "host"),
    ("cpu", torch.float64, 1 << 20, "host")])
def test_s1_route(device, dtype, n, route):
    """make's S1 route is JAX's (libstb_tpu/core/stirling.py:627-628), the
    CUDA device standing for its kernels: anchored for f32 tables of n %
    32 == 0 and n >= 2^16 on a card, the host column everywhere else."""
    assert tst.s1_route(torch.device(device), dtype, n) == route
