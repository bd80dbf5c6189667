"""Port parity: libstb_tpu_torch.core.special vs libstb_tpu.core.special.

Same f64 inputs (a numpy seed) through both packages, elementwise: rtol
1e-12 for the polygamma family, the log-space helpers and digamma_inv
(digamma itself also gets atol 1e-14 for the points beside its root at
1.4616, where the value cancels to ~1e-3).  torch.special is the oracle,
beside scipy (tests/test_special.py's): f64 to that file's tolerances
against scipy and 2e-9 against torch.special, f32 to 1e-5 relative (+ 1e-5
beside digamma's root)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from libstb_tpu.core import special as jsp
from libstb_tpu_torch.core import special as tsp

torch.set_num_threads(1)

_R = np.random.default_rng(12)
XS = np.concatenate([
    [0.01, 0.02, 0.1, 0.3, 0.5, 0.98, 1.0, 1.5, 2.0, 3.7, 5.0, 5.9, 6.0, 6.1,
     7.0, 7.999, 8.0, 8.001, 10.0, 57.3, 400.0, 1e4, 1e6],
    np.exp(_R.uniform(np.log(0.01), np.log(1e5), 400))])

POLY = ["digamma", "trigamma", "tetragamma", "pentagamma"]


@pytest.mark.parametrize("name", POLY)
def test_polygamma_equal(name):
    got = getattr(tsp, name)(torch.tensor(XS)).numpy()
    want = np.asarray(getattr(jsp, name)(jnp.asarray(XS)))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-14 if name == "digamma" else 0)
    x2 = XS[:24].reshape(2, 3, 4)              # leading axes
    np.testing.assert_allclose(
        getattr(tsp, name)(torch.tensor(x2)).numpy(),
        np.asarray(getattr(jsp, name)(jnp.asarray(x2))), rtol=1e-12,
        atol=1e-14)


@pytest.mark.parametrize("order,name,rtol", [
    (0, "digamma", 1e-12), (1, "trigamma", 1e-12), (2, "tetragamma", 1e-11),
    (3, "pentagamma", 1e-10)])
def test_polygamma_vs_oracles_f64(order, name, rtol):
    """scipy to tests/test_special.py's tolerances; torch.special, whose
    f64 polygamma series is itself good to ~5e-10, to 2e-9."""
    x = torch.tensor(XS)
    got = getattr(tsp, name)(x).numpy()
    np.testing.assert_allclose(got, sp.polygamma(order, XS), rtol=rtol,
                               atol=1e-14 if order == 0 else 0)
    want = torch.special.digamma(x) if order == 0 else \
        torch.special.polygamma(order, x)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-9,
                               atol=1e-14 if order == 0 else 0)


@pytest.mark.parametrize("order,name", [(0, "digamma"), (1, "trigamma")])
def test_polygamma_f32(order, name):
    x = torch.tensor(XS, dtype=torch.float32)
    got = getattr(tsp, name)(x)
    assert got.dtype == torch.float32
    want = torch.special.digamma(x.double()) if order == 0 else \
        torch.special.polygamma(order, x.double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 if order == 0 else 0)


def test_digamma_inv_equal_and_roundtrip():
    y = np.concatenate([[-100.0, -10.0, -2.23, -2.22, -2.21, 0.0, 3.0, 9.0],
                        _R.uniform(-20.0, 9.0, 200)])
    got = tsp.digamma_inv(torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.digamma_inv(jnp.asarray(y))),
                               rtol=1e-12)
    np.testing.assert_allclose(
        torch.special.digamma(torch.tensor(got)).numpy(), y, rtol=1e-8,
        atol=1e-8)
    np.testing.assert_allclose(
        tsp.digamma_inv(torch.tensor(y), iters=2).numpy(),
        np.asarray(jsp.digamma_inv(jnp.asarray(y), iters=2)), rtol=1e-12)


def test_log_helpers_equal():
    x = _R.uniform(-30.0, 30.0, 300)
    gap = np.concatenate([[0.0, 1e-12, 1e-9, 0.6931, 0.6932, 700.0],
                          np.exp(_R.uniform(np.log(1e-10), np.log(50.0),
                                            294))])
    y = x - gap
    np.testing.assert_allclose(
        tsp.logadd(torch.tensor(x), torch.tensor(y)).numpy(),
        np.asarray(jsp.logadd(jnp.asarray(x), jnp.asarray(y))), rtol=1e-12)
    # jax's f64 exp / expm1 on the CPU are only ~1.5e-8 accurate
    # (tests/test_special.py:64-67), which bounds these two
    got = tsp.logdiff(torch.tensor(x), torch.tensor(y)).numpy()
    want = np.asarray(jsp.logdiff(jnp.asarray(x), jnp.asarray(y)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-7, atol=1e-7)
    d = -gap[gap > 0]
    np.testing.assert_allclose(
        tsp.log1mexp(torch.tensor(d)).numpy(),
        np.asarray(jsp.log1mexp(jnp.asarray(d))), rtol=1e-7, atol=1e-9)
    # and against the closed forms in numpy, to f64 rounding
    np.testing.assert_allclose(tsp.log1mexp(torch.tensor(d)).numpy(),
                               np.log(-np.expm1(d)), rtol=1e-13, atol=1e-15)


def test_log_helper_conventions():
    inf = float("inf")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    assert float(tsp.logadd(-inf, -inf)) == -inf
    assert float(tsp.logadd(f64(3.0), -2.0)) == pytest.approx(
        np.logaddexp(3, -2), rel=1e-14)
    assert float(tsp.logdiff(1.0, 1.0)) == -inf
    assert float(tsp.logdiff(1.0, 2.0)) == -inf
    assert float(tsp.logdiff(f64(2.0), 1.0)) == pytest.approx(
        np.log(np.exp(2.0) - np.exp(1.0)), rel=1e-14)
    assert np.isfinite(float(tsp.logdiff(f64(5.0), 5.0 - 1e-9)))
    x = torch.tensor([0.5, 3.0], dtype=torch.float32)
    assert tsp.logdiff(x, x - 1).dtype == torch.float32
    assert torch.equal(tsp.lgamma(x), torch.lgamma(x))


def test_integer_input_takes_the_default_float():
    assert tsp.digamma(torch.tensor([1, 2, 9])).dtype == torch.float32
    np.testing.assert_allclose(float(tsp.digamma(1)), -0.5772156649015329,
                               rtol=1e-6)
