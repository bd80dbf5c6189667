"""Port parity: libstb_tpu_torch.core.sapprox vs libstb_tpu.core.sapprox.

The same (n, m, a) points through both packages in f64, rtol 1e-10
for m <= 2 (m = 1 for the derivative: lgamma and the polygamma series
enter), 1e-7 where differences of
exponentials cancel, and 1e-4 for the derivative at a < 0.02 and m >= 3,
where the division by a^(m-1) amplifies the ~1.5e-8 error of XLA's f64 exp
on the CPU), with identical -inf / 0 patterns; and the checks of
tests/test_sapprox.py against exact rational tables."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import sapprox as jsa
from libstb_tpu_torch.core import sapprox as tsa
from test_torch_stirling_table import exact_logS

torch.set_num_threads(1)

_R = np.random.default_rng(21)
N = np.concatenate([[1.0, 2.0, 3.0, 4.0, 5.0, 9.0],
                    _R.integers(2, 400, 120).astype(np.float64)])
M = np.concatenate([[1, 2, 3, 4, 5, 5], _R.integers(1, 6, 120)])
A = np.concatenate([[0.0, 0.0005, 0.001, 0.01, 0.2, 0.3],
                    _R.uniform(0.0, 0.24, 120)])


@pytest.mark.parametrize("fn", ["s_approx", "s_approx_da"])
def test_equal_to_jax(fn):
    got = getattr(tsa, fn)(torch.tensor(N), torch.tensor(M),
                           torch.tensor(A)).numpy()
    want = np.asarray(getattr(jsa, fn)(jnp.asarray(N), jnp.asarray(M),
                                       jnp.asarray(A)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.array_equal(got == 0, want == 0)
    fin = np.isfinite(want)
    assert fin.sum() > 80 and np.isfinite(got[fin]).all()
    hard = fin & (A < 0.02) & (M >= 3) & (fn == "s_approx_da")
    np.testing.assert_allclose(got[fin & ~hard], want[fin & ~hard],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got[hard], want[hard], rtol=1e-4)
    easy = fin & (M <= (2 if fn == "s_approx" else 1))
    np.testing.assert_allclose(got[easy], want[easy], rtol=1e-10, atol=1e-12)


def test_exact_cases():
    from scipy.special import gammaln
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    np.testing.assert_allclose(float(tsa.s_approx(f64(20.0), 1, 0.4)),
                               gammaln(20 - 0.4) - gammaln(1 - 0.4),
                               rtol=1e-12)
    assert float(tsa.s_approx(f64(5.0), 5, 0.3)) == 0.0
    assert np.isneginf(float(tsa.s_approx(f64(3.0), 4, 0.3)))
    assert np.isneginf(float(tsa.s_approx(f64(9.0), 5, 0.3)))
    assert tsa.s_approx(torch.tensor([7, 9]), 2, 0.1).dtype == torch.float32


@pytest.mark.parametrize("frac,n,tol", [(Fraction(1, 100), 30, 2e-3),
                                        (Fraction(1, 5), 40, None)])
def test_against_exact_tables(frac, n, tol):
    """Close for small a (absolute 2e-3 at a = 0.01), within 2% at
    a = 1/5 (tests/test_sapprox.py:22-37)."""
    ex = exact_logS(frac, n)
    for m in (2, 3, 4):
        got = float(tsa.s_approx(torch.tensor(float(n), dtype=torch.float64),
                                 m, float(frac)))
        if tol is not None:
            assert abs(got - ex[(n, m)]) < tol
        else:
            assert abs(got - ex[(n, m)]) / abs(ex[(n, m)]) < 0.02


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_da_finite_difference(m):
    eps = 1e-6
    n = torch.tensor(25.0, dtype=torch.float64)
    fd = (float(tsa.s_approx(n, m, 0.2 + eps))
          - float(tsa.s_approx(n, m, 0.2 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(tsa.s_approx_da(n, m, 0.2)), fd,
                               rtol=1e-3)
