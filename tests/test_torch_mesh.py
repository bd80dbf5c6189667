"""Port parity: the convergence diagnostics of libstb_tpu_torch.parallel.mesh
(rhat, ess, cross_chain_moments) vs libstb_tpu.parallel.mesh on the CPU in
f64, to 1e-10, on the draws of tests/test_parallel.py (converged against
not, iid against AR(1)) and at odd and short chain lengths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.parallel import mesh as jmesh
from libstb_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


def _ar1(T, C, rho, seed):
    r = np.random.default_rng(seed)
    x = np.zeros((T, C))
    for t in range(1, T):
        x[t] = rho * x[t - 1] + r.normal(size=C)
    return x


def _draws():
    r = np.random.default_rng(0)
    good = r.normal(size=(512, 8))
    return {
        "iid": good,
        "shifted": good + np.arange(8)[None, :] * 5.0,
        "iid_1024x4": np.random.default_rng(1).normal(size=(1024, 4)),
        "ar1": _ar1(1024, 4, 0.95, 1),
        "odd_T": _ar1(301, 6, 0.5, 2),
        "short": _ar1(5, 3, 0.3, 3),
        "anti": _ar1(257, 5, -0.6, 4),
    }


DRAWS = _draws()


@pytest.mark.parametrize("name", sorted(DRAWS))
@pytest.mark.parametrize("fn", ["rhat", "ess"])
def test_diagnostic_equal(name, fn):
    x = DRAWS[name]
    want = float(getattr(jmesh, fn)(jnp.asarray(x)))
    got = getattr(tmesh, fn)(torch.tensor(x))
    assert got.dtype == torch.float64 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-10)


def test_rhat_and_ess_separate_the_cases():
    """tests/test_parallel.py's bounds, on the port."""
    assert abs(float(tmesh.rhat(torch.tensor(DRAWS["iid"]))) - 1.0) < 0.05
    assert float(tmesh.rhat(torch.tensor(DRAWS["shifted"]))) > 2.0
    iid = DRAWS["iid_1024x4"]
    assert float(tmesh.ess(torch.tensor(iid))) > 0.5 * iid.size
    ar = DRAWS["ar1"]
    assert float(tmesh.ess(torch.tensor(ar))) < 0.15 * ar.size


@pytest.mark.parametrize("dim", [0, 1])
def test_cross_chain_moments_equal(dim):
    x = DRAWS["odd_T"]
    jm, jv = jmesh.cross_chain_moments(jnp.asarray(x), axis=dim)
    tm, tv = tmesh.cross_chain_moments(torch.tensor(x), dim=dim)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
