"""Port parity: libstb_tpu_torch.core.lgcache vs libstb_tpu.core.lgcache.

The same (n, alpha) and (a, n) points through both packages in f64, rtol
1e-10 (lgamma and the digamma series enter), plus the scipy and closed-
form checks of tests/test_lgcache.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma as sdigamma
from scipy.special import gammaln

from libstb_tpu.core import lgcache as jlg
from libstb_tpu_torch.core import lgcache as tlg

torch.set_num_threads(1)

_R = np.random.default_rng(31)
NS = np.concatenate([[-1, 0, 1, 2, 3, 4, 57, 500], _R.integers(0, 300, 100)])
ALPHA = np.concatenate([[0.1, 0.7, 3.3, 1e-6, 1e-3, 0.5, 2.0, 40.0],
                        np.exp(_R.uniform(np.log(1e-4), np.log(50.0), 100))])


@pytest.mark.parametrize("fn", ["gammadiff", "psidiff"])
def test_diffs_equal(fn):
    got = getattr(tlg, fn)(torch.tensor(NS), torch.tensor(ALPHA)).numpy()
    want = np.asarray(getattr(jlg, fn)(jnp.asarray(NS), jnp.asarray(ALPHA)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    oracle = (gammaln if fn == "gammadiff" else sdigamma)
    ok = NS >= 0
    np.testing.assert_allclose(
        got[ok], oracle(NS[ok] + ALPHA[ok]) - oracle(ALPHA[ok]), rtol=1e-9,
        atol=1e-9)
    assert (got[NS <= 0] == 0).all()


def test_qval_equal():
    a = np.concatenate([[0.0, 0.01, 0.0199, 0.02, 0.25, 0.45],
                        _R.uniform(0.0, 0.49, 100)])
    n = np.concatenate([[1, 2, 3, 9, 11, 200], _R.integers(1, 300, 100)])
    got = tlg.qval(torch.tensor(a), torch.tensor(n)).numpy()
    want = np.asarray(jlg.qval(jnp.asarray(a), jnp.asarray(n)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    # S^{n+1}_2 / S^{n+1}_1 at n = 1: 1 / (1 - a)
    np.testing.assert_allclose(
        float(tlg.qval(torch.tensor(0.25, dtype=torch.float64), 1)),
        1 / 0.75, rtol=1e-12)


@pytest.mark.parametrize("name,arg", [("gcache_table", 0.3),
                                      ("pcache_table", 0.3),
                                      ("qcache_table", 0.25),
                                      ("qcache_table", 0.005)])
def test_cache_tables_equal(name, arg):
    got = getattr(tlg, name)(torch.tensor(arg, dtype=torch.float64), 24)
    want = np.asarray(getattr(jlg, name)(jnp.asarray(arg, jnp.float64), 24))
    assert got.shape == (24,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)
    assert float(got[0]) == 0.0


def test_cache_tables_pointwise():
    gt = tlg.gcache_table(torch.tensor(0.3, dtype=torch.float64), 20).numpy()
    j = np.arange(1, 20)
    np.testing.assert_allclose(gt[1:], gammaln(j + 0.3) - gammaln(0.3),
                               rtol=1e-10)
    qt = tlg.qcache_table(torch.tensor(0.25, dtype=torch.float64), 8).numpy()
    np.testing.assert_allclose(qt[1], 1 / (1 - 0.25), rtol=1e-12)
    np.testing.assert_allclose(qt[2], 3 / (2 - 0.25), rtol=1e-12)
    np.testing.assert_allclose(
        qt[3], (11 - 7 * 0.25) / (3 - 0.25) / (2 - 0.25), rtol=1e-12)
    assert tlg.gcache_table(0.3, 5).dtype == torch.float32
