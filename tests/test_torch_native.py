"""The port's native oracle (libstb_tpu_torch.native): its stb_ref.cpp is
byte-equal to the JAX package's, its results bitwise equal to the JAX
package's loader, and tests/test_native.py's checks pass against the port
(the long-double fill vs the port's f64 plain fill and exact rationals,
the CRP generator's E[T] and base)."""
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import gammaln

from libstb_tpu import native as jnative
from libstb_tpu_torch import native
from libstb_tpu_torch.core import stirling
from libstb_tpu_torch.models import pyp

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def test_source_is_a_byte_copy():
    assert ((ROOT / "libstb_tpu_torch" / "native" / "stb_ref.cpp")
            .read_bytes()
            == (ROOT / "libstb_tpu" / "native" / "stb_ref.cpp").read_bytes())


def test_built_into_the_port_build_dir():
    path = native.build()
    assert path.parent == ROOT / "libstb_tpu_torch" / "_build"
    assert path.name.startswith("stb_ref_") and path.suffix == ".so"


@pytest.mark.parametrize("a,n,m", [(0.5, 300, 60), (0.0, 50, 50),
                                   (0.9, 1000, 7), (0.37, 64, 200)])
def test_fill_ref_bitwise_equal_jax(a, n, m):
    for x, y in zip(native.fill_ref(a, n, m), jnative.fill_ref(a, n, m)):
        np.testing.assert_array_equal(x, y)
    logS, V, S1 = native.fill_ref(a, n, m, want_v=False, want_s1=False)
    assert V is None and S1 is None and logS.shape == (n, m)


@pytest.mark.parametrize("seed,args,H", [
    (3, (2, 12, 80, 0.5, 5.0), None),
    (1, (100, 20, 1000, 0.5, 10.0), None),
    (11, (1, 10, 100, 0.3, 2.0), np.r_[0, 0, 0, 0.5, 0, 0, 0, 0.5, 0, 0])])
def test_crp_generate_equal_jax(seed, args, H):
    got, t, T = native.crp_generate(seed, *args, H=H, return_latent=True)
    want, jt, jT = jnative.crp_generate(seed, *args, H=H, return_latent=True)
    assert isinstance(got, pyp.PYPData)
    for f in pyp.PYPData._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(T, jT)


# -- tests/test_native.py, against the port ----------------------------------

def test_fill_ref_matches_f64_plain_fill():
    logS, V, S1 = native.fill_ref(0.5, 300, 60)
    v64, s64, _ = stirling.fill_rows(0.5, 300, 60, dtype=torch.float64,
                                     device="cpu")
    s1 = stirling.s1_host(0.5, 300)
    full = s64.numpy() + s1[:, None]
    fin = np.isfinite(logS)
    assert np.max(np.abs(logS[fin] - full[fin])) < 1e-10
    finv = fin & np.isfinite(v64.numpy())
    np.testing.assert_allclose(V[finv], v64.numpy()[finv], rtol=1e-12)
    np.testing.assert_allclose(S1, s1, rtol=1e-13)


def test_fill_ref_exact_small_n():
    """Against exact rationals at a = 1/2."""
    a = Fraction(1, 2)
    N, M = 20, 8
    S = {(1, 1): Fraction(1)}
    for n in range(2, N + 1):
        for m in range(1, min(n, M) + 1):
            S[(n, m)] = (S.get((n - 1, m - 1), Fraction(0))
                         + (n - 1 - m * a) * S.get((n - 1, m), Fraction(0)))
    logS, _, _ = native.fill_ref(0.5, N, M)
    for n in range(1, N + 1):
        for m in range(1, min(n, M) + 1):
            want = float(np.log(float(S[(n, m)])))
            np.testing.assert_allclose(logS[n - 1, m - 1], want, atol=1e-12,
                                       err_msg=f"({n},{m})")


def test_crp_generate_statistics():
    """E[T] of PYP(a, b) after n draws = (b/a) ((b+a)_n / (b)_n - 1); the
    counts match the item streams."""
    a, b, n = 0.5, 5.0, 200
    reps = 400
    Ts = np.asarray([int(native.crp_generate(s + 1, 1, 50, n, a, b,
                                             return_latent=True)[2][0])
                     for s in range(reps)], np.float64)
    want = (b / a) * (np.exp(gammaln(b + a + n) - gammaln(b + a)
                             - gammaln(b + n) + gammaln(b)) - 1.0)
    se = Ts.std(ddof=1) / np.sqrt(reps)
    assert abs(Ts.mean() - want) < 5 * se, (Ts.mean(), want, se)
    d = native.crp_generate(3, 2, 12, 80, a, b)
    for j in range(2):
        sel = d.data_grp == j
        np.testing.assert_array_equal(
            np.bincount(d.data_cat[sel], minlength=12), d.n[j])
    assert d.first.sum() == (d.n > 0).sum()


def test_crp_generate_respects_base():
    H = np.zeros(10)
    H[3] = 0.5
    H[7] = 0.5
    d = native.crp_generate(11, 1, 10, 100, 0.3, 2.0, H=H)
    assert set(np.nonzero(d.n[0])[0].tolist()) <= {3, 7}


def test_native_data_drives_the_port():
    """A native PYPData feeds the port's sweeps like pyp.crp_generate's."""
    d = native.crp_generate(5, 2, 8, 30, 0.5, 2.0)
    t, T = pyp.init_state(d, 3, "cpu")
    assert t.shape == (3, 2, 8)
    np.testing.assert_array_equal(T[0].numpy(), (d.n > 0).sum(axis=1))
