"""Port parity: libstb_tpu_torch.core.sympoly vs libstb_tpu.core.sympoly.

Same log weights (a numpy seed) through both packages in f64: ``sympoly``
to rtol 1e-12 (+ the brute-force oracle of tests/test_sympoly.py to
1e-10); ``sympoly_sample``'s masks exactly equal on the uniforms JAX
draws (one (K,) + batch block from the key, handed over by rng.Replay),
and with a torch.Generator within 5 sigma of the exact subset
distribution."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import sympoly as jsym
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.core import sympoly as tsym

torch.set_num_threads(1)


def esp_exact(x, h):
    """Brute-force elementary symmetric polynomial."""
    return sum(np.prod(c) for c in itertools.combinations(x, h)) if h else 1.0


@pytest.mark.parametrize("shape,h", [((9,), 5), ((4, 7), 3), ((2, 3, 6), 6),
                                     ((12,), 0)])
def test_sympoly_equal(shape, h):
    x = np.random.default_rng(0).gamma(1.0, 5.0, size=shape)
    x.reshape(-1)[::5] = 0.0                   # absent features: log x = -inf
    with np.errstate(divide="ignore"):
        lx = np.log(x)
    got = tsym.sympoly(torch.tensor(lx), h)
    want = np.asarray(jsym.sympoly(jnp.asarray(lx), h))
    assert got.shape == shape[:-1] + (h + 1,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert not torch.isnan(got).any()
    row = x.reshape(-1, shape[-1])[0]
    oracle = np.array([esp_exact(row, k) for k in range(h + 1)])
    np.testing.assert_allclose(np.exp(got.reshape(-1, h + 1)[0].numpy()),
                               oracle, rtol=1e-10)


def test_sympoly_binomial():
    from scipy.special import comb
    le = tsym.sympoly(torch.zeros(12, dtype=torch.float64), 6)
    np.testing.assert_allclose(
        le.numpy(), np.log([comb(12, h, exact=True) for h in range(7)]),
        rtol=1e-12)


@pytest.mark.parametrize("shape,h", [((8,), 4), ((5, 8), 3), ((2, 3, 6), 2),
                                     ((6,), 6)])
def test_sympoly_sample_equal(shape, h):
    r = np.random.default_rng(1)
    lx = np.log(r.gamma(1.0, 2.0, size=shape) + 0.05)
    for seed in range(6):
        key = jax.random.key(seed)
        want = np.asarray(jsym.sympoly_sample(key, jnp.asarray(lx), h))
        us = np.asarray(jax.random.uniform(
            key, (shape[-1],) + shape[:-1], jnp.float64))
        got = tsym.sympoly_sample(rng.Replay([us]), torch.tensor(lx), h)
        assert got.dtype == torch.bool and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.sum(-1) == h).all()


def test_sample_exact_distribution():
    """4000 batched draws from one generator against the exact subset
    probabilities (tests/test_sympoly.py:54-76)."""
    K, H, n = 6, 3, 4000
    x = np.random.default_rng(2).gamma(1.0, 2.0, size=K)
    subsets = list(itertools.combinations(range(K), H))
    probs = np.array([np.prod(x[list(s)]) for s in subsets])
    probs /= probs.sum()
    lx = torch.tensor(np.log(x)).expand(n, K)
    masks = tsym.sympoly_sample(rng.generator(0, "cpu"), lx, H).numpy()
    assert (masks.sum(axis=1) == H).all()
    counts = {}
    for m in masks:
        key = tuple(np.nonzero(m)[0])
        counts[key] = counts.get(key, 0) + 1
    for s, p in zip(subsets, probs):
        se = np.sqrt(n * p * (1 - p))
        assert abs(counts.get(s, 0) - n * p) < 5 * se + 3, (s, n * p)


def test_absent_features_are_never_picked():
    """-inf weights: never in the mask, with enough finite weights for the
    h picks or (as the JAX sampler, e_h = 0) without."""
    lx = np.array([0.3, -np.inf, 1.2, -np.inf, 0.1])
    for h in (2, 3, 4):
        key = jax.random.key(h)
        want = np.asarray(jsym.sympoly_sample(key, jnp.asarray(lx), h))
        us = np.asarray(jax.random.uniform(key, (5,), jnp.float64))
        got = tsym.sympoly_sample(rng.Replay([us]), torch.tensor(lx), h)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[1] and not got[3] and int(got.sum()) <= h
    assert int(tsym.sympoly_sample(rng.generator(1, "cpu"),
                                   torch.tensor(lx), 3).sum()) == 3
