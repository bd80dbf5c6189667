"""Port parity: libstb_tpu_torch.samplers.ars vs libstb_tpu.samplers.ars.

The JAX sampler's draws are rebuilt from its key (per round: split(key,
3) -> a Gumbel block and a uniform; split(key, 3) -> the accept uniform
and, in Metropolis mode, one more; ars.py:234-241, 252-265) and handed to
the port through rng.Replay, on the targets of tests/test_ars.py.  In f64
the draws x must then agree to rtol 1e-9 with ``ok`` and ``neval`` equal;
the envelope helpers agree to rtol 1e-12.  With a real torch.Generator
the port is held to the targets' known moments, as tests/test_ars.py
holds the JAX sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.samplers import ars as jars
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.samplers import ars as tars

torch.set_num_threads(1)


def _ars_draws(key, shape, n_max=16, metropolis=False):
    """ars_sample's draws in the order the port asks for them."""
    while True:
        key, kg, ku = jax.random.split(key, 3)
        yield np.asarray(jax.random.gumbel(
            kg, shape + (2 * (n_max - 1),), jnp.float64))
        yield np.asarray(jax.random.uniform(ku, shape, jnp.float64, 1e-12,
                                            1.0))
        key, ka, km = jax.random.split(key, 3)
        yield np.asarray(jax.random.uniform(ka, shape, jnp.float64, 1e-12,
                                            1.0))
        if metropolis:
            yield np.asarray(jax.random.uniform(km, shape, jnp.float64,
                                                1e-12, 1.0))


def _bimodal(np_):
    def logp(x):
        return np_.logaddexp(-0.5 * (x - 2.0) ** 2 / 0.25,
                             np.log(3.0) - 0.5 * (x + 2.0) ** 2 / 0.25)
    return logp


_MU = np.linspace(-3.0, 3.0, 96)

# name -> (C, lo, hi, jax logpost, torch logpost, ars_sample keywords)
TARGETS = {
    "truncated_normal": (128, -6.0, 6.0, lambda x: -0.5 * x * x,
                         lambda x: -0.5 * x * x, {}),
    "gamma": (128, 1e-3, 50.0, lambda x: 4.0 * jnp.log(x) - x,
              lambda x: 4.0 * torch.log(x) - x, {}),
    "skewed_exponential": (128, 1e-4, 20.0, lambda x: -x, lambda x: -x, {}),
    "heterogeneous": (96, -12.0, 12.0,
                      lambda x: -0.5 * (x - jnp.asarray(_MU)) ** 2,
                      lambda x: -0.5 * (x - torch.tensor(_MU)) ** 2, {}),
    "small_envelope": (64, -6.0, 6.0, lambda x: -0.5 * x * x,
                       lambda x: -0.5 * x * x, dict(n_init=3, n_max=6)),
    # a spike the 5-point envelope cannot cover in 2 rounds: chains give up
    "reject_cap": (64, -1.0, 1.0,
                   lambda x: -0.5 * ((x - 0.123456) / 1e-3) ** 2,
                   lambda x: -0.5 * ((x - 0.123456) / 1e-3) ** 2,
                   dict(max_rejects=2)),
    "bimodal_no_metropolis": (64, -8.0, 8.0, _bimodal(jnp), _bimodal(torch),
                              {}),
}


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", sorted(TARGETS))
def test_ars_sample_equal(name, warm):
    C, lo, hi, jlogp, tlogp, kw = TARGETS[name]
    key = jax.random.key(sorted(TARGETS).index(name))
    xp = np.random.default_rng(3).uniform(lo, hi, C) if warm else None
    jx, jok, jnev = jars.ars_sample(
        jlogp, key, jnp.full((C,), lo), jnp.full((C,), hi),
        x_prev=None if xp is None else jnp.asarray(xp), with_info=True, **kw)
    tx, tok, tnev = tars.ars_sample(
        tlogp, rng.Replay(_ars_draws(key, (C,), kw.get("n_max", 16))),
        torch.full((C,), lo, dtype=torch.float64), hi,
        x_prev=None if xp is None else torch.tensor(xp), with_info=True, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tnev.numpy(), np.asarray(jnev))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9)
    assert tnev.dtype == torch.int32 and tok.dtype == torch.bool
    n_init = kw.get("n_init", 5)
    if name == "reject_cap":
        assert not tok.all()
        assert int(tnev.max()) == n_init + 1 + kw["max_rejects"]
    else:
        assert tok.all() and int(tnev.min()) >= n_init + 2


def test_metropolis_chain_equal():
    """ARMS mode on the bimodal target, 4 moves chained: state after every
    move equal (the Metropolis uniform is the round's fourth draw)."""
    C = 96
    key = jax.random.key(4)
    jx, tx = jnp.zeros((C,)), torch.zeros(C, dtype=torch.float64)
    for _ in range(4):
        key, k = jax.random.split(key)
        jx, jok = jars.ars_sample(_bimodal(jnp), k, jnp.full((C,), -8.0),
                                  jnp.full((C,), 8.0), x_prev=jx,
                                  metropolis=True)
        tx, tok = tars.ars_sample(
            _bimodal(torch), rng.Replay(_ars_draws(k, (C,), metropolis=True)),
            torch.full((C,), -8.0, dtype=torch.float64), 8.0, x_prev=tx,
            metropolis=True)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (np.asarray(jx) < 0).any() and (np.asarray(jx) > 0).any()


def test_leading_axes_are_flattened():
    """(2, 24) chains: the same draws as the JAX sampler, which keeps the
    axes; the callback sees the bounds' shape."""
    shape = (2, 24)
    mu = np.linspace(-2.0, 2.0, 48).reshape(shape)
    key = jax.random.key(9)
    jx, jok = jars.ars_sample(lambda x: -0.5 * (x - jnp.asarray(mu)) ** 2,
                              key, jnp.full(shape, -9.0), jnp.full(shape, 9.0))

    def tlogp(x):
        assert x.shape == shape
        return -0.5 * (x - torch.tensor(mu)) ** 2

    tx, tok = tars.ars_sample(tlogp, rng.Replay(_ars_draws(key, shape)),
                              torch.full(shape, -9.0, dtype=torch.float64),
                              torch.tensor(9.0))
    assert tx.shape == shape and tok.shape == shape
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.fixture(scope="module")
def envelopes():
    """Sorted (C, P) supports with k live points, the rest the last live
    point repeated, and log densities of a concave and a bimodal target."""
    r = np.random.default_rng(5)
    C, P = 40, 10
    k = r.integers(3, P + 1, C)
    xs = np.sort(r.uniform(-4.0, 4.0, (C, P)), axis=1)
    xs[5, 2] = xs[5, 1]                                # a repeated point
    fs = np.where(np.arange(C)[:, None] % 2 == 0, -0.5 * xs ** 2,
                  np.asarray(_bimodal(np)(xs)))
    for c in range(C):
        xs[c, k[c]:] = xs[c, k[c] - 1]
        fs[c, k[c]:] = fs[c, k[c] - 1]
    x = r.uniform(-4.5, 4.5, C)
    x[:4] = xs[:4, 1]                                  # on a support point
    return xs, fs, k, x


def test_hull_pieces_equal(envelopes):
    xs, fs, k, _ = envelopes
    want = jars._hull_pieces(jnp.asarray(xs), jnp.asarray(fs),
                             jnp.asarray(k, jnp.int32), xs.shape[1])
    got = tars._hull_pieces(torch.tensor(xs), torch.tensor(fs),
                            torch.tensor(k))
    for g, w, what in zip(got, want, ("starts", "widths", "y0s", "slopes",
                                      "logm")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   err_msg=what)
    assert not torch.isnan(got[4]).any()
    assert (torch.isneginf(got[4]) == (got[1] <= 0)).all()


@pytest.mark.parametrize("fn", ["_hull_at", "_squeeze_at"])
def test_hull_and_squeeze_at_equal(envelopes, fn):
    xs, fs, k, x = envelopes
    want = jax.vmap(getattr(jars, fn))(
        jnp.asarray(xs), jnp.asarray(fs), jnp.asarray(k, jnp.int32),
        jnp.asarray(x))
    got = getattr(tars, fn)(torch.tensor(xs), torch.tensor(fs),
                            torch.tensor(k), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_insert_equal(envelopes):
    xs, fs, k, x = envelopes
    P = xs.shape[1]
    f = -0.5 * x ** 2
    want = jax.vmap(jars._insert, in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(xs), jnp.asarray(fs), jnp.asarray(k, jnp.int32),
        jnp.asarray(x), jnp.asarray(f), P)
    got = tars._insert(torch.tensor(xs), torch.tensor(fs), torch.tensor(k),
                       torch.tensor(x), torch.tensor(f))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (k == P).any() and (got[2].numpy() <= P).all()
    live = got[0].numpy()
    assert (np.diff(live, axis=1) >= 0).all()


def test_exponential_integrals_equal():
    r = np.random.default_rng(6)
    y0 = r.uniform(-5.0, 5.0, 200)
    s = np.concatenate([r.uniform(-40.0, 40.0, 150), r.uniform(-1e-7, 1e-7, 48),
                        [0.0, 0.0]])
    h = np.concatenate([np.exp(r.uniform(-8.0, 3.0, 198)), [0.0, 1.0]])
    want = jars._log_int_exp(jnp.asarray(y0), jnp.asarray(s), jnp.asarray(h))
    got = tars._log_int_exp(torch.tensor(y0), torch.tensor(s), torch.tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    logw = np.asarray(want) + np.log(r.uniform(1e-12, 1.0, 200))
    np.testing.assert_allclose(
        tars._inv_int_exp(torch.tensor(y0), torch.tensor(s), torch.tensor(h),
                          torch.tensor(logw)).numpy(),
        np.asarray(jars._inv_int_exp(jnp.asarray(y0), jnp.asarray(s),
                                     jnp.asarray(h), jnp.asarray(logw))),
        rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,mean,sd", [
    ("truncated_normal", 0.0, 1.0), ("gamma", 5.0, np.sqrt(5.0)),
    ("skewed_exponential", 1.0, 1.0)])
def test_moments_with_a_torch_generator(name, mean, sd, dtype):
    """One draw per chain, 4096 chains: mean within 5 SE, sd within 6%;
    no NaN leaks from the masked lanes in f32."""
    C = 4096
    _, lo, hi, _, tlogp, _ = TARGETS[name]
    x, ok, nev = tars.ars_sample(tlogp, rng.generator(1, "cpu"),
                                 torch.full((C,), lo, dtype=dtype), hi,
                                 with_info=True)
    assert x.dtype == dtype and bool(ok.all())
    assert bool(torch.isfinite(x).all())
    assert bool(((x >= lo) & (x <= hi)).all())
    assert abs(float(x.mean()) - mean) < 5 * sd / np.sqrt(C)
    assert abs(float(x.std()) / sd - 1.0) < 0.06
    assert 7 <= float(nev.float().mean()) < 20


def test_metropolis_mode_weights():
    """20 ARMS moves per walker on the bimodal target: the left mode holds
    3/4 of the mass (tests/test_ars.py:65-79)."""
    C = 2048
    gen = rng.generator(4, "cpu")
    x = torch.zeros(C, dtype=torch.float64)
    for _ in range(20):
        x, _ = tars.ars_sample(_bimodal(torch), gen,
                               torch.full((C,), -8.0, dtype=torch.float64),
                               8.0, x_prev=x, metropolis=True)
    assert abs(float((x < 0).double().mean()) - 0.75) < 0.08
