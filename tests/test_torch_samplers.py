"""Port parity: libstb_tpu_torch.samplers (slice, hyper) and core.rng.

The slice moves and the (a, b) steps run on the draws JAX makes, rebuilt
from the key and handed to the port through rng.Replay; results must
then agree to f64 rounding (rtol 1e-12; 1e-10 where lgamma enters).  The
gamma and loggamma draws themselves are checked against scipy's
distributions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from libstb_tpu.core import agrid as jag
from libstb_tpu.samplers import hyper as jhyper
from libstb_tpu.samplers import slice as jslice
from libstb_tpu_torch import convert
from libstb_tpu_torch.core import rng
from libstb_tpu_torch.models import pyp as tpyp
from libstb_tpu_torch.samplers import hyper as thyper
from libstb_tpu_torch.samplers import slice as tslice

torch.set_num_threads(1)


def _slice_draws(key, shape):
    """The uniforms of one slice_sample loop (slice.py:47-73): the level
    draw, then one per try, each from its own split."""
    key, ky = jax.random.split(key)
    yield np.asarray(jax.random.uniform(ky, shape, jnp.float64))
    while True:
        key, ku = jax.random.split(key)
        yield np.asarray(jax.random.uniform(ku, shape, jnp.float64))


def test_slice_sample_gaussian():
    C = 16
    mu = np.linspace(-3.0, 4.0, C)
    sig = np.linspace(0.05, 2.0, C)
    x0, lo, hi = mu + 0.3 * sig, mu - 6 * sig, mu + 6 * sig
    key = jax.random.key(3)
    jx, jok = jslice.slice_sample(
        lambda x: -0.5 * ((x - mu) / sig) ** 2, key, jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(hi))
    tmu, tsig = torch.tensor(mu), torch.tensor(sig)
    tx, tok = tslice.slice_sample(
        lambda x: -0.5 * ((x - tmu) / tsig) ** 2,
        rng.Replay(_slice_draws(key, (C,))), torch.tensor(x0),
        torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not np.allclose(tx.numpy(), x0)


def test_slice_sample_try_cap():
    """A density nothing beats exhausts the cap: x stays, ok is False."""
    x, ok = tslice.slice_sample(
        lambda x: torch.where(x == 0.5, 0.0, -torch.inf),
        rng.generator(0, "cpu"), torch.full((3,), 0.5, dtype=torch.float64),
        0.0, 1.0, max_tries=7)
    assert torch.equal(x, torch.full((3,), 0.5, dtype=torch.float64))
    assert not bool(ok.any())


@pytest.fixture(scope="module")
def workload():
    data = tpyp.crp_generate(5, 3, 12, 40, 0.5, 5.0)
    jg = jag.make_grid(48, 48, g=32, dtype=jnp.float64)
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in convert.GRID_ARRAYS},
        {k: getattr(jg, k) for k in convert.GRID_STATICS}, "cpu")
    C = 12
    r = np.random.default_rng(8)
    ns = data.n.reshape(-1)
    ts = np.where(ns > 0, np.minimum(r.integers(1, 9, (C, ns.size)), ns), 0)
    T = ts.reshape(C, 3, -1).sum(-1).astype(np.float64)
    return data, jg, tg, ns, ts, T


def test_sample_a_equal(workload):
    data, jg, tg, ns, ts, T = workload
    C = ts.shape[0]
    a0 = np.linspace(0.005, 0.99, C)               # clamped starts too
    b = np.linspace(0.5, 30.0, C)[:, None] * np.ones((1, 3))
    key = jax.random.key(21)
    ja, jok = jhyper.sample_a(key, jnp.asarray(a0), jg, jnp.asarray(ns),
                              jnp.asarray(ts), jnp.asarray(T),
                              jnp.asarray(b))
    ta, tok = thyper.sample_a(rng.Replay(_slice_draws(key, (C,))),
                              torch.tensor(a0), tg, torch.tensor(ns),
                              torch.tensor(ts), torch.tensor(T),
                              torch.tensor(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert ((ta.numpy() >= thyper.A_MIN) & (ta.numpy() <= thyper.A_MAX)).all()


def _sample_b_draws(key, b0, N, T, shape_):
    """sample_b's draws in order (hyper.py:334-349): loggamma(b), loggamma
    (N), gamma(shape + sum T), then the slice uniforms."""
    kq1, kq2, kg, ks = jax.random.split(key, 4)
    bshape = np.broadcast_shapes(b0[:, None].shape, N.shape)
    yield np.asarray(jax.random.loggamma(kq1, jnp.broadcast_to(
        jnp.maximum(b0[:, None], jhyper.B_MIN * 1e-3), bshape)))
    yield np.asarray(jax.random.loggamma(kq2, jnp.broadcast_to(
        jnp.maximum(N, 1.0), bshape)))
    yield np.asarray(jax.random.gamma(kg, shape_ + T.sum(-1)))
    yield from _slice_draws(ks, b0.shape)


@pytest.mark.parametrize("groups", ["first", "all"])
def test_sample_b_equal(workload, groups):
    """Mixed a > 0 (slice) and a == 0 (conjugate) chains; with all groups
    one group has N = 0 (masked out of the auxiliary sum)."""
    data, _, _, _, _, T = workload
    C = T.shape[0]
    a = np.where(np.arange(C) % 4 == 0, 0.0, np.linspace(0.1, 0.9, C))
    b0 = np.linspace(0.001, 300.0, C)
    if groups == "first":
        N, T = data.N[:1].astype(np.float64), T[:, :1]
    else:
        N = np.broadcast_to(data.N.astype(np.float64) * [1, 0, 1], (C, 3))
    key = jax.random.key(5)
    jb, jok = jhyper.sample_b(key, jnp.asarray(b0), jnp.asarray(N),
                              jnp.asarray(T), jnp.asarray(a), 1.1, 20.0)
    NC = np.broadcast_to(N, (C, N.shape[-1]))
    tb, tok = thyper.sample_b(rng.Replay(_sample_b_draws(key, b0, NC, T,
                                                         1.1)),
                              torch.tensor(b0), torch.tensor(N),
                              torch.tensor(T), torch.tensor(a), 1.1, 20.0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_deterministic_terms_equal(workload):
    _, _, _, _, _, T = workload
    C = T.shape[0]
    x = np.linspace(0.02, 0.97, C)
    b = np.linspace(0.3, 40.0, C)[:, None] * np.ones((1, 3))
    np.testing.assert_allclose(
        thyper._conc_terms(torch.tensor(x), torch.tensor(T),
                           torch.tensor(b)).numpy(),
        np.asarray(jhyper._conc_terms(jnp.asarray(x), jnp.asarray(T),
                                      jnp.asarray(b))), rtol=1e-12)
    Q = np.linspace(0.1, 3.0, C)
    a = np.where(np.arange(C) % 3 == 0, 0.0, x)
    np.testing.assert_allclose(
        thyper._bterms(torch.tensor(b[:, 0]), torch.tensor(Q),
                       torch.tensor(T), 1.1, torch.tensor(a)).numpy(),
        np.asarray(jhyper._bterms(jnp.asarray(b[:, 0]), jnp.asarray(Q),
                                  jnp.asarray(T), 1.1, jnp.asarray(a))),
        rtol=1e-12)
    a0 = np.linspace(-0.5, 1.5, C)
    for p, q in zip(thyper.a_bounds(torch.tensor(a0)),
                    jhyper.a_bounds(jnp.asarray(a0))):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-15)


@pytest.mark.parametrize("alpha", [0.004, 0.3, 2.5, 40.0])
def test_gamma_and_loggamma_draws(alpha):
    """200k draws each: sample mean within 6 SE of scipy's, a
    Kolmogorov-Smirnov p-value above 1e-3 (fixed seeds), the loggamma
    variance within 5%.  The plain gamma draw is checked from alpha = 0.3:
    at alpha = 0.004 some 6% of Gamma's mass lies below the smallest
    normal double, where torch clamps -- the underflow that sample_b's
    loggamma route exists for."""
    n = 200_000
    a = torch.full((n,), alpha, dtype=torch.float64)
    draws = [(rng.loggamma(rng.generator(1, "cpu"), a).numpy(),
              stats.loggamma(alpha))]
    if alpha >= 0.3:
        draws.append((rng.gamma(rng.generator(2, "cpu"), a).numpy(),
                      stats.gamma(alpha)))
    for x, dist in draws:
        assert np.isfinite(x).all()
        assert abs(x.mean() - dist.mean()) < 6 * dist.std() / np.sqrt(n)
        assert stats.kstest(x, dist.cdf).pvalue > 1e-3
    assert abs(draws[0][0].var() / draws[0][1].var() - 1) < 0.05
    np.testing.assert_allclose(stats.loggamma(alpha).mean(),
                               special.digamma(alpha), rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gumbel_and_open_uniform_draws(dtype):
    """200k draws each: the Gumbel's mean (Euler's constant) and variance
    (pi^2 / 6) within 6 SE / 3%, a KS p-value above 1e-3; the uniform on
    [1e-12, 1) has a finite log.  A Replay hands either back unchanged."""
    n = 200_000
    g = rng.gumbel(rng.generator(3, "cpu"), (n,), dtype, "cpu")
    assert g.dtype == dtype and bool(torch.isfinite(g).all())
    g = g.double().numpy()
    assert abs(g.mean() - np.euler_gamma) < 6 * np.pi / np.sqrt(6 * n)
    assert abs(g.var() / (np.pi ** 2 / 6) - 1) < 0.03
    assert stats.kstest(g, stats.gumbel_r.cdf).pvalue > 1e-3
    u = rng.uniform_open(rng.generator(4, "cpu"), (n,), dtype, "cpu")
    assert u.dtype == dtype and float(u.min()) >= 1e-12 and float(u.max()) < 1
    assert bool(torch.isfinite(torch.log(u)).all())
    assert abs(float(u.double().mean()) - 0.5) < 6 / np.sqrt(12 * n)
    rec = np.array([0.25, 1e-12, 0.75])
    for fn in (rng.gumbel, rng.uniform_open):
        np.testing.assert_array_equal(
            fn(rng.Replay([rec]), (3,), torch.float64, "cpu").numpy(), rec)
