"""The slice moves' kernel (ops/slice_cuda.py, csrc/slice_move.cu) and its
plain version slice_move_ref.

On the CPU: slice_move_ref gives samplers/slice.slice_sample's x and ok
for the same draws (its extra blocks left unused), for both moves' log
posteriors, in f32 and f64, over 1, 4 and 100 groups, with chains that
run to the 200-try cap; the draws it makes, replayed by the benchmark's
plain reference (benchmark/reference/hpyp_ref.slice_sample, f64), give
the same moves within f32 rounding; sample_a and sample_b on CPU chains
take slice_sample and build nothing; the lanes a chain; the wrapper
refuses what the kernel cannot take.

On a card (``-m cuda``): the kernel against slice_move_ref at the cells'
shapes (16384 x 4, 512 x 100, 512 x 1), both moves, f32 and f64: x and ok
equal on >= 99.9% of the chains, the rest within the rounding of the
level; one launch a batch; chains at the cap take 7 batches; sample_a
and sample_b take the kernel.

This file imports no JAX."""
import types

import numpy as np
import pytest
import torch

from benchmark.reference import hpyp_ref
from libstb_tpu_torch.core import agrid, rng
from libstb_tpu_torch.ops import _nvcc, slice_cuda
from libstb_tpu_torch.samplers import hyper
from libstb_tpu_torch.samplers import slice as slicemod

SHAPES = [(16384, 4), (512, 100), (512, 1)]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slice moves' kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def move_inputs(density, C, I, dtype, device, seed=0, capped=0):
    """One move of ``C`` chains over ``I`` groups as sample_a / sample_b
    build it (chip_smoke.py's phase 10e takes it too): ``logpost``,
    ``x0``, ``lo``, ``hi``, ``kernel(gen)`` (the kernel's move),
    ``scale(x)`` (the size of the log posterior's terms), ``lp64`` (the
    log posterior in f64 on the same values) and ``nbytes`` (what a
    launch reads and writes once: T, b and the curve or Q and a, K + 1
    uniforms, the state).  Totals T in 1..40; the a-move on a centred grid
    curve of 8 (n, t) pairs a chain, b 0.5-20.5; the b-move at a
    0.05-0.95 (every 16th chain 0), Q 0.5-5.5.  The first ``capped``
    chains read NaN totals, so that they accept nothing and run to the
    try cap."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=dtype, device=device)

    T = torch.randint(1, 41, (C, I), generator=g, device=device).to(dtype)
    T[:capped, 0] = torch.nan
    m = types.SimpleNamespace()
    if density == "a":
        grid = agrid.make_grid(24, 24, g=16, dtype=dtype, device=device)
        ns = torch.randint(2, 21, (C, 8), generator=g, device=device)
        ts = torch.minimum(ns, torch.randint(1, 8, (C, 8), generator=g,
                                             device=device))
        curve = grid.data_curve(ns, ts)
        curve = curve - curve.amax(dim=-1, keepdim=True)
        b = (0.5 + 20.0 * rand(C))[:, None].expand(C, I)
        m.x0, m.lo, m.hi = hyper.a_bounds(0.05 + 0.9 * rand(C))
        m.logpost = hyper._logpost_a(T, b, curve, grid)
        grid64 = agrid.make_grid(24, 24, g=16, dtype=torch.float64,
                                 device=device)
        m.lp64 = hyper._logpost_a(T.double(), b.double(), curve.double(),
                                  grid64)

        def kernel(gen):
            return slice_cuda.slice_move_a(gen, m.x0, m.lo, m.hi, T, b, curve,
                                           grid)

        def scale(x):
            y = b / x[:, None]
            return ((T * torch.log(x[:, None])).abs()
                    + torch.lgamma(T + y).abs() + torch.lgamma(y).abs()
                    ).sum(-1) + 2 * curve.abs().amax(-1)
        inputs = C * I + C + curve.numel()
    else:
        shape = 1.5
        a = 0.05 + 0.9 * rand(C)
        a[::16] = 0.0
        Q = 0.5 + 5.0 * rand(C)
        m.x0 = torch.clamp(30.0 * rand(C), hyper.B_MIN, hyper.B_MAX)
        m.lo = torch.full_like(m.x0, hyper.B_MIN)
        m.hi = torch.full_like(m.x0, hyper.B_MAX)
        m.logpost = hyper._logpost_b(Q, T, shape, a)
        m.lp64 = hyper._logpost_b(Q.double(), T.double(), shape, a.double())

        def kernel(gen):
            return slice_cuda.slice_move_b(gen, m.x0, m.lo, m.hi, Q, T, shape,
                                           a)

        def scale(x):
            y = (x / torch.where(a > 0, a, 1.0))[:, None]
            return ((Q * x).abs() + (0.5 * torch.log(x)).abs()
                    + (torch.lgamma(T + y).abs() + torch.lgamma(y).abs())
                    .sum(-1))
        inputs = C * I + 2 * C
    m.kernel, m.scale = kernel, scale
    item = torch.finfo(dtype).bits // 8
    m.nbytes = item * (inputs + C * (slice_cuda.K + 1) + 4 * C) + C
    return m


class _Counted(rng.Replay):
    """A Replay that counts the draws it hands out."""

    def __init__(self, draws):
        super().__init__(draws)
        self.used = 0

    def next(self, shape, dtype, device):
        self.used += 1
        return super().next(shape, dtype, device)


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("density", ["a", "b"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 4, 100])
def test_ref_equals_slice_sample(density, dtype, groups):
    """The same numpy-made draws: slice_move_ref's x and ok are
    slice_sample's; the capped chains keep x0 and report not ok, and the
    batches drew the level's uniform and 200 tries."""
    C = 96
    m = move_inputs(density, C, groups, dtype, "cpu", seed=groups, capped=3)
    draws = list(np.random.default_rng(groups).random((1 + 7 * 32, C)))
    x1, ok1 = slicemod.slice_sample(m.logpost, rng.Replay(draws), m.x0, m.lo,
                                    m.hi)
    gen = _Counted(draws)
    x2, ok2 = slice_cuda.slice_move_ref(m.logpost, gen, m.x0, m.lo, m.hi)
    assert torch.equal(x1, x2) and torch.equal(ok1, ok2)
    assert not bool(ok2[:3].any()) and bool(ok2[3:].all())
    assert torch.equal(x2[:3], m.x0[:3])
    assert not torch.equal(x2[3:], m.x0[3:])
    assert gen.used == 1 + slicemod.TOOMANY


@pytest.mark.parametrize("density", ["a", "b"])
def test_ref_draws_a_batch_at_a_time(density):
    """Without capped chains one batch ends the move: the level's uniform
    and K tries' blocks, whatever the slowest chain needed."""
    m = move_inputs(density, 64, 4, torch.float64, "cpu")
    draws = list(np.random.default_rng(5).random((1 + 7 * 32, 64)))
    gen = _Counted(draws)
    _, ok = slice_cuda.slice_move_ref(m.logpost, gen, m.x0, m.lo, m.hi)
    assert bool(ok.all()) and gen.used == 1 + slice_cuda.K


@pytest.mark.parametrize("density,groups", [("a", 4), ("a", 100),
                                            ("b", 1), ("b", 100)])
def test_replay_of_the_ref_draws(monkeypatch, density, groups):
    """The draws slice_move_ref makes in f32 through ``rng.uniform``,
    replayed by the benchmark's f64 reference, give the same x within f32
    rounding on >= 99% of the chains (the HPYP cell's replay)."""
    m = move_inputs(density, 512, groups, torch.float32, "cpu", seed=11)
    draws, real = [], rng.uniform

    def record(*args, **kw):
        draws.append(real(*args, **kw))
        return draws[-1]

    monkeypatch.setattr(rng, "uniform", record)
    x, ok = slice_cuda.slice_move_ref(m.logpost,
                                      torch.Generator().manual_seed(3), m.x0,
                                      m.lo, m.hi)
    monkeypatch.undo()
    assert bool(ok.all()) and len(draws) == 1 + slice_cuda.K
    ref = hpyp_ref.slice_sample(iter(draws), m.lp64, m.x0.double(),
                                m.lo.double(), m.hi.double())
    gap = (x.double() - ref).abs() / ref.abs()
    assert float((gap <= 1e-5).double().mean()) >= 0.99, float(gap.max())


@pytest.mark.parametrize("move", ["a", "b"])
def test_cpu_moves_take_slice_sample(monkeypatch, move):
    """On CPU chains sample_a and sample_b run slice_sample once and build
    and launch nothing."""
    monkeypatch.setattr(_nvcc, "build_all", lambda _: pytest.fail("built"))
    calls, real = [], slicemod.slice_sample

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(slicemod, "slice_sample", spy)
    before = slice_cuda.LAUNCHES["slice_move"]
    C, dt = 32, torch.float64
    gen = torch.Generator().manual_seed(4)
    g = torch.Generator().manual_seed(6)
    T = torch.randint(1, 20, (C, 4), generator=g).to(dt)
    a = torch.full((C,), 0.4, dtype=dt)
    b = torch.full((C,), 5.0, dtype=dt)
    if move == "a":
        grid = agrid.make_grid(24, 24, g=16, dtype=dt, device="cpu")
        ns = torch.randint(2, 21, (8,), generator=g)
        ts = torch.minimum(ns[None], torch.randint(1, 8, (C, 8), generator=g))
        x, ok = hyper.sample_a(gen, a, grid, ns, ts, T, b[:, None].expand(
            C, 4))
    else:
        N = T + torch.randint(0, 10, (C, 4), generator=g).to(dt)
        x, ok = hyper.sample_b(gen, b, N, T, a, 1.0, 1.0)
    assert calls == [1] and bool(ok.all()) and not torch.equal(x, {
        "a": a, "b": b}[move])
    assert slice_cuda.LAUNCHES["slice_move"] == before


@pytest.mark.parametrize("groups,lanes", [(1, 1), (2, 2), (3, 4), (4, 4),
                                          (5, 8), (17, 32), (32, 32),
                                          (33, 32), (100, 32)])
def test_lanes(groups, lanes):
    assert slice_cuda.lanes(groups) == lanes


def test_lanes_refuses_no_groups():
    with pytest.raises(ValueError, match="0 groups"):
        slice_cuda.lanes(0)


def _kernel_args(density, C=8, I=4, dtype=torch.float32):
    """Valid CPU arguments of slice_move_a / slice_move_b by name."""
    z = torch.full((C,), 0.5, dtype=dtype)
    kw = dict(gen=torch.Generator(), x0=z, lo=z * 0.5, hi=z * 1.5,
              T=torch.ones((C, I), dtype=dtype))
    if density == "a":
        grid = agrid.make_grid(8, 8, g=8, dtype=dtype, device="cpu")
        return dict(kw, b=torch.ones((C, I), dtype=dtype),
                    curve=torch.zeros((C, 8), dtype=dtype), grid=grid)
    return dict(kw, Q=z.clone(), shape=1.5, a=z.clone())


def _call(density, kw):
    fn = slice_cuda.slice_move_a if density == "a" else slice_cuda.slice_move_b
    return fn(**kw)


@pytest.mark.parametrize("density,layout", [("a", "rows"), ("a", "columns"),
                                            ("b", "rows")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_passes_all_but_the_device(density, layout, dtype):
    """Valid arguments pass every check but the device's, the curve in
    either layout (data_curve gives a card's curve column-major)."""
    kw = _kernel_args(density, dtype=dtype)
    if layout == "columns":
        kw["curve"] = kw["curve"].t().contiguous().t()
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _call(density, kw)


@pytest.mark.parametrize("density,name,bad,error,match", [
    ("a", "x0", lambda x: x.half(), TypeError, "float32 or float64"),
    ("b", "x0", lambda x: x.half(), TypeError, "float32 or float64"),
    ("a", "lo", lambda x: x.double(), TypeError, "lo has dtype"),
    ("b", "Q", lambda x: x.double(), TypeError, "Q has dtype"),
    ("b", "a", lambda x: x[:4], ValueError, "a has shape"),
    ("a", "T", lambda x: x[:, :3], ValueError, "b has shape"),
    ("b", "T", lambda x: x[:4], ValueError, "T has shape"),
    ("a", "b", lambda x: x[:, :2], ValueError, "b has shape"),
    ("a", "curve", lambda x: x[:, :7], ValueError, "curve has shape"),
    ("a", "grid", lambda g: agrid.make_grid(8, 8, g=3, device="cpu"),
     ValueError, "3 discounts"),
    ("a", "curve", lambda x: x[:5], ValueError, "curve has shape"),
    ("b", "hi", lambda x: torch.stack([x, x], 1)[:, 0], ValueError,
     "hi must be contiguous"),
    ("a", "x0", lambda x: x[:, None], ValueError, "x0 has shape"),
])
def test_wrapper_refuses(density, name, bad, error, match):
    kw = _kernel_args(density)
    kw[name] = bad(kw[name])
    with pytest.raises(error, match=match):
        _call(density, kw)


# -- on the card -------------------------------------------------------------

def agreement(logpost, scale, x0, u0, got, ref):
    """(share of chains whose x and ok equal the plain version's, worst
    level gap): for the chains that differ, how far the plain version's
    log posterior at the kernel's point lies below the plain version's
    level, in units of the terms' size (the rounding of the level)."""
    same = (got[0] == ref[0]) & (got[1] == ref[1])
    y = logpost(x0) + torch.log(u0)
    gap = ((y - logpost(got[0])).clamp(min=0) / scale(got[0]))[~same]
    return (float(same.double().mean()),
            float(gap.max()) if gap.numel() else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["a", "b"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,groups", SHAPES)
def test_kernel_matches_ref(cuda_device, monkeypatch, density, dtype, C,
                            groups):
    """Two generators of one seed: the kernel's x and ok equal the plain
    version's on >= 99.9% of the chains, the others sit within 64 eps of
    the terms' size of the level; a launch a batch of K draws."""
    m = move_inputs(density, C, groups, dtype, cuda_device, seed=groups)
    draws, real = [], rng.uniform

    def count(*args, **kw):
        draws.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(rng, "uniform", count)
    before = slice_cuda.LAUNCHES["slice_move"]
    got = m.kernel(torch.Generator(cuda_device).manual_seed(9))
    torch.cuda.synchronize()
    monkeypatch.undo()
    batches = -(-(len(draws) - 1) // slice_cuda.K)
    assert slice_cuda.LAUNCHES["slice_move"] - before == batches >= 1
    ref = slice_cuda.slice_move_ref(
        m.logpost, torch.Generator(cuda_device).manual_seed(9), m.x0, m.lo,
        m.hi)
    u0 = torch.rand((C,), generator=torch.Generator(cuda_device).manual_seed(9),
                    dtype=dtype, device=cuda_device)
    share, gap = agreement(m.logpost, m.scale, m.x0, u0, got, ref)
    assert share >= 0.999 and gap <= 64 * torch.finfo(dtype).eps, (share,
                                                                     gap)
    assert bool(got[1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["a", "b"])
def test_kernel_capped_chains(cuda_device, density):
    """Chains that accept nothing run 200 tries in 7 launches, keep x0 and
    report not ok; the others move."""
    m = move_inputs(density, 512, 4, torch.float32, cuda_device, capped=5)
    before = slice_cuda.LAUNCHES["slice_move"]
    x, ok = m.kernel(torch.Generator(cuda_device).manual_seed(2))
    assert slice_cuda.LAUNCHES["slice_move"] - before == 7
    assert not bool(ok[:5].any()) and bool(ok[5:].all())
    assert torch.equal(x[:5], m.x0[:5]) and not torch.equal(x[5:], m.x0[5:])


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["a", "b"])
def test_moves_take_the_kernel(cuda_device, monkeypatch, move):
    """On CUDA chains sample_a and sample_b launch the kernel and never
    run slice_sample."""
    monkeypatch.setattr(slicemod, "slice_sample",
                        lambda *a, **k: pytest.fail("the per-try loop ran"))
    before = slice_cuda.LAUNCHES["slice_move"]
    C, dt, dev = 256, torch.float32, cuda_device
    gen = torch.Generator(dev).manual_seed(4)
    T = torch.randint(1, 20, (C, 4), device=dev).to(dt)
    a = torch.full((C,), 0.4, dtype=dt, device=dev)
    b = torch.full((C,), 5.0, dtype=dt, device=dev)
    if move == "a":
        grid = agrid.make_grid(24, 24, g=16, dtype=dt, device=dev)
        ns = torch.randint(2, 21, (8,), device=dev)
        ts = torch.minimum(ns[None], torch.randint(1, 8, (C, 8), device=dev))
        x, ok = hyper.sample_a(gen, a, grid, ns, ts, T, b[:, None].expand(
            C, 4))
    else:
        x, ok = hyper.sample_b(gen, b, T + 3, T, a, 1.0, 1.0)
    assert slice_cuda.LAUNCHES["slice_move"] > before
    assert bool(ok.all()) and bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_kernel_rejects_on_the_card(cuda_device):
    kw = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
          for k, v in _kernel_args("b").items()}
    kw["gen"] = torch.Generator(cuda_device)
    with pytest.raises(ValueError, match="lies on cpu"):
        slice_cuda.slice_move_b(**dict(kw, Q=kw["Q"].cpu()))
    with pytest.raises(TypeError, match="dtype"):
        slice_cuda.slice_move_b(**dict(kw, T=kw["T"].double()))
