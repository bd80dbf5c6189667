"""The TI sweep's kernel (ops/ti_cuda.py, csrc/ti_sweep.cu) against its
plain version, models/pyp._ti_run_ref.

On a card (``-m cuda``): for the same uniforms (two generators of one
seed) the kernel's t and T equal the plain loop's bitwise, sweep after
sweep, in f32 and f64, over group, cat and item schedules, on a grid and
on a StirlingTable, in every skip_first x legacy_odds, at a chain count
that fills no block whole and on counts whose groups differ in size (pad
slots); the inputs are left as they were and each sweep is one launch.
On the CPU: the sweep takes the plain loop and builds nothing, the
wrapper refuses what the kernel cannot take, what ti.prepare makes
passes the wrapper's checks but the device's, and the launch geometry.

This file imports no JAX."""
import numpy as np
import pytest
import torch

from libstb_tpu_torch.core import agrid, stirling
from libstb_tpu_torch.models import pyp
from libstb_tpu_torch.ops import _nvcc, ti_cuda

CHAINS = 293          # prime: a multiple of no block's chains
SWEEPS = 3
MODES = ["group", "cat", "item"]
ODDS = [(True, False), (False, False), (True, True), (False, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TI sweep's kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _data():
    """Three groups of 41, 29 and 36 items over 9 categories: the group
    schedule pads the shorter groups, the cat schedule most pairs."""
    n = np.array([[9, 0, 7, 5, 1, 0, 12, 4, 3],
                  [0, 6, 2, 0, 11, 3, 0, 5, 2],
                  [4, 4, 0, 9, 0, 8, 1, 0, 10]])
    H = pyp.base_distribution("linear", n.shape[1])
    return pyp.from_counts(n, H)


def _sched(data, mode):
    if mode == "item":
        return pyp.item_schedule(data)
    return pyp.ti_schedule(data, mode)


def _table(kind, data, dtype, device):
    n = int(data.n.max()) + 2
    if kind == "grid":
        return agrid.make_grid(n, n, g=32, dtype=dtype, device=device)
    return stirling.make(n, n, n + 32, n + 32, 0.5, dtype=dtype,
                         device=device)


def _state(data, kind, dtype, device, C=CHAINS):
    t, T = pyp.init_state(data, C, device)
    a = (torch.linspace(0.15, 0.85, C, dtype=dtype, device=device)
         if kind == "grid" else torch.full((C,), 0.5, dtype=dtype,
                                           device=device))
    b = torch.linspace(0.5, 20.0, C, dtype=dtype, device=device)
    return t, T, a, b


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["grid", "table"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("skip_first,legacy", ODDS)
def test_kernel_equals_plain_loop(cuda_device, dtype, kind, mode,
                                  skip_first, legacy):
    data = _data()
    tab = _table(kind, data, dtype, cuda_device)
    plan = pyp.ti_plan(data, _sched(data, mode), cuda_device)
    t, T, a, b = _state(data, kind, dtype, cuda_device)
    _sweeps_equal(tab, plan, t, T, a, b, skip_first, legacy, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_off_chip_equals_plain_loop(cuda_device, monkeypatch, dtype,
                                           mode):
    """With no room for a chain's row in shared memory the state lives in
    the output tensors: the same sweeps, bitwise."""
    monkeypatch.setattr(ti_cuda, "SMEM_MAX", 16)
    data = _data()
    tab = _table("grid", data, dtype, cuda_device)
    plan = pyp.ti_plan(data, _sched(data, mode), cuda_device)
    assert not ti_cuda.sweep_plan(CHAINS, plan.flat.shape[1],
                                  data.n.size, data.n.shape[0]).on_chip
    t, T, a, b = _state(data, "grid", dtype, cuda_device)
    _sweeps_equal(tab, plan, t, T, a, b, True, False, 50)


def _sweeps_equal(tab, plan, t, T, a, b, skip_first, legacy, seed):
    dev = t.device
    moved = False
    for k in range(SWEEPS):
        t_in, T_in = t.clone(), T.clone()
        ref = pyp._ti_run_ref(torch.Generator(dev).manual_seed(seed + k), t,
                              T, a, b, tab, plan, skip_first, legacy)
        before = ti_cuda.LAUNCHES["ti_sweep"]
        got = pyp._ti_run(torch.Generator(dev).manual_seed(seed + k), t, T,
                          a, b, tab, plan, skip_first, legacy)
        torch.cuda.synchronize()
        assert ti_cuda.LAUNCHES["ti_sweep"] == before + 1
        assert torch.equal(t, t_in) and torch.equal(T, T_in)
        assert torch.equal(got[0], ref[0]), f"t differs after sweep {k}"
        assert torch.equal(got[1], ref[1]), f"T differs after sweep {k}"
        assert torch.equal(got[0].sum(-1), got[1])
        moved |= not torch.equal(got[0], t)
        t, T = got
    assert moved


@pytest.mark.cuda
def test_kernel_at_the_quick_start_shape(cuda_device):
    """demo.c's data at 16384 chains, group schedule, a K1 grid in f32,
    through ti_sweep_blocked, as models/driver calls it."""
    data = pyp.crp_generate(0, 4, 20, 100, 0.5, 10.0)
    grid = agrid.make_grid(512, 128, g=64, device=cuda_device)
    plan = pyp.ti_plan(data, pyp.ti_schedule(data, "group"), cuda_device)
    t, T, a, b = _state(data, "grid", torch.float32, cuda_device, C=16384)
    ref = pyp._ti_run_ref(torch.Generator(cuda_device).manual_seed(3), t, T,
                          a, b, grid, plan, True, False)
    got = pyp.ti_sweep_blocked(torch.Generator(cuda_device).manual_seed(3),
                               t, T, a, b, grid, data, sched=plan)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_kernel_rejects_on_the_card(cuda_device):
    data = _data()
    tab = _table("grid", data, torch.float32, cuda_device)
    plan = pyp.ti_plan(data, _sched(data, "group"), cuda_device)
    t, T, a, b = _state(data, "grid", torch.float32, cuda_device)
    live, nf, H, vrows, u = pyp._ti_prepare(
        torch.Generator(cuda_device).manual_seed(1), t, a, tab, plan, True)
    args = [t, T, a, b, vrows, u, plan, live, nf, H, False]
    with pytest.raises(ValueError, match="lies on cpu"):
        ti_cuda.ti_sweep(*args[:5], u.cpu(), *args[6:])
    with pytest.raises(TypeError, match="dtype"):
        ti_cuda.ti_sweep(*args[:5], u.double(), *args[6:])


# -- on the CPU --------------------------------------------------------------

def test_cpu_takes_the_plain_loop(monkeypatch):
    """_ti_run on the CPU is _ti_run_ref: the same state, and the kernel
    is neither built nor launched."""
    monkeypatch.setattr(_nvcc, "build_all", lambda _: pytest.fail("built"))
    data = _data()
    tab = _table("grid", data, torch.float64, "cpu")
    plan = pyp.ti_plan(data, _sched(data, "group"), "cpu")
    t, T, a, b = _state(data, "grid", torch.float64, "cpu", C=16)
    before = ti_cuda.LAUNCHES["ti_sweep"]
    ref = pyp._ti_run_ref(torch.Generator().manual_seed(5), t, T, a, b, tab,
                          plan, True, False)
    got = pyp._ti_run(torch.Generator().manual_seed(5), t, T, a, b, tab,
                      plan, True, False)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert ti_cuda.LAUNCHES["ti_sweep"] == before


def _prepared(mode="group", kind="grid", dtype=torch.float32,
              skip_first=True):
    data = _data()
    tab = _table(kind, data, dtype, "cpu")
    plan = pyp.ti_plan(data, _sched(data, mode), "cpu")
    t, T, a, b = _state(data, kind, dtype, "cpu", C=12)
    live, nf, H, vrows, u = pyp._ti_prepare(
        torch.Generator().manual_seed(2), t, a, tab, plan, skip_first)
    return dict(t=t, T=T, a=a, b=b, vrows=vrows, u=u, plan=plan, live=live,
                nf=nf, H=H, legacy_odds=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["grid", "table"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("skip_first", [True, False])
def test_prepare_feeds_the_wrapper(dtype, kind, mode, skip_first):
    """What ti.prepare makes passes every check of the wrapper but the
    device's: the grid's V rows at a row stride, the table's one row at
    stride 0."""
    kw = _prepared(mode, kind, dtype, skip_first)
    assert kw["vrows"].stride(0) == (0 if kind == "table"
                                     else kw["vrows"].shape[1])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ti_cuda.ti_sweep(**kw)


@pytest.mark.parametrize("name,bad,error,match", [
    ("u", lambda x: x.double(), TypeError, "u has dtype"),
    ("a", lambda x: x.double(), TypeError, "b has dtype"),
    ("t", lambda x: x.long(), TypeError, "t has dtype"),
    ("T", lambda x: x.long(), TypeError, "T has dtype"),
    ("live", lambda x: x.int(), TypeError, "live has dtype"),
    ("nf", lambda x: x.double(), TypeError, "nf has dtype"),
    ("u", lambda x: x.transpose(2, 3).contiguous().transpose(2, 3),
     ValueError, "u must be contiguous"),
    ("t", lambda x: x.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError, "t must be contiguous"),
    ("H", lambda x: x.t().contiguous().t(), ValueError,
     "H must be contiguous"),
    ("u", lambda x: x[:-1], ValueError, "u has shape"),
    ("T", lambda x: x[:, :-1], ValueError, "T has shape"),
    ("b", lambda x: x[:-1], ValueError, "b has shape"),
    ("vrows", lambda x: x[:, :-1], ValueError, "vrows must be"),
    ("vrows", lambda x: torch.cat([x, x[:, :1]], 1), ValueError,
     "vrows must be"),
    ("vrows", lambda x: x.double(), ValueError, "vrows must be"),
    ("vrows", lambda x: x[:, ::2], ValueError, "vrows must be"),
])
def test_wrapper_refuses(name, bad, error, match):
    """A wrong dtype, a non-contiguous input, a wrong shape and V rows
    whose width, dtype or strides disagree with the plan each raise
    before anything is launched."""
    kw = _prepared()
    kw[name] = bad(kw[name])
    with pytest.raises(error, match=match):
        ti_cuda.ti_sweep(**kw)


def test_wrapper_refuses_a_plan_of_another_width():
    kw = _prepared()
    plan = kw["plan"]
    kw["plan"] = plan._replace(mq=plan.mq + 1)
    with pytest.raises(ValueError, match="vrows must be"):
        ti_cuda.ti_sweep(**kw)
    kw["plan"] = plan._replace(vbase=plan.vbase[:, :-1].contiguous())
    with pytest.raises(ValueError, match="vbase has shape"):
        ti_cuda.ti_sweep(**kw)


def test_wrapper_refuses_a_cpu_state_and_a_half_dtype():
    kw = _prepared(dtype=torch.float64)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ti_cuda.ti_sweep(**kw)
    kw["a"] = kw["a"].half()
    with pytest.raises(TypeError, match="float32 or float64 only"):
        ti_cuda.ti_sweep(**kw)


@pytest.mark.parametrize("C,W,cells,groups,want", [
    # the Quick-start: 64 chains of 4 threads, 88 ints each on chip
    (16384, 4, 80, 4, (4, 64, 256, 64 * 4 * 88)),
    # item order: a thread a chain
    (16384, 1, 80, 4, (1, 256, 64, 256 * 4 * 85)),
    # cat mode on the Quick-start: 3 chains of 71 slots
    (16384, 71, 80, 4, (71, 3, 5462, 3 * 4 * 155)),
    # fewer chains than a block holds
    (5, 4, 80, 4, (4, 5, 1, 5 * 4 * 88)),
    # wider than a block: 256 threads take every 256th slot
    (10, 700, 2000, 100, (256, 1, 10, 4 * 2800)),
    # shared memory holds 2 of a block's 64 chains
    (100, 4, 25000, 4, (4, 2, 50, 2 * 4 * 25008)),
    # no chain's row fits on chip: the state in the outputs
    (100, 4, 60000, 4, (4, 64, 2, 0)),
])
def test_sweep_plan(C, W, cells, groups, want):
    geo = ti_cuda.sweep_plan(C, W, cells, groups)
    assert tuple(geo) == want
    assert geo.tpc * geo.cpb <= ti_cuda.BLOCK_THREADS
    assert geo.blocks * geo.cpb >= C > (geo.blocks - 1) * geo.cpb
    assert geo.smem <= ti_cuda.SMEM_MAX
    assert geo.on_chip == (want[3] > 0)


@pytest.mark.parametrize("args", [(0, 4, 80, 4), (8, 0, 80, 4),
                                  (8, 4, 0, 4), (8, 4, 80, 0)])
def test_sweep_plan_rejects_empty(args):
    with pytest.raises(ValueError):
        ti_cuda.sweep_plan(*args)
