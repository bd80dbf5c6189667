"""The TI sweep's kernel (ops/ti_cuda.py, csrc/ti_sweep.cu) against its
plain version, models/pyp._ti_run_ref.

On a card (``-m cuda``): for the same uniforms (two generators of one
seed) the kernel's t and T equal the plain loop's bitwise, sweep after
sweep, in f32 and f64, over group, cat and item schedules, on a grid
(the grid route) and on a StirlingTable (the rows route), in every
skip_first x legacy_odds, at a chain count that fills no block whole and
on counts whose groups differ in size (pad slots); on grids too small for
the counts (the rows route, with V's asymptote) and at discounts on the
grid's ends, on its nodes and beyond it; the inputs are left as they were
and each sweep is one launch, counted under its route.  The grid route's
interpolation alone (``grid_v``) equals AGridTable.V bitwise.
On the CPU: the sweep takes the plain loop and builds nothing, the route
choice, the wrapper refuses what the kernel cannot take, what ti.prepare
makes passes the wrapper's checks but the device's, and the launch
geometry.

This file imports no JAX."""
import dataclasses

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


# grids that leave the counts (up to 12, so mq = 13) or the discounts
# off their tables: (n_max, m_max, a_lo, a_hi) and the route taken
OFF_GRID = {"n_max": (8, 8, 0.0, 0.99, "rows"),
            "m_max": (14, 8, 0.0, 0.99, "rows"),
            "edges": (14, 14, 0.2, 0.8, "grid")}


def _edge_discounts(grid, C, dtype, device):
    """C discounts cycling over the grid's two ends, each of its nodes
    (t = 0) and points beyond both ends (the clamped extrapolation)."""
    top = grid.a0 + grid.da * (grid.g_max - 1)
    beyond = [grid.a0 - 0.5 * grid.da, grid.a0 - 2.5 * grid.da,
              max(grid.a0 - 0.19, 0.01), top + 0.5 * grid.da,
              top + 2.5 * grid.da, min(top + 0.18, 0.98)]
    pts = torch.cat([torch.tensor([grid.a0, top] + beyond, dtype=dtype),
                     grid.avec.to(dtype).cpu()])
    return pts[torch.arange(C) % pts.numel()].to(device)


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
    _sweeps_equal(tab, plan, t, T, a, b, skip_first, legacy, 40,
                  "grid" if kind == "grid" else "rows")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(OFF_GRID))
def test_kernel_equals_plain_loop_off_the_grid(cuda_device, dtype, case):
    """A grid too small for the counts takes the rows route, V's
    asymptote and zeros included; discounts at the grid's ends, on its
    nodes and beyond it take the grid route: both bitwise."""
    n_max, m_max, a_lo, a_hi, route = OFF_GRID[case]
    data = _data()
    grid = agrid.make_grid(n_max, m_max, g=32, a_lo=a_lo, a_hi=a_hi,
                           dtype=dtype, device=cuda_device)
    plan = pyp.ti_plan(data, _sched(data, "group"), cuda_device)
    assert pyp.ti_route(grid, plan, dtype) == route
    t, T, _, b = _state(data, "grid", dtype, cuda_device)
    a = _edge_discounts(grid, CHAINS, dtype, cuda_device)
    _sweeps_equal(grid, plan, t, T, a, b, True, False, 60, route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g,a_lo,a_hi", [
    (4, 0.2, 0.8), (32, 0.2, 0.8), (64, 0.2, 0.8), (17, 0.03, 0.91),
    (64, 0.0, 0.99), (100, 0.0, 0.99)])
def test_grid_v_equals_agrid_V(cuda_device, dtype, g, a_lo, a_hi):
    """The grid route's interpolation, every (n, m) of the grid (m from 0,
    n < m and m < 2 included) at the grid's ends, its nodes, beyond it and
    at 257 discounts across it, equals AGridTable.V bitwise."""
    grid = agrid.make_grid(24, 16, g=g, a_lo=a_lo, a_hi=a_hi, dtype=dtype,
                           device=cuda_device)
    a = torch.cat([_edge_discounts(grid, 40, dtype, cuda_device),
                   torch.linspace(0.01, 0.98, 257, dtype=dtype,
                                  device=cuda_device)])
    n, m = torch.meshgrid(torch.arange(1, 25, device=cuda_device),
                          torch.arange(0, 17, device=cuda_device),
                          indexing="ij")
    n, m = n.flatten(), m.flatten()
    before = ti_cuda.LAUNCHES["ti_grid_v"]
    got = ti_cuda.grid_v(grid, a, n, m)
    ref = grid.V(n[None], m[None], a[:, None])
    assert ti_cuda.LAUNCHES["ti_grid_v"] == before + 1
    bad = (got != ref).nonzero()
    assert bad.numel() == 0, (
        f"{bad.shape[0]} of {got.numel()} values differ, first at a = "
        f"{float(a[bad[0, 0]])!r}, n = {int(n[bad[0, 1]])}, m = "
        f"{int(m[bad[0, 1]])}")


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
    _sweeps_equal(tab, plan, t, T, a, b, True, False, 50, "grid")


def _launches():
    return ti_cuda.LAUNCHES["ti_sweep"], ti_cuda.LAUNCHES["ti_sweep_grid"]


def _sweeps_equal(tab, plan, t, T, a, b, skip_first, legacy, seed, route):
    """SWEEPS sweeps of the kernel against the plain loop, bitwise, each
    one launch of ``route``."""
    dev = t.device
    moved = False
    one = (0, 1) if route == "grid" else (1, 0)
    for k in range(SWEEPS):
        t_in, T_in = t.clone(), T.clone()
        ref = pyp._ti_run_ref(torch.Generator(dev).manual_seed(seed + k), t,
                              T, a, b, tab, plan, skip_first, legacy)
        before = _launches()
        got = pyp._ti_run(torch.Generator(dev).manual_seed(seed + k), t, T,
                          a, b, tab, plan, skip_first, legacy)
        torch.cuda.synchronize()
        assert _launches() == (before[0] + one[0], before[1] + one[1])
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
    before = _launches()
    got = pyp.ti_sweep_blocked(torch.Generator(cuda_device).manual_seed(3),
                               t, T, a, b, grid, data, sched=plan)
    assert _launches() == (before[0], before[1] + 1)
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
    small = agrid.make_grid(8, 8, g=8, device=cuda_device)
    with pytest.raises(ValueError, match="must hold"):
        ti_cuda.ti_sweep(*args[:4], None, *args[5:], grid=small)


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


def _route_case(case):
    """(table, plan, dtype) of each route-choice case; the data's largest
    count is 12, so its plan has mq = 13."""
    data = _data()
    plan = pyp.ti_plan(data, _sched(data, "group"), "cpu")
    dt = torch.float32
    grids = {"grid": (12, 13, dt), "n_above_n_max": (11, 13, dt),
             "mq_above_m_max": (12, 12, dt),
             "dtype": (12, 13, torch.float64)}
    if case == "table":
        return _table("table", data, dt, "cpu"), plan, dt
    n_max, m_max, gdt = grids[case]
    return (agrid.make_grid(n_max, m_max, g=8, dtype=gdt, device="cpu"),
            plan, dt)


@pytest.mark.parametrize("case,route", [
    ("grid", "grid"), ("n_above_n_max", "rows"), ("mq_above_m_max", "rows"),
    ("dtype", "rows"), ("table", "rows")])
def test_ti_route(case, route):
    """The grid route exactly where the grid holds every V the plan reads
    in the sweep's dtype: a count above n_max, mq above m_max, a grid of
    another dtype and a StirlingTable take the rows."""
    tab, plan, dt = _route_case(case)
    assert plan.mq == 13
    assert pyp.ti_route(tab, plan, dt) == route


def _prepared(mode="group", kind="grid", dtype=torch.float32,
              skip_first=True, rows=True):
    data = _data()
    tab = _table(kind, data, dtype, "cpu")
    plan = pyp.ti_plan(data, _sched(data, mode), "cpu")
    t, T, a, b = _state(data, kind, dtype, "cpu", C=12)
    live, nf, H, vrows, u = pyp._ti_prepare(
        torch.Generator().manual_seed(2), t, a, tab, plan, skip_first,
        rows=rows)
    kw = dict(t=t, T=T, a=a, b=b, vrows=vrows, u=u, plan=plan, live=live,
              nf=nf, H=H, legacy_odds=False)
    if not rows:
        kw["grid"] = tab
    return kw


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", MODES)
def test_prepare_on_the_grid_route_feeds_the_wrapper(dtype, mode):
    """On the grid route ti.prepare builds no V rows and draws the same
    uniforms; the grid passes every check of the wrapper but the
    device's."""
    kw = _prepared(mode, "grid", dtype, rows=False)
    assert kw["vrows"] is None
    assert pyp.ti_route(kw["grid"], kw["plan"], dtype) == "grid"
    assert torch.equal(kw["u"], _prepared(mode, "grid", dtype)["u"])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ti_cuda.ti_sweep(**kw)


@pytest.mark.parametrize("case,match", [
    ("both", "one of the two"), ("neither", "one of the two"),
    ("n_max", "must hold"), ("m_max", "must hold"), ("g_max", "must hold"),
    ("dtype", "vtab has dtype"), ("no_vtab", "no V table"),
    ("strided", "vtab must be contiguous")])
def test_wrapper_refuses_a_grid(case, match):
    """The grid route takes the grid alone, with a contiguous vtab in the
    sweep's dtype that holds every V the plan reads."""
    kw = _prepared(rows=False)
    grid, mq = kw["grid"], kw["plan"].mq
    if case == "both":
        kw["vrows"] = _prepared()["vrows"]
    elif case == "neither":
        kw["grid"] = None
    elif case == "n_max":
        kw["grid"] = agrid.make_grid(mq - 2, mq, g=8, device="cpu")
    elif case == "m_max":
        kw["grid"] = agrid.make_grid(mq, mq - 1, g=8, device="cpu")
    elif case == "g_max":
        kw["grid"] = dataclasses.replace(grid, g_max=3,
                                         vtab=grid.vtab[:3].contiguous())
    elif case == "dtype":
        kw["grid"] = dataclasses.replace(grid, vtab=grid.vtab.double())
    elif case == "no_vtab":
        kw["grid"] = dataclasses.replace(grid, vtab=None)
    else:
        kw["grid"] = dataclasses.replace(
            grid, vtab=grid.vtab.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises((ValueError, TypeError), match=match):
        ti_cuda.ti_sweep(**kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_scalars(dtype):
    """a0 and 1 / da as the dtype's values that ``x - a0`` and ``x / da``
    use on the device (on the CPU a true division: the reciprocal rounded
    once), taken once per grid axis."""
    grid = agrid.make_grid(8, 8, g=17, a_lo=0.03, a_hi=0.91, device="cpu")
    a0, inv_da = ti_cuda.grid_scalars(grid, dtype, "cpu")
    one = torch.tensor(1.0, dtype=dtype)
    assert a0 == float(torch.tensor(0.03, dtype=dtype))
    assert inv_da == float(one / grid.da)
    assert float(torch.tensor(inv_da, dtype=dtype)) == inv_da
    if dtype == torch.float64:
        assert (a0, inv_da) == (grid.a0, 1.0 / grid.da)
    assert ti_cuda._SCALARS[(grid.a0, grid.da, dtype, "cpu")] == (a0, inv_da)


def test_grid_v_refuses():
    grid = agrid.make_grid(8, 6, g=8, device="cpu")
    a = torch.full((3,), 0.5)
    ok = torch.tensor([1, 8]), torch.tensor([0, 6])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ti_cuda.grid_v(grid, a, *ok)
    for n, m in (([0, 8], [0, 6]), ([1, 9], [0, 6]), ([1, 8], [0, 7])):
        with pytest.raises(ValueError, match="must lie in"):
            ti_cuda.grid_v(grid, a, torch.tensor(n), torch.tensor(m))
    with pytest.raises(TypeError, match="vtab has dtype"):
        ti_cuda.grid_v(grid, a.double(), *ok)


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
