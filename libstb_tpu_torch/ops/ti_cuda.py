"""The TI sweep in one launch: the hand-written CUDA kernel behind
models/pyp._ti_run on a CUDA device.

``ti_sweep`` (csrc/ti_sweep.cu) runs every step of one table-indicator
sweep over an item schedule: each (chain, slot) lane reads its cell of t
and its group's block-start total T, decides the removal and the
addition with the sweep's two uniforms, and adds its delta to both, with
each chain's counts and totals on chip across all S steps.  It replaces
no TPU kernel (the JAX sweep is XLA code); its plain version is
models/pyp._ti_run_ref, the step loop in PyTorch, which it equals bitwise
for the same uniforms.

``sweep_plan`` sets the geometry: ``tpc`` threads a chain (one a slot up
to a block's 256 threads, each then taking every tpc-th slot), ``cpb``
chains a block, and the dynamic shared memory that holds the block's
chains (their t and T rows and a stage of W deltas); where one chain does
not fit, the state lives in the output tensors and the stage in a
scratch.  The kernel is a library of ops/_nvcc.py, built on first use.

V(n, t+1) reaches a lane by one of two routes.  On the rows route the
kernel gathers it from the V rows ``vrows`` that ti.prepare built; on the
grid route (``grid``, an AGridTable) it interpolates it from the grid's
``vtab`` itself, four taps a lane-step, bitwise as AGridTable.V does where
V's clamps and asymptote cannot apply (models/pyp.ti_route picks the
route).  ``LAUNCHES["ti_sweep"]`` and ``LAUNCHES["ti_sweep_grid"]`` count
the sweeps of each route, so a run can show which its sweeps took;
``grid_v`` runs the grid route's interpolation alone, for the card tests.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _nvcc

__all__ = ["LAUNCHES", "SOURCES", "SweepPlan", "sweep_plan", "grid_scalars",
           "ti_sweep", "grid_v"]

LAUNCHES = {"ti_sweep": 0, "ti_sweep_grid": 0, "ti_grid_v": 0}
_GRID_ARGS = [ctypes.c_double] * 2 + [ctypes.c_int] * 3   # a0 .. m_max
# (t_in, T_in, t_out, T_out, stage, a, b, vrows, vtab, u, nf, H, flat, grp,
#  cnt, vbase, live), vstride, (a0, inv_da, g_max, n_max, m_max), (C, S,
#  W, cells, groups, mq, legacy, tpc, cpb, blocks, smem), stream; then
# (vtab, a, n, m, out), (a0 .. m_max), (C, K), stream
_LIB = _nvcc.register("ti_sweep", {
    **_nvcc.pair("ti_sweep", [ctypes.c_void_p] * 17 + [ctypes.c_longlong]
                 + _GRID_ARGS + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    **_nvcc.pair("ti_grid_v", [ctypes.c_void_p] * 5 + _GRID_ARGS
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])}, LAUNCHES)
SOURCES = {_LIB.name: _LIB.source}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

BLOCK_THREADS = 256                   # csrc/ti_sweep.cu: kThreads
# the shared memory a block may have (227 KB on Hopper)
SMEM_MAX = 232448


class SweepPlan(NamedTuple):
    """The launch geometry for C chains of ``cells`` counts and ``groups``
    totals over W slots: ``blocks`` blocks of ``cpb`` chains x ``tpc``
    threads, ``smem`` bytes of shared memory a block (0: the state in the
    output tensors)."""
    tpc: int
    cpb: int
    blocks: int
    smem: int

    @property
    def on_chip(self) -> bool:
        return self.smem > 0


def sweep_plan(C: int, W: int, cells: int, groups: int) -> SweepPlan:
    """The kernel's geometry: a thread a slot up to BLOCK_THREADS, as many
    chains a block as the threads and the shared memory allow, each
    chain's row (t, T and the stage of W deltas, 4 bytes each) on chip
    where one fits."""
    if min(C, W, cells, groups) < 1:
        raise ValueError(f"sweep_plan: empty ({C} chains, {W} slots, "
                         f"{cells} cells, {groups} groups)")
    tpc = min(W, BLOCK_THREADS)
    row = 4 * (cells + groups + W)
    fit = SMEM_MAX // row
    cpb = min(BLOCK_THREADS // tpc, C)
    if fit >= 1:
        cpb = min(cpb, fit)
    smem = cpb * row if fit >= 1 else 0
    return SweepPlan(tpc, cpb, -(-C // cpb), smem)


_SCALARS: dict = {}        # (a0, da, dtype, device) -> grid_scalars


def grid_scalars(grid, dtype, device) -> tuple:
    """(a0, 1 / da) of ``grid`` as AGridTable._locate's PyTorch operations
    on ``device`` meet them in ``dtype``: a0 is the Python scalar as
    ``x - a0`` rounds it, 1 / da the factor of ``x / da`` (on a card a
    division by a Python scalar is a product by its reciprocal, itself
    rounded from a double).  Both come from those operations themselves,
    once for each grid axis, dtype and device."""
    key = (grid.a0, grid.da, dtype, str(device))
    if key not in _SCALARS:
        zero = torch.zeros(1, dtype=dtype, device=device)
        _SCALARS[key] = (-float(zero - grid.a0), float((zero + 1) / grid.da))
    return _SCALARS[key]


def _grid_args(grid, dtype, device) -> tuple:
    return (*grid_scalars(grid, dtype, device), grid.g_max, grid.n_max,
            grid.m_max)


def _check_grid_table(fn, grid, dev, dt, n_top, m_top):
    """Raise unless ``grid``'s vtab can be read by the grid route for
    counts up to ``n_top`` and m up to ``m_top``."""
    if grid.vtab is None:
        raise ValueError(f"{fn}: the grid has no V table")
    if grid.g_max < 4 or grid.n_max < n_top or grid.m_max < m_top:
        raise ValueError(
            f"{fn}: the grid ({grid.g_max} discounts, n_max {grid.n_max}, "
            f"m_max {grid.m_max}) must hold 4 discounts, n up to {n_top} "
            f"and m up to {m_top}")
    _nvcc.check(fn, dev, {"vtab": (grid.vtab, dt, (grid.g_max, grid.n_max,
                                                   grid.m_max))})


def _check(t, T, a, b, vrows, u, plan, live, nf, H, grid):
    """Raise on anything the kernel cannot take (_nvcc.check, and the V
    rows' own stride rule or the grid's bounds)."""
    dev, dt = t.device, a.dtype
    S, W = plan.flat.shape
    C, J = t.shape[:2] if t.ndim == 3 else (-1, -1)
    width = plan.pair_n.numel() * plan.mq

    def check_v():
        if (vrows is None) == (grid is None):
            raise ValueError("ti_sweep: give the V rows or the grid, one "
                             "of the two")
        if grid is not None:
            # the plan's counts go up to mq - 1 (models/pyp.ti_plan)
            _check_grid_table("ti_sweep", grid, dev, dt, plan.mq - 1,
                              plan.mq)
        elif (vrows.device != dev or vrows.dtype != dt or vrows.ndim != 2
                or tuple(vrows.shape) != (C, width) or vrows.stride(1) != 1
                or vrows.stride(0) not in (0, width)):
            raise ValueError(
                f"ti_sweep: vrows must be ({C}, {width}) {dt} on {dev}, rows "
                f"contiguous at a stride of {width} or 0; it is "
                f"{tuple(vrows.shape)} {vrows.dtype} on {vrows.device}, "
                f"strides {vrows.stride()}")

    _nvcc.check("ti_sweep", dev, {
        "t": (t, torch.int32, (C, J, None)), "T": (T, torch.int32, (C, J)),
        "a": (a, dt, (C,)), "b": (b, dt, (C,)),
        "u": (u, dt, (S, 2, C, W)), "live": (live, torch.bool, (S, W)),
        "nf": (nf, dt, (S, W)), "H": (H, dt, (S, W)),
        "flat": (plan.flat, torch.int64, (S, W)),
        "grp": (plan.grp, torch.int64, (S, W)),
        "cnt": (plan.cnt, torch.int64, (S, W)),
        "vbase": (plan.vbase, torch.int64, (S, W))}, real=dt,
        then=check_v)


def ti_sweep(t: torch.Tensor, T: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, vrows: Optional[torch.Tensor],
             u: torch.Tensor, plan, live: torch.Tensor, nf: torch.Tensor,
             H: torch.Tensor, legacy_odds: bool, grid=None):
    """Launch the sweep of ``plan`` (a models/pyp.TIPlan) on t (C, J, D)
    and T (C, J), int32, with what models/pyp's ti.prepare made: the
    uniforms ``u`` (S, 2, C, W), ``live``, ``nf`` and ``H`` (S, W), and
    either the V rows ``vrows`` (C, P * mq) or, for the grid route, None
    and the AGridTable ``grid`` they would come from.  Returns new (t, T);
    the inputs are left as they are."""
    _check(t, T, a, b, vrows, u, plan, live, nf, H, grid)
    C, J, D = t.shape
    S, W = plan.flat.shape
    geo = sweep_plan(C, W, J * D, J)
    t_out = torch.empty_like(t)
    T_out = torch.empty_like(T)
    stage = (None if geo.on_chip else
             torch.empty((C, W), dtype=torch.int32, device=t.device))
    if grid is None:
        vrows_p, vtab_p, vstride = vrows.data_ptr(), None, vrows.stride(0)
        gargs, key = (0.0, 0.0, 0, 0, 0), "ti_sweep"
    else:
        vrows_p, vtab_p, vstride = None, grid.vtab.data_ptr(), 0
        gargs, key = _grid_args(grid, a.dtype, t.device), "ti_sweep_grid"
    _LIB.launch(a.dtype, t.device, t.data_ptr(), T.data_ptr(),
                t_out.data_ptr(), T_out.data_ptr(),
                None if stage is None else stage.data_ptr(), a.data_ptr(),
                b.data_ptr(), vrows_p, vtab_p, u.data_ptr(), nf.data_ptr(),
                H.data_ptr(), plan.flat.data_ptr(), plan.grp.data_ptr(),
                plan.cnt.data_ptr(), plan.vbase.data_ptr(), live.data_ptr(),
                vstride, *gargs, C, S, W, J * D, J, plan.mq,
                int(legacy_odds), geo.tpc, geo.cpb, geo.blocks, geo.smem,
                key=key)
    return t_out, T_out


def grid_v(grid, a: torch.Tensor, n: torch.Tensor,
           m: torch.Tensor) -> torch.Tensor:
    """The grid route's V: (C, K) with V(n[k], m[k]) at discount a[c],
    interpolated from ``grid.vtab`` as the sweep's kernel does it, for
    int64 ``n`` and ``m`` (K,) in the grid's bounds (1 <= n <= n_max, m <=
    m_max)."""
    dt, dev = a.dtype, a.device
    C, K = a.numel(), n.numel()

    def check_grid():
        if K and (int(n.min()) < 1 or int(n.max()) > grid.n_max
                  or int(m.max()) > grid.m_max):
            raise ValueError(f"grid_v: n must lie in [1, {grid.n_max}] and "
                             f"m at most {grid.m_max}")
        _check_grid_table("grid_v", grid, dev, dt, 0, 0)

    _nvcc.check("grid_v", dev, {"a": (a, dt, (C,)),
                                "n": (n, torch.int64, (K,)),
                                "m": (m, torch.int64, (K,))}, real=dt,
                then=check_grid)
    out = torch.empty((C, K), dtype=dt, device=dev)
    _LIB.launch(f"stb_ti_grid_v_{_SUFFIX[dt]}", dev, grid.vtab.data_ptr(),
                a.data_ptr(), n.data_ptr(), m.data_ptr(), out.data_ptr(),
                *_grid_args(grid, dt, dev), C, K, key="ti_grid_v")
    return out
