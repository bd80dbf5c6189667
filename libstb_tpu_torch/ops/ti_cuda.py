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
scratch.  The kernel is a library of ops/_nvcc.py, built on first use;
``LAUNCHES["ti_sweep"]`` counts its launches, so a run can show that its
sweeps took the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _nvcc

__all__ = ["LAUNCHES", "SOURCES", "SweepPlan", "sweep_plan", "ti_sweep"]

LAUNCHES = {"ti_sweep": 0}
# (t_in, T_in, t_out, T_out, stage, a, b, vrows, u, nf, H, flat, grp, cnt,
#  vbase, live), vstride, (C, S, W, cells, groups, mq, legacy, tpc, cpb,
#  blocks, smem), stream
_LIB = _nvcc.register("ti_sweep", _nvcc.pair(
    "ti_sweep", [ctypes.c_void_p] * 16 + [ctypes.c_longlong]
    + [ctypes.c_int] * 11 + [ctypes.c_void_p]), LAUNCHES)
SOURCES = {_LIB.name: _LIB.source}

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


def _check(t, T, a, b, vrows, u, plan, live, nf, H):
    """Raise on anything the kernel cannot take (_nvcc.check, and the V
    rows' own stride rule)."""
    dev, dt = t.device, a.dtype
    S, W = plan.flat.shape
    C, J = t.shape[:2] if t.ndim == 3 else (-1, -1)
    width = plan.pair_n.numel() * plan.mq

    def check_vrows():
        if (vrows.device != dev or vrows.dtype != dt or vrows.ndim != 2
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
        then=check_vrows)


def ti_sweep(t: torch.Tensor, T: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, vrows: torch.Tensor, u: torch.Tensor, plan,
             live: torch.Tensor, nf: torch.Tensor, H: torch.Tensor,
             legacy_odds: bool):
    """Launch the sweep of ``plan`` (a models/pyp.TIPlan) on t (C, J, D)
    and T (C, J), int32, with what models/pyp's ti.prepare made: the V
    rows ``vrows`` (C, P * mq), the uniforms ``u`` (S, 2, C, W), ``live``,
    ``nf`` and ``H`` (S, W).  Returns new (t, T); the inputs are left as
    they are."""
    _check(t, T, a, b, vrows, u, plan, live, nf, H)
    C, J, D = t.shape
    S, W = plan.flat.shape
    geo = sweep_plan(C, W, J * D, J)
    t_out = torch.empty_like(t)
    T_out = torch.empty_like(T)
    stage = (None if geo.on_chip else
             torch.empty((C, W), dtype=torch.int32, device=t.device))
    _LIB.launch(a.dtype, t.device, t.data_ptr(), T.data_ptr(),
                t_out.data_ptr(), T_out.data_ptr(),
                None if stage is None else stage.data_ptr(), a.data_ptr(),
                b.data_ptr(), vrows.data_ptr(), u.data_ptr(), nf.data_ptr(),
                H.data_ptr(), plan.flat.data_ptr(), plan.grp.data_ptr(),
                plan.cnt.data_ptr(), plan.vbase.data_ptr(), live.data_ptr(),
                vrows.stride(0), C, S, W, J * D, J, plan.mq,
                int(legacy_odds), geo.tpc, geo.cpb, geo.blocks, geo.smem)
    return t_out, T_out
