"""Probes of the card's floors for K1-K3: the hand-written kernels of
csrc/vpu_probe.cu and their plain versions.

The port of tools/vpu_probe.py's Pallas probes, each of which measured on
the TPU what bounds the Stirling fills; here they measure it on the card.
None computes a function of the system:

* P1 ``write_floor``: V[j, :] = 1 + j%7 and Srel[j, :] = 2 + j%7, f32, (m,
  n) column-major as K3's tables: ``full`` (16-byte stores over both
  arrays, the card's write floor), ``piecewise`` (K3's store pattern over
  ``cols_plan``'s chunks; the values change every ``piece`` rows, as the
  TPU probe's sub-stores did), ``onecol`` (the pattern for V alone);
* P2 ``alu``: ``u`` register streams a thread of one op for r x unroll
  steps, the sum of the streams a thread (the issue rate of fma, mul, log,
  the approximate reciprocal, IEEE divide and a lane rotation in f32, and
  of fma, mul, row_walk.cuh's div_pos and log_pos, IEEE divide and log and
  a lane shuffle in f64);
* P3 ``smem``: K3's f64 row-state accesses in shared memory, scalar or 16
  bytes, with and without its pad, the acc recurrence a thread;
* P4 ``overlap``: K3's residency and column loop, a dependent f64 FMA
  chain and then the two output columns' stores, either alone or both;
* P5 ``mix``: K3's memory mix in K3's residency, its f64 row state in
  shared memory moved on by out = state 0.999 + acc_p each column and the
  column stored one row a lane (V = out, Srel = out + 1, f32), or in
  ``staged`` mode through a staging area of two buffers, one barrier and
  one bulk copy a table a column;
* P6 ``bisect``: P5 with the steps of BISECT_STEPS, a ladder from the mix
  to K3: the TPU probe's flags (smem, xscratch, initbranch, vcarry; its
  ``cost`` has no counterpart) and then K3's own structure (barriers,
  scan, div_pos, log_pos, handoff); ``ladder()`` lists its rungs.  A
  branch from its top rung (``branch()``) adds the LEVERS, each alone and
  both: storewarps (the store pass in warps of its own), early (the
  hand-off's poll in a warp of its own, without a sleep, taken after the
  carry warp's scan); each moves work between warps and gives the top
  rung's values bitwise.

Each ``*_cuda`` wrapper checks its arguments, allocates its outputs with
``torch.empty`` (or takes them in ``out``), launches on the current stream
and raises on a launch error; it runs on a CUDA device only.  Each
``*_ref`` is the plain PyTorch version, giving the same values (the
kernels' arithmetic is rounded as the plain version's: no contracted
multiply-adds); the CPU uses it, and chip_smoke.py holds each kernel to it
on the card.  ``LAUNCHES[name]`` counts each probe's launches.  The probes
are one library of ops/_nvcc.py, built on first use.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _nvcc
from .stirling_cuda import COLS_MAX_N, cols_plan

__all__ = ["PROBES", "LAUNCHES", "SOURCES", "WRITE_MODES",
           "write_floor_cuda", "write_floor_ref",
           "ALU_OPS", "OP_CODES", "ALU_U", "ALU_PERIOD", "alu_rtol",
           "alu_blocks", "alu_cuda", "alu_ref", "SMEM_MODES",
           "headline_chunk", "smem_rows", "smem_cuda", "smem_ref",
           "overlap_cuda", "overlap_ref", "MIX_MODES", "TPU_STEPS",
           "K3_STEPS", "BISECT_STEPS", "LEVERS", "ladder", "branch",
           "probe_name", "mix_threads", "steps_bits",
           "bisect_exact", "mix_smem", "mix_plan", "mix_errors", "MixOut",
           "mix_cuda", "mix_ref", "bisect_cuda", "bisect_ref"]

# the probes' kernels by name (P5 staged and the branch's rungs apart from
# P5 mix and P6's ladder: probe_name)
PROBES = ("write_floor", "alu", "smem", "overlap", "mix", "bisect",
          "mix_staged", "bisect_storewarps", "bisect_early",
          "bisect_storewarps_early")
LAUNCHES = {name: 0 for name in PROBES}
_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LIB = _nvcc.register("vpu_probe", {
    "stb_vpu_write_full": [_p, _p, _i, _i, _p],
    "stb_vpu_write_rows": [_p, _p] + [_i] * 7 + [_p],
    "stb_vpu_alu_occupancy": [_i, _i, _i, ctypes.POINTER(ctypes.c_int)],
    "stb_vpu_alu": [_i, _i, _i, _p, _d, _d, _d, _d, _i, _i, _p],
    "stb_vpu_smem": [_i, _i, _p, _d, _i, _i, _i, _p],
    "stb_vpu_overlap": [_i, _i, _p, _p, _p] + [_i] * 7 + [_d, _d, _d, _p],
    "stb_vpu_mix": [_i, _i] + [_p] * 7 + [_i] * 9 + [_p]}, LAUNCHES)
SOURCES = {_LIB.name: _LIB.source}

# the TPU probes' seeds: stream i starts at (X0 + i DX) c, c = 1 + (t % 3)
# EPS (t: the TPU's grid step; here the thread, or K3's column in P4)
X0, DX, EPS = 1.2, 0.01, 1e-6

WRITE_MODES = ("full", "piecewise", "onecol")
# the TPU probe's sub-store: u = 8 slabs of (32, 128) rows
PIECE = 8 * 32 * 128

ALU_OPS = {torch.float32: ("fma", "mul", "log", "recip", "div", "roll"),
           torch.float64: ("fma", "mul", "div_pos", "log_pos", "div", "log",
                           "shfl")}
OP_CODES = {"fma": 0, "mul": 1, "log": 2, "recip": 3, "div": 4, "roll": 5,
            "div_pos": 6, "log_pos": 7, "shfl": 8}
ALU_U = {"fma": (4, 8, 16)}            # every other op at u = 8 only
ALU_THREADS = 256
ALU_UNROLL = 8                          # steps a loop trip in the kernel
# a P2 thread's sum depends on its seed, t % 3, and for roll and shfl on
# its lane's place in the warp: thread t of any grid holds the value of
# thread t % ALU_PERIOD of a 3-warp grid
ALU_PERIOD = 96
# P2's relative tolerances against alu_ref: f32 1e-5, the approximate
# reciprocal and logf 1e-4 (rcp.approx and CUDA's logf against torch's 1/x
# and log, an ulp or two a step, which the orbits x -> 1/x (period 2) and
# log x + 1.54 (contractive) do not amplify); f64 1e-12 (div_pos and
# log_pos within an ulp of IEEE on contractive orbits)
_ALU_RTOL = {(torch.float32, "recip"): 1e-4, (torch.float32, "log"): 1e-4}
_ALU_RTOL_DTYPE = {torch.float32: 1e-5, torch.float64: 1e-12}

SMEM_MODES = ("load1", "load8", "store1", "store8")
ROW_THREADS = 512                       # K3's row threads (16 warps)
SMEM_MAX = 232448                       # shared memory a block may have
THREADS_MAX = 1024                      # threads a block may have
STORE_WARPS = 8                         # storewarps' store warps

MIX_MODES = ("mix", "staged")
# P6's ladder, in order: the TPU probe's flags (its ``cost``, XLA's
# CostEstimate, has no counterpart on the card), then K3's structure
TPU_STEPS = ("smem", "xscratch", "initbranch", "vcarry")
K3_STEPS = ("barriers", "scan", "div_pos", "log_pos", "handoff")
BISECT_STEPS = TPU_STEPS + K3_STEPS
# the branch from the ladder's top rung: levers that move work between
# warps and leave every value as the top rung's
LEVERS = ("storewarps", "early")
SLAB = 32 * 128                         # the TPU probe's (S, 128) slab, S = 32
A_SMEM = 0.5                            # the TPU probe's scalar operand
TINY = 1e-300                           # log_pos's floor for |V|
# a P5 / P6 block's static shared memory, kept free beside the dynamic
MIX_STATIC = 1024


def _cuda(fn: str, device) -> torch.device:
    device = torch.device(device)
    _nvcc.check(fn, device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_shape(fn: str, n: int, m: int):
    if not (1 <= n < COLS_MAX_N and m >= 1):
        raise ValueError(f"{fn}: (n, m) = ({n}, {m}) outside 1 <= n < 2^24, "
                         "m >= 1")


def _check_out(fn: str, t, shape, dtype, device):
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    _nvcc.check(fn, device, {"out": (t, dtype, tuple(shape))})
    return t


# -- P1: the write floor -------------------------------------------------------

def write_floor_ref(m: int, n: int, mode: str = "full", piece: int = PIECE,
                    device="cpu"):
    """(V, Srel) of shape (m, n), f32; Srel None for ``onecol``."""
    if mode not in WRITE_MODES:
        raise ValueError(f"write_floor_ref: mode {mode!r}")
    base = 1 + (torch.arange(m, device=device) % 7).to(torch.float32)
    if mode == "piecewise":
        # acc 0.9999 + 1e-5 as one f32 FMA: in f64 the product of two f32
        # and the sum (acc in (0.5, 8): 51 bits at most) are exact, so one
        # rounding to f32 is the FMA's
        c, b = (torch.tensor(x, dtype=torch.float32).item()
                for x in (0.9999, 1e-5))
        accs = [base]
        for _ in range(1, -(-n // piece)):
            accs.append((accs[-1].double() * c + b).float())
        v = torch.stack(accs, 1).repeat_interleave(piece, 1)[:, :n]
        return v.contiguous(), (v + 1).contiguous()
    v = base[:, None].expand(m, n).contiguous()
    if mode == "onecol":
        return v, None
    return v, (base + 1)[:, None].expand(m, n).contiguous()


def write_floor_cuda(m: int, n: int, mode: str = "full", piece: int = PIECE,
                     device="cuda", out=None):
    """Launch P1 on ``device``; the same values as write_floor_ref.  ``out``
    (V, Srel or None) takes the outputs' place."""
    device = _cuda("write_floor_cuda", device)
    if mode not in WRITE_MODES:
        raise ValueError(f"write_floor_cuda: mode {mode!r}")
    _check_shape("write_floor_cuda", n, m)
    if mode == "full" and n % 4:
        raise ValueError(f"write_floor_cuda: full mode needs n % 4 == 0, "
                         f"not {n}")
    if mode == "piecewise" and piece < 32:
        raise ValueError(f"write_floor_cuda: piece {piece} < 32 rows")
    out_v, out_s = out if out is not None else (None, None)
    v = _check_out("write_floor_cuda", out_v, (m, n), torch.float32, device)
    s = (None if mode == "onecol" else
         _check_out("write_floor_cuda", out_s, (m, n), torch.float32, device))
    if mode == "full":
        _LIB.launch("stb_vpu_write_full", device, v.data_ptr(), s.data_ptr(),
                    n, m, key="write_floor")
        return v, s
    plan = cols_plan(n, m, _sms(device), with_srel=mode == "piecewise")
    piece = piece if mode == "piecewise" else n
    smem = max(plan.smem, 7 * 4 * -(-n // piece))
    if smem > SMEM_MAX:
        raise ValueError(f"write_floor_cuda: {-(-n // piece)} pieces of "
                         f"{piece} rows: their table takes {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    _LIB.launch("stb_vpu_write_rows", device, v.data_ptr(),
                None if s is None else s.data_ptr(), n, m, plan.chunk,
                plan.chunks, plan.blocks, smem, piece, key="write_floor")
    return v, s


# -- P2: issue rates -----------------------------------------------------------

def _check_alu(fn: str, op: str, dtype, u: int, r: int, unroll: int):
    if dtype not in ALU_OPS or op not in ALU_OPS[dtype]:
        raise ValueError(f"{fn}: no op {op!r} in {dtype}")
    if u not in ALU_U.get(op, (8,)):
        raise ValueError(f"{fn}: {op} at u = {u}; u in "
                         f"{ALU_U.get(op, (8,))}")
    steps = r * unroll
    if steps < 0 or steps % ALU_UNROLL:
        raise ValueError(f"{fn}: r x unroll = {steps} steps, not a "
                         f"multiple of {ALU_UNROLL}")
    return steps


def alu_ref(op: str, dtype=torch.float64, u: int = 8, r: int = 256,
            unroll: int = 8, threads: int = ALU_THREADS, device="cpu"):
    """The (threads,) sums of each thread's ``u`` streams after r x unroll
    steps of ``op`` (roll / shfl: across each 32 threads)."""
    if dtype not in ALU_OPS or op not in ALU_OPS[dtype]:
        raise ValueError(f"alu_ref: no op {op!r} in {dtype}")
    if op in ("roll", "shfl") and threads % 32:
        raise ValueError("alu_ref: roll and shfl need whole warps")
    t = torch.arange(threads, device=device)
    c = 1 + (t % 3).to(dtype) * EPS
    x = torch.stack([torch.tensor(X0 + DX * i, dtype=dtype, device=device) * c
                     for i in range(u)])
    for _ in range(r * unroll):
        if op == "fma":
            x = x * 0.5 + 0.75
        elif op == "mul":
            x = x * 1.0000001
        elif op in ("log", "log_pos"):
            x = torch.log(x) + 1.54
        elif op == "recip":
            x = torch.reciprocal(x)
        elif op in ("div", "div_pos"):
            x = (x + 1) / x
        elif op == "roll":                  # lane l takes lane l+1's value
            x = x.view(u, -1, 32).roll(-1, 2).reshape(u, -1)
        else:                               # shfl: lane l takes lane l-1's
            w = x.view(u, -1, 32)
            x = torch.cat([w[..., :1], w[..., :-1]], 2).reshape(u, -1)
    acc = x[0]
    for i in range(1, u):
        acc = acc + x[i]
    return acc


def alu_rtol(op: str, dtype) -> float:
    """The relative error that P2's ``op`` may have against alu_ref."""
    return _ALU_RTOL.get((dtype, op), _ALU_RTOL_DTYPE[dtype])


def alu_blocks(op: str, dtype=torch.float64, u: int = 8, device="cuda") -> int:
    """P2's grid: the most blocks of ALU_THREADS that each SM keeps
    resident for this op, on every SM (one wave)."""
    device = _cuda("alu_blocks", device)
    _check_alu("alu_blocks", op, dtype, u, 0, ALU_UNROLL)
    per_sm = ctypes.c_int(0)
    _, query = _LIB.fns()["stb_vpu_alu_occupancy"]
    with torch.cuda.device(device):
        err = query(int(dtype == torch.float64), OP_CODES[op], u,
                    ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"alu_blocks: occupancy query failed: cudaError "
                           f"{err}, {per_sm.value} blocks an SM")
    return per_sm.value * _sms(device)


def alu_cuda(op: str, dtype=torch.float64, u: int = 8, r: int = 256,
             unroll: int = 8, device="cuda"):
    """Launch P2 over one full wave of blocks of ALU_THREADS (alu_blocks);
    the same values as alu_ref(threads=blocks x ALU_THREADS)."""
    device = _cuda("alu_cuda", device)
    steps = _check_alu("alu_cuda", op, dtype, u, r, unroll)
    blocks = alu_blocks(op, dtype, u, device)
    out = torch.empty(blocks * ALU_THREADS, dtype=dtype, device=device)
    _LIB.launch("stb_vpu_alu", device, int(dtype == torch.float64),
                OP_CODES[op], u, out.data_ptr(), X0, DX, EPS, 1.0,
                steps // ALU_UNROLL, blocks, key="alu")
    return out


# -- P3: shared-memory accesses at K3's row-state layout -----------------------

def headline_chunk(sms: int) -> int:
    """K3's chunk of rows at its headline shape (2^20, 1024)."""
    return cols_plan(1 << 20, 1024, sms).chunk


def smem_rows(mode: str) -> int:
    """f64 rows a P3 access moves: one, or two (16 bytes)."""
    return 2 if mode.endswith("8") else 1


def smem_ref(mode: str, dtype=torch.float64, chunk: int = 8192,
             steps: int = 1024, blocks: int = 1, device="cpu"):
    """The (blocks x 512,) accumulators after ``steps`` passes over each
    thread's chunk / 512 rows (the state holds zeros until stored to).
    ``dtype`` f32 gives the TPU probe's values; the kernel is f64."""
    if mode not in SMEM_MODES:
        raise ValueError(f"smem_ref: mode {mode!r}")
    t = torch.arange(blocks * ROW_THREADS, device=device)
    acc = 1 + (t % 3).to(dtype) * EPS
    add = 1.0 if mode.startswith("store") else 0.0
    for _ in range(steps * (chunk // ROW_THREADS)):
        acc = acc * 0.999 + add
    return acc


def smem_cuda(mode: str, pad: bool = True, chunk: int = None,
              steps: int = 1024, device="cuda"):
    """Launch P3 on K3's f64 row state with one block an SM (K3's) and
    K3's headline chunk by default, with or without the pad; the same
    values as smem_ref(dtype=float64, blocks = the SMs)."""
    device = _cuda("smem_cuda", device)
    if mode not in SMEM_MODES:
        raise ValueError(f"smem_cuda: mode {mode!r}")
    chunk = headline_chunk(_sms(device)) if chunk is None else chunk
    blocks = _sms(device)
    w = smem_rows(mode)
    if chunk < ROW_THREADS or chunk % ROW_THREADS or (chunk // ROW_THREADS) % w:
        raise ValueError(f"smem_cuda: chunk {chunk} is not whole rows of "
                         f"{w} a thread")
    if steps < 0:
        raise ValueError(f"smem_cuda: {steps} steps")
    out = torch.empty(blocks * ROW_THREADS, dtype=torch.float64,
                      device=device)
    _LIB.launch("stb_vpu_smem", device, SMEM_MODES.index(mode), int(pad),
                out.data_ptr(), EPS, chunk, steps, blocks, key="smem")
    return out


# -- P4: overlap of K3's column chain with its stores --------------------------

def _overlap_accs(m: int, iters: int, device):
    """acc_j, the sum of the four chains of column j, f64."""
    j = torch.arange(m, device=device)
    c = 1 + (j % 3).to(torch.float64) * EPS
    x = [torch.tensor(X0 + DX * i, dtype=torch.float64, device=device) * c
         for i in range(4)]
    for _ in range(iters // 8 * 8):
        x = [xi * 0.5 + 0.75 for xi in x]
    return x[0] + x[1] + x[2] + x[3]


def overlap_ref(m: int, n: int, iters: int = 128, store: bool = True,
                sms: int = 132, device="cpu"):
    """With ``store``, (V, Srel) of shape (m, n), f32: column j holds acc_j
    and acc_j + 1 (iters 0: the stores alone).  Without, the chains
    alone: each row thread's sum of acc_j over its block's chunks and
    columns in order, (blocks x 512,) f64, on cols_plan's geometry for
    ``sms`` SMs."""
    acc = _overlap_accs(m, iters, device)
    if store:
        v = acc.float()[:, None].expand(m, n).contiguous()
        return v, (acc + 1).float()[:, None].expand(m, n).contiguous()
    plan = cols_plan(n, m, sms)
    terms = acc.tolist()
    sums = []
    for b in range(plan.blocks):
        total = 0.0
        for _ in range(b, plan.chunks, plan.blocks):
            for a in terms:
                total += a
        sums.append(total)
    return torch.tensor(sums, dtype=torch.float64,
                        device=device).repeat_interleave(ROW_THREADS)


def overlap_cuda(m: int, n: int, iters: int = 128, alu: bool = True,
                 store: bool = True, device="cuda", out=None):
    """Launch P4 on cols_plan's geometry with K3's shared memory: the
    chains and the stores (``alu`` and ``store``), the stores alone, or
    the chains alone; the same values as overlap_ref(iters if alu else
    0, store).  ``out`` (V, Srel) takes the outputs' place."""
    device = _cuda("overlap_cuda", device)
    _check_shape("overlap_cuda", n, m)
    if not (alu or store):
        raise ValueError("overlap_cuda: neither the chains nor the stores")
    if iters < 0 or iters % 8:
        raise ValueError(f"overlap_cuda: iters {iters}, not a multiple of 8")
    plan = cols_plan(n, m, _sms(device))
    v = s = sink = None
    if store:
        out_v, out_s = out if out is not None else (None, None)
        v = _check_out("overlap_cuda", out_v, (m, n), torch.float32, device)
        s = _check_out("overlap_cuda", out_s, (m, n), torch.float32, device)
    else:
        sink = torch.empty(plan.blocks * ROW_THREADS, dtype=torch.float64,
                           device=device)
    ptr = (lambda x: None if x is None else x.data_ptr())
    _LIB.launch("stb_vpu_overlap", device, int(alu), int(store), ptr(v),
                ptr(s), ptr(sink), n, m, plan.chunk, plan.chunks,
                plan.blocks, plan.smem, iters if alu else 0, X0, DX, EPS,
                key="overlap")
    return (v, s) if store else sink


# -- P5 / P6: K3's column mix, and the ladder from it to K3 --------------------

class MixOut(NamedTuple):
    """A P5 / P6 result: V and Srel (m, n) f32; w, the vcarry sums (w1, w2)
    of each row thread of each chunk, (chunks x 512, 2) f64; xs, the
    xscratch pair's sum of each row, (n,) f64.  w and xs None without
    their step."""
    v: torch.Tensor
    srel: torch.Tensor
    w: Optional[torch.Tensor]
    xs: Optional[torch.Tensor]


def ladder() -> list:
    """P6's rungs in order, each the rung before it and one more step:
    BISECT_STEPS[:i] for i = 1..9 (P5's mix, no step, comes first)."""
    return [BISECT_STEPS[:i] for i in range(1, len(BISECT_STEPS) + 1)]


def branch() -> list:
    """The branch from the ladder's top rung: BISECT_STEPS with each
    lever of LEVERS alone, then with both."""
    return [BISECT_STEPS + (lever,) for lever in LEVERS] + [
        BISECT_STEPS + LEVERS]


def _steps(fn: str, steps) -> tuple:
    steps = tuple(steps)
    every = BISECT_STEPS + LEVERS
    if len(set(steps)) != len(steps) or not set(steps) <= set(every):
        raise ValueError(f"{fn}: steps {steps}, each at most once of "
                         f"{every}")
    return tuple(x for x in every if x in steps)


def steps_bits(steps) -> int:
    """The kernel's template bits of ``steps``: bit i for step i of
    BISECT_STEPS + LEVERS."""
    every = BISECT_STEPS + LEVERS
    return sum(1 << every.index(x) for x in _steps("steps_bits", steps))


def probe_name(steps=(), mode: str = "mix") -> str:
    """The name (a key of LAUNCHES, and of chip_smoke.py's kernels line)
    of a P5 / P6 launch: ``mix`` and ``mix_staged`` for P5's modes,
    ``bisect`` for the ladder's rungs, ``bisect_<its levers>`` for the
    branch's."""
    steps = _steps("probe_name", steps)
    if not steps:
        return "mix" if mode == "mix" else f"mix_{mode}"
    levers = [x for x in steps if x in LEVERS]
    return "_".join(["bisect"] + levers)


def bisect_exact(steps) -> bool:
    """Whether P6 at ``steps`` is held to its plain version bitwise: with no
    div_pos or log_pos, each within an ulp of torch's divide and log."""
    return not {"div_pos", "log_pos"} & set(steps)


def mix_threads(steps) -> int:
    """A P5 / P6 block's threads, as the kernel launches it: the 16 row
    warps, from barriers on the carry warp, with storewarps STORE_WARPS
    store warps, with early a poll warp."""
    has = set(_steps("mix_threads", steps)).__contains__
    return (ROW_THREADS + (32 if has("barriers") else 0)
            + (32 * STORE_WARPS if has("storewarps") else 0)
            + (32 if has("early") else 0))


def mix_smem(steps, staged: bool, chunk: int, pieces: int) -> int:
    """A P5 / P6 block's dynamic shared memory: the row state (K3's 8.5
    bytes a row), xscratch's pair (16 more), the piece table, staged's two
    staging buffers (16 more), storewarps' two columns of V (17 more)."""
    slots = chunk + chunk // 16
    return (8 * slots + (16 * chunk if "xscratch" in steps else 0)
            + 4 * ((7 * pieces + 3) & ~3) + (16 * chunk if staged else 0)
            + (16 * slots if "storewarps" in steps else 0))


def _fma32(a, b, c):
    """a b + c rounded once to f32 (XLA's fused multiply-add on the CPU):
    the product of two f32 is exact in f64, the sum is rounded to odd in
    f64 from its exact error (TwoSum), and that rounds to f32 as the exact
    sum would."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(s)
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def _mix_table(pieces: int, steps):
    """(7, pieces) f32 on the CPU: the piece values of column residue t,
    acc_0 = 1 + t (+ A_SMEM with smem), acc_{p+1} = acc_p 0.9999 + 1e-5 as
    one f32 FMA, or with vcarry acc_p 0.9999 rounded each step (the card's
    arithmetic; XLA's CPU evaluation folds the chain into one rounding)."""
    acc = 1 + torch.arange(7, dtype=torch.float32)
    if "smem" in steps:
        acc = acc + torch.tensor(A_SMEM, dtype=torch.float32)
    decay = torch.tensor(0.9999, dtype=torch.float32)
    add = torch.tensor(1e-5, dtype=torch.float32)
    cols = [acc]
    for _ in range(1, pieces):
        acc = acc * decay if "vcarry" in steps else _fma32(acc, decay, add)
        cols.append(acc)
    return torch.stack(cols, 1)


def _scan_lanes(a, b):
    """Inclusive scan of the maps x -> a x + b along the last dimension, as
    the kernel's scan_maps: entry l ends with map_l o ... o map_0 (torch
    tensors or numpy arrays)."""
    cat = np.concatenate if isinstance(a, np.ndarray) else torch.cat
    off = 1
    while off < a.shape[-1]:
        a, b = (cat([a[..., :off], a[..., off:] * a[..., :-off]], -1),
                cat([b[..., :off], a[..., off:] * b[..., :-off]
                     + b[..., off:]], -1))
        off *= 2
    return a, b


def _chain(a, b, k: int, chunks: int, handoff: bool):
    """The scan step's rows in the kernel's order of operations: each
    thread composes its k rows, each warp scans its 32 threads' maps, and
    each thread replays its rows from the value entering it: 0 at each
    warp's first row, or with the hand-off V above the warp (on the host,
    in the same operations: the carry warp's scan of the 16 warps' maps,
    the chunks' carries in order)."""
    shape = (chunks, ROW_THREADS // 32, 32, k)
    a, b = a.view(shape), b.view(shape)
    ca, cb = a[..., 0], b[..., 0]
    for i in range(1, k):
        ca, cb = a[..., i] * ca, a[..., i] * cb + b[..., i]
    ia, ib = _scan_lanes(ca, cb)
    if handoff:
        pa, pb = _scan_lanes(ia[..., 31].cpu().numpy(),
                             ib[..., 31].cpu().numpy())
        ta, tb = pa[:, -1], pb[:, -1]
        carry = [ta.dtype.type(0)]
        for c in range(1, chunks):
            carry.append(ta[c - 1] * carry[-1] + tb[c - 1])
        cin = np.array(carry)[:, None]
        vw = torch.from_numpy(np.concatenate(
            [cin, pa[:, :-1] * cin + pb[:, :-1]], 1)).to(a.device)
    else:
        vw = torch.zeros(ia.shape[:2], dtype=a.dtype, device=a.device)
    vw = vw[..., None]
    x = torch.cat([vw, ia[..., :-1] * vw + ib[..., :-1]], -1)
    out = torch.empty_like(a)
    for i in range(k):
        x = a[..., i] * x + b[..., i]
        out[..., i] = x
    return out.reshape(-1)


def bisect_ref(m: int, n: int, steps=(), dtype=torch.float64,
               piece: int = PIECE, slab: int = SLAB, sms: int = 132,
               device="cpu") -> MixOut:
    """P6 at any combination of ``steps`` (P5 at none) on cols_plan's
    geometry for ``sms`` SMs.  ``dtype`` is the row state's: f64 is the
    kernel's; f32 reproduces the TPU probe as XLA evaluates it on the CPU
    (the state step state 0.999 + acc one f32 FMA, Srel = V + 1 in f32).
    ``slab`` is the TPU's S 128 of the init branch's transposed index
    rvec = (r mod slab) H + r div slab, H = ceil(n / slab) (the TPU's H
    where slab divides n); smem's scalar is A_SMEM.  Without the scan,
    div_pos has no effect on the values (A is read by the scan alone) nor
    has handoff; barriers and the LEVERS never do."""
    steps = tuple(x for x in _steps("bisect_ref", steps) if x not in LEVERS)
    _check_shape("bisect_ref", n, m)
    if piece < 32 or slab < 1:
        raise ValueError(f"bisect_ref: piece {piece} < 32 or slab {slab} < 1")
    has = set(steps).__contains__
    plan = cols_plan(n, m, sms)
    k = plan.chunk // ROW_THREADS
    rows = plan.chunks * plan.chunk
    r = torch.arange(rows, device=device)
    live = r < n
    acc_rows = _mix_table(-(-rows // piece), steps).to(device)[:, r // piece]
    if has("initbranch"):
        hs = -(-n // slab)
        state = 1 / (((r % slab) * hs + r // slab).to(dtype) - 0.5)
    else:
        state = torch.zeros(rows, dtype=dtype, device=device)
    decay = torch.tensor(0.999, dtype=dtype, device=device)
    v = torch.empty((m, n), dtype=torch.float32, device=device)
    srel = torch.empty_like(v)
    xs = comp = torch.zeros(n, dtype=dtype, device=device)
    w1 = w2 = torch.zeros(rows // k, dtype=dtype, device=device)
    for j in range(m):
        acc = acc_rows[j % 7]
        out = (_fma32(state, decay, acc) if dtype == torch.float32
               else state * decay + acc.to(dtype))
        if has("scan"):
            am = (1 / (2 + state.abs()) if has("div_pos")
                  else torch.full_like(state, 0.5))
            bm = (1 - am) * out
            x = _chain(torch.where(live, am, 1.0), torch.where(live, bm, 0.0),
                       k, plan.chunks, has("handoff"))
        else:
            x = torch.where(live, out, 0.0)
        state = x
        if has("vcarry"):
            xt = x.view(-1, k)
            w1, w2 = w1 * decay + xt[:, 0], w2 * decay + xt[:, -1]
        xv = x[:n]
        v[j] = xv.float()
        term = torch.log(xv.abs().clamp_min(TINY)) if has("log_pos") else xv
        if has("xscratch"):
            y = term - comp
            t = xs + y
            comp, xs = (t - xs) - y, t
            term = t
        srel[j] = (term if has("log_pos") else xv + 1).float()
    return MixOut(v, srel, torch.stack([w1, w2], 1) if has("vcarry") else None,
                  xs if has("xscratch") else None)


def mix_ref(m: int, n: int, dtype=torch.float64, piece: int = PIECE,
            sms: int = 132, device="cpu"):
    """P5's (V, Srel), (m, n) f32, the values of both MIX_MODES; dtype as
    bisect_ref's."""
    out = bisect_ref(m, n, (), dtype, piece, sms=sms, device=device)
    return out.v, out.srel


def mix_errors(got, want, steps=()):
    """(largest absolute difference, within tolerance) of a P5 / P6 result
    against its plain version, part by part: bitwise where
    bisect_exact(steps); else the f64 sinks within alu_rtol's f64 1e-12
    relative and the f32 tables within one f32 ulp (2^-23 relative), since
    an f64 difference of an ulp rounds to the other f32 neighbour at a
    tie."""
    exact = bisect_exact(steps)
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g is None or w is None:
            ok = ok and g is None and w is None
            continue
        ok = ok and g.shape == w.shape and g.dtype == w.dtype
        rtol = 2.0 ** -23 if g.dtype == torch.float32 else _ALU_RTOL_DTYPE[
            torch.float64]
        gf, wf = g.reshape(-1), w.reshape(-1)
        for i in range(0, gf.numel(), 1 << 26):
            gb, wb = gf[i:i + (1 << 26)].double(), wf[i:i + (1 << 26)].double()
            d = (gb - wb).abs()
            err = max(err, float(d.nan_to_num(math.inf).max()))
            if exact:
                ok = ok and torch.equal(gb, wb)
            else:
                ok = ok and bool(torch.isfinite(gb).all()) and bool(
                    (d <= rtol * wb.abs()).all())
    return err, ok


def mix_plan(fn: str, steps, staged: bool, m: int, n: int, piece: int,
             sms: int):
    """(cols_plan, pieces, shared memory) of a P5 / P6 launch on ``sms``
    SMs; a ValueError for a shape, piece or (steps, chunk) the kernel does
    not take: staged needs n % 4 == 0 (whole 16-byte bulk copies), and a
    block's shared memory must fit beside MIX_STATIC (storewarps' does
    not at chunks of 8192, (2^20, 1024)) and its threads within
    THREADS_MAX."""
    _check_shape(fn, n, m)
    if mix_threads(steps) > THREADS_MAX:
        raise ValueError(f"{fn}: {mix_threads(steps)} threads a block, more "
                         f"than {THREADS_MAX}")
    if piece < 32:
        raise ValueError(f"{fn}: piece {piece} < 32 rows")
    if staged and n % 4:
        raise ValueError(f"{fn}: staged needs n % 4 == 0 (whole 16-byte "
                         f"bulk copies), not {n}")
    plan = cols_plan(n, m, sms)
    pieces = -(-plan.chunks * plan.chunk // piece)
    smem = mix_smem(steps, staged, plan.chunk, pieces)
    if smem > SMEM_MAX - MIX_STATIC:
        raise ValueError(f"{fn}: {' '.join(steps) or 'mix'}"
                         f"{' staged' if staged else ''} at a chunk of "
                         f"{plan.chunk} rows and {pieces} pieces needs "
                         f"{smem} bytes of shared memory, more than "
                         f"{SMEM_MAX - MIX_STATIC}")
    return plan, pieces, smem


def _mix_launch(name: str, steps, staged: bool, m: int, n: int, piece: int,
                a, device, out, blocks=None) -> MixOut:
    fn = f"{name}_cuda"
    plan, pieces, smem = mix_plan(fn, steps, staged, m, n, piece,
                                  _sms(device))
    if blocks is not None and not 1 <= blocks <= plan.blocks:
        raise ValueError(f"{fn}: blocks {blocks} outside 1..{plan.blocks}")
    has = set(steps).__contains__
    out_v, out_s, out_w, out_x = out if out is not None else (None,) * 4
    v = _check_out(fn, out_v, (m, n), torch.float32, device)
    s = _check_out(fn, out_s, (m, n), torch.float32, device)
    w = (_check_out(fn, out_w, (plan.chunks * ROW_THREADS, 2), torch.float64,
                    device) if has("vcarry") else None)
    xs = (_check_out(fn, out_x, (n,), torch.float64, device)
          if has("xscratch") else None)
    if has("smem"):
        if a is None:
            a = torch.full((1,), A_SMEM, dtype=torch.float32, device=device)
        _nvcc.check(fn, device, {"a": (a, torch.float32, (1,))})
    halo = ticket = None
    if has("handoff"):
        halo = torch.full((plan.halo_len,), math.nan, dtype=torch.float64,
                          device=device)
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    ptr = (lambda x: None if x is None else x.data_ptr())
    _LIB.launch("stb_vpu_mix", device, steps_bits(steps), int(staged),
                ptr(a) if has("smem") else None, v.data_ptr(), s.data_ptr(),
                ptr(w), ptr(xs), ptr(halo), ptr(ticket), n, m, plan.chunk,
                plan.chunks, plan.blocks if blocks is None else blocks, smem,
                piece, pieces, SLAB,
                key=probe_name(steps, "staged" if staged else "mix"))
    return MixOut(v, s, w, xs)


def mix_cuda(m: int, n: int, mode: str = "mix", piece: int = PIECE,
             device="cuda", out=None):
    """Launch P5 in a mode of MIX_MODES on cols_plan's geometry; the same
    values as mix_ref(dtype = float64).  ``out`` (V, Srel) takes the
    outputs' place."""
    device = _cuda("mix_cuda", device)
    if mode not in MIX_MODES:
        raise ValueError(f"mix_cuda: mode {mode!r}")
    res = _mix_launch("mix", (), mode == "staged", m, n, piece, None, device,
                      None if out is None else (*out, None, None))
    return res.v, res.srel


def bisect_cuda(m: int, n: int, steps, piece: int = PIECE, a=None,
                device="cuda", out=None, blocks=None) -> MixOut:
    """Launch P6 at a rung of ladder() or branch() (the kernel is built for
    those); the same values as bisect_ref(dtype=float64), within
    mix_errors' tolerance (a branch rung: bitwise the top rung's).  ``a``:
    a buffer of one f32 on the device holding A_SMEM, smem's scalar, to
    reuse across launches (made if None); ``out`` (V, Srel, w, xs) takes
    the outputs' place; ``blocks`` fewer blocks than cols_plan's, each
    taking several chunks in turn (the storewarps rungs fit only where
    cols_plan gives at most one chunk an SM)."""
    device = _cuda("bisect_cuda", device)
    steps = _steps("bisect_cuda", steps)
    if steps not in ladder() + branch():
        raise ValueError(f"bisect_cuda: {steps} is not a rung of the "
                         f"ladder {BISECT_STEPS} nor of its branch "
                         f"{LEVERS}")
    return _mix_launch("bisect", steps, False, m, n, piece, a, device, out,
                       blocks)
