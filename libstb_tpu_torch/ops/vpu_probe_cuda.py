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
  chain and then the two output columns' stores, either alone or both.

Each ``*_cuda`` wrapper checks its arguments, allocates its outputs with
``torch.empty`` (or takes them in ``out``), launches on the current stream
and raises on a launch error; it runs on a CUDA device only.  Each
``*_ref`` is the plain PyTorch version, giving the same values (the
kernels' arithmetic is rounded as the plain version's: no contracted
multiply-adds); the CPU uses it, and chip_smoke.py holds each kernel to it
on the card.  ``LAUNCHES[name]`` counts each probe's launches.  The source
is built by ops/_nvcc.py on first use, as K1-K3's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _nvcc
from .stirling_cuda import COLS_MAX_N, cols_plan

__all__ = ["PROBES", "LAUNCHES", "SOURCES", "build", "load",
           "WRITE_MODES", "write_floor_cuda", "write_floor_ref",
           "ALU_OPS", "OP_CODES", "ALU_U", "ALU_PERIOD", "alu_rtol",
           "alu_blocks", "alu_cuda", "alu_ref", "SMEM_MODES",
           "headline_chunk", "smem_rows", "smem_cuda", "smem_ref",
           "overlap_cuda", "overlap_ref"]

PROBES = ("write_floor", "alu", "smem", "overlap")
LAUNCHES = {name: 0 for name in PROBES}
SOURCES = {"vpu_probe": Path(__file__).resolve().parent.parent / "csrc"
           / "vpu_probe.cu"}

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

_lib = None


def build() -> dict:
    """Build csrc/vpu_probe.cu if needed; {name: .so path}."""
    return _nvcc.build_all(SOURCES)


def load():
    """Build the probes if needed and bind their library (once)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["vpu_probe"]))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn, args in (
                ("stb_vpu_write_full", [p, p, i, i, p]),
                ("stb_vpu_write_rows", [p, p] + [i] * 7 + [p]),
                ("stb_vpu_alu_occupancy",
                 [i, i, i, ctypes.POINTER(ctypes.c_int)]),
                ("stb_vpu_alu", [i, i, i, p, d, d, d, d, i, i, p]),
                ("stb_vpu_smem", [i, i, p, d, i, i, i, p]),
                ("stb_vpu_overlap", [i, i, p, p, p] + [i] * 7 + [d, d, d, p])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _cuda(fn: str, device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{fn}: {device} is not a CUDA device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, device, fn: str, *args):
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} probe launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _check_shape(fn: str, n: int, m: int):
    if not (1 <= n < COLS_MAX_N and m >= 1):
        raise ValueError(f"{fn}: (n, m) = ({n}, {m}) outside 1 <= n < 2^24, "
                         "m >= 1")


def _check_out(fn: str, t, shape, dtype, device):
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if t.device != device:
        raise ValueError(f"{fn}: out lies on {t.device}, not {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: out is {t.dtype} {tuple(t.shape)}, not "
                         f"{dtype} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: out must be contiguous")
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
        _launch("write_floor", device, "stb_vpu_write_full", v.data_ptr(),
                s.data_ptr(), n, m)
        return v, s
    plan = cols_plan(n, m, _sms(device), with_srel=mode == "piecewise")
    piece = piece if mode == "piecewise" else n
    smem = max(plan.smem, 7 * 4 * -(-n // piece))
    if smem > SMEM_MAX:
        raise ValueError(f"write_floor_cuda: {-(-n // piece)} pieces of "
                         f"{piece} rows: their table takes {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    _launch("write_floor", device, "stb_vpu_write_rows", v.data_ptr(),
            None if s is None else s.data_ptr(), n, m, plan.chunk,
            plan.chunks, plan.blocks, smem, piece)
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
    with torch.cuda.device(device):
        err = load().stb_vpu_alu_occupancy(int(dtype == torch.float64),
                                           OP_CODES[op], u,
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
    _launch("alu", device, "stb_vpu_alu", int(dtype == torch.float64),
            OP_CODES[op], u, out.data_ptr(), X0, DX, EPS, 1.0,
            steps // ALU_UNROLL, blocks)
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
    _launch("smem", device, "stb_vpu_smem", SMEM_MODES.index(mode), int(pad),
            out.data_ptr(), EPS, chunk, steps, blocks)
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
    _launch("overlap", device, "stb_vpu_overlap", int(alu), int(store),
            ptr(v), ptr(s), ptr(sink), n, m, plan.chunk, plan.chunks,
            plan.blocks, plan.smem, iters if alu else 0, X0, DX, EPS)
    return (v, s) if store else sink
