"""The slice moves of a and b in batches of K tries: the hand-written CUDA
kernel behind samplers/hyper.sample_a and sample_b (kernel "slice") on a
CUDA device.

``slice_move_a`` / ``slice_move_b`` (csrc/slice_move.cu) run
samplers/slice.slice_sample's shrinking-interval loop (SliceSimple, the
200-try cap) with the move's log posterior computed in the kernel: one
launch runs up to K tries of every chain, and the host reads back one
count of the chains still live a batch (``stb/slice.read``), not
``all(done)`` a try.  The draws are slice_sample's: the level's uniform,
then one (C,) ``rng.uniform`` block a try, K blocks a batch; a chain that
accepts early leaves the rest of its batch's draws unused, as a reader of
the same draws that stops at the acceptance (benchmark/reference's
replay) does.  It replaces no TPU kernel (the JAX move is a
``while_loop`` XLA compiles whole).

Its plain version ``slice_move_ref`` is the same batched loop in
PyTorch around the caller's log posterior: with samplers/hyper's
densities it is the kernel's arithmetic but for the order of the group
sum, and with any density it gives slice_sample's x and ok for the same
draws.  ``lanes`` sets the geometry: a chain's group count rounded up to a
power of two, at most 32, threads a chain.  The kernel is a library of
ops/_nvcc.py, built on first use; ``LAUNCHES["slice_move"]`` counts its
launches, one a batch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc
from ..core import rng
from ..samplers.slice import TOOMANY, try_once
from ..utils import metrics

__all__ = ["K", "LAUNCHES", "SOURCES", "lanes", "slice_move_a",
           "slice_move_b", "slice_move_ref"]

K = 32                                  # tries a batch (csrc: kBatch)
LAUNCHES = {"slice_move": 0}
# density, (xp, rlo, rhi, y, done, live, x0, lo, hi, u0, T, w, curve, Q, a),
# (sT0, sT1, sw0, sw1, sc0, sc1), c1, c2, (g_max, C, I, lanes, tries, init),
# u, stream
_LIB = _nvcc.register("slice_move", _nvcc.pair(
    "slice_move", [ctypes.c_int] + [ctypes.c_void_p] * 15
    + [ctypes.c_longlong] * 6 + [ctypes.c_double] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2), LAUNCHES)
SOURCES = {_LIB.name: _LIB.source}

_DENSITY = {"a": 0, "b": 1}


def lanes(groups: int) -> int:
    """Threads a chain: ``groups`` rounded up to a power of two, at most
    32 (a warp)."""
    if groups < 1:
        raise ValueError(f"lanes: {groups} groups")
    return min(32, 1 << (groups - 1).bit_length())


def _check(x0, lo, hi, per_chain: dict, groups: dict, curve=None,
           nodes: int = 0):
    """Raise on anything the kernel cannot take (_nvcc.check; the (C, I)
    tensors and ``curve``, (C, ``nodes``), at any strides)."""
    if curve is not None and nodes < 4:
        raise ValueError(f"slice_move: a grid of {nodes} discounts (the "
                         "four-tap curve needs 4)")
    dt = x0.dtype
    C = x0.shape[0] if x0.ndim == 1 and x0.shape[0] > 0 else -1
    I = next(iter(groups.values())).shape[-1] or -1
    args = {k: (x, dt, (C,)) for k, x in
            (("x0", x0), ("lo", lo), ("hi", hi), *per_chain.items())}
    args.update({k: (x, dt, (C, I)) for k, x in groups.items()})
    if curve is not None:
        args["curve"] = (curve, dt, (C, nodes))
    _nvcc.check("slice_move", x0.device, args, real=dt,
                strided=(*groups, "curve"))


def _launch(density, state, live, x0, lo, hi, u0, T, w, curve, Q, a, c1,
            c2, g_max, us, init):
    xp, rlo, rhi, y, done = state
    C, I = T.shape
    ptrs = (ctypes.c_void_p * K)(*[u.data_ptr() for u in us])

    def ptr(x):
        return None if x is None else x.data_ptr()

    _LIB.launch(x0.dtype, x0.device, _DENSITY[density], xp.data_ptr(),
                rlo.data_ptr(), rhi.data_ptr(), y.data_ptr(), done.data_ptr(),
                live.data_ptr(), x0.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                u0.data_ptr(), T.data_ptr(), ptr(w), ptr(curve), ptr(Q),
                ptr(a), T.stride(0), T.stride(1),
                0 if w is None else w.stride(0),
                0 if w is None else w.stride(1),
                0 if curve is None else curve.stride(0),
                0 if curve is None else curve.stride(1), c1, c2, g_max, C, I,
                lanes(I), len(us), int(init), ptrs)


def _moves(density, gen, x0, lo, hi, loops, T, w=None, curve=None, Q=None,
           a=None, c1=0.0, c2=0.0, g_max=0):
    """``loops`` slice moves of every chain from x0, each in batches of K
    tries, the count of live chains read after each."""
    dt, dev = x0.dtype, x0.device
    C = x0.shape[0]
    x, ok = x0, None
    for _ in range(loops):
        with metrics.span("slice.move"):
            state = torch.empty((4, C), dtype=dt, device=dev)
            done = torch.empty((C,), dtype=torch.uint8, device=dev)
            live = torch.zeros((-(-TOOMANY // K),), dtype=torch.int32,
                               device=dev)
            u0 = rng.uniform(gen, (C,), dt, dev)
            tries = 0
            for batch in range(live.shape[0]):
                us = [rng.uniform(gen, (C,), dt, dev)
                      for _ in range(min(K, TOOMANY - tries))]
                _launch(density, (*state, done), live[batch], x, lo, hi, u0,
                        T, w, curve, Q, a, c1, c2, g_max, us, batch == 0)
                tries += len(us)
                with metrics.span("slice.read"):
                    if int(live[batch]) == 0:
                        break
            x = state[0]
            moved = done.view(torch.bool)
            ok = moved if ok is None else ok & moved
    return x, ok


def slice_move_a(gen, x0, lo, hi, T, b, curve, grid, loops: int = 1):
    """The discount's slice move (hyper.sample_a) on a card: x0, lo, hi
    (C,); T, b (C, I) and ``curve``, the chains' centred (C, G) data curve
    on ``grid`` (an agrid.AGridTable), at any strides; the curve is
    interpolated in the chains' dtype.  Returns (a, ok)."""
    dt = x0.dtype
    curve = curve.to(dt)
    _check(x0, lo, hi, {}, {"T": T, "b": b}, curve, grid.g_max)
    if dt == torch.float32:      # a card divides by a scalar as x * (1 / d)
        inv_da = float(np.float32(1.0) / np.float32(grid.da))
    else:
        inv_da = 1.0 / grid.da
    return _moves("a", gen, x0, lo, hi, loops, T, w=b, curve=curve,
                  c1=grid.a0, c2=inv_da, g_max=grid.g_max)


def slice_move_b(gen, x0, lo, hi, Q, T, shape: float, a, loops: int = 1):
    """The concentration's slice move (hyper.sample_b, a > 0) on a card:
    x0, lo, hi, Q, a (C,); T (C, I) (any strides).  Chains at a <= 0 move
    as at a = 1 (the caller takes their conjugate draw).  Returns (b,
    ok)."""
    _check(x0, lo, hi, {"Q": Q, "a": a}, {"T": T})
    return _moves("b", gen, x0, lo, hi, loops, T, Q=Q, a=a,
                  c1=shape - 1.0)


def slice_move_ref(logpost, gen, x0, lo, hi, loops: int = 1):
    """The kernel's loop in PyTorch, on any device: slice_sample's tries
    in batches of K, the same draws in the same order, all(done) read
    once a batch.  ``logpost`` maps (C,) points to (C,) log densities."""
    dt, dev = x0.dtype, x0.device
    lo = torch.as_tensor(lo, dtype=dt, device=dev).expand(x0.shape)
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(x0.shape)
    x = x0
    ok = torch.ones(x0.shape, dtype=torch.bool, device=dev)
    for _ in range(loops):
        y = logpost(x) + torch.log(rng.uniform(gen, x.shape, dt, dev))
        xp, rlo, rhi = x, lo, hi
        done = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        tries = 0
        while tries < TOOMANY:
            us = [rng.uniform(gen, x.shape, dt, dev)
                  for _ in range(min(K, TOOMANY - tries))]
            for u in us:
                xp, rlo, rhi, done = try_once(logpost, y, u, xp, rlo, rhi,
                                              done)
            tries += len(us)
            if bool(done.all()):
                break
        x = xp
        ok = ok & done
    return x, ok
