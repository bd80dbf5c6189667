"""Batched shrinking-interval slice sampler, in PyTorch.

Port of libstb_tpu/samplers/slice.py: SliceSimple (lib/sslice.c:33-80)
with interval shrinking toward the last accepted point and a 200-try cap,
all chains proposing in lockstep with finished chains masked.  The JAX
``while_loop`` becomes a Python loop that reads ``all(done)`` back from
the device once per try (the span ``stb/slice.read``, inside one
``stb/slice.move`` a loop).  This is the loop of the CPU and of the
moves without a kernel; on a card the moves of a and b
(samplers/hyper.sample_a / sample_b) run it in ops/slice_cuda's kernel,
which reads back once a batch of K = 32 tries.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import rng
from ..utils import metrics

__all__ = ["slice_sample", "try_once", "TOOMANY"]

TOOMANY = 200  # sslice.c:24


def try_once(logpost, y, u, xp, rlo, rhi, done):
    """One try of every chain not yet done: the proposal rlo + u (rhi -
    rlo) is accepted above the level ``y``, else the interval shrinks
    toward the last accepted point xp (sslice.c:62-68).  Returns the new
    (xp, rlo, rhi, done)."""
    xprop = rlo + u * (rhi - rlo)
    accept = logpost(xprop) > y
    live = ~done
    shrink = live & ~accept
    rlo = torch.where(shrink & (xprop < xp), xprop, rlo)
    rhi = torch.where(shrink & (xprop >= xp), xprop, rhi)
    xp = torch.where(live & accept, xprop, xp)
    return xp, rlo, rhi, done | accept


def slice_sample(logpost: Callable, gen, x0, lo, hi,
                 loops: int = 1, max_tries: int = TOOMANY):
    """Batched SliceSimple.

    Args:
      logpost: batched log-density, maps x of shape ``x0.shape`` to the
        same shape.
      gen: torch.Generator on x0's device (or an rng.Replay).
      x0: (C,) starting points; lo, hi: scalar or (C,) bounds.
      loops: outer burn-in loops (sslice.c:47).
      max_tries: shrink cap per loop; chains that exhaust it keep their
        current value and report ok=False.

    Returns:
      (x, ok): accepted points and per-chain success flags.
    """
    dt, dev = x0.dtype, x0.device
    lo = torch.as_tensor(lo, dtype=dt, device=dev).expand(x0.shape)
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(x0.shape)
    x = x0
    ok = torch.ones(x0.shape, dtype=torch.bool, device=dev)
    for _ in range(loops):
        with metrics.span("slice.move"):
            y = logpost(x) + torch.log(rng.uniform(gen, x.shape, dt, dev))
            xp, rlo, rhi = x, lo, hi
            done = torch.zeros(x.shape, dtype=torch.bool, device=dev)
            tries = 0
            while tries < max_tries:
                with metrics.span("slice.read"):
                    finished = bool(done.all())
                if finished:
                    break
                xp, rlo, rhi, done = try_once(
                    logpost, y, rng.uniform(gen, xp.shape, dt, dev), xp, rlo,
                    rhi, done)
                tries += 1
            x = xp
            ok = ok & done
    return x, ok
