"""The yardstick of the windowed collapsed-table sweep (CTW): the least time
one sweep can take on one NVIDIA H100, counted from its shape alone, and
the device time a traced window's sweeps took.

A sweep of C chains over J groups and D categories, with ``occupied`` of
the J x D counts above 0 and K = 2w + 1 candidates a count, must

* read and write the state once: t (C, J, D) and T (C, J), 4 bytes each,
  read and written; n (J, D) and H (D,), 4 bytes each, read;
* evaluate every candidate of every occupied count, C x occupied x K,
  CTW_FLOPS f32 operations each: Srel off the grid by a 4-tap cubic in
  a (8), the product term log(b + (T' + k) a) and its running sum (4,
  the log counted as two), the weight's sum (1), the Gumbel from its
  uniform (4, two logs), the perturbed weight's compare (1), the window's
  two bounds (2).

The bound is the larger of the bytes at the data sheet's HBM rate and the
operations at its f32 rate (NVIDIA's H100 SXM data sheet, at its 700 W
power limit: 3.35 TB/s, 67 TFLOP/s of f32 outside the tensor cores).  It
counts what the sweep's semantics need, not what the program launches,
so that a sweep fused into one kernel is read against the same work.

``sweep_device_s`` reads a traced window whose view keeps the trace's
raw events (``events``; ``drivers/checkc.py`` has its views keep them):
the device operations whose launch (the host call with the same
``correlation`` id) lies inside a ``bench/<span>`` span.
"""
from __future__ import annotations

import bisect
from typing import List

from . import roofline
from .tracing import DEVICE_CATS, SPAN_PREFIX

__all__ = ["F32_FLOPS", "CTW_FLOPS", "state_bytes", "sweep_bound_s",
           "sweep_device_s"]

F32_FLOPS = 67e12
CTW_FLOPS = 8 + 4 + 1 + 4 + 1 + 2
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def state_bytes(chains: int, groups: int, dim: int) -> int:
    """Bytes of one sweep's state traffic: t and T read and written, n and
    H read."""
    return 4 * (2 * chains * groups * dim + 2 * chains * groups
                + groups * dim + dim)


def sweep_bound_s(chains: int, groups: int, dim: int, occupied: int,
                  candidates: int) -> float:
    """Seconds: the larger of the bytes bound and the f32 operations bound
    of one CTW sweep."""
    return max(state_bytes(chains, groups, dim) / roofline.HBM_BPS,
               CTW_FLOPS * chains * occupied * candidates / F32_FLOPS)


def sweep_device_s(view, span: str) -> List[float]:
    """Device seconds of each ``bench/<span>`` span that starts in the
    window: the summed durations of the device operations it launched.
    Empty where the view keeps no raw events or holds no such span."""
    events = getattr(view, "events", None)
    if not events:
        return []
    name = SPAN_PREFIX + span
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == name
                   and view.t0 <= float(e["ts"]) < view.t1)
    if not spans:
        return []
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    starts = [s for s, _ in spans]
    per = [0.0] * len(spans)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            per[i] += float(e["dur"])
    return [p * 1e-6 for p in per if p > 0]
