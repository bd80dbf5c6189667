"""The port's own spans in a traced window, and the per-layer readings
made from them.

The port marks where its time goes with spans of its own
(``libstb_tpu_torch/utils/metrics.span``: ``record_function``s named
``stb/<name>``, recorded only while a profiler records).  In the Chrome
trace of a traced run they lie on the host's timeline beside the host's
CUDA calls (``cuda_runtime`` or ``cuda_driver`` events), on the same
clock as the device operations: each launch carries the ``correlation``
id of the kernel, copy or set it launched (``args.correlation``).  The
helpers here read the window's raw ``X`` events:

* ``spans`` / ``count``: a span's intervals and how many started in the
  window: a span of a name is also its counter;
* ``launches_in``: the device operations whose launch lies inside a span;
* ``idle_in``: the device-idle time (the window less the union of device
  operations, ``TraceView.busy_intervals``) that the union of some spans
  covers.

``READINGS`` holds the seven per-layer readings, each a function of a
view that has the window's raw events as ``view.events`` and None where
it finds nothing to read.  ``TraceView`` (``benchmark/tracing.py``) keeps
only the device operations and the ``bench/`` spans, so until it keeps
the raw events too, this file's command runs one traced run of a cell
through ``benchmark/run.py`` with ``TraceView`` swapped for a subclass
that keeps them, and adds the readings to the run's line under
``program_spans``:

    python3 -m benchmark.program_spans --workload <name> --seed <n> \\
        --seconds <s>

Where the program has no ``stb/`` spans (an older commit) the readings
are None and the line carries none of them.
"""
from __future__ import annotations

import bisect
import statistics
import sys
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import harness, tracing
from .tracing import DEVICE_CATS, STEP_PREFIX

SPAN_PREFIX = "stb/"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def window_events(events: list, t0: float, t1: float) -> list:
    """The ``X`` events that overlap the window [t0, t1) (us)."""
    return [e for e in events
            if e.get("ph") == "X" and "dur" in e
            and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]


def _merge(iv: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def spans(events: list, name: str) -> List[Tuple[float, float]]:
    """(start, end) in us of every ``stb/<name>`` span among ``events``."""
    full = SPAN_PREFIX + name
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == full]


def durations_s(view, name: str) -> List[float]:
    """Host durations of the ``stb/<name>`` spans that start in the
    window."""
    return [(e - s) * 1e-6 for s, e in spans(view.events, name)
            if view.t0 <= s < view.t1]


def count(view, name: str) -> int:
    """``stb/<name>`` spans that start in the window."""
    return len(durations_s(view, name))


def launches_in(view, name: str) -> int:
    """Device operations that start in the window and whose launch (the
    host call with the same correlation id) lies inside a ``stb/<name>``
    span."""
    launch = {}
    for e in view.events:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    inside = _merge(spans(view.events, name))
    starts = [s for s, _ in inside]
    n = 0
    for e in view.events:
        if (e.get("cat") in DEVICE_CATS
                and view.t0 <= float(e["ts"]) < view.t1):
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= inside[i][1]:
                n += 1
    return n


def idle_intervals(view) -> List[Tuple[float, float]]:
    """The window's stretches (us) in which no device operation ran."""
    out, at = [], view.t0
    for s, e in view.busy_intervals():
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if view.t1 > at:
        out.append((at, view.t1))
    return out


def _overlap_us(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_in(view, names: Iterable[str]) -> float:
    """Seconds of device-idle time in the window that the union of the
    ``stb/<name>`` spans of ``names`` covers."""
    union = _merge(iv for n in names for iv in spans(view.events, n))
    union = [(max(s, view.t0), min(e, view.t1)) for s, e in union
             if e > view.t0 and s < view.t1]
    return _overlap_us(idle_intervals(view), union) * 1e-6


def idle_s(view) -> float:
    return sum(e - s for s, e in idle_intervals(view)) * 1e-6


def all_names(view) -> List[str]:
    return sorted({str(e["name"])[len(SPAN_PREFIX):] for e in view.events
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(SPAN_PREFIX)})


def n_steps(view) -> int:
    """Steps in the window: the host's ``ProfilerStep#k`` annotations.
    Where a step launched device work Kineto writes it again on the
    device's timeline (``gpu_user_annotation``), which
    ``TraceView.n_steps`` counts too: there it reads twice the steps."""
    return sum(1 for e in view.events
               if e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith(STEP_PREFIX))


def _ratio(num: float, den: float) -> Optional[float]:
    return num / den if den > 0 else None


def _median_of(view, name: str, scale: float) -> Optional[float]:
    d = durations_s(view, name)
    return statistics.median(d) * scale if d else None


def _launches_per(view, name: str) -> Optional[float]:
    if not view.device_ops:
        return None
    return _ratio(launches_in(view, name), count(view, name))


def _idle_per_step(view, names, scale: float) -> Optional[float]:
    steps = n_steps(view)
    if (steps == 0 or not view.device_ops
            or not any(count(view, n) for n in names)):
        return None
    return idle_in(view, names) / steps * scale


READINGS: Dict[str, Callable] = {
    # launches a TI step makes: its device operations / the steps
    "gibbs.ti_launches_per_step": lambda v: _launches_per(v, "ti.step"),
    # device-idle ms an iteration inside the TI sweep
    "gibbs.ti_idle_ms_per_iter": lambda v: _idle_per_step(
        v, ["ti.sweep"], 1e3),
    # host reads of all(done) a slice move: one a try, one to end it
    "gibbs.slice_tries_per_move": lambda v: _ratio(
        count(v, "slice.read"), count(v, "slice.move")),
    # device-idle ms an iteration inside the moves of a and b
    "gibbs.hyper_idle_ms_per_iter": lambda v: _idle_per_step(
        v, ["hyper.sample_a", "hyper.sample_b"], 1e3),
    # median host us from make's entry to the fill's launch returning
    "remake.launch_us": lambda v: _median_of(v, "make.launch", 1e6),
    # median host ms of the S1 pair's copies, which wait for the fill
    "remake.s1_wait_ms": lambda v: _median_of(v, "make.s1_upload", 1e3),
    # device-idle us a remake inside make
    "remake.idle_in_make_us": lambda v: _idle_per_step(v, ["make"], 1e6),
}


def breakdown(view) -> dict:
    """Per step (an iteration or a remake): the window's wall time, and
    where its device-idle time and its launches lie among the spans: the
    idle share inside any ``stb/`` span, and per span name its count,
    median host time, and the idle ms and launches a step inside it."""
    steps = n_steps(view)
    if steps == 0:
        return {}
    out = {"steps": steps, "step_ms": view.window_s / steps * 1e3}
    idle = idle_s(view)
    names = all_names(view)
    if idle <= 0 or not names or not view.device_ops:
        return out
    durs = {n: durations_s(view, n) for n in names}
    per = 1.0 / steps
    out.update({
        "idle_ms_per_step": idle * per * 1e3,
        "idle_share_in_spans": idle_in(view, names) / idle,
        "counts": {n: len(d) for n, d in durs.items()},
        "median_ms": {n: statistics.median(d) * 1e3
                      for n, d in durs.items() if d},
        "idle_ms_per_step_in": {n: idle_in(view, [n]) * per * 1e3
                                for n in names},
        "launches_per_step_in": {n: launches_in(view, n) * per
                                 for n in names}})
    return out


def readings(view) -> dict:
    out = {}
    for name, fn in READINGS.items():
        val = fn(view)
        if val is not None:
            out[name] = val
    out["breakdown"] = breakdown(view)
    return out


def main(argv=None) -> int:
    """One traced run of a cell through ``benchmark/run.py`` (its checks,
    its line), with the program's span readings added to the line."""
    run = harness.load_module(harness.HERE / "run.py")
    kept = []

    class KeepEvents(tracing.TraceView):
        def __init__(self, events, params=None):
            super().__init__(events, params)
            self.events = window_events(events, self.t0, self.t1)
            kept.append(self)

    real_run_cell = harness.run_cell

    def run_cell(*args, **kwargs):
        out = real_run_cell(*args, **kwargs)
        if kept:
            checks = out.pop("checks")
            out["program_spans"] = readings(kept[-1])
            out["checks"] = checks
        return out

    tracing.TraceView = KeepEvents
    harness.run_cell = run_cell
    args = list(sys.argv[1:] if argv is None else argv)
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
