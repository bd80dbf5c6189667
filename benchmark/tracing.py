"""The traced run: spans around the calls into the program's layers, a
``torch.profiler`` window over a few steps, and the view of that window
that the per-layer readers (``layer_metrics/<name>.py``) read.

Spans are recorded from the benchmark's side only: while a run is traced,
each public module attribute that a driver names in its ``SPANS`` is
replaced by a wrapper that opens a ``torch.profiler.record_function``
named ``bench/<span>`` around the call, and one of them (the driver's
``STEP``, called once a step: a Gibbs iteration, a remake) advances the
profiler's schedule.  The profiler skips ``skip`` steps, warms up one and
records ``steps``; each recorded step shows in the trace as a
``ProfilerStep#k`` annotation, and those annotations bound the traced
window.  The attributes are put back when the window closes, and only
then is the recorded trace exported and read: that takes seconds, which
at the profiler's last step would fall inside the measured window and
cut the work it holds.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "TraceView", "DEVICE_CATS"]

# device operations in a Chrome trace from torch.profiler (Kineto)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench/"
STEP_PREFIX = "ProfilerStep#"


class Tracer:
    """Wraps the driver's spans and profiles ``steps`` steps after
    ``skip``; ``view`` holds the recorded window once it is closed."""

    def __init__(self, spans: Dict[str, Tuple[str, str]], step: str,
                 skip: int, steps: int, cuda: bool):
        self.spans = spans
        self.step = step
        self.skip = skip
        self.steps = steps
        self.cuda = cuda
        self.view: Optional[TraceView] = None
        self._prof = None
        self._recorded = None

    def _wrap(self, name: str, fn):
        import torch

        label = SPAN_PREFIX + name
        is_step = name == self.step

        def wrapper(*args, **kwargs):
            if is_step:
                self._prof.step()
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    def _ready(self, prof):
        # called at the profiler's last step, inside the window: keep the
        # recording and read it once the window has closed
        self._recorded = prof

    def _read(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.view = TraceView(events)

    @contextlib.contextmanager
    def active(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        # the profiler's first start loads and sets up CUPTI, which takes
        # seconds: pay it here, before the window, not at its warm-up step
        with profile(activities=acts):
            torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()
        saved = []
        self._prof = profile(
            activities=acts,
            schedule=schedule(wait=self.skip, warmup=1, active=self.steps,
                              repeat=1),
            on_trace_ready=self._ready)
        try:
            for name, (module, attr) in self.spans.items():
                mod = importlib.import_module(module)
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))
            with self._prof:
                yield self
                if self.cuda:
                    torch.cuda.synchronize()
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
            self._prof = None
        if self._recorded is not None:
            self._read(self._recorded)
            self._recorded = None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class TraceView:
    """The recorded window of a Chrome trace (times in us as the trace
    gives them; the properties below return seconds)."""

    def __init__(self, events: list, params: Optional[dict] = None):
        self.params = dict(params or {})
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        steps = [e for e in xs
                 if str(e.get("name", "")).startswith(STEP_PREFIX)]
        self.n_steps = len(steps)
        if steps:
            self.t0 = min(float(e["ts"]) for e in steps)
            self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
        else:
            self.t0 = self.t1 = 0.0
        inside = [e for e in xs if self.t0 <= float(e["ts"]) < self.t1]
        self.device_ops = [(str(e.get("name", "")), float(e["ts"]),
                            float(e["dur"]))
                           for e in inside if e.get("cat") in DEVICE_CATS]
        self._spans = [(str(e["name"])[len(SPAN_PREFIX):], float(e["ts"]),
                        float(e["dur"]))
                       for e in inside
                       if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith(SPAN_PREFIX)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def span_durations_s(self, name: str) -> List[float]:
        """Host durations of the window's ``bench/<name>`` spans."""
        return [d * 1e-6 for n, _, d in self._spans if n == name]

    def device_sum_s(self) -> float:
        """Summed duration of the window's device operations."""
        return sum(d for _, _, d in self.device_ops) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _merge([(max(ts, self.t0), min(ts + d, self.t1))
                       for _, ts, d in self.device_ops])

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def top_device_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, _, d in self.device_ops:
            tot[name[:160]] = tot.get(name[:160], 0.0) + d * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches of the window with no device
        operation, each named by the innermost span the host was in at
        the gap's middle ("outside spans" where it was in none)."""
        edges = [self.t0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            holding = [(d, n) for n, ts, d in self._spans
                       if ts <= mid < ts + d]
            label = min(holding)[1] if holding else "outside spans"
            out.append([label, (e - s) * 1e-6])
        return out
