"""The readings of the port's own spans (benchmark/program_spans.py) on a
synthetic Chrome trace, each where it finds nothing, and on the card one
span around a K3 launch that holds the launch on the device's clock."""
import json
import types

import pytest

from benchmark import program_spans as ps
from benchmark.tracing import TraceView


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _s(name, ts, dur):
    return _x("stb/" + name, "user_annotation", ts, dur)


def _view(ev):
    v = TraceView(ev)
    v.events = ps.window_events(ev, v.t0, v.t1)
    return v


def _trace():
    """Two steps (window 1000-1200 us): a Gibbs-like iteration and a
    remake-like tail in each; each step, and one span, also on the
    device's timeline.  Busy 72 us: 1003-1008, 1015-1025,
    1035-1045, 1062-1064, 1120-1155, 1170-1180; idle 128 us."""
    ev = [_x("ProfilerStep#1", "user_annotation", 1000, 100),
          _x("ProfilerStep#2", "user_annotation", 1100, 100),
          # Kineto's copies on the device's timeline, which TraceView
          # counts as steps too
          _x("ProfilerStep#1", "gpu_user_annotation", 1003, 60),
          _x("ProfilerStep#2", "gpu_user_annotation", 1120, 60),
          _x("stb/ti.step", "gpu_user_annotation", 1015, 30),
          _s("driver.iter", 990, 105),       # starts before the window
          _s("driver.iter", 1095, 100),
          _s("ti.sweep", 1000, 50), _s("ti.sweep", 1100, 60),
          _s("ti.prepare", 1000, 10), _s("ti.prepare", 1100, 5),
          _s("ti.step", 1010, 20), _s("ti.step", 1030, 20),
          _s("ti.step", 1105, 55),
          _s("hyper.sample_b", 1050, 30), _s("slice.move", 1052, 26),
          _s("slice.read", 1055, 1), _s("slice.read", 1060, 1),
          _s("slice.read", 1070, 1),
          _s("hyper.sample_a", 1160, 30), _s("hyper.curve", 1160, 5),
          _s("slice.move", 1166, 23), _s("slice.read", 1170, 1),
          _s("make", 1080, 15), _s("make.launch", 1080, 3),
          _s("make.s1", 1083, 11), _s("make.s1_upload", 1084, 9),
          _s("make", 1190, 9), _s("make.launch", 1190, 2),
          _s("make.s1", 1192, 6), _s("make.s1_upload", 1193, 4),
          # launches (host) and what they launched (device), paired by id
          _x("cudaMemcpyAsync", "cuda_runtime", 1002, 1, corr=3),
          _x("Memcpy HtoD", "gpu_memcpy", 1003, 5, corr=3),
          _x("cudaLaunchKernel", "cuda_runtime", 1012, 1, corr=1),
          _x("k1", "kernel", 1015, 10, corr=1),
          _x("cuLaunchKernel", "cuda_driver", 1031, 1, corr=2),
          _x("k2", "kernel", 1035, 10, corr=2),
          _x("cudaLaunchKernel", "cuda_runtime", 1061.5, 0.2, corr=5),
          _x("k5", "kernel", 1062, 2, corr=5),
          _x("cudaLaunchKernel", "cuda_runtime", 1110, 1, corr=4),
          _x("k4", "kernel", 1120, 30, corr=4),
          _x("cudaLaunchKernel", "cuda_runtime", 1111, 1, corr=6),
          _x("k6", "kernel", 1205, 5, corr=6),     # runs after the window
          _x("cudaLaunchKernel", "cuda_runtime", 1140, 1, corr=8),
          _x("k8", "kernel", 1150, 5, corr=8),
          _x("k7", "kernel", 1170, 10, corr=7)]    # no launch recorded
    return _view(ev)


def test_window_events_overlap_the_window():
    v = _trace()
    assert (v.t0, v.t1) == (1000, 1200)
    assert ps.n_steps(v) == 2 and v.n_steps == 4
    assert ps.spans(v.events, "driver.iter") == [(990, 1095), (1095, 1195)]
    assert ps.count(v, "driver.iter") == 1       # the one started inside
    assert ps.count(v, "ti.step") == 3
    assert all(e["name"] != "k6" for e in v.events)


def test_launches_matched_by_correlation():
    v = _trace()
    # k1, k2 (a driver-API launch), k4, k8; not the copy launched in
    # ti.prepare, k5 in the slice move, k6 after the window, k7 unlaunched
    assert ps.launches_in(v, "ti.step") == 4
    assert ps.launches_in(v, "ti.prepare") == 1
    assert ps.launches_in(v, "slice.move") == 1
    assert ps.READINGS["gibbs.ti_launches_per_step"](v) == pytest.approx(
        4 / 3)


def test_idle_overlap_arithmetic():
    v = _trace()
    assert ps.idle_intervals(v) == [(1000, 1003), (1008, 1015),
                                    (1025, 1035), (1045, 1062),
                                    (1064, 1120), (1155, 1170),
                                    (1180, 1200)]
    assert ps.idle_s(v) == pytest.approx(128e-6)
    # sweep: 3 + 7 + 10 + 5 in the first, 20 + 5 in the second
    assert ps.idle_in(v, ["ti.sweep"]) == pytest.approx(50e-6)
    assert ps.idle_in(v, ["ti.prepare", "ti.step"]) == pytest.approx(50e-6)
    assert ps.READINGS["gibbs.ti_idle_ms_per_iter"](v) == pytest.approx(
        0.025)
    # b: 12 + 16; a: 10 + 10
    assert ps.READINGS["gibbs.hyper_idle_ms_per_iter"](v) == pytest.approx(
        0.024)
    # the union is counted once, and clipped to the window: the first
    # driver.iter from 1000 on
    assert ps.idle_in(v, ["driver.iter", "ti.sweep"]) == pytest.approx(
        123e-6)
    assert ps.READINGS["remake.idle_in_make_us"](v) == pytest.approx(12.0)


def test_counters_and_durations():
    v = _trace()
    assert ps.READINGS["gibbs.slice_tries_per_move"](v) == 2.0
    assert ps.READINGS["remake.launch_us"](v) == pytest.approx(2.5)
    assert ps.READINGS["remake.s1_wait_ms"](v) == pytest.approx(0.0065)


def test_breakdown():
    b = ps.breakdown(_trace())
    assert b["steps"] == 2 and b["step_ms"] == pytest.approx(0.1)
    assert b["idle_ms_per_step"] == pytest.approx(0.064)
    assert b["idle_share_in_spans"] == pytest.approx(127 / 128)
    assert b["counts"]["ti.step"] == 3 and b["counts"]["slice.read"] == 4
    assert b["median_ms"]["make.s1_upload"] == pytest.approx(0.0065)
    assert b["idle_ms_per_step_in"]["make"] == pytest.approx(0.012)
    assert b["launches_per_step_in"]["ti.step"] == 2.0


@pytest.mark.parametrize("name", sorted(ps.READINGS))
def test_reading_with_nothing_to_read(name):
    assert ps.READINGS[name](_view([])) is None
    # the parent's trace: bench/ spans, device operations, no stb/ spans
    ev = [_x("ProfilerStep#1", "user_annotation", 0, 10),
          _x("bench/remake", "user_annotation", 0, 8),
          _x("k", "kernel", 2, 3, corr=1),
          _x("cudaLaunchKernel", "cuda_runtime", 1, 1, corr=1)]
    assert ps.READINGS[name](_view(ev)) is None
    # spans but no device operation: a trace of the CPU
    ev = [e for e in _trace().events if e["cat"] == "user_annotation"]
    if name not in ("gibbs.slice_tries_per_move", "remake.launch_us",
                    "remake.s1_wait_ms"):
        assert ps.READINGS[name](_view(ev)) is None


@pytest.mark.cuda
def test_span_holds_its_launch_on_the_device_clock(cuda_device, tmp_path):
    """A span around one K3 launch holds that launch's host call, which
    carries the kernel's correlation id; the kernel starts no earlier
    than the span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libstb_tpu_torch.ops import stirling_cuda as sc
    from libstb_tpu_torch.utils import metrics

    a = torch.tensor(0.5, dtype=torch.float32, device=cuda_device)
    sc.fill_table_cols(a, 1 << 16, 256)          # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with metrics.span("make.launch"):
            sc.fill_table_cols(a, 1 << 16, 256)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and "dur" in e]
    (span,) = ps.spans(ev, "make.launch")
    kern = [e for e in ev if e.get("cat") == "kernel"
            and "cols_kernel" in e["name"]]
    assert len(kern) == 1, [e["name"] for e in ev if e.get("cat")
                            == "kernel"]
    corr = kern[0]["args"]["correlation"]
    (launch,) = [e for e in ev if e.get("cat") in ps.LAUNCH_CATS
                 and e.get("args", {}).get("correlation") == corr]
    t0, t1 = span
    assert t0 <= float(launch["ts"]) <= t1
    assert float(kern[0]["ts"]) >= max(t0, float(launch["ts"]))
    view = types.SimpleNamespace(t0=t0, t1=max(float(e["ts"]) + e["dur"]
                                                for e in ev) + 1, events=ev)
    assert ps.launches_in(view, "make.launch") >= 1
