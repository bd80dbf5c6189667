"""The traced window's reading on a synthetic Chrome trace, and each
reader's answer where it finds nothing."""
import pytest

from benchmark import harness
from benchmark.tracing import TraceView


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    ev = [_x("ProfilerStep#3", "user_annotation", 1000, 100),
          _x("ProfilerStep#4", "user_annotation", 1100, 100),
          _x("bench/ti_sweep", "user_annotation", 1000, 60),
          _x("bench/sample_b", "user_annotation", 1060, 20),
          _x("bench/ti_sweep", "user_annotation", 1100, 75),
          _x("bench/remake", "user_annotation", 1100, 8),
          _x("k1", "kernel", 1010, 20),
          _x("k2", "kernel", 1020, 20),          # overlaps k1
          _x("memset", "gpu_memset", 1150, 10),
          _x("k1", "kernel", 1180, 40),          # runs past the window
          _x("early", "kernel", 900, 50),        # before the window
          _x("cudaLaunchKernel", "cuda_runtime", 1010, 5)]
    return TraceView(ev, {"n": 1 << 16, "m": 1024, "dtype": "float32"})


def test_window_busy_and_gaps():
    v = _trace()
    assert v.n_steps == 2
    assert v.window_s == pytest.approx(200e-6)
    assert len(v.device_ops) == 4
    # busy: 1010-1040, 1150-1160, 1180-1200 (clipped)
    assert v.busy_s() == pytest.approx(60e-6)
    assert v.device_sum_s() == pytest.approx(90e-6)
    gaps = v.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx(
        [110e-6, 20e-6, 10e-6])
    # 1040-1150: its middle (1095) lies in no span but the steps
    assert gaps[0][0] == "outside spans"
    assert gaps[1][0] == "ti_sweep"      # 1160-1180, inside the sweep
    assert gaps[2][0] == "ti_sweep"      # 1000-1010
    assert v.top_device_ops()[0] == ["k1", pytest.approx(60e-6)]


def _reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


def test_readers():
    v = _trace()
    assert _reader("gibbs.launches_per_iter").read(v) == 2.0
    assert _reader("gibbs.ti_sweep_ms_per_iter").read(v) == pytest.approx(
        0.0675)
    assert _reader("gibbs.hyper_ms_per_iter").read(v) == pytest.approx(0.01)
    assert _reader("device_idle_pct.gibbs").read(v) == pytest.approx(70.0)
    assert _reader("remake.host_ms").read(v) == pytest.approx(0.008)
    bound = 2 * 4 * (1 << 16) * 1024 / 3.35e12
    assert _reader("remake.fill_roofline").read(v) == pytest.approx(
        100 * bound * 2 / 90e-6)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.load_manifest()["per_layer"]])
def test_reader_with_nothing_to_read(name):
    assert _reader(name).read(TraceView([], {"n": 1, "m": 1,
                                             "dtype": "float32"})) is None


def test_tracer_reads_the_trace_after_the_window():
    """The profiler records ``steps`` steps after ``skip``, and the
    recording is exported and read only when the window closes, not at
    its last step inside the window."""
    import torch

    from benchmark import stats
    from benchmark.tracing import Tracer

    tracer = Tracer({"step": ("benchmark.stats", "rate")}, "step", skip=1,
                    steps=2, cuda=False)
    real = stats.rate
    with tracer.active():
        for _ in range(6):
            assert stats.rate(2.0, 1.0) == 2.0
            torch.ones(8).add_(1)
        assert tracer.view is None
    assert stats.rate is real
    assert tracer.view is not None and tracer.view.n_steps == 2
    assert len(tracer.view.span_durations_s("step")) == 2
