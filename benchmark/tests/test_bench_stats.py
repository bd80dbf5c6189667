"""The window's arithmetic on synthetic timings, and the fill bound."""
import pytest

from benchmark import roofline, stats


def _window(latencies):
    """A closed loop of remakes back to back: (cells/s, p95 ms)."""
    n, m = 1 << 20, 1024
    return (stats.rate(n * m * len(latencies), sum(latencies)),
            stats.percentile(latencies, 95) * 1e3)


def test_rate_and_p95():
    lat = [0.010] * 100
    r, p95 = _window(lat)
    assert r == pytest.approx((1 << 30) / 0.010)
    assert p95 == pytest.approx(10.0)


@pytest.mark.parametrize("stalls", [5, 6, 10])
def test_a_stall_moves_both(stalls):
    """Remakes that stall inside the window lower the rate and, once
    they are more than 5% of the remakes, raise the p95."""
    base_r, base_p = _window([0.010] * 100)
    r, p = _window([0.010] * (100 - stalls) + [0.050] * stalls)
    assert r < base_r
    assert (p > base_p) == (stalls > 5)


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_fill_bound_at_the_headline_shape():
    """V and Srel in f32 at (2^20, 1024): 8 GiB at 3.35 TB/s."""
    assert roofline.fill_bound_s(1 << 20, 1024) * 1e3 == pytest.approx(
        2.564, abs=5e-4)
    # the f64 operations bound (72 a cell at 34 TFLOP/s) is below it
    assert roofline.FILL_FLOPS * (1 << 30) / roofline.F64_FLOPS < \
        roofline.fill_bound_s(1 << 20, 1024)
