"""Device milliseconds of one CTW sweep (models/pyp.ctw_sweep_rel, one an
iteration): the median, over the traced window's ``ctw_sweep`` spans, of
the summed durations of the device operations each launched
(benchmark/ctw_roofline.py).  The median, as a sweep's last operations
may run past the profiler's stop."""
import statistics

from benchmark import ctw_roofline


def read(view):
    per = ctw_roofline.sweep_device_s(view, "ctw_sweep")
    if not per:
        return None
    return statistics.median(per) * 1e3
