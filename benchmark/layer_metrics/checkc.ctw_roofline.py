"""A CTW sweep's share, in %, of its bound (benchmark/ctw_roofline.py: the
state read and written once at the data sheet's HBM rate, or the f32
operations of every candidate of every occupied count at its f32 rate,
the larger): the bound over the median device time of the traced
window's sweeps, each the summed durations of the device operations its
``ctw_sweep`` span launched."""
import statistics

from benchmark import ctw_roofline


def read(view):
    shape = getattr(view, "ctw_shape", None)
    per = ctw_roofline.sweep_device_s(view, "ctw_sweep")
    if not shape or not per:
        return None
    return 100.0 * ctw_roofline.sweep_bound_s(**shape) / statistics.median(
        per)
