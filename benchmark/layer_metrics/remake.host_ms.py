"""Host milliseconds from a remake's call to its return, before the
caller's synchronize (core/stirling.make's route, S1 anchors, allocation
and launches): the median over the traced window's ``remake`` spans."""
import statistics


def read(view):
    spans = view.span_durations_s("remake")
    if not spans:
        return None
    return statistics.median(spans) * 1e3
