"""Host milliseconds an iteration spends in models/pyp.ti_sweep_blocked
(the TI sweep), from the traced window's ``ti_sweep`` spans."""


def read(view):
    spans = view.span_durations_s("ti_sweep")
    if view.n_steps == 0 or not spans:
        return None
    return sum(spans) / view.n_steps * 1e3
