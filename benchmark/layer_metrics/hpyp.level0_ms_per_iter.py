"""Host milliseconds an iteration spends in models/hpyp._level0 (the
level-0 CT sweep on the fresh counts), from the traced window's
``hpyp_level0`` spans."""


def read(view):
    spans = view.span_durations_s("hpyp_level0")
    if view.n_steps == 0 or not spans:
        return None
    return sum(spans) / view.n_steps * 1e3
