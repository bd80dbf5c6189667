"""Host milliseconds an iteration spends in models/hpyp._level1 (n0, the
level-0 predictive and the level-1 CT sweep), from the traced window's
``hpyp_level1`` spans."""


def read(view):
    spans = view.span_durations_s("hpyp_level1")
    if view.n_steps == 0 or not spans:
        return None
    return sum(spans) / view.n_steps * 1e3
