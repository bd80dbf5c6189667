"""Host milliseconds an iteration spends in models/hpyp._hyper (the slice
moves of b1, a1, b0 and a0, every hyper_cycle iterations), from the
traced window's ``hpyp_hyper`` spans, over every iteration."""


def read(view):
    spans = view.span_durations_s("hpyp_hyper")
    if view.n_steps == 0 or not spans:
        return None
    return sum(spans) / view.n_steps * 1e3
