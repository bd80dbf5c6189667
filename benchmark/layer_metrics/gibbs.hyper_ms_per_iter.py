"""Host milliseconds an iteration spends in samplers/hyper's sample_a and
sample_b (the slice moves of a and b), from the traced window's spans."""


def read(view):
    spans = view.span_durations_s("sample_a") + view.span_durations_s(
        "sample_b")
    if view.n_steps == 0 or not spans:
        return None
    return sum(spans) / view.n_steps * 1e3
