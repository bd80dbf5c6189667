"""Share of the traced window, in %, in which no device operation ran."""


def read(view):
    if view.window_s <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
