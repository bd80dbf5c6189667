"""Device operations (kernels, copies, sets) an HPYP iteration launches:
those in the traced window over the iterations it holds."""


def read(view):
    if view.n_steps == 0 or not view.device_ops:
        return None
    return len(view.device_ops) / view.n_steps
