"""A remake's share, in %, of the fill's bound (benchmark/roofline.py:
V and Srel written once in the table's dtype at the data sheet's HBM
rate, or its f64 operations at the data sheet's rate, the larger): the
bound of every remake in the traced window over the summed time of the
window's device operations, which are the remakes' kernels (K3, the S1
fill) and copies."""
from benchmark import roofline


def read(view):
    dev = view.device_sum_s()
    if view.n_steps == 0 or dev <= 0:
        return None
    itemsize = {"float32": 4, "float64": 8}[view.params["dtype"]]
    bound = roofline.fill_bound_s(view.params["n"], view.params["m"],
                                  itemsize)
    return 100.0 * bound * view.n_steps / dev
