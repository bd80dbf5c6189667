"""The window's arithmetic: a rate over the whole window and a tail over
every request in it."""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["rate", "percentile"]


def rate(units: float, seconds: float) -> float:
    """Units completed per second of the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values``, nearest rank: the
    smallest value with at least q% of all values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]
