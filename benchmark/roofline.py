"""The yardstick of the fills: the least time a Stirling fill can take on
one NVIDIA H100, counted from its shape alone.

A frozen copy of ``chip_smoke.bound``: a fill of n x m cells writes V and
Srel once, 2 x itemsize bytes a cell, and does FILL_FLOPS f64 operations
a cell (the V step's 12, and 20 each for the divide, the reciprocal and
the log of the Srel sum, at three operations apiece).  The count does not
depend on which kernel does the work.

Peaks: NVIDIA's H100 SXM data sheet, at its 700 W power limit: 3.35 TB/s
of HBM3 and 34 TFLOP/s of f64 outside the tensor cores.  A card set
below 700 W runs slower under load, so every share is printed with the
card's power limit (``power_limit_w``).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional

__all__ = ["HBM_BPS", "F64_FLOPS", "FILL_FLOPS", "fill_bound_s",
           "power_limit_w"]

HBM_BPS = 3.35e12
F64_FLOPS = 34e12
FILL_FLOPS = 12 + 3 * 20


def fill_bound_s(n: int, m: int, itemsize: int = 4) -> float:
    """Seconds: the larger of the bytes bound and the f64 operations
    bound of one fill of an (n, m) table of V and Srel."""
    cells = n * m
    return max(2 * itemsize * cells / HBM_BPS, FILL_FLOPS * cells / F64_FLOPS)


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, read from nvidia-smi; None
    where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
