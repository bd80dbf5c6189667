"""Tanh-sinh (double-exponential) quadrature, in PyTorch.

Port of libstb_tpu/core/quadrature.py: the independent-oracle capability
of test/DEIntegrator.h (used by test/ngg_integral.cpp:105-121 to validate
the NGG saddle-point approximations), built from the published
Takahasi-Mori construction -- x = tanh((pi/2) sinh t) on a fixed level-L
trapezoid grid.  The nodes are made on the host in f64 (``_nodes``, a copy
of the JAX package's, held equal by tests/test_torch_package.py); every
abscissa of every batched interval evaluates in one call of the integrand,
on the device of the interval bounds.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["tanh_sinh", "tanh_sinh_log"]


def _nodes(levels: int, dtype=np.float64):
    """Abscissae x in (-1, 1) and weights w for the tanh-sinh rule."""
    h = 1.0 / (1 << (levels - 1))
    # |t| beyond ~6.1 underflows the double-exponential weight in f64
    tmax = 6.1
    t = np.arange(-tmax, tmax + h / 2, h, dtype=np.float64)
    st = 0.5 * np.pi * np.sinh(t)
    x = np.tanh(st)
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(st) ** 2
    keep = (np.abs(x) < 1.0) & (w > 0)
    return x[keep].astype(dtype), w[keep].astype(dtype)


def _interval(a, b, levels: int):
    """(abscissae (..., P), weights (P,), half-widths (...,)) of the rule
    on [a, b]; f64 unless ``a`` is a floating tensor, on a's device."""
    if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
        a = torch.as_tensor(a, dtype=torch.float64,
                            device=getattr(a, "device", None))
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    x, w = (torch.as_tensor(v, dtype=a.dtype, device=a.device)
            for v in _nodes(levels))
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    return mid[..., None] + half[..., None] * x, w, half


def tanh_sinh(f: Callable, a, b, levels: int = 10):
    """integral_a^b f(x) dx; ``f`` must accept a tensor of abscissae.

    ``a``/``b`` may be tensors (batched intervals); then f receives
    (..., P) and the result is (...,)."""
    xs, w, half = _interval(a, b, levels)
    return half * torch.sum(f(xs) * w, dim=-1)


def tanh_sinh_log(logf: Callable, a, b, levels: int = 10):
    """log integral_a^b exp(logf(x)) dx, stable for peaked integrands."""
    xs, w, half = _interval(a, b, levels)
    ly = logf(xs) + torch.log(w)
    m = torch.amax(ly, dim=-1, keepdim=True)
    s = torch.sum(torch.exp(ly - m), dim=-1)
    return torch.log(half) + m[..., 0] + torch.log(s)
