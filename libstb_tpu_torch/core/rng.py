"""Random draws for the samplers: a facade over ``torch.Generator``.

Port of libstb_tpu/core/rng.py.  Where the JAX package threads a key, the
port threads a ``torch.Generator`` (``gen``) living on the device the
draws are made on.  The two streams differ, so parity tests feed both
packages the same numbers: a ``Replay`` stands in for the generator and
hands out recorded draws in the order the sampler asks for them.
"""
from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

__all__ = ["generator", "uniform", "uniform_open", "uniform_min", "gumbel",
           "gamma", "loggamma", "Replay"]


class Replay:
    """Recorded draws in the order a sampler consumes them (a test double
    for a torch.Generator; each draw must have the requested shape)."""

    def __init__(self, draws: Iterable):
        self._it = iter(draws)

    def next(self, shape, dtype, device) -> torch.Tensor:
        x = torch.as_tensor(np.array(next(self._it)), dtype=dtype,
                            device=device)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"replayed draw has shape {tuple(x.shape)}, "
                             f"the sampler asked for {tuple(shape)}")
        return x


Gen = Union[torch.Generator, Replay]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform(gen: Gen, shape, dtype, device) -> torch.Tensor:
    """Uniform[0, 1) like rng_unit (srng.h:30)."""
    if isinstance(gen, Replay):
        return gen.next(shape, dtype, device)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def uniform_open(gen: Gen, shape, dtype, device) -> torch.Tensor:
    """Uniform[1e-12, 1): a uniform whose log is finite (the draws of the
    ARS inverse-CDF and accept tests)."""
    if isinstance(gen, Replay):
        return gen.next(shape, dtype, device)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return torch.clamp(1e-12 + (1.0 - 1e-12) * u, min=1e-12)


def uniform_min(gen: Gen, lo: float, shape, dtype, device) -> torch.Tensor:
    """Uniform[lo, 1) as lo + (1 - lo) U (jax.random.uniform's ``minval``;
    the inverse-CDF draws of the pair-major HSA sweep)."""
    if isinstance(gen, Replay):
        return gen.next(shape, dtype, device)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return lo + (1.0 - lo) * u


def gumbel(gen: Gen, shape, dtype, device) -> torch.Tensor:
    """Standard Gumbel, -log(-log U) with U kept off 0 (the Gumbel-max
    categorical draws)."""
    if isinstance(gen, Replay):
        return gen.next(shape, dtype, device)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(dtype).tiny)))


def gamma(gen: Gen, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1), one draw per element of ``alpha``."""
    if isinstance(gen, Replay):
        return gen.next(alpha.shape, alpha.dtype, alpha.device)
    return torch._standard_gamma(alpha.contiguous(), generator=gen)


def loggamma(gen: Gen, alpha: torch.Tensor) -> torch.Tensor:
    """log of a Gamma(alpha, 1) draw without underflow for small alpha:
    log G(alpha) = log G(alpha + 1) + log(U) / alpha, U ~ Uniform(0, 1]."""
    if isinstance(gen, Replay):
        return gen.next(alpha.shape, alpha.dtype, alpha.device)
    alpha = alpha.contiguous()
    g1 = torch._standard_gamma(alpha + 1.0, generator=gen)
    u = 1.0 - torch.rand(alpha.shape, generator=gen, dtype=alpha.dtype,
                         device=alpha.device)
    return torch.log(g1) + torch.log(u) / alpha
