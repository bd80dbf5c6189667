"""Convergence diagnostics over a chain ensemble, in PyTorch.

Port of the diagnostics of libstb_tpu/parallel/mesh.py: the cross-chain
moments, split-R-hat and the bulk effective sample size.  Each takes the
draws on whatever device they live on and reduces over the chain axis
there.  Chain sharding over several devices is not ported yet (ROADMAP
Queue 1, item 11).
"""
from __future__ import annotations

import math

import torch

__all__ = ["rhat", "ess", "cross_chain_moments"]


def cross_chain_moments(x, dim: int = 0):
    """(mean, var) over the chain axis -- the adaptation statistic
    (population variance, as jnp.var)."""
    return (torch.mean(x, dim=dim),
            torch.var(x, dim=dim, correction=0))


def rhat(draws):
    """Split-R-hat (Gelman et al. 2013) over draws of shape (T, C).

    T = kept iterations, C = chains; each chain is split in half, so the
    effective chain count is 2C.  Returns a 0-d tensor; values near 1
    indicate convergence."""
    T, C = draws.shape
    half = T // 2
    x = torch.cat([draws[:half], draws[half:2 * half]], dim=1)   # (half, 2C)
    n = half
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    B = n * torch.var(chain_mean, correction=1)
    W = torch.mean(chain_var)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / W)


def ess(draws):
    """Bulk effective sample size via Geyer initial-monotone pairs, the
    autocovariance taken per chain by FFT and averaged over chains
    (draws: (T, C)); returns a 0-d tensor."""
    T, C = draws.shape
    x = draws - torch.mean(draws, dim=0, keepdim=True)
    nfft = int(2 ** math.ceil(math.log2(2 * T)))
    f = torch.fft.rfft(x, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:T] / T
    rho = torch.mean(acov, dim=1) / torch.mean(acov[0])
    # Geyer: sum consecutive pairs while positive
    npair = (T - 1) // 2
    pair = rho[1:1 + 2 * npair:2] + rho[2:2 + 2 * npair:2]
    pos = torch.cumprod((pair > 0).to(pair.dtype), dim=0)
    tau = 1.0 + 2.0 * (rho[0] - 1.0) + 2.0 * torch.sum(pair * pos)
    return T * C / torch.clamp(tau, min=1.0 / (T * C))
