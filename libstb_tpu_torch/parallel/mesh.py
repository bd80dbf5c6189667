"""Chain-parallel scale-out over ``torch.distributed``, and the convergence
diagnostics over a chain ensemble.

Port of libstb_tpu/parallel/mesh.py (see its docstring for the design:
many-chain data parallelism, tables replicated as read-only caches, the
only collectives cross-chain reductions).  One process runs per device,
so a mesh is a grid of ranks:

* ``chain_mesh`` places this rank on a ``("chains",)`` or ``("chains",
  "data")`` grid (rank = chain coordinate x data size + data coordinate,
  JAX's row-major device order) and holds one process group per axis of
  size > 1.  A world of one process needs no process group;
* ``shard_chain_tree`` (every rank passes the global tree) and
  ``shard_chain_tree_global`` (every rank passes its own slice) put this
  rank's part of the chain axis on its device and every other leaf there
  whole.  ``chain_slice`` says which part; it plays the role of JAX's
  ``chain_sharding``, and a whole tensor on ``mesh.device`` that of
  ``replicated``;
* ``gather_chains`` is the all-gather along the chain axis that a JAX
  global array makes implicitly, and ``sum_over`` / ``max_over`` the
  reductions over one axis (the psum XLA inserts), summed in rank order
  so that every rank of the group gets the same bits;
* ``cross_chain_moments``, ``rhat`` and ``ess`` reduce over all chains
  when given a mesh whose chain axis is sharded.

A torch tensor has no global form, so each collective is a call here.
On the gloo backend the collectives stage through host memory (gloo's
support for CUDA tensors differs between torch versions); the same code
runs on the CPU, where the staging copies nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

__all__ = ["ChainMesh", "chain_mesh", "chain_slice", "shard_chain_tree",
           "shard_chain_tree_global", "gather_chains", "sum_over",
           "max_over", "rhat", "ess", "cross_chain_moments"]

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """This rank's place on a grid of ranks: the axis names, their sizes,
    this rank's coordinate on each, one process group per axis (None for
    an axis of size 1), the group of all ranks (None in a world of one)
    and the rank's device."""
    axis_names: tuple
    sizes: tuple
    coords: tuple
    groups: tuple
    world_group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def group(self, axis: str):
        return dict(zip(self.axis_names, self.groups)).get(axis)


def chain_mesh(n_devices: Optional[int] = None, shape=None,
               device=None) -> ChainMesh:
    """The mesh over all processes: ``shape`` (P,) names the axis
    "chains", (Pc, Pd) the axes ("chains", "data"); the default is (P,)
    for the world's P processes.  ``n_devices``, if given, must be P (one
    process a device).  ``device``: this rank's device (default
    ``distributed.local_device()``, the card).  Every rank must call this
    at the same point: it creates the axis groups collectively."""
    world = distributed.world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"chain_mesh: {n_devices} devices, but {world} "
                         "processes (one process a device)")
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) not in (1, 2) or math.prod(shape) != world:
        raise ValueError(f"chain_mesh: shape {shape} does not cover "
                         f"{world} processes")
    names = (CHAIN_AXIS,) if len(shape) == 1 else (CHAIN_AXIS, DATA_AXIS)
    nd = shape[1] if len(shape) == 2 else 1
    r = distributed.rank()
    coords = (r // nd, r % nd)[:len(shape)]
    world_group = dist.group.WORLD if world > 1 else None
    groups = []
    for ax, size in enumerate(shape):
        if size == 1:
            groups.append(None)
        elif size == world:
            groups.append(world_group)
        else:
            # every rank creates every group of the axis, in one order
            mine = None
            others = shape[1 - ax]
            for o in range(others):
                ranks = ([o * nd + d for d in range(size)] if ax == 1
                         else [c * nd + o for c in range(size)])
                g = dist.new_group(ranks)
                if r in ranks:
                    mine = g
            groups.append(mine)
    return ChainMesh(axis_names=names, sizes=shape, coords=coords,
                     groups=tuple(groups), world_group=world_group,
                     device=distributed.local_device(device))


def chain_slice(mesh: ChainMesh, chains: int) -> slice:
    """This rank's part of a global chain axis of ``chains``."""
    cs = mesh.size(CHAIN_AXIS)
    if chains % cs:
        raise ValueError(f"{chains} chains not divisible by the chain "
                         f"axis {cs} (pad chains up at the call site)")
    local = chains // cs
    lo = mesh.coord(CHAIN_AXIS) * local
    return slice(lo, lo + local)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    return tree


def shard_chain_tree(tree: Any, mesh: ChainMesh, chains: int) -> Any:
    """Every rank passes the same global tree (nested dicts, lists and
    tuples of tensors or arrays): a leaf whose leading dim is ``chains``
    comes back as this rank's slice of the chain axis, every other leaf
    whole, each a new tensor on ``mesh.device``.  ``chains`` must divide
    by the chain axis."""
    sl = chain_slice(mesh, chains)

    def place(x):
        if x.ndim >= 1 and x.shape[0] == chains:
            x = x[sl]
        return x.to(mesh.device, copy=True)

    return _tree_map(place, tree)


def shard_chain_tree_global(tree: Any, mesh: ChainMesh,
                            global_chains: int) -> Any:
    """Multi-process ``shard_chain_tree``: each rank passes its OWN slice
    of the ensemble (leading dim ``global_chains`` / the chain axis) and
    gets it back on its device, with every other leaf (identical on every
    rank) there whole.  In a world of one process it defers to
    ``shard_chain_tree``, so drivers need not know the process count."""
    if distributed.world_size() == 1:
        return shard_chain_tree(tree, mesh, global_chains)
    chain_slice(mesh, global_chains)             # raises if it does not divide
    return _tree_map(lambda x: x.to(mesh.device, copy=True), tree)


# ---------------------------------------------------------------------------
# Collectives over one axis of the mesh
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group``, in rank order, concatenated along
    ``dim`` (the same shape on every rank); staged through host memory on
    gloo."""
    if group is None:
        return x
    staged = dist.get_backend(group) == "gloo"
    src = (x.detach().cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def _parts(x: torch.Tensor, group):
    return _all_gather(x.unsqueeze(0), group, 0).unbind(0)


def sum_over(x: torch.Tensor, mesh: ChainMesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, added in rank order (every
    rank of the group gets the same bits)."""
    group = mesh.group(axis)
    if group is None:
        return x
    parts = _parts(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def max_over(x: torch.Tensor, mesh: ChainMesh, axis: str) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``axis``."""
    group = mesh.group(axis)
    if group is None:
        return x
    return torch.amax(torch.stack(_parts(x, group)), dim=0)


def gather_chains(x: torch.Tensor, mesh: ChainMesh, dim: int = 0):
    """All-gather along the chain axis: every rank's (..., C_local, ...)
    slice -> the global (..., C, ...) tensor, chains in global order."""
    return _all_gather(x, mesh.group(CHAIN_AXIS), dim)


# ---------------------------------------------------------------------------
# Convergence diagnostics: the cross-chain collectives of the design
# ---------------------------------------------------------------------------

def _sharded(mesh: Optional[ChainMesh]) -> bool:
    return mesh is not None and mesh.size(CHAIN_AXIS) > 1


def cross_chain_moments(x, dim: int = 0, mesh: Optional[ChainMesh] = None):
    """(mean, var) over the chain axis -- the adaptation statistic
    (population variance, as jnp.var).  With a ``mesh`` whose chain axis
    is sharded, over all chains: the sums are reduced over the chain
    axis (two passes, so the variance keeps the one-process accuracy)."""
    if not _sharded(mesh):
        return (torch.mean(x, dim=dim),
                torch.var(x, dim=dim, correction=0))
    n = x.shape[dim] * mesh.size(CHAIN_AXIS)
    mean = sum_over(torch.sum(x, dim=dim), mesh, CHAIN_AXIS) / n
    dev = x - mean.unsqueeze(dim)
    var = sum_over(torch.sum(dev * dev, dim=dim), mesh, CHAIN_AXIS) / n
    return mean, var


def rhat(draws, mesh: Optional[ChainMesh] = None):
    """Split-R-hat (Gelman et al. 2013) over draws of shape (T, C).

    T = kept iterations, C = chains; each chain is split in half, so the
    effective chain count is 2C.  Returns a 0-d tensor; values near 1
    indicate convergence.  With a ``mesh`` whose chain axis is sharded,
    each rank passes its (T, C_local) draws and gets the value over all
    chains."""
    if _sharded(mesh):
        draws = gather_chains(draws, mesh, dim=1)
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


def ess(draws, mesh: Optional[ChainMesh] = None):
    """Bulk effective sample size via Geyer initial-monotone pairs, the
    autocovariance taken per chain by FFT and averaged over chains
    (draws: (T, C); with a sharded ``mesh``, this rank's (T, C_local));
    returns a 0-d tensor."""
    if _sharded(mesh):
        draws = gather_chains(draws, mesh, dim=1)
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
