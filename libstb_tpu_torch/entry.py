"""Driver entry points of the port: one composite Gibbs step, and the
multi-process dry run of that step.

The analogs of ``__graft_entry__.entry()`` and ``dryrun_multichip()`` in
the repository root:

* ``entry()`` returns one full Gibbs step on the flagship PYP workload (a
  table-indicator sweep over the data plus concentration (sample_b) and
  discount (sample_a) posterior updates, batched over chains) with
  example arguments, on a given device;
* ``dryrun_multichip()`` runs the same step over all processes of a
  ``torch.distributed`` world with the framework's real layout: chains
  split over the mesh axis "chains", the flattened pair axis of
  sample_a's inputs over "data" (partial curves summed over the data
  group), the grid filled by the sharded K1 fill and replicated.

Random draws.  A step takes three generators, one for the sweep, one for
sample_b and one for sample_a (JAX's step splits its key in three).  In
the dry run each rank seeds them from (seed, its chain-shard coordinate,
the call): the peers of a data group draw the same numbers and distinct
chain shards draw different ones.  JAX's draws are global -- one key for
the whole chain axis -- so the sharded stream is not the one-process
stream, and a sharded run is compared with one-process steps on the same
chains under the same generators (or replayed draws), not with a
one-process run of the whole ensemble.

    python -m libstb_tpu_torch.entry                     # one step, card
    torchrun --nproc_per_node P -m libstb_tpu_torch.entry --dryrun
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import agrid, rng
from .models import pyp
from .parallel import distributed
from .parallel import mesh as pmesh
from .samplers import hyper

__all__ = ["entry", "dryrun_multichip", "step_generators"]


def step_generators(seed: int, device, shard: int = 0):
    """The three generators of a step (sweep, sample_b, sample_a) for
    chain shard ``shard``, each seeded from (seed, shard, call)."""
    states = np.random.SeedSequence((seed, shard)).generate_state(
        3, dtype=np.uint64)
    return tuple(rng.generator(int(s), device) for s in states)


def _build(chains: int, device, n_max: int = 48, m_max: int = 24,
           g: int = 12, dtype=torch.float32, dim: int = 8,
           n_per_group: int = 24, grid=None, mesh=None):
    """One composite Gibbs step closure + example args (gens, t, T, a, b,
    ns_flat) for ``chains`` chains on ``device``.

    ``grid``: the discount grid (default: make_grid here).  ``mesh``: a
    ChainMesh with a "data" axis: the flattened (group, category) pair
    axis is zero-padded to divide by it (n == 0 pairs are masked out of
    the posterior), ``ns_flat`` holds this rank's share of the pairs, and
    sample_a sums the curve over the data group."""
    data = pyp.crp_generate(seed=0, n_groups=2, dim=dim,
                            n_per_group=n_per_group, a=0.5, b=2.0)
    if grid is None:
        grid = agrid.make_grid(n_max, m_max, g=g, dtype=dtype, device=device)
    t0, T0 = pyp.init_state(data, chains, device)
    a0 = torch.full((chains,), 0.5, dtype=dtype, device=device)
    b0 = torch.full((chains,), 2.0, dtype=dtype, device=device)
    nd = 1 if mesh is None else mesh.size(pmesh.DATA_AXIS)
    pad = (-data.n.size) % nd
    per = (data.n.size + pad) // nd
    lo = 0 if mesh is None else mesh.coord(pmesh.DATA_AXIS) * per
    pairs = slice(lo, lo + per)
    ns = np.pad(data.n.reshape(-1), (0, pad))[pairs]
    ns_flat = torch.as_tensor(np.broadcast_to(ns, (chains, per)).copy(),
                              device=device)
    N_b = torch.as_tensor(data.N, dtype=dtype, device=device)
    # exact group-major TI reordering: one item of every group per step
    plan = pyp.ti_plan(data, pyp.ti_schedule(data, "group"), device)

    def step(gens, t, T, a, b, ns_flat):
        gs, gb, ga = gens
        t, T = pyp.ti_sweep_blocked(gs, t, T, a, b, grid, data, sched=plan)
        b, _ = hyper.sample_b(gb, b, N_b, T.to(dtype), a,
                              shape=1.1, scale=float(data.n.shape[1]))
        t_flat = torch.nn.functional.pad(t.reshape(t.shape[0], -1),
                                         (0, pad))[:, pairs]
        a, _ = hyper.sample_a(ga, a, grid, ns_flat, t_flat, T.to(dtype),
                              b[:, None].expand(T.shape), mesh=mesh)
        return t, T, a, b

    args = (step_generators(0, device), t0, T0, a0, b0, ns_flat)
    return step, args


def entry(device="cuda"):
    """(fn, example_args): one Gibbs step on ``device``, 16 chains."""
    return _build(chains=16, device=device)


def dryrun_multichip(n_devices=None, *, chains: int = 1024,
                     n_max: int = 512, m_max: int = 128, g: int = 32,
                     dim: int = 16, n_per_group: int = 200, seed: int = 0,
                     device=None, gens=None) -> dict:
    """Run the full Gibbs step once over every process of the world.

    Joins the process group from torchrun's environment if no group is
    up (``distributed.init``); ``n_devices``, if given, must be the
    world size.  The mesh is (P/2, 2) as ("chains", "data") when P >= 4
    is even, else (P,) as ("chains",).  The shapes are the JAX package's:
    at least ``chains`` chains (rounded up to a multiple of the chain
    axis), a ``n_max`` x ``m_max`` x ``g`` grid filled by
    ``make_grid(mesh=...)`` over all ranks, ``crp_generate(0, 2, dim,
    n_per_group, 0.5, 2.0)``.  The step
    runs on this rank's chains and pairs with ``gens`` (default:
    ``step_generators(seed, device, chain coordinate)``).  Rank 0 prints
    ``dryrun_multichip ok: ...`` with the means over all chains.

    Returns dict(mesh, chains, local, t, T, a, b, a_mean, b_mean, grid)
    with this rank's state."""
    distributed.init()
    world = distributed.world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"dryrun_multichip: {n_devices} devices, but "
                         f"{world} processes (one process a device)")
    shape = (world // 2, 2) if world >= 4 and world % 2 == 0 else (world,)
    cm = pmesh.chain_mesh(shape=shape, device=device)
    cs = cm.size(pmesh.CHAIN_AXIS)
    chains = -(-chains // cs) * cs
    grid = agrid.make_grid(n_max, m_max, g=g, mesh=cm)
    step, (_, t, T, a, b, ns_flat) = _build(
        chains, cm.device, n_max, m_max, g, dim=dim,
        n_per_group=n_per_group, grid=grid, mesh=cm)
    st = pmesh.shard_chain_tree(dict(t=t, T=T, a=a, b=b, ns=ns_flat), cm,
                                chains)
    if gens is None:
        gens = step_generators(seed, cm.device,
                               cm.coord(pmesh.CHAIN_AXIS))
    t, T, a, b = step(gens, st["t"], st["T"], st["a"], st["b"], st["ns"])
    if t.shape[0] != chains // cs:
        raise AssertionError("dryrun_multichip: lost the chain shard")
    a_mean = float(pmesh.cross_chain_moments(a.double(), mesh=cm)[0])
    b_mean = float(pmesh.cross_chain_moments(b.double(), mesh=cm)[0])
    if distributed.rank() == 0:
        print(f"dryrun_multichip ok: mesh={cm.shape}, chains={chains}, "
              f"a_mean={a_mean:.3f}, b_mean={b_mean:.3f}", flush=True)
    return dict(mesh=cm, chains=chains, local=chains // cs, t=t, T=T, a=a,
                b=b, a_mean=a_mean, b_mean=b_mean, grid=grid)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dryrun", action="store_true",
                   help="the multi-process dry run (under torchrun)")
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--device", default=None,
                   help="default: this rank's card; 'cpu' to ask for the "
                        "CPU")
    args = p.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(chains=args.chains, device=args.device)
        return
    dev = distributed.local_device(args.device)
    step, fargs = entry(dev)
    t, T, a, b = step(*fargs)
    print(f"entry ok: chains={t.shape[0]}, a_mean={float(a.mean()):.3f}, "
          f"b_mean={float(b.mean()):.3f}")


if __name__ == "__main__":
    main()
