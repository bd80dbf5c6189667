"""Multi-process initialisation over ``torch.distributed``.

Port of libstb_tpu/parallel/distributed.py.  One process runs per device
(``torchrun --nproc_per_node P``, or explicit arguments); one call per
process:

    from libstb_tpu_torch.parallel import distributed, mesh
    distributed.init()                 # torchrun's environment, or args
    cm = mesh.chain_mesh()             # this rank's place on the mesh

then shard chain state with ``mesh.shard_chain_tree`` (every rank passes
the global tree) or ``mesh.shard_chain_tree_global`` (every rank passes
its own slice; ``host_local_chains`` sizes it).

The backend is chosen in the open and printed once (``choose_backend``):
NCCL when every local rank has a card of its own, gloo on the CPU or when
ranks share a card (NCCL refuses two ranks on one device).  Unlike the
JAX package, an initialisation error is raised, not swallowed.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init", "is_distributed", "host_local_chains", "local_device",
           "choose_backend", "world_size", "rank"]


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> str:
    """"nccl" when each of ``local_world_size`` ranks has one of
    ``device_count`` CUDA cards to itself, else "gloo"."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None) -> bool:
    """Join the process group (idempotent); True if more than one process
    runs.

    ``coordinator``: an init URL (``tcp://host:port``, ``file:///path``,
    or ``host:port`` for TCP); with ``num_processes`` and ``process_id``.
    Without them, torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``); with neither, a single
    process and nothing to do (False).  ``backend`` overrides
    ``choose_backend`` (for CUDA where a card is there, else the CPU)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        if "MASTER_ADDR" not in os.environ or _env_int("WORLD_SIZE") is None:
            return False
        url = "env://"
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if num_processes is None or process_id is None:
        raise ValueError("distributed.init: a coordinator needs "
                         "num_processes and process_id")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = backend or choose_backend(device_type, local_world, count)
    if process_id == 0:
        print(f"distributed.init: backend {backend}, {num_processes} "
              f"processes, {local_world} a host, {count} CUDA device(s) "
              "a host", flush=True)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def host_local_chains(global_chains: int) -> int:
    """Per-process chain count for an evenly sharded global ensemble."""
    p = world_size()
    if global_chains % p:
        raise ValueError(f"{global_chains} chains not divisible by "
                         f"{p} processes")
    return global_chains // p


def local_device(device=None) -> torch.device:
    """``device`` if given; else this process's card,
    ``cuda:{LOCAL_RANK % device_count}``.  Raises when no card is there:
    the CPU is used only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device(
        "cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count())
