"""Checkpoint/resume for chain ensembles, in PyTorch.

Port of libstb_tpu/utils/checkpoint.py.  A checkpoint holds what a run
needs to continue exactly where it stopped: the chain state (tensors), the
random generator's state and JSON metadata.  Tables are not saved: they
are deterministic functions of their configuration and refill on the card
in milliseconds.

Format: one ``.npz`` with the tensors and generator states as arrays, and
a JSON sidecar (``<path>.npz.json``) with the container structure and the
metadata.  The idea is the JAX package's; the structure is the port's own
(JAX's treedef proto cannot be read without JAX), so neither package reads
the other's checkpoints.

Multi-process (``torch.distributed`` world of P > 1): each rank writes
``<path>.p<rank>.npz`` (+ sidecar) with its own chain shards, so saves on
a shared filesystem never collide; the sidecar also records the world
size, the rank and which leaves are chain-sharded.  ``load`` reads this
rank's file and returns its local state, which a resume re-shards with
``parallel.mesh.shard_chain_tree_global``.  A one-process save keeps the
plain name and format.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..parallel import distributed

__all__ = ["save", "load"]

_FORMAT = 1


def _npz_path(path: str) -> str:
    """``path`` with .npz, and in a multi-process world this rank's
    ``.p<rank>`` before it (unless already there)."""
    if path.endswith(".npz"):
        path = path[:-len(".npz")]
    if distributed.is_distributed():
        suffix = f".p{distributed.rank()}"
        if not path.endswith(suffix):
            path += suffix
    return path + ".npz"


def save(path: str, state: Any, meta: Optional[dict] = None,
         chains: Optional[int] = None) -> str:
    """Write ``state`` -- tensors, ``torch.Generator``s and None, in
    nested dicts (string keys), lists and tuples -- and ``meta`` (JSON-
    able) to ``path`` (.npz appended if missing; ``.p<rank>`` before it
    in a multi-process world).  ``chains``: this rank's chain count; a
    multi-process sidecar lists the tensors whose leading dim it is as
    chain-sharded.  Returns the final path."""
    arrays = {}
    sharded = []

    def encode(x):
        key = f"leaf{len(arrays)}"
        if isinstance(x, torch.Tensor):
            arrays[key] = x.detach().cpu().numpy()
            if chains is not None and x.ndim >= 1 and x.shape[0] == chains:
                sharded.append(key)
            return {"tensor": key}
        if isinstance(x, torch.Generator):
            arrays[key] = x.get_state().numpy()
            return {"generator": key, "device": x.device.type}
        if x is None:
            return {"none": None}
        if isinstance(x, dict):
            if not all(isinstance(k, str) for k in x):
                raise TypeError("checkpoint.save: dict keys must be str")
            return {"dict": {k: encode(v) for k, v in x.items()}}
        if isinstance(x, (list, tuple)):
            return {type(x).__name__: [encode(v) for v in x]}
        raise TypeError(f"checkpoint.save: cannot store {type(x).__name__}")

    tree = encode(state)
    path = _npz_path(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    side = {"format": _FORMAT, "tree": tree, "meta": meta or {}}
    if distributed.is_distributed():
        side.update(world_size=distributed.world_size(),
                    rank=distributed.rank(), chain_sharded=sharded)
    with open(path + ".json", "w") as f:
        json.dump(side, f)
    return path


def load(path: str, like: Any = None, device=None):
    """Read a checkpoint (in a multi-process world, this rank's
    ``.p<rank>`` file, which must come from a world of the same size);
    returns (state, meta).

    Tensors go to ``device`` if given, else to the device of the matching
    tensor of ``like`` (a state of the same structure), else to the CPU.
    A generator comes back as a new ``torch.Generator`` with the saved
    state, on ``device`` / ``like``'s generator's device / the saved
    device type; a CUDA generator's state cannot be set on a CPU generator,
    so that raises, as does a ``like`` of another structure."""
    path = _npz_path(path)
    with open(path + ".json") as f:
        side = json.load(f)
    if side.get("format") != _FORMAT:
        raise ValueError(f"{path}: checkpoint format {side.get('format')}, "
                         f"this reader knows {_FORMAT}")
    want = (distributed.world_size(), distributed.rank())
    got = (side.get("world_size", 1), side.get("rank", 0))
    if got != want:
        raise ValueError(f"{path}: saved by rank {got[1]} of {got[0]}, "
                         f"read by rank {want[1]} of {want[0]}")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}

    def where(like_x, fallback):
        if device is not None:
            return torch.device(device)
        if isinstance(like_x, (torch.Tensor, torch.Generator)):
            return like_x.device
        return torch.device(fallback)

    def mismatch(what):
        raise ValueError(f"{path}: the checkpoint's structure differs from "
                         f"like's at {what}")

    def decode(node, like_x, at):
        (kind, val), = ((k, v) for k, v in node.items() if k != "device")
        if kind == "tensor":
            return torch.from_numpy(arrays[val]).to(where(like_x, "cpu"))
        if kind == "generator":
            dev = where(like_x, node["device"])
            if dev.type != node["device"]:
                raise ValueError(f"{path}: a {node['device']} generator's "
                                 f"state cannot be loaded on {dev}")
            gen = torch.Generator(device=dev)
            gen.set_state(torch.from_numpy(arrays[val]))
            return gen
        if kind == "none":
            return None
        if kind == "dict":
            if like_x is not None and set(like_x) != set(val):
                mismatch(at or "the top")
            return {k: decode(v, None if like_x is None else like_x[k],
                              f"{at}[{k!r}]") for k, v in val.items()}
        if like_x is not None and len(like_x) != len(val):
            mismatch(at or "the top")
        seq = [decode(v, None if like_x is None else like_x[i], f"{at}[{i}]")
               for i, v in enumerate(val)]
        return tuple(seq) if kind == "tuple" else seq

    return decode(side["tree"], like, ""), side["meta"]
