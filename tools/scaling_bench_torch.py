#!/usr/bin/env python
"""Weak scaling of the chain-sharded Gibbs step over torch.distributed:
the PyTorch/CUDA counterpart of tools/scaling_bench.py.

Runs the full step of ``libstb_tpu_torch.entry`` (TI sweep + sample_b +
sample_a) plus the cross-chain moments of a and b
(``parallel.mesh.cross_chain_moments``, an all-reduce over the chain
axis) in one process and in N processes, with ``chains_per_dev`` chains a
process (weak scaling), and reports steps/s and chain-updates/s.  With
--ngg it measures the NGG saddle-point workload instead (BASELINE config
5): each process evaluates ``umax_log`` and ``gmax_log`` on its slice of
the seed-0 (N, K) draws, and the worst u-vs-g disagreement is reduced as
a maximum over the processes.

One process runs per device.  ``r1`` is measured in the calling process
(world 1); ``rn`` in N processes of this tool, which meet through a file
rendezvous, rank 0 handing its result back.  Under torchrun (its
environment set) rank 0 measures ``r1`` alone first, then every rank
measures ``rn`` in the world it is in.  The backend is
``distributed.choose_backend``'s: gloo when ranks share a card, so with
more processes than cards (``shared_card``) the figures are those of one
card shared, not weak scaling.  The sizes of a run (the grid, the data)
are keyword arguments of ``measure`` with tools/scaling_bench.py's values
as defaults.

Prints one JSON line: device, backend, shared_card, r1, rn (each with
devices, chains, sec_per_step, chain_steps_per_s,
per_device_chain_steps_per_s, and the last step's moments and kernel
launches, or the worst disagreement) and weak_scaling_efficiency = rn
chain-steps/s / (N x r1's).

Usage:
  python tools/scaling_bench_torch.py [--devices N] [--iters 30]
      [--chains-per-dev 128] [--ngg] [--device cuda|cpu] [--write-md PATH]
  torchrun --nproc_per_node N tools/scaling_bench_torch.py [...]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
sys.path.insert(0, ROOT)

import numpy as np
import torch

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK", "LOCAL_WORLD_SIZE")
NGG_A, NGG_M, NGG_WORST = 0.1, 10.0, 0.2


def _sync(cm):
    """Wait for the device and then for every rank of ``cm``."""
    import torch.distributed as dist

    if cm.device.type == "cuda":
        torch.cuda.synchronize(cm.device)
    if cm.world_group is not None:
        dist.barrier(group=cm.world_group)


def _timed(fn, iters, cm):
    """fn() once to warm, then ``iters`` times; seconds a call, the last
    result."""
    out = fn()
    _sync(cm)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(cm)
    return (time.perf_counter() - t0) / iters, out


def _launches(before, cm):
    """Kernel launches since ``before`` (a copy of stirling_cuda.LAUNCHES),
    summed over the ranks of ``cm``."""
    from libstb_tpu_torch.ops import stirling_cuda
    from libstb_tpu_torch.parallel import mesh as pmesh

    names = sorted(before)
    mine = torch.tensor([stirling_cuda.LAUNCHES[k] - before[k]
                         for k in names], dtype=torch.int64)
    total = pmesh.sum_over(mine.to(cm.device), cm, pmesh.CHAIN_AXIS)
    return dict(zip(names, (int(x) for x in total.tolist())))


def _row(cm, chains, dt, **extra):
    return dict(devices=cm.world, chains=chains, sec_per_step=dt,
                chain_steps_per_s=chains / dt,
                per_device_chain_steps_per_s=chains / dt / cm.world, **extra)


def measure(device, iters, chains_per_dev, *, n_max=256, m_max=64, g=16,
            dim=16, n_per_group=100, seed=0):
    """The Gibbs step + cross-chain moments over every process of the
    current world (one process: world 1), ``chains_per_dev`` chains a
    process, each shard's draws from ``entry.step_generators(seed,
    device, shard)``.  Returns the result row, with ``stats`` = [a_mean,
    a_var, b_mean, b_var] over all chains after the last step (which
    must be finite) and ``launches``, the kernels launched in the call
    over all ranks (K1 fills each rank's grid)."""
    from libstb_tpu_torch import entry
    from libstb_tpu_torch.ops import stirling_cuda
    from libstb_tpu_torch.parallel import mesh as pmesh

    before = dict(stirling_cuda.LAUNCHES)
    cm = pmesh.chain_mesh(device=device)
    chains = chains_per_dev * cm.world
    step, (_, t, T, a, b, ns) = entry._build(
        chains_per_dev, cm.device, n_max=n_max, m_max=m_max, g=g, dim=dim,
        n_per_group=n_per_group, mesh=cm)
    gens = entry.step_generators(seed, cm.device,
                                 shard=cm.coord(pmesh.CHAIN_AXIS))
    state = dict(t=t, T=T, a=a, b=b)

    def step_with_stats():
        s = state
        s["t"], s["T"], s["a"], s["b"] = step(gens, s["t"], s["T"], s["a"],
                                              s["b"], ns)
        a_mean, a_var = pmesh.cross_chain_moments(s["a"], mesh=cm)
        b_mean, b_var = pmesh.cross_chain_moments(s["b"], mesh=cm)
        return torch.stack([a_mean, a_var, b_mean, b_var])

    dt, stats = _timed(step_with_stats, iters, cm)
    stats = stats.double().cpu().numpy()
    if not np.isfinite(stats).all():
        raise AssertionError(f"scaling_bench_torch: moments {stats}")
    return _row(cm, chains, dt, stats=stats.tolist(),
                launches=_launches(before, cm))


def ngg_inputs(chains, device):
    """tools/scaling_bench.py's draws: N in [50, 10^5), K = max(1, N x
    U(0.005, 0.05)), f64, from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    Ns = rng.integers(50, 100000, chains).astype(np.float64)
    Ks = np.maximum(1, Ns * rng.uniform(0.005, 0.05, chains))
    return (torch.as_tensor(Ns, device=device),
            torch.as_tensor(Ks.astype(np.float64), device=device))


def ngg_eval(N, K):
    """(u, the worst |u - g| / max(|u|, 1) over these chains)."""
    from libstb_tpu_torch.core import ngg

    u = ngg.umax_log(NGG_A, NGG_M, N, K)
    g = ngg.gmax_log(NGG_A, NGG_M, N, K)
    return u, torch.max(torch.abs(u - g) / torch.clamp(torch.abs(u),
                                                       min=1.0))


def measure_ngg(device, iters, chains_per_dev):
    """The NGG saddle-point workload over every process of the current
    world: each rank its slice of the global draws, the worst
    disagreement reduced as a maximum.  Returns the row, with
    ``worst``."""
    from libstb_tpu_torch.parallel import mesh as pmesh

    cm = pmesh.chain_mesh(device=device)
    chains = chains_per_dev * cm.world
    sl = pmesh.chain_slice(cm, chains)
    N, K = (x[sl] for x in ngg_inputs(chains, cm.device))

    dt, worst = _timed(lambda: pmesh.max_over(ngg_eval(N, K)[1], cm,
                                              pmesh.CHAIN_AXIS), iters, cm)
    worst = float(worst)
    # gross-structure sanity only (rigorous accuracy: tests/test_torch_ngg.py)
    if not worst < NGG_WORST:
        raise AssertionError(f"scaling_bench_torch: worst u-vs-g "
                             f"disagreement {worst} (< {NGG_WORST})")
    return _row(cm, chains, dt, worst=worst)


def _measure(ngg, device, iters, chains_per_dev, sizes):
    if ngg:
        return measure_ngg(device, iters, chains_per_dev)
    return measure(device, iters, chains_per_dev, **sizes)


def _placement(device):
    """(the device argument of measure, the backend) for ``device``: the
    CPU over gloo, or each rank's own card (cuda:LOCAL_RANK % cards) with
    distributed.choose_backend's pick."""
    if torch.device(device).type == "cpu":
        return "cpu", "gloo"
    return None, None


def _under_torchrun() -> bool:
    return "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ


def _run_ranks(n, ngg, device, iters, chains_per_dev, sizes,
               timeout=1200):
    """rn in ``n`` processes of this tool; rank 0's result."""
    out = tempfile.mkdtemp(prefix="scaling_bench_")
    spec = json.dumps(dict(ngg=ngg, device=device, iters=iters,
                           chains_per_dev=chains_per_dev, sizes=sizes))
    procs = []
    try:
        for r in range(n):
            env = {k: v for k, v in os.environ.items()
                   if k not in _TORCHRUN_VARS}
            env.update(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 str(n), os.path.join(out, "rdzv"), out, spec], env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        for r, p in enumerate(procs):
            try:
                text = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"scaling_bench_torch: {n} ranks did not "
                                   f"finish in {timeout} s")
            if p.returncode != 0:
                raise RuntimeError(f"scaling_bench_torch: rank {r} exited "
                                   f"{p.returncode}:\n{text[-4000:]}")
        with open(os.path.join(out, "rank0.json")) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out, ignore_errors=True)


def _in_world(ngg, device, iters, chains_per_dev, sizes, *init_args):
    """Join the world (``distributed.init(*init_args)``: torchrun's
    environment, or a --rank's rendezvous), measure over it, and leave;
    the row, with the backend."""
    import torch.distributed as dist
    from libstb_tpu_torch.parallel import distributed

    dev_arg, backend = _placement(device)
    distributed.init(*init_args, backend=backend)
    try:
        row = _measure(ngg, dev_arg, iters, chains_per_dev, sizes)
        row["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return row


def rank_main(argv):
    """One rank of rn (see _run_ranks): join the file rendezvous, measure,
    rank 0 writes its row."""
    rank, world, rdzv, out, spec = argv
    rank, world, spec = int(rank), int(world), json.loads(spec)
    row = _in_world(spec["ngg"], spec["device"], spec["iters"],
                    spec["chains_per_dev"], spec["sizes"], f"file://{rdzv}",
                    world, rank)
    if rank == 0:
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(row, f)


def _device_label(device) -> str:
    sys.path.insert(0, TOOLS)
    from extra_bench_torch import card_label

    return card_label(device)


def run(devices, *, iters=30, chains_per_dev=128, ngg=False, device="cuda",
        **sizes):
    """r1 in this process, rn over ``devices`` processes (or over
    torchrun's world); the result dict (None on a torchrun rank but 0)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_bench_torch: --device cuda but no CUDA "
                         "device")
    dev_arg = _placement(device)[0]
    if _under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if devices not in (0, world):
            raise SystemExit(f"scaling_bench_torch: --devices {devices} "
                             f"under a torchrun world of {world}")
        devices = world
        r1 = (_measure(ngg, dev_arg, iters, chains_per_dev, sizes)
              if int(os.environ.get("RANK", 0)) == 0 else None)
        rn = _in_world(ngg, device, iters, chains_per_dev, sizes)
        if r1 is None:
            return None
    else:
        devices = devices or (torch.cuda.device_count()
                              if dev.type == "cuda" else 1)
        r1 = _measure(ngg, dev_arg, iters, chains_per_dev, sizes)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rn = _run_ranks(devices, ngg, device, iters, chains_per_dev, sizes)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    eff = rn["chain_steps_per_s"] / (r1["chain_steps_per_s"] * devices)
    return dict(device=_device_label(dev), backend=rn.pop("backend"),
                shared_card=dev.type == "cuda" and devices > cards,
                r1=r1, rn=rn, weak_scaling_efficiency=round(eff, 4))


def write_md(path, result):
    """tools/scaling_bench.py's table, to ``path`` (never the repository's
    SCALING.md, which the JAX tool writes)."""
    if os.path.realpath(path) == os.path.realpath(
            os.path.join(ROOT, "SCALING.md")):
        raise SystemExit("scaling_bench_torch: SCALING.md belongs to "
                         "tools/scaling_bench.py; name another path")
    r1, rn = result["r1"], result["rn"]
    shared = (" (ranks sharing one card: not weak scaling)"
              if result["shared_card"] else "")
    with open(path, "w") as f:
        f.write("# Multi-process weak scaling (chain-sharded Gibbs step, "
                "PyTorch port)\n\n"
                f"Device: {result['device']}; backend: {result['backend']}"
                f"{shared}\n\n"
                "| devices | chains | ms/step | chain-updates/s | "
                "per-device/s |\n|---|---|---|---|---|\n")
        for r in (r1, rn):
            f.write(f"| {r['devices']} | {r['chains']} "
                    f"| {r['sec_per_step'] * 1e3:.1f} "
                    f"| {r['chain_steps_per_s']:.3g} "
                    f"| {r['per_device_chain_steps_per_s']:.3g} |\n")
        f.write(f"\nWeak-scaling efficiency (N-process total vs N x "
                f"1-process total): **{result['weak_scaling_efficiency']:.2f}"
                "**\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=0,
                   help="processes of the scaled run (0 = every card; 1 on "
                        "the CPU; torchrun's world under torchrun)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--ngg", action="store_true",
                   help="measure the NGG saddle-point workload "
                        "(BASELINE config 5) instead of the Gibbs step")
    p.add_argument("--chains-per-dev", type=int, default=128)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--write-md", default=None, metavar="PATH",
                   help="also write tools/scaling_bench.py's table here")
    args = p.parse_args(argv)
    result = run(args.devices, iters=args.iters,
                 chains_per_dev=args.chains_per_dev, ngg=args.ngg,
                 device=args.device)
    if result is None:
        return None
    print(json.dumps(result), flush=True)
    if args.write_md:
        write_md(args.write_md, result)
        print(f"wrote {os.path.abspath(args.write_md)}", file=sys.stderr)
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
