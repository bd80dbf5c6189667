"""libstb_tpu_torch.parallel.distributed (the port of
libstb_tpu/parallel/distributed.py): single-process init, the chain split,
the backend choice, the device choice, and init under 2 gloo processes.

``run_ranks`` is the multi-process harness of the port's tests: it starts
P CPU processes that join one gloo group through a file rendezvous in the
test's tmp_path (no TCP port, so xdist workers never collide) and waits
for them with a timeout, so a hung rendezvous fails the test instead of
hanging the suite."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from libstb_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parent.parent

_PRELUDE = textwrap.dedent("""
    import sys
    rank, world, rdzv, repo, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from libstb_tpu_torch.parallel import distributed
    assert distributed.init(f"file://{rdzv}", world, rank)
""")

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def run_ranks(code: str, world: int, tmp_path, timeout: float = 120):
    """Run ``code`` (after a prelude that joins a ``world``-process gloo
    group; it sees ``rank``, ``world`` and ``out``, a directory for its
    results) in ``world`` CPU processes; returns their stdouts and fails
    the test if any process fails or the group outlives ``timeout``."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    rdzv = tmp_path / f"rdzv{world}"
    env = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_VARS}
    env["OMP_NUM_THREADS"] = "1"
    script = _PRELUDE + textwrap.dedent(code)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(rdzv),
         str(ROOT), str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world} ranks did not finish in {timeout} s")
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
    return outs


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in _TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)


def test_single_process_init_is_false(no_torchrun):
    """No torchrun environment and no coordinator: one process, nothing
    to join (as JAX's init off a TPU pod)."""
    assert distributed.init() is False
    assert not distributed.is_distributed()
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_init_needs_the_process_count(no_torchrun):
    with pytest.raises(ValueError, match="num_processes"):
        distributed.init("file:///nonexistent/rdzv")


def test_host_local_chains(monkeypatch):
    assert distributed.host_local_chains(1024) == 1024
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    assert distributed.host_local_chains(9) == 3
    with pytest.raises(ValueError, match="not divisible by 3"):
        distributed.host_local_chains(8)


@pytest.mark.parametrize("case,want", [
    (("cpu", 1, 0), "gloo"), (("cpu", 4, 0), "gloo"),
    (("cpu", 2, 8), "gloo"), (("cuda", 1, 1), "nccl"),
    (("cuda", 4, 4), "nccl"), (("cuda", 2, 8), "nccl"),
    (("cuda", 2, 1), "gloo"), (("cuda", 8, 4), "gloo"),
    (("cuda", 1, 0), "gloo")])
def test_backend_choice(case, want):
    """NCCL only when every local rank has a card of its own; ranks
    sharing a card, or on the CPU, take gloo."""
    assert distributed.choose_backend(*case) == want


def test_local_device(monkeypatch):
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert distributed.local_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert distributed.local_device() == torch.device("cuda", 2)


def test_init_idempotent_two_processes(tmp_path):
    """Two gloo processes: init is idempotent (True again), the split and
    its ValueError follow the world, rank 0 names the backend once."""
    outs = run_ranks("""
        assert distributed.init() is True
        assert distributed.init(f"file://{rdzv}", world, rank) is True
        assert distributed.is_distributed()
        assert (distributed.world_size(), distributed.rank()) == (2, rank)
        assert distributed.host_local_chains(8) == 4
        try:
            distributed.host_local_chains(7)
        except ValueError:
            print(f"rank {rank} ok", flush=True)
        import torch.distributed as dist
        assert dist.get_backend() == "gloo"
        dist.barrier()
    """, 2, tmp_path)
    for r, text in enumerate(outs):
        assert f"rank {r} ok" in text
    assert outs[0].count("backend gloo") == 1
    assert "backend" not in outs[1]


def test_sharded_ngg_workload_equals_one_process(tmp_path):
    """cli/ngg_torch.py --chains under 2 processes: each rank its slice of
    the seed-0 draws; worst equal to the one-process value, mean to rtol
    1e-12, the line printed once."""
    sys.path.insert(0, str(ROOT / "cli"))
    import ngg_torch

    outs = run_ranks("""
        import json
        sys.path.insert(0, repo + "/cli")
        import ngg_torch
        res = ngg_torch.main(["--device", "cpu", "--chains", "301"])
        with open(f"{out}/ngg{rank}.json", "w") as f:
            json.dump(res, f)
    """, 2, tmp_path)
    one = ngg_torch.main(["--device", "cpu", "--chains", "300"])
    for r in range(2):
        res = json.loads((tmp_path / "out" / f"ngg{r}.json").read_text())
        assert res["chains"] == 300
        assert res["worst"] == one["worst"]
        assert res["mean"] == pytest.approx(one["mean"], rel=1e-12)
    assert sum("NGG workload: 300 chains on 2 device(s)" in o
               for o in outs) == 1
