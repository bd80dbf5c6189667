"""tools/scaling_bench_torch.py (the port of tools/scaling_bench.py) on the
CPU at a tiny size: both modes in one process (r1) and over 1 and 2 gloo
CPU processes (rn) started by the tool itself, which meet through a file
rendezvous.  The 2-rank moments and the NGG worst are held to the same
chains in one process; the NGG saddle point to JAX's (rtol 1e-10).  The
timings mean nothing here: the card's are in PERF.md."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libstb_tpu.core import ngg as jngg
from libstb_tpu_torch import entry
from libstb_tpu_torch.ops import stirling_cuda as sc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import scaling_bench_torch as sb  # noqa: E402

torch.set_num_threads(1)

CPD, ITERS = 4, 2
SIZES = dict(n_max=48, m_max=24, g=6, dim=8, n_per_group=24)
ROW_KEYS = {"devices", "chains", "sec_per_step", "chain_steps_per_s",
            "per_device_chain_steps_per_s"}


@pytest.fixture(scope="module")
def gibbs():
    return {n: sb.run(n, iters=ITERS, chains_per_dev=CPD, device="cpu",
                      **SIZES) for n in (1, 2)}


@pytest.fixture(scope="module")
def ngg2():
    return sb.run(2, iters=ITERS, chains_per_dev=CPD, ngg=True,
                  device="cpu")


def _check_row(row, devices):
    assert ROW_KEYS <= set(row)
    assert row["devices"] == devices and row["chains"] == CPD * devices
    assert row["sec_per_step"] > 0
    assert row["chain_steps_per_s"] == pytest.approx(
        row["chains"] / row["sec_per_step"], rel=1e-12)
    assert row["per_device_chain_steps_per_s"] == pytest.approx(
        row["chain_steps_per_s"] / devices, rel=1e-12)


@pytest.mark.parametrize("devices", [1, 2])
def test_gibbs_result_fields(gibbs, devices):
    res = gibbs[devices]
    assert json.loads(json.dumps(res)) == res
    assert res["backend"] == "gloo" and res["shared_card"] is False
    assert res["device"] == "cpu, host clock"
    _check_row(res["r1"], 1)
    _check_row(res["rn"], devices)
    for row in (res["r1"], res["rn"]):
        assert len(row["stats"]) == 4 and np.isfinite(row["stats"]).all()
        # the CPU fills by the plain version: no kernel launch to count
        assert row["launches"] == dict.fromkeys(sc.KERNELS, 0)
    eff = res["rn"]["chain_steps_per_s"] / (
        res["r1"]["chain_steps_per_s"] * devices)
    assert res["weak_scaling_efficiency"] == round(eff, 4)


def _one_process_chains(shards):
    """Each chain shard's steps (the warm one + ITERS) in this process,
    with the generators that shard's rank draws from; the chains in
    global order."""
    a, b = [], []
    for shard in range(shards):
        step, (_, t, T, a_, b_, ns) = entry._build(CPD, "cpu", **SIZES)
        gens = entry.step_generators(0, "cpu", shard=shard)
        for _ in range(ITERS + 1):
            t, T, a_, b_ = step(gens, t, T, a_, b_, ns)
        a.append(a_)
        b.append(b_)
    return torch.cat(a), torch.cat(b)


@pytest.mark.parametrize("devices", [1, 2])
def test_gibbs_moments_equal_one_process(gibbs, devices):
    """The sharded cross_chain_moments of a and b after the last step
    equal the one-process moments over the same chains within 1e-6
    (relative; f32 sums taken in another order)."""
    a, b = _one_process_chains(devices)
    want = [x.item() for v in (a, b)
            for x in (torch.mean(v), torch.var(v, correction=0))]
    np.testing.assert_allclose(gibbs[devices]["rn"]["stats"], want,
                               rtol=1e-6, atol=1e-7)


def test_r1_equals_one_rank(gibbs):
    """r1 (this process) and rn at 1 process (a rank of the tool) run the
    same chains under the same draws."""
    np.testing.assert_allclose(gibbs[1]["r1"]["stats"],
                               gibbs[1]["rn"]["stats"], rtol=1e-6, atol=1e-7)


def test_ngg_two_ranks(ngg2):
    """--ngg over 2 ranks: the fields, and the worst disagreement (a max,
    exact in any order) bitwise equal to one process's over the same
    chains."""
    _check_row(ngg2["r1"], 1)
    _check_row(ngg2["rn"], 2)
    assert ngg2["backend"] == "gloo"
    assert 0 <= ngg2["rn"]["worst"] < sb.NGG_WORST
    one = sb.measure_ngg("cpu", 1, 2 * CPD)
    assert one["chains"] == ngg2["rn"]["chains"]
    assert ngg2["rn"]["worst"] == one["worst"]


def test_ngg_draws_and_saddle_point_match_jax():
    """The tool's draws are tools/scaling_bench.py's (rng 0), and u on them
    matches JAX's ngg.umax_log within rtol 1e-10."""
    N, K = sb.ngg_inputs(6, "cpu")
    rng = np.random.default_rng(0)
    Ns = rng.integers(50, 100000, 6).astype(np.float64)
    Ks = np.maximum(1, Ns * rng.uniform(0.005, 0.05, 6)).astype(np.float64)
    np.testing.assert_array_equal(N.numpy(), Ns)
    np.testing.assert_array_equal(K.numpy(), Ks)
    u, worst = sb.ngg_eval(N, K)
    want = np.asarray(jngg.umax_log(sb.NGG_A, sb.NGG_M, Ns, Ks))
    np.testing.assert_allclose(u.numpy(), want, rtol=1e-10)
    assert 0 <= float(worst) < sb.NGG_WORST


def test_write_md(gibbs, tmp_path):
    """--write-md writes the JAX tool's table to the named path and
    refuses the repository's SCALING.md."""
    path = tmp_path / "scaling.md"
    sb.write_md(str(path), gibbs[2])
    text = path.read_text()
    assert "| devices | chains | ms/step |" in text
    assert f"| 2 | {2 * CPD} |" in text and "efficiency" in text
    with pytest.raises(SystemExit, match="SCALING.md"):
        sb.write_md(os.path.join(sb.ROOT, "SCALING.md"), gibbs[2])


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sb.main(["--device", "cuda", "--iters", "1"])


def test_under_torchrun():
    """Under torchrun the tool measures rn in the world it is in (rank 0
    measures r1 alone first) and rank 0 prints the one JSON line."""
    env = {k: v for k, v in os.environ.items() if k not in sb._TORCHRUN_VARS}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.join(sb.TOOLS,
                                               "scaling_bench_torch.py"),
         "--device", "cpu", "--ngg", "--iters", "1", "--chains-per-dev",
         str(CPD)], cwd=sb.ROOT, env=env, capture_output=True, text=True,
        timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["backend"] == "gloo" and out["shared_card"] is False
    _check_row(out["r1"], 1)
    _check_row(out["rn"], 2)
    assert out["rn"]["worst"] < sb.NGG_WORST
