"""The port's on-device tools on the CPU at tiny sizes:
tools/extra_bench_torch.py (the seven workloads of tools/extra_bench.py)
and tools/lgcache_bench_torch.py (the six variants of
tools/lgcache_bench.py).  Each workload runs with device="cpu", prints its
line naming the device, and returns its numbers; both tools refuse to run
on the CPU by default when there is no card.  Their timings mean nothing
here: the card's are in PERF.md."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import extra_bench_torch as eb  # noqa: E402
import lgcache_bench_torch as lb  # noqa: E402

torch.set_num_threads(1)

SMALL = {
    "make": (eb.bench_make, dict(n=256, m=32), r"^make\(256,32\) production "
             r"wall: .* S1 route host\); apart: fill_rows fill .* host "
             r"anchors .* anchor copy \(64 B, pageable\) .* pair fill on "
             r"cpu .* s1_host .* S1 pair copy "),
    "ensure": (eb.bench_ensure, dict(n=256, m=32), r"^ensure\(128 -> 256, "
               r"m=32\): .* bitwise equal to the fresh make: True "),
    "xfer": (eb.bench_xfer, dict(n=1024), r"^S1 hi/lo pair \(8192 B\) to "
             r"cpu: pageable "),
    "sparse": (eb.bench_sparse, dict(P=3000, C=3, iters=2),
               r"^sparse sample_a \(CSR, 3000 pairs, C=3, 2 moves, grid "
               r"96x32 g=16\): .* samples/s = .* pair-terms/s; .* ms a "
               r"move, of which the streamed curve .* ms "),
    "hsa": (eb.bench_hsa, dict(n_groups=2, n_per_group=30, C=4, sweeps=1),
            r"^HSA \(item-sequential oracle, N=60, C=4\): .* item-updates/s"),
    "hsapairs": (eb.bench_hsa_pairs, dict(n_groups=3, n_per_group=50, C=4,
                                          sweeps=1),
                 r"^HSA pair-major staged \(N=150, C=4, s_max=\d+\): .* "
                 r"item-updates/s \(.* ms/sweep\) "),
    "ctw": (eb.bench_ctw, dict(n_groups=3, n_per_group=50, C=4, sweeps=1),
            r"^CTW\(rel,w=10\) N=150 C=4 m_sel=0: .* item-updates/s "),
}


def test_every_workload_has_a_small_case():
    assert tuple(SMALL) == eb.WORKLOADS


@pytest.mark.parametrize("workload", list(SMALL))
def test_extra_bench_workload_runs_on_cpu(workload, capsys):
    fn, kw, line = SMALL[workload]
    out = fn("cpu", eb.card_label("cpu"), **kw)
    text = capsys.readouterr().out
    assert re.search(line, text, re.M), text
    assert text.rstrip().endswith("[cpu, host clock]")
    if workload == "make":
        assert out["route"] == "fill_rows" and out["s1_route"] == "host"
        assert min(out[k] for k in ("wall_ms", "fill_ms", "s1_host_ms",
                                    "h2d_ms", "anchors_ms", "anchor_h2d_ms",
                                    "s1_fill_ms")) > 0
    elif workload == "ensure":
        assert out["equal_fresh"] and out["peak"] is None
        assert out["new"] == 2 * out["old"]
    elif workload == "sparse":
        from libstb_tpu_torch.samplers import hyper

        a = out["a"]
        assert a.shape == (3,) and bool(((a >= hyper.A_MIN)
                                         & (a <= hyper.A_MAX)).all())
        assert 0 < out["curve_ms"] and 0 < out["move_ms"]
    elif workload == "ctw":
        assert len(out) == 2 and 0 in out and min(out.values()) > 0


def test_sparse_inputs_match_the_jax_tool():
    """The pairs of tools/extra_bench.py's bench_sparse: seed 4, ns in
    [2, 90), ts in [1, 30) capped at n."""
    ns, ts, T = eb.sparse_inputs(1000, 4, "cpu")
    rng = np.random.default_rng(4)
    ns_j = rng.integers(2, 90, 1000).astype(np.int32)
    ts_j = np.minimum(rng.integers(1, 30, (4, 1000)).astype(np.int32),
                      ns_j[None])
    np.testing.assert_array_equal(ns.numpy(), ns_j)
    np.testing.assert_array_equal(ts.numpy(), ts_j)
    np.testing.assert_array_equal(T.numpy()[:, 0], ts_j.sum(axis=1))


def test_lgcache_bench_runs_on_cpu(capsys):
    rows = lb.run("cpu", eb.card_label("cpu"), batch=256, reps=2)
    text = capsys.readouterr().out
    assert list(rows) == ["gammadiff", "lgamma-raw", "psidiff",
                          "digamma-raw", "qval", "gcache-gather"]
    assert all(np.isfinite(v) and v > 0 for v in rows.values())
    assert "device=cpu [cpu, host clock], batch=256, reps=2" in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("| ") and "e-" in ln]) == 6


def test_lgcache_bench_variants_compute_the_differences():
    """Each variant computes what its name says: the fused forms equal
    the raw differences where both are accurate (f64)."""
    n = torch.tensor([1, 2, 3, 7, 150])
    al = torch.tensor([0.3, 0.5, 0.9, 0.2, 0.7], dtype=torch.float64)
    v = lb.variants()
    torch.testing.assert_close(v["gammadiff"](n, al), v["lgamma-raw"](n, al),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(v["psidiff"](n, al), v["digamma-raw"](n, al),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("main", [eb.main, lb.main])
def test_tools_default_to_the_card(main):
    """Without a CUDA device the default --device cuda fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])


def test_tools_run_without_jax():
    """Both mains on the CPU with jax and the JAX package unimportable."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['libstb_tpu'] = None\n"
            "sys.path.insert(0, 'tools')\n"
            "import extra_bench_torch, lgcache_bench_torch\n"
            "lgcache_bench_torch.main(['--device', 'cpu', '--batch', '64', "
            "'--reps', '2'])\n"
            "try:\n"
            "    extra_bench_torch.main(['--device', 'cpu', '--only', 'x'])\n"
            "except SystemExit as e:\n"
            "    print('refused:', e)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "| gcache-gather (x16 reuse) |" in res.stdout
    assert "refused: extra_bench_torch: unknown workload(s) ['x']" in (
        res.stdout)
