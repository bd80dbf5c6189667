"""A whole run of a cell on the CPU at a small size, with the look for a
card skipped: sound, it reads correct; with the timed path broken
underneath, it reads not correct, once for each fault a cell can have (a
step that returns its state unchanged, the TI sweep and each move of a
and of b alone among them; half of the batch left out; an answer altered
where it is produced).  The cells use one chip, so there is no exchange
between chips to leave out.

The small sizes have limits of their own (``SMALL``): 256 chains, a short
window and a short burn-in read a larger gap of T and larger distances of
a and b than the cells' (the faults read 0.3 and more, and 1/2 and more);
on the CPU the port fills the grid by another path than K1, which reads
1.3e-5 of V where K1 reads 1.0e-6."""
import dataclasses
import json
import math
import shutil
import time

import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
SMALL = {
    "gibbs.demo_c16k": {"chains": 256, "burnin_iters": 20, "min_kept": 20,
                       "limits": {"T_gap": 0.1, "a_ks": 0.4, "b_ks": 0.4,
                                  "grid_v_rel": 1e-4}},
    "table.remake_n64k": {"n": 4096, "keep": 2},
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench") / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.load_manifest()
    for cell, over in SMALL.items():
        name = next(w["traffic"] for w in man["workloads"]
                    if w["name"] == cell)
        path = root / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(over)
        path.write_text(json.dumps(mix))
    return root


def _run(bench, cell, seconds):
    return harness.run_cell(cell, 20261017, seconds, False, CPU,
                            time.perf_counter(), bench_dir=bench)


# -- the table cell ---------------------------------------------------------

def _unchanged(real):
    return lambda table, a: table


def _half_rows(real):
    def remake(table, a):
        t = real(table, a)
        v = t.vtab.clone()
        v[v.shape[0] // 2:] = 0.0
        return type(t)(**{**t.__dict__, "vtab": v})
    return remake


def _one_cell(real):
    def remake(table, a):
        t = real(table, a)
        v = t.vtab.clone()
        v[1000, 10] *= 1.01
        return type(t)(**{**t.__dict__, "vtab": v})
    return remake


def test_table_sound(bench):
    out = _run(bench, "table.remake_n64k", 1.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _one_cell])
def test_table_fault(bench, monkeypatch, fault):
    from libstb_tpu_torch.core import stirling

    monkeypatch.setattr(stirling, "remake", fault(stirling.remake))
    out = _run(bench, "table.remake_n64k", 1.0)
    assert not out["correct"], out["checks"]


# -- the Gibbs cell -----------------------------------------------------------

def _frozen(pyp, hyper, monkeypatch):
    monkeypatch.setattr(pyp, "ti_sweep_blocked",
                        lambda gen, t, T, *a, **k: (t, T))
    for name in ("sample_a", "sample_b"):
        monkeypatch.setattr(hyper, name,
                            lambda gen, x0, *a, **k: (x0, None))


def _a_frozen(pyp, hyper, monkeypatch):
    monkeypatch.setattr(hyper, "sample_a", lambda gen, x0, *a, **k: (x0, None))


def _b_frozen(pyp, hyper, monkeypatch):
    monkeypatch.setattr(hyper, "sample_b", lambda gen, x0, *a, **k: (x0, None))


def _half_chains(pyp, hyper, monkeypatch):
    real = pyp.ti_sweep_blocked

    def sweep(gen, t, T, *a, **k):
        t2, T2 = real(gen, t, T, *a, **k)
        h = t.shape[0] // 2
        return torch.cat([t2[:h], t[h:]]), torch.cat([T2[:h], T[h:]])
    monkeypatch.setattr(pyp, "ti_sweep_blocked", sweep)


def _altered(pyp, hyper, monkeypatch):
    real = pyp.ti_sweep_blocked

    def sweep(gen, t, T, *a, **k):
        t2, T2 = real(gen, t, T, *a, **k)
        T2 = T2.clone()
        T2[0, 0] += 1
        return t2, T2
    monkeypatch.setattr(pyp, "ti_sweep_blocked", sweep)


def _failed_by_the_fault(out) -> bool:
    """Not correct, and by a number that the outputs read, not by a
    window too short to judge."""
    return not out["correct"] and any(
        not v <= lim for k, (v, lim) in out["checks"].items()
        if k != "kept_short")


def test_gibbs_sound(bench):
    out = _run(bench, "gibbs.demo_c16k", 6.0)
    print(json.dumps(out["checks"]))
    assert out["correct"], out["checks"]
    assert out["attempted"] == 256 and out["failed"] == 0


@pytest.mark.parametrize("fault", [_frozen, _a_frozen, _b_frozen,
                                   _half_chains, _altered])
def test_gibbs_fault(bench, monkeypatch, fault):
    from libstb_tpu_torch.models import pyp
    from libstb_tpu_torch.samplers import hyper

    fault(pyp, hyper, monkeypatch)
    out = _run(bench, "gibbs.demo_c16k", 4.0)
    print(json.dumps(out["checks"]))
    assert _failed_by_the_fault(out), out["checks"]


def test_gibbs_short_window(bench, tmp_path):
    """A window that keeps fewer iterations than the mix's ``min_kept``
    is not judged correct, whatever its numbers read."""
    root = tmp_path / "benchmark"
    shutil.copytree(bench, root)
    path = root / "traffic" / "demo_c16k.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps({**mix, "min_kept": 10 ** 6}))
    out = _run(root, "gibbs.demo_c16k", 2.0)
    assert not out["correct"] and out["checks"]["kept_short"][0] > 0


# -- on the card, at the cells' own sizes -------------------------------------

def _at_min_kept(run):
    """The window of a sound run cut to the fewest iterations it may keep:
    the driver's count mode, burn-in then ``min_kept`` iterations."""
    from libstb_tpu_torch.models import driver

    c, t = run.config, run.traffic
    chunk = math.ceil(t["chunk"] / math.lcm(c["bcycle"], c["acycle"])) * \
        math.lcm(c["bcycle"], c["acycle"])
    iters = t["burnin_iters"] // chunk * chunk + t["min_kept"]
    run.out = driver.run_gibbs_timed(
        run.gen, run.data, run.grid, run.chains, c["a0"], c["b0"],
        dataclasses.replace(run.cfg, iters=iters), iter_ms=None,
        chunk=t["chunk"])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2147483901, 2147483913))
@pytest.mark.parametrize("cell", ["gibbs.demo_c16k"])
def test_gibbs_sound_at_min_kept_on_card(cuda_device, cell, seed):
    """Sound runs cut to ``min_kept`` kept iterations read correct: the
    lower readings of T_gap, a_ks and b_ks at the smallest window the
    check judges, printed as one JSON line each."""
    _, config, traffic, path = harness.resolve_cell(
        harness.load_manifest(), cell)
    run = harness.load_module(path).Run(config, traffic, seed, cuda_device,
                                        lambda what: None)
    _at_min_kept(run)
    checks, _, _ = run.check()
    print(json.dumps({"cell": cell, "fault": None, "seed": seed,
                      "checks": checks}))
    assert checks["kept_short"][0] == 0
    assert all(v <= lim for v, lim in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483701, 2147483702, 2147483703])
@pytest.mark.parametrize("fault", [_frozen, _a_frozen, _b_frozen,
                                   _half_chains])
@pytest.mark.parametrize("cell", ["gibbs.demo_c16k"])
def test_gibbs_fault_on_card(cuda_device, monkeypatch, cell, fault, seed):
    """The faults' readings at the cell's size and window (their upper
    readings of T_gap), printed as one JSON line each."""
    from libstb_tpu_torch.models import pyp
    from libstb_tpu_torch.samplers import hyper

    fault(pyp, hyper, monkeypatch)
    out = harness.run_cell(cell, seed, harness.load_manifest()["run_seconds"],
                           False, cuda_device, time.perf_counter())
    print(json.dumps({"cell": cell, "fault": fault.__name__, "seed": seed,
                      "checks": out["checks"]}))
    assert _failed_by_the_fault(out), out["checks"]
