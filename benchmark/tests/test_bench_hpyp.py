"""The HPYP cell (drivers/hpyp.py) run whole on the CPU at a tiny mix, with
the look for a card skipped: sound, it reads correct; with the timed path
broken underneath, it reads not correct, by the check named for each
fault: the level-1 base H in place of the predictive p0 (``ct1_tv``), a
level-0 sweep handed the counts of the iteration before
(``invalid_chains``), a move of b1 that returns its input
(``hyper_frozen``), a grid left at its start size, so that the level-0
counts beyond it read the asymptote (``ct0_tv``); inside ``ct_sweep``
the argmax without its Gumbels, each row reading another row's Gumbels,
the per-chain base dropped (``replay_t1_differ``, which ``ct1_tv`` does
not see: it builds its conditional without ``ct_sweep``); a1's move
aimed at the wrong posterior (``replay_move_gap``).  The control, the
reference's grid in bfloat16, reads not correct too, and so does the
replay with the reference in bfloat16 in the port's place.  A program without
``run_hpyp_timed`` (the commit before the cell) fails at once, before
set-up.  The cell's five readers are read on a synthetic trace.  On the
card the faults' readings at the cell's own size are printed (``-m
cuda``).

The tiny mix: 6 groups x 40 items over DIM 5, 32 chains (all replayed),
a 3 s window, the grid started at 16 x 16.  The grid's limits hold there as
they are (the CPU fills the grid by the plain fill, not K1); ``ct0_tv``
has a limit of its own, 0.05: with six groups the level-0 discount's
posterior is broad and reaches toward the sampler's bound 0.98, where the
grid's cubic in a is coarsest, and sound runs read up to 1.3e-2 (the
cell's runs read 2.6e-5).  With a conditional that far off, one of the
replay's 160 level-0 counts may differ (0.6%), so ``replay_t0_differ``
has 0.1 there (the cell 0.01 over 640 counts)."""
import json
import shutil
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tracing import TraceView

CPU = torch.device("cpu")
CELL = "hpyp.maxdata_c512"
TINY_CONFIG = {"groups": 6, "dim": 5, "items_per_group": 40}
TINY_GRID = {"n": 16, "m": 16, "max_n": 512, "max_m": 512}
TINY_MIX = {"chains": 32, "burnin_iters": 20, "min_kept": 10, "chunk": 5,
            "replay_chains": 32,
            "limits": {"ct1_tv": 0.001, "ct0_tv": 0.05,
                       "replay_t1_differ": 0.001, "replay_t0_differ": 0.1,
                       "replay_move_gap": 0.001}}


def _files(man):
    w = next(w for w in man["workloads"] if w["name"] == CELL)
    return (f"configs/{w['config']}.json", f"traffic/{w['traffic']}.json")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench") / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg_path, mix_path = (root / p for p in _files(harness.load_manifest()))
    config = json.loads(cfg_path.read_text())
    config.update(TINY_CONFIG)
    config["grid"].update(TINY_GRID)
    cfg_path.write_text(json.dumps(config))
    mix = json.loads(mix_path.read_text())
    mix.update(TINY_MIX)
    mix_path.write_text(json.dumps(mix))
    # one thread: the windows are wall-clock, and several test processes
    # each taking every core starve them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield root
    torch.set_num_threads(threads)


def _run(bench, seconds=3.0, seed=2147483999):
    return harness.run_cell(CELL, seed, seconds, False, CPU,
                            time.perf_counter(), bench_dir=bench)


def test_sound(bench):
    out = _run(bench)
    print(json.dumps(out["checks"]))
    assert out["correct"], out["checks"]
    assert out["attempted"] == 32 and out["failed"] == 0
    assert set(out["metrics"]) == {"gibbs_updates_per_s", "setup_s"}


# -- the faults --------------------------------------------------------------

def _base_h(hpyp, pyp, hyper, monkeypatch):
    monkeypatch.setattr(hpyp, "_predictive",
                        lambda n0, t0, T0, a0, b0, H:
                        H[None].expand(n0.shape).to(a0.dtype))


def _stale_n0(hpyp, pyp, hyper, monkeypatch):
    real = hpyp._level0
    before = []

    def level0(gen, t1, *args, **kw):
        stale = before[-1] if before else t1
        before.append(t1)
        return real(gen, stale, *args, **kw)
    monkeypatch.setattr(hpyp, "_level0", level0)


def _b1_frozen(hpyp, pyp, hyper, monkeypatch):
    real = hyper.sample_b

    def sample_b(gen, b0, N, *args, **kw):
        if N.ndim == 1:                       # level 1's group totals
            return b0, None
        return real(gen, b0, N, *args, **kw)
    monkeypatch.setattr(hyper, "sample_b", sample_b)


def _not_grown(hpyp, pyp, hyper, monkeypatch):
    from libstb_tpu_torch.core import agrid

    monkeypatch.setattr(agrid, "ensure_grid", lambda grid, n, m, **kw: grid)


class _Draws:
    """``core/rng`` as ``models/pyp`` sees it, its Gumbel blocks drawn as
    the real module draws them (so the replay records them) and then
    altered by ``alter`` before the sweep reads them."""

    def __init__(self, real, alter):
        self._real, self._alter = real, alter

    def __getattr__(self, name):
        return getattr(self._real, name)

    def gumbel(self, *args, **kw):
        return self._alter(self._real.gumbel(*args, **kw))


def _no_gumbels(hpyp, pyp, hyper, monkeypatch):
    """ct_sweep's category loop takes the argmax of the log weights
    alone."""
    monkeypatch.setattr(pyp, "rng", _Draws(pyp.rng, torch.zeros_like))


def _gumbel_rows_shifted(hpyp, pyp, hyper, monkeypatch):
    """Each (chain, group) reads the Gumbel row of the one before it."""
    monkeypatch.setattr(pyp, "rng",
                        _Draws(pyp.rng, lambda g: g.roll(1, dims=1)))


def _h_arr_ignored(hpyp, pyp, hyper, monkeypatch):
    """ct_sweep drops the per-chain base: level 1 draws over H, not p0."""
    real = pyp.ct_sweep
    monkeypatch.setattr(pyp, "ct_sweep",
                        lambda *args, H_arr=None, **kw: real(*args, **kw))


def _a1_wrong_target(hpyp, pyp, hyper, monkeypatch):
    """a1's move targets its posterior at ten times b1."""
    real = hyper.sample_a

    def sample_a(gen, a0, grid, ns, ts, T, b, **kw):
        if ns.ndim == 1:                      # level 1's shared pairs
            b = 10 * b
        return real(gen, a0, grid, ns, ts, T, b, **kw)
    monkeypatch.setattr(hyper, "sample_a", sample_a)


FAULTS = {_base_h: "ct1_tv", _stale_n0: "invalid_chains",
          _b1_frozen: "hyper_frozen", _not_grown: "ct0_tv",
          _no_gumbels: "replay_t1_differ",
          _gumbel_rows_shifted: "replay_t1_differ",
          _h_arr_ignored: "replay_t1_differ",
          _a1_wrong_target: "replay_move_gap"}


def _apply(fault, monkeypatch):
    from libstb_tpu_torch.models import hpyp, pyp
    from libstb_tpu_torch.samplers import hyper

    fault(hpyp, pyp, hyper, monkeypatch)


@pytest.mark.parametrize("fault", list(FAULTS), ids=lambda f: f.__name__)
def test_fault(bench, monkeypatch, fault):
    _apply(fault, monkeypatch)
    out = _run(bench)
    print(json.dumps(out["checks"]))
    value, limit = out["checks"][FAULTS[fault]]
    assert not out["correct"] and not value <= limit, out["checks"]


def test_bf16_control(bench):
    cfg_path, mix_path = (bench / p for p in _files(harness.load_manifest()))
    out = control.control(json.loads(cfg_path.read_text()),
                          json.loads(mix_path.read_text()), 1, CPU)
    assert not out["correct"], out
    assert any(v > lim for v, lim in out["checks"].values())


def _window(root, device, seconds, seed=2147483999):
    """A run of the cell through its window, the check not yet made."""
    _, config, traffic, path = harness.resolve_cell(
        harness.load_manifest(), CELL, root)
    run = harness.load_module(path).Run(config, traffic, seed, device,
                                        lambda what: None)
    run.window(seconds)
    return run, {**config.get("limits", {}), **traffic.get("limits", {})}


REPLAY = ("replay_t1_differ", "replay_t0_differ", "replay_move_gap")


def test_replay_bf16_control(bench, tmp_path):
    """The reference in bfloat16 in the port's place fails the replay.  At
    the tiny mix bfloat16 rounds the log weights by ~0.1 and the reading
    may stay under; at 20 groups x 200 items over DIM 20 the moves' log
    posteriors (~1e3, rounded by ~4) part most chains: the move gap read
    0.184-0.307 on three seeds (limit 1e-3)."""
    root = tmp_path / "benchmark"
    shutil.copytree(bench, root)
    cfg_path, mix_path = (root / p for p in _files(harness.load_manifest()))
    config = json.loads(cfg_path.read_text())
    config.update(groups=20, dim=20, items_per_group=200)
    cfg_path.write_text(json.dumps(config))
    mix = json.loads(mix_path.read_text())   # a sample of the chains
    mix_path.write_text(json.dumps({**mix, "replay_chains": 8}))
    run, lim = _window(root, CPU, 1.0)
    got = dict(zip(REPLAY, run.replay(torch.bfloat16)))
    print(json.dumps(got))
    assert any(not got[k] <= lim[k] for k in REPLAY), got


def test_program_without_the_timed_run_fails_before_setup(bench,
                                                          monkeypatch):
    from libstb_tpu_torch.models import hpyp

    monkeypatch.delattr(hpyp, "run_hpyp_timed")
    made = []
    monkeypatch.setattr("benchmark.datagen.crp_generate",
                        lambda *a, **k: made.append(a))
    with pytest.raises(AttributeError):
        _run(bench)
    assert not made


def test_short_window_is_not_correct(bench, tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(bench, root)
    mix_path = root / _files(harness.load_manifest())[1]
    mix = json.loads(mix_path.read_text())
    mix_path.write_text(json.dumps({**mix, "min_kept": 10 ** 6}))
    out = _run(root, 1.0)
    assert not out["correct"] and out["checks"]["kept_short"][0] > 0


# -- the readers --------------------------------------------------------------

def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


def test_readers():
    """Two iterations (200 us): level 1, level 0 each, the moves in the
    first; busy 1010-1040 and 1150-1160 of the window."""
    v = TraceView([
        _x("ProfilerStep#21", "user_annotation", 1000, 100),
        _x("ProfilerStep#22", "user_annotation", 1100, 100),
        _x("bench/hpyp_level1", "user_annotation", 1000, 50),
        _x("bench/ct_srel", "user_annotation", 1001, 20),
        _x("bench/hpyp_level0", "user_annotation", 1050, 20),
        _x("bench/hpyp_hyper", "user_annotation", 1070, 30),
        _x("bench/hpyp_level1", "user_annotation", 1100, 40),
        _x("bench/hpyp_level0", "user_annotation", 1140, 30),
        _x("k1", "kernel", 1010, 20), _x("k2", "kernel", 1020, 20),
        _x("memset", "gpu_memset", 1150, 10),
        _x("early", "kernel", 900, 50)])
    assert _reader("hpyp.launches_per_iter").read(v) == 1.5
    assert _reader("hpyp.level1_ms_per_iter").read(v) == pytest.approx(0.045)
    assert _reader("hpyp.level0_ms_per_iter").read(v) == pytest.approx(0.025)
    assert _reader("hpyp.hyper_ms_per_iter").read(v) == pytest.approx(0.015)
    assert _reader("device_idle_pct.hpyp").read(v) == pytest.approx(80.0)


# -- on the card, at the cell's own size --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483801, 2147483802])
def test_replay_bf16_control_on_card(cuda_device, seed):
    """The control's replay readings at the cell's size, one JSON line a
    seed: the upper readings of the replay's limits."""
    run, lim = _window(harness.HERE, cuda_device, 5.0, seed)
    got = dict(zip(REPLAY, run.replay(torch.bfloat16)))
    print(json.dumps({"cell": CELL, "control": "bfloat16", "seed": seed,
                      "replay": got}))
    assert any(not got[k] <= lim[k] for k in REPLAY), got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483801])
@pytest.mark.parametrize("fault", list(FAULTS), ids=lambda f: f.__name__)
def test_fault_on_card(cuda_device, monkeypatch, fault, seed):
    """The faults' readings at the cell's size and window, printed as one
    JSON line each: the upper readings of the limits."""
    _apply(fault, monkeypatch)
    out = harness.run_cell(CELL, seed, harness.load_manifest()["run_seconds"],
                           False, cuda_device, time.perf_counter())
    print(json.dumps({"cell": CELL, "fault": fault.__name__, "seed": seed,
                      "checks": out["checks"]}))
    value, limit = out["checks"][FAULTS[fault]]
    assert not out["correct"] and not value <= limit, out["checks"]
