"""The CTW cell (drivers/checkc.py) run whole on the CPU at a tiny mix, with
the look for a card skipped: sound, it reads correct; with the timed path
broken underneath, it reads not correct, by the check named for each
fault: the window left unshifted at the ends of [1, n], the semantics of
``ct_sweep(window)`` (``ctw_tv``); T left stale across the categories
(``invalid_chains``); each row reading another row's Gumbels
(``replay_t_differ``, which ``ctw_tv`` does not see: it builds its
conditional without the sweep); a move of a that returns its input
(``hyper_frozen``).  The control, the reference's grid in bfloat16,
reads not correct too, and so does the replay with the reference in
bfloat16 in the port's place.  A program without the CTW route over
relative candidates (the commit before the cell) fails at once, before
set-up.  The cell's two readers are read on a synthetic trace.  On the
card the faults' readings at the cell's own size are printed (``-m
cuda``).

The tiny mix: 6 groups x 150 items over DIM 5, a window of 3 (so that
the counts, 10-60, reach past both ends of it), 32 chains (all checked
and replayed: the unshifted window shows only in rows whose count sits
within 3 of an end, which 8 chains need not hold), a 3 s window, the
grid at 64 x 64, which ``ensure_grid`` grows where a count needs it."""
import json
import shutil
import time

import pytest
import torch

from benchmark import control, ctw_roofline, harness
from benchmark.tracing import TraceView

CPU = torch.device("cpu")
CELL = "checkc.ctw_maxdata_c8k"
TINY_CONFIG = {"groups": 6, "dim": 5, "items_per_group": 150, "window": 3,
               "b_groups": 6}
TINY_GRID = {"n": 64, "m": 64}
TINY_MIX = {"chains": 32, "burnin_iters": 20, "min_kept": 10, "chunk": 10,
            "check_chains": 32, "replay_chains": 32}


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

def _unshifted(pyp, hyper, monkeypatch):
    """t_i - w .. t_i + w as they are, the candidates outside [1, n]
    masked: ct_sweep(window)'s semantics."""
    monkeypatch.setattr(pyp, "_ctw_window", lambda ti, ni, window: (
        ti[:, None] + torch.arange(-window, window + 1,
                                   device=ti.device)[None]))


def _stale_t_total(pyp, hyper, monkeypatch):
    """The sweep hands back the T it was given: every category after the
    first reads the group's tables as they stood before the sweep."""
    real = pyp.ctw_sweep_rel

    def sweep(gen, t, T, *args, **kw):
        return real(gen, t, T, *args, **kw)[0], T
    monkeypatch.setattr(pyp, "ctw_sweep_rel", sweep)


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


def _gumbel_rows_shifted(pyp, hyper, monkeypatch):
    """Each (chain, group) reads the Gumbel row of the one before it."""
    monkeypatch.setattr(pyp, "rng",
                        _Draws(pyp.rng, lambda g: g.roll(1, dims=1)))


def _a_frozen(pyp, hyper, monkeypatch):
    monkeypatch.setattr(hyper, "sample_a",
                        lambda gen, a0, *args, **kw: (a0, None))


FAULTS = {_unshifted: "ctw_tv", _stale_t_total: "invalid_chains",
          _gumbel_rows_shifted: "replay_t_differ",
          _a_frozen: "hyper_frozen"}


def _apply(fault, monkeypatch):
    from libstb_tpu_torch.models import pyp
    from libstb_tpu_torch.samplers import hyper

    fault(pyp, hyper, monkeypatch)


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


REPLAY = ("replay_t_differ", "replay_move_gap")


def test_replay_bf16_control(bench, tmp_path):
    """The reference in bfloat16 in the port's place fails the replay:
    bfloat16 rounds the moves' log posteriors (~1e3 at 20 groups x 200
    items) by ~4, which parts most chains."""
    root = tmp_path / "benchmark"
    shutil.copytree(bench, root)
    cfg_path, mix_path = (root / p for p in _files(harness.load_manifest()))
    config = json.loads(cfg_path.read_text())
    config.update(groups=20, dim=20, items_per_group=200, b_groups=20)
    cfg_path.write_text(json.dumps(config))
    mix = json.loads(mix_path.read_text())   # a sample of the chains
    mix_path.write_text(json.dumps({**mix, "replay_chains": 8}))
    run, lim = _window(root, CPU, 1.0)
    got = dict(zip(REPLAY, run.replay(torch.bfloat16)))
    print(json.dumps(got))
    assert any(not got[k] <= lim[k] for k in REPLAY), got


def test_program_without_the_route_fails_before_setup(bench, monkeypatch):
    from libstb_tpu_torch.models import driver

    real = driver.run_gibbs_timed

    def timed(gen, data, grid, chains, a0, b0, cfg, iter_ms=None,
              burnin_ms=None, chunk=16, progress=None):
        return real(gen, data, grid, chains, a0, b0, cfg, iter_ms,
                    burnin_ms, chunk, progress)
    monkeypatch.setattr(driver, "run_gibbs_timed", timed)
    made = []
    monkeypatch.setattr("benchmark.datagen.crp_generate",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError):
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

def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


SHAPE = dict(chains=8192, groups=100, dim=20, occupied=2000, candidates=21)


def _view(keep=True):
    """Three iterations (300 us): each sweep launches two kernels (30 and
    10 us of device time, run after the span as the host runs ahead),
    the moves of the first launch one more; the third sweep's second
    kernel ran past the profiler's stop."""
    ev = [
        _x("ProfilerStep#21", "user_annotation", 1000, 100),
        _x("ProfilerStep#22", "user_annotation", 1100, 100),
        _x("ProfilerStep#23", "user_annotation", 1200, 100),
        _x("bench/ctw_sweep", "user_annotation", 1000, 20),
        _x("bench/sample_b", "user_annotation", 1030, 60),
        _x("bench/ctw_sweep", "user_annotation", 1100, 20),
        _x("bench/ctw_sweep", "user_annotation", 1200, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 1005, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1010, 2, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1040, 2, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 1105, 2, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 1110, 2, corr=5),
        _x("cudaLaunchKernel", "cuda_runtime", 1205, 2, corr=6),
        _x("cudaLaunchKernel", "cuda_runtime", 1210, 2, corr=7),
        _x("sweep_k1", "kernel", 1020, 30, corr=1),
        _x("sweep_k2", "kernel", 1050, 10, corr=2),
        _x("move_k", "kernel", 1060, 25, corr=3),
        _x("sweep_k1", "kernel", 1120, 30, corr=4),
        _x("sweep_k2", "kernel", 1150, 10, corr=5),
        _x("sweep_k1", "kernel", 1220, 30, corr=6)]
    v = TraceView(ev)
    if keep:
        v.events = ev
        v.ctw_shape = dict(SHAPE)
    return v


def test_readers():
    v = _view()
    assert ctw_roofline.sweep_device_s(v, "ctw_sweep") == pytest.approx(
        [40e-6, 40e-6, 30e-6])
    assert _reader("checkc.ctw_sweep_ms_per_iter").read(v) == pytest.approx(
        0.040)
    bound = ctw_roofline.sweep_bound_s(**SHAPE)
    assert bound == pytest.approx(
        ctw_roofline.CTW_FLOPS * 8192 * 2000 * 21 / 67e12)
    assert _reader("checkc.ctw_roofline").read(v) == pytest.approx(
        100 * bound / 40e-6)


def test_readers_find_nothing_without_raw_events():
    """A view without the raw events (another driver's) reads nothing."""
    v = _view(keep=False)
    assert _reader("checkc.ctw_sweep_ms_per_iter").read(v) is None
    assert _reader("checkc.ctw_roofline").read(v) is None


def test_bound_reads_bytes_where_they_dominate():
    """With one candidate of one occupied count the state's bytes bound."""
    got = ctw_roofline.sweep_bound_s(8192, 100, 20, 1, 1)
    assert got == pytest.approx(ctw_roofline.state_bytes(8192, 100, 20)
                                / 3.35e12)


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
