"""The port's utils: checkpoint round trip with the generator state,
resume equal to the straight run (bitwise, on the CPU), load onto an asked
device, device_timer and trace, and the program's spans: how they nest in
a traced run, and a traced run's outputs bitwise equal to an untraced
one's."""
import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from libstb_tpu_torch.core import agrid, rng, stirling
from libstb_tpu_torch.models import driver, pyp
from libstb_tpu_torch.utils import checkpoint, metrics

torch.set_num_threads(1)


def test_checkpoint_roundtrip(tmp_path):
    gen = rng.generator(7, "cpu")
    state = {"t": torch.arange(12, dtype=torch.int32).reshape(3, 4),
             "a": torch.tensor([0.5, 0.6], dtype=torch.float64),
             "b": torch.tensor([1.5], dtype=torch.float32),
             "hist": None,
             "pair": (torch.ones(2, dtype=torch.bool), [torch.zeros(1)]),
             "gen": gen}
    p = checkpoint.save(str(tmp_path / "ck"), state, meta={"iter": 42})
    assert p.endswith(".npz") and os.path.exists(p)
    assert json.load(open(p + ".json"))["meta"] == {"iter": 42}
    loaded, meta = checkpoint.load(p)
    assert meta == {"iter": 42} and set(loaded) == set(state)
    for k in ("t", "a", "b"):
        assert loaded[k].dtype == state[k].dtype
        assert torch.equal(loaded[k], state[k])
    assert loaded["hist"] is None
    assert isinstance(loaded["pair"], tuple)
    assert isinstance(loaded["pair"][1], list)
    assert torch.equal(loaded["pair"][0], state["pair"][0])
    # the generator round-trips: the same draws from here on
    assert loaded["gen"] is not gen
    np.testing.assert_array_equal(torch.rand(5, generator=loaded["gen"]),
                                  torch.rand(5, generator=gen))


def test_checkpoint_load_like_and_device(tmp_path):
    state = (torch.arange(6.0).reshape(2, 3), rng.generator(3, "cpu"))
    p = checkpoint.save(str(tmp_path / "ck2.npz"), state)
    assert p == str(tmp_path / "ck2.npz")
    for kw in ({"device": "cpu"}, {"like": state},
               {"like": state, "device": torch.device("cpu")}):
        (x, gen), meta = checkpoint.load(p, **kw)
        assert meta == {} and x.device.type == "cpu"
        assert torch.equal(x, state[0]) and gen.device.type == "cpu"
    with pytest.raises(ValueError, match="structure differs"):
        checkpoint.load(p, like=(state[0],))
    with pytest.raises(ValueError, match="cannot be loaded on"):
        checkpoint.load(p, device="meta")
    with pytest.raises(TypeError, match="cannot store"):
        checkpoint.save(str(tmp_path / "bad"), {"x": object()})


def _resume_case(sampler):
    data = pyp.crp_generate(0, 1, 12, 25, 0.5, 5.0)
    grid = agrid.make_grid(30, 27, g=32, dtype=torch.float64, device="cpu")
    cfg = driver.GibbsConfig(iters=40, burnin=1, bcycle=2, acycle=5,
                             sampler=sampler)
    return data, grid, cfg


@pytest.mark.parametrize("sampler", ["TI", "CT", "HSA"])
def test_resume_equals_straight_run(tmp_path, sampler):
    """k iterations, save the state and the generator, load, k more
    through the driver's chunk runner: the final t, T, (hist,) a, b equal
    the straight 2k run's bitwise (k a multiple of lcm(bcycle, acycle),
    so the cycle phases line up)."""
    data, grid, cfg = _resume_case(sampler)
    straight = driver.run_gibbs(rng.generator(0, "cpu"), data, grid, 8, 0.5,
                                5.0, cfg)
    grid, plan = driver._prepare(data, grid, cfg)
    gen = rng.generator(0, "cpu")
    half = dataclasses.replace(cfg, iters=cfg.iters // 2)
    out = driver._run_chunk(gen, data, grid,
                            driver._init(data, grid, 8, 0.5, 5.0, plan),
                            half, plan, 0)
    keys = ("t", "T", "hist", "a", "b")
    p = checkpoint.save(str(tmp_path / "run"),
                        {"state": {k: out[k] for k in keys}, "gen": gen},
                        meta={"iters_done": half.iters})
    del out, gen
    ck, meta = checkpoint.load(p)
    assert meta["iters_done"] == 20
    out = driver._run_chunk(ck["gen"], data, grid, ck["state"], half, plan,
                            0)
    for k in keys:
        if straight[k] is None:
            assert out[k] is None
            continue
        assert out[k].dtype == straight[k].dtype
        assert torch.equal(out[k], straight[k]), k


def test_device_timer_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    dt = metrics.device_timer(fn, torch.ones(64, 64), reps=2)
    assert dt > 0 and len(calls) == 3           # one warm call + 2 timed
    assert metrics.device_timer(lambda: None, reps=1) >= 1e-9


def test_trace_writes_a_chrome_trace(tmp_path):
    with metrics.trace(str(tmp_path / "prof")) as prof:
        torch.ones(32, 32).sum()
    assert any("sum" in e.name for e in prof.events())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def _stb_spans(logdir):
    """(name, start, end, thread) of every stb/ span in a trace's file."""
    with open(os.path.join(logdir, "trace.json")) as f:
        ev = json.load(f)["traceEvents"]
    return [(e["name"][len("stb/"):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]), e["tid"]) for e in ev
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("stb/")]


def _parents(spans):
    """Each span with the name of the innermost other span on its thread
    that holds it (None at the top)."""
    out = []
    for i, (name, t0, t1, tid) in enumerate(spans):
        holding = [(b - a, n) for k, (n, a, b, th) in enumerate(spans)
                   if k != i and th == tid and a <= t0 and t1 <= b]
        out.append((name, min(holding)[1] if holding else None))
    return out


def test_span_is_a_shared_noop_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    off = metrics.span("ti.step")
    assert off is metrics.span("make") and off.__enter__() is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = metrics.span("ti.step")
        assert isinstance(on, torch.profiler.record_function)
        assert on.name == "stb/ti.step"
    assert metrics.span("ti.step") is off


_GIBBS = driver.GibbsConfig(iters=3, burnin=1, bcycle=1, acycle=1)


def _gibbs(traced_dir=None, timed=False):
    data = pyp.from_counts(np.array([[3, 1, 0, 2], [0, 4, 1, 1]]))
    grid = agrid.make_grid(30, 27, g=16, dtype=torch.float64, device="cpu")
    run, kw = ((driver.run_gibbs_timed, {"chunk": 2}) if timed
               else (driver.run_gibbs, {}))
    with (metrics.trace(traced_dir) if traced_dir
          else contextlib.nullcontext()):
        return data, run(rng.generator(5, "cpu"), data, grid, 4, 0.5, 5.0,
                         _GIBBS, **kw)


@pytest.fixture(scope="module")
def traced_gibbs(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("gibbs_trace"))
    data, out = _gibbs(logdir)
    return data, out, _stb_spans(logdir)


def test_traced_gibbs_spans_nest(traced_gibbs):
    """TI, bcycle = acycle = 1: every iteration sweeps and moves b and a;
    S ti.step spans a sweep, a read or more a slice move."""
    data, _, spans = traced_gibbs
    want = {"driver.iter": {None}, "ti.sweep": {"driver.iter"},
            "ti.prepare": {"ti.sweep"}, "ti.step": {"ti.sweep"},
            "hyper.sample_b": {"driver.iter"},
            "hyper.sample_a": {"driver.iter"},
            "hyper.curve": {"hyper.sample_a"},
            "slice.move": {"hyper.sample_a", "hyper.sample_b"},
            "slice.read": {"slice.move"}}
    got = _parents(spans)
    assert {n for n, _ in got} == set(want)
    for name, parent in got:
        assert parent in want[name], (name, parent)
    names = [n for n, *_ in spans]
    S = pyp.ti_schedule(data, "group").shape[0]
    iters = _GIBBS.iters
    assert names.count("driver.iter") == names.count("ti.sweep") == iters
    assert names.count("ti.prepare") == iters
    assert names.count("ti.step") == S * iters
    assert names.count("hyper.sample_a") == names.count("hyper.curve")
    assert names.count("hyper.sample_a") == names.count(
        "hyper.sample_b") == iters
    assert names.count("slice.move") == 2 * iters
    moves = [(a, b) for n, a, b, _ in spans if n == "slice.move"]
    reads = [a for n, a, _, _ in spans if n == "slice.read"]
    for a, b in moves:
        assert any(a <= r <= b for r in reads)


def test_traced_gibbs_equals_untraced(traced_gibbs):
    _, traced, _ = traced_gibbs
    _, plain = _gibbs()
    assert set(traced) == set(plain)
    for k, v in plain.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == traced[k].dtype
            assert torch.equal(v, traced[k]), k


def test_traced_timed_gibbs_chunk_end(tmp_path):
    """run_gibbs_timed: one chunk_end span a chunk on the clock, after
    its iterations; the outputs equal the untraced run's."""
    logdir = str(tmp_path / "prof")
    _, traced = _gibbs(logdir, timed=True)
    _, plain = _gibbs(timed=True)
    spans = _stb_spans(logdir)
    names = [n for n, *_ in spans]
    # chunks of 2: one off the clock, then iters / 2 on it
    assert names.count("driver.chunk_end") == -(-_GIBBS.iters // 2)
    assert names.count("driver.iter") == 2 + traced["iters_done"]
    assert dict(_parents(spans))["driver.chunk_end"] is None
    for k in ("t", "T", "a", "b", "tave", "Tave", "aave", "bave"):
        assert torch.equal(traced[k], plain[k]), k


@pytest.mark.parametrize("dtype,n", [(torch.float32, 300),
                                     (torch.float64, 300)])
def test_traced_make_spans_and_equal(tmp_path, dtype, n):
    """make: launch, then the S1 pair and its copies inside; the table
    equal to an untraced make's."""
    def build():
        tab = stirling.make(n, 40, n, 40, 0.4, dtype=dtype, device="cpu")
        return stirling.remake(tab, 0.6)

    logdir = str(tmp_path / "prof")
    with metrics.trace(logdir):
        traced = build()
    plain = build()
    got = _parents(_stb_spans(logdir))
    assert sorted(got, key=str) == sorted(
        [("make", None), ("make.launch", "make"), ("make.s1", "make"),
         ("make.s1_upload", "make.s1")] * 2, key=str)
    for f in ("a", "lga1", "s1_hi", "s1_lo", "vtab", "srel"):
        assert torch.equal(getattr(traced, f), getattr(plain, f)), f


def test_traced_s1_anchored_upload(tmp_path):
    """The anchored S1 pair (make's route on a card) copies its anchors
    inside make.s1_upload; traced equal to untraced."""
    logdir = str(tmp_path / "prof")
    with metrics.trace(logdir):
        traced = stirling.s1_anchored(0.5, 1 << 10, device="cpu")
    plain = stirling.s1_anchored(0.5, 1 << 10, device="cpu")
    assert [n for n, *_ in _stb_spans(logdir)] == ["make.s1_upload"]
    for x, y in zip(traced, plain):
        assert torch.equal(x, y)
