"""The port's utils: checkpoint round trip with the generator state,
resume equal to the straight run (bitwise, on the CPU), load onto an asked
device, device_timer and trace (Meter's copy: tests/test_torch_package.py)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from libstb_tpu_torch.core import agrid, rng
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
