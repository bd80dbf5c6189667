"""The probes of the card's floors (ops/vpu_probe_cuda.py, csrc/vpu_probe.cu,
tools/vpu_probe_torch.py) held to the JAX probes of tools/vpu_probe.py.

The JAX tool is imported as it is; its module's ``pl`` is swapped for a
shim whose ``pallas_call`` runs in interpret mode and records the kernel's
outputs, and each probe runs under ``jax.disable_jit()`` at a tiny shape.
The TPU's (M, H, S, 128) outputs are the port's (m, n) tables with n = H
S 128; its grid step j is the port's column j (P1, P4) or, for the
issue-rate and scratch probes, whose output is the last step's, the
threads t with t % 3 == j % 3 (the seed c = 1 + (j % 3) 1e-6).  The
kernels themselves run on a card only (marker ``cuda``); chip_smoke.py's
phase 19 holds them to these plain versions there.
"""
import json
import math
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libstb_tpu_torch.ops import _nvcc
from libstb_tpu_torch.ops import stirling_cuda as sc
from libstb_tpu_torch.ops import vpu_probe_cuda as vp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import vpu_probe as jvp  # noqa: E402  the JAX tool, unedited
import vpu_probe_torch as tool  # noqa: E402

torch.set_num_threads(1)

STEPS = 3                      # the JAX probes' grid: its last step j = 2
F32_ULP = 2.0 ** -23


@pytest.fixture
def jax_probe(monkeypatch):
    """run(fn, *lead, raises=None, **kw): a JAX probe of tools/vpu_probe.py
    in interpret mode, ``lead`` its arguments before the overhead
    (``raises``: the exception its timing code ends in);
    returns the outputs of its last pallas_call as numpy arrays."""
    outs = []

    def pallas_call(*args, **kw):
        call = pl.pallas_call(*args, interpret=True, **kw)

        def run(*xs):
            out = call(*xs)
            outs.append(out)
            return out
        return run

    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("__")})
    shim.pallas_call = pallas_call
    monkeypatch.setattr(jvp, "pl", shim)

    def run(fn, *lead, raises=None, **kw):
        with jax.disable_jit():
            if raises is None:
                fn(*lead, 0.0, **kw)
            else:
                with pytest.raises(raises):
                    fn(*lead, 0.0, **kw)
        last = outs[-1]
        return ([np.asarray(x) for x in last]
                if isinstance(last, (list, tuple)) else np.asarray(last))
    return run


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probes have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# -- P1 -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "piecewise", "onecol"])
def test_write_floor_matches_jax(jax_probe, mode):
    """V exactly: the per-column constants, and for piecewise the
    sub-stores' recurrence acc 0.9999 + 1e-5 (u = 2 slabs of (2, 128) =
    512 rows), one f32 FMA as XLA's CPU evaluation carries it.  Srel
    exactly, but piecewise: its acc + 1 is V + 1 in the port, while XLA
    forms that acc again unfused, so 1 f32 ulp apart where the product
    rounds a tie (3 x 0.9999).  The JAX tool's onecol timing indexes its
    one-output list as an array (tools/vpu_probe.py:111-114) and raises
    after the kernel ran, so its V is the shim's record."""
    m, h, s, u = 3, 8, 2, 2
    out = jax_probe(jvp.write_floor, raises=TypeError if mode == "onecol"
                    else None, m=m, h=h, s=s, k=1, mode=mode, u=u)
    want_v, want_s = vp.write_floor_ref(m, h * s * 128, mode,
                                        piece=u * s * 128)
    np.testing.assert_array_equal(out[0].reshape(m, -1), want_v.numpy())
    if mode == "onecol":
        assert len(out) == 1 and want_s is None
        return
    np.testing.assert_allclose(out[1].reshape(m, -1), want_s.numpy(),
                               rtol=F32_ULP if mode == "piecewise" else 0,
                               atol=0)
    assert torch.equal(want_s, want_v + 1)
    if mode == "piecewise":
        assert want_v[0, 511] == 1.0 and want_v[0, 512] < 1.0


@pytest.mark.parametrize("n,piece", [(1000, 300), (4096, 32768), (97, 32)])
def test_write_floor_ref_pieces(n, piece):
    """A piece's value holds from its first row to the next piece's, the
    last piece cut by n; Srel = V + 1; full and onecol are constant."""
    v, s = vp.write_floor_ref(9, n, "piecewise", piece)
    assert v.shape == s.shape == (9, n) and v.dtype == torch.float32
    torch.testing.assert_close(s, v + 1, rtol=0, atol=0)
    for p in range(0, n, piece):
        block = v[:, p:p + piece]
        assert torch.equal(block, block[:, :1].expand_as(block))
    assert torch.equal(v[:, 0], 1 + (torch.arange(9) % 7).float())
    full_v, full_s = vp.write_floor_ref(9, n, "full")
    assert torch.equal(full_s, full_v + 1) and torch.equal(
        full_v[:, -1], v[:, 0])
    assert vp.write_floor_ref(9, n, "onecol")[1] is None


# -- P2 -------------------------------------------------------------------------

def _source_threads(op, threads, steps):
    """The thread whose stream each entry holds after ``steps`` steps: its
    own, or for roll the lane ``steps`` ahead within its warp."""
    t = np.arange(threads)
    if op != "roll":
        return t
    return t - t % 32 + (t % 32 + steps) % 32


def _bf16_recip_orbit(u, steps, c):
    """pl.reciprocal(approx=True) off the TPU: the f32 reciprocal of its
    input rounded to bf16 (jax/_src/pallas/primitives.py)."""
    xs = [torch.tensor(vp.X0 + vp.DX * i, dtype=torch.float32) * c
          for i in range(u)]
    for _ in range(steps):
        xs = [1 / x.to(torch.bfloat16).float() for x in xs]
    return sum(xs[1:], xs[0]).item()


def _folded_mul_orbit(u, steps, c):
    """The JAX probe's mul chain as its interpret mode evaluates it on the
    CPU: each stream x (1.0000001f)^steps, rounded to f32 once, not at
    every step."""
    mul = np.float64(np.float32(1.0000001)) ** steps
    xs = [np.float32(np.float64(np.float32(vp.X0 + vp.DX * i) * c) * mul)
          for i in range(u)]
    return sum(xs[1:], xs[0])


@pytest.mark.parametrize("op", vp.ALU_OPS[torch.float32])
def test_alu_matches_jax(jax_probe, op):
    """Each f32 op's sum of 2 streams after 2 x 2 steps: within 1e-6
    relative (the CPU's f32 log and divide in both).  The approximate
    reciprocal: JAX's interpret mode rounds each step's input to bf16
    (exactly _bf16_recip_orbit), 2^-9 relative a step, so the port's
    orbit (the card's rcp.approx, ~1 ulp; plain: 1/x) is within 4 x 2^-9
    of it.  mul runs 8 x 8 steps, so that its drift is well past the
    tolerance: JAX's interpret mode rounds the chain once (exactly
    _folded_mul_orbit), the port at every step, as the card does, half an
    f32 ulp (2^-24 relative at x >= 1) a step at most, while the orbit
    moves 1.0000001f - 1 = 2^-23 a step: a plain version that skipped the
    steps would miss by twice the tolerance.  roll: the JAX probe rotates
    a uniform tile, so this case holds only the sum;
    test_alu_roll_ref_rotates_lanes holds the rotation."""
    u, r, unroll = (2, 8, 8) if op == "mul" else (2, 2, 2)
    out = jax_probe(jvp.alu_kernel, op, u=u, r=r, unroll=unroll,
                    steps=STEPS, k=1)
    assert np.all(out == out.flat[0])
    got = vp.alu_ref(op, torch.float32, u, r, unroll, threads=64).numpy()
    src = _source_threads(op, 64, r * unroll)
    pick = got[src % 3 == (STEPS - 1) % 3]
    rtol = 1e-6
    if op == "recip":
        c = 1 + torch.tensor(float((STEPS - 1) % 3)) * vp.EPS
        assert out.flat[0] == _bf16_recip_orbit(u, r * unroll, c)
        rtol = r * unroll * 2.0 ** -9
    if op == "mul":
        c = np.float32(1) + np.float32((STEPS - 1) % 3) * np.float32(vp.EPS)
        assert out.flat[0] == _folded_mul_orbit(u, r * unroll, c)
        rtol = r * unroll * 2.0 ** -24
        start = vp.alu_ref(op, torch.float32, u, 0, unroll, threads=64)
        moved = (got / start.numpy() - 1)[src % 3 == (STEPS - 1) % 3]
        assert np.all(moved > 1.5 * rtol)
    np.testing.assert_allclose(pick, out.flat[0], rtol=rtol, atol=0)


@pytest.mark.parametrize("steps", [1, 5, 31, 32, 37])
def test_alu_roll_ref_rotates_lanes(steps):
    """The plain roll against numpy's rotation of lanes that differ (the
    seed 1 + (t % 3) EPS has no period that divides 32, so a warp's
    rotation by s is the identity only for s % 32 == 0): lane l holds lane
    (l + steps) % 32's streams."""
    u, threads = 3, 64
    got = vp.alu_ref("roll", torch.float32, u, 1, steps, threads)
    start = vp.alu_ref("roll", torch.float32, u, 0, 1, threads).numpy()
    want = np.roll(start.reshape(-1, 32), -steps, axis=1).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    if steps % 32:
        assert not np.array_equal(got.numpy(), start)


@pytest.mark.parametrize("op,dtype", [
    (op, d) for d, ops in vp.ALU_OPS.items() for op in ops])
def test_alu_period(op, dtype):
    """Thread t of a larger grid holds thread t % ALU_PERIOD's sum: the
    tool holds a full wave to a plain version of ALU_PERIOD threads."""
    threads = 4 * vp.ALU_PERIOD + 64
    big = vp.alu_ref(op, dtype, 2, 1, 5, threads)
    small = vp.alu_ref(op, dtype, 2, 1, 5, vp.ALU_PERIOD)
    assert torch.equal(big, small[torch.arange(threads) % vp.ALU_PERIOD])


def _numpy_orbit(op, u, steps, threads):
    t = np.arange(threads)
    c = 1 + (t % 3).astype(np.float64) * vp.EPS
    x = np.stack([np.float64(vp.X0 + vp.DX * i) * c for i in range(u)])
    for _ in range(steps):
        if op == "fma":
            x = x * 0.5 + 0.75
        elif op == "mul":
            x = x * 1.0000001
        elif op in ("div", "div_pos"):
            x = (x + 1) / x
        elif op in ("log", "log_pos"):
            x = np.log(x) + 1.54
        else:                                   # shfl: from lane l - 1
            w = x.reshape(u, -1, 32)
            x = np.concatenate([w[..., :1], w[..., :-1]], 2).reshape(u, -1)
    acc = x[0]
    for i in range(1, u):
        acc = acc + x[i]
    return acc


@pytest.mark.parametrize("op", vp.ALU_OPS[torch.float64])
def test_alu_f64_orbits_match_numpy(op):
    """The f64 ops' plain orbits against numpy: exact for the FMA, mul,
    divide and shuffle, 1e-15 relative for the log (two libm's)."""
    for u in vp.ALU_U.get(op, (8,)):
        got = vp.alu_ref(op, torch.float64, u, 3, 8, threads=96).numpy()
        want = _numpy_orbit(op, u, 24, 96)
        np.testing.assert_allclose(got, want, atol=0,
                                   rtol=1e-15 if "log" in op else 0)
        assert np.all(np.isfinite(got)) and np.all(got > 0)


def test_alu_orbits_stay_in_range():
    """The orbits are contractive or of period 2: fma to 1.5 a stream, div
    to the golden ratio, log to the fixed point of log x + 1.54, recip
    back to its start after an even count, shfl to lane 0's stream."""
    sums = {op: vp.alu_ref(op, torch.float64, 8, 32, 8, threads=64)
            for op in ("fma", "div", "log")}
    assert torch.allclose(sums["fma"], torch.full((64,), 12.0, dtype=torch.float64))
    phi = (1 + 5 ** 0.5) / 2
    assert torch.allclose(sums["div"], torch.full((64,), 8 * phi,
                                                  dtype=torch.float64))
    fp = sums["log"][0] / 8
    assert abs(float(torch.log(fp) + 1.54 - fp)) < 1e-12
    rec = vp.alu_ref("recip", torch.float32, 8, 1, 8, threads=32)
    start = vp.alu_ref("fma", torch.float32, 8, 0, 8, threads=32)
    torch.testing.assert_close(rec, start, rtol=1e-6, atol=0)
    sh = vp.alu_ref("shfl", torch.float64, 8, 4, 8, threads=64)
    assert torch.equal(sh[:32], sh[:1].expand(32)) and torch.equal(
        sh[32:], sh[32:33].expand(32))


# -- P3 -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", vp.SMEM_MODES)
def test_smem_matches_jax(jax_probe, mode):
    """The accumulator after one pass over 4 rows, exactly: the TPU's h = 4
    slabs a step are a thread's k = 4 rows; loads read the zeroed state,
    stores carry acc."""
    h = 4
    out = jax_probe(jvp.vmem_kernel, mode, h=h, s=8, steps=STEPS, k=1, u=2)
    assert np.all(out == out.flat[0])
    got = vp.smem_ref(mode, torch.float32, chunk=h * vp.ROW_THREADS,
                      steps=1, blocks=1).numpy()
    pick = got[np.arange(got.size) % 3 == (STEPS - 1) % 3]
    np.testing.assert_array_equal(pick, np.full_like(pick, out.flat[0]))


# -- P4 -------------------------------------------------------------------------

@pytest.mark.parametrize("iters,ulps", [(200, 0), (16, 4)])
def test_overlap_matches_jax(jax_probe, iters, ulps):
    """V = acc_j and Srel = acc_j + 1 of column j.  At 200 steps both
    chains sit at their fixed point (4 x 1.5) and agree exactly; at 16 the
    port's f64 chain, rounded once to f32, is within 4 f32 ulps of the
    TPU's f32 chain, rounded at each of its steps and sums."""
    m, h, s = 3, 4, 2
    v, srel = jax_probe(jvp.overlap_probe, m=m, h=h, s=s, k=1,
                        alu_iters=iters)
    want_v, want_s = vp.overlap_ref(m, h * s * 128, iters)
    for got, want in ((v, want_v), (srel, want_s)):
        np.testing.assert_allclose(got.reshape(m, -1), want.numpy(), atol=0,
                                   rtol=ulps * F32_ULP)
    if iters == 200:
        assert np.all(v == 6.0) and np.all(srel == 7.0)


def test_overlap_ref_chains_alone():
    """Without the stores each row thread sums acc_j over its block's
    chunks and columns: two chunks for the first blocks past one wave."""
    n, m, sms = 40000, 3, 2
    plan = sc.cols_plan(n, m, sms)
    assert plan.chunks == 5 and plan.blocks == 2
    sink = vp.overlap_ref(m, n, 16, store=False, sms=sms)
    assert sink.shape == (plan.blocks * vp.ROW_THREADS,)
    col = vp.overlap_ref(m, n, 16)[0][:, 0].double()
    per = [sink[b * vp.ROW_THREADS].item() for b in range(plan.blocks)]
    chunks = [len(range(b, plan.chunks, plan.blocks)) for b in range(2)]
    assert chunks == [3, 2]
    for b in range(2):
        assert per[b] == pytest.approx(chunks[b] * float(col.sum()),
                                       rel=1e-6)


# -- P5 / P6 ----------------------------------------------------------------------

MIX_SHAPE = dict(m=3, h=16, s=1, u=8)   # 2048 rows in 2 pieces of 1024
FLAG_CASES = {**{f: {f: True} for f in vp.TPU_STEPS},
              "all": {f: True for f in vp.TPU_STEPS}}


def _mix_kw(h=16):
    return dict(MIX_SHAPE, h=h, k=1)


def _port_mix(steps=(), h=16, mode="mix"):
    """The port's f32 plain version at the JAX probe's shape: n = h s 128,
    the TPU's sub-store of u slabs its piece, its slab s 128."""
    m, s, u = MIX_SHAPE["m"], MIX_SHAPE["s"], MIX_SHAPE["u"]
    return vp.bisect_ref(m, h * s * 128, steps, torch.float32,
                         piece=u * s * 128, slab=s * 128)


@pytest.mark.parametrize("mode", vp.MIX_MODES)
def test_mix_matches_jax(jax_probe, mode):
    """V and Srel exactly, both modes (staged copies the same values): the
    state step state 0.999 + acc is one f32 FMA as XLA evaluates the
    kernel on the CPU (test_mix_state_step_is_one_fma), acc the pieces'
    FMA recurrence, Srel = V + 1 in f32."""
    v, srel = jax_probe(jvp.mix_floor, mode=mode, **_mix_kw())
    want_v, want_s = vp.mix_ref(3, 2048, torch.float32, piece=1024)
    got = _port_mix()
    assert torch.equal(want_v, got.v) and torch.equal(want_s, got.srel)
    np.testing.assert_array_equal(v.reshape(3, -1), want_v.numpy())
    np.testing.assert_array_equal(srel.reshape(3, -1), want_s.numpy())
    assert want_v[2, 0] != want_v[2, 1024]          # the pieces differ


@pytest.mark.parametrize("flags", list(FLAG_CASES))
def test_bisect_matches_jax(jax_probe, flags):
    """Each TPU flag alone and all of them, exactly (tolerance 0) at two
    pieces a column: smem's 0.5 in acc_0, xscratch's scratch (no effect on
    V, Srel), the init branch's 1 / (rvec - 0.5) start (its inf / 0
    column overwritten), vcarry's acc 0.9999 decay."""
    kw = FLAG_CASES[flags]
    v, srel = jax_probe(jvp.bisect_probe, **_mix_kw(), **kw)
    got = _port_mix(tuple(kw))
    np.testing.assert_array_equal(v.reshape(3, -1), got.v.numpy())
    np.testing.assert_array_equal(srel.reshape(3, -1), got.srel.numpy())
    assert torch.isfinite(got.v).all()
    if "initbranch" in kw:                      # rows differ within a piece
        assert got.v[0, 0] != got.v[0, 1]
    assert (got.w is not None) == ("vcarry" in kw)
    assert (got.xs is not None) == ("xscratch" in kw)


@pytest.mark.parametrize("others", [False, True], ids=["alone", "all"])
def test_bisect_cost_has_no_counterpart(jax_probe, others):
    """XLA's CostEstimate is a scheduling hint: the JAX probe with
    cost=True equals the port without it (no step stands for it)."""
    kw = FLAG_CASES["all"] if others else {}
    v, srel = jax_probe(jvp.bisect_probe, cost=True, **_mix_kw(), **kw)
    got = _port_mix(tuple(kw))
    np.testing.assert_array_equal(v.reshape(3, -1), got.v.numpy())
    np.testing.assert_array_equal(srel.reshape(3, -1), got.srel.numpy())
    assert "cost" not in vp.BISECT_STEPS


def _unfused_mix(h):
    """The mix with the state step rounded twice (multiply, then add)."""
    m, piece = 3, 8 * 128
    pieces = h // 8
    st = np.zeros(pieces, np.float32)
    out = []
    for j in range(m):
        acc = [np.float32(1 + j % 7)]
        for _ in range(pieces - 1):
            acc.append(vp._fma32(torch.tensor(acc[-1]), torch.tensor(
                np.float32(0.9999)), torch.tensor(np.float32(1e-5))).numpy())
        st = (st * np.float32(0.999)).astype(np.float32) + np.array(
            acc, np.float32)
        out.append(np.repeat(st, piece))
    return np.array(out)


def test_mix_state_step_is_one_fma(jax_probe):
    """The rule the f32 plain version follows, at four pieces, where the
    two roundings differ: XLA's CPU evaluation of out = carry 0.999 + acc
    is one f32 FMA (the port's _fma32), not a rounded multiply and add."""
    v, _ = jax_probe(jvp.mix_floor, **_mix_kw(32))
    fused = _port_mix(h=32).v.numpy()
    unfused = _unfused_mix(32)
    assert np.any(fused != unfused)             # the roundings differ here
    np.testing.assert_array_equal(v.reshape(3, -1), fused)


def test_bisect_vcarry_chain_is_folded(jax_probe):
    """At four pieces XLA's CPU evaluation folds vcarry's acc x 0.9999 chain
    into one rounding, acc_p = f32(c 0.9999f^p), where the port (the
    card's arithmetic) rounds each step: V and Srel within pieces x 2^-24
    relative (half an f32 ulp a step), and not equal."""
    v, srel = jax_probe(jvp.bisect_probe, vcarry=True, **_mix_kw(32))
    got = _port_mix(("vcarry",), h=32)
    d = np.float64(np.float32(0.9999))
    folded = np.array([[np.float32(np.float64(1 + j % 7) * d ** p)
                        for p in range(4)] for j in range(3)])
    per_step = vp._mix_table(4, ("vcarry",))[:3].numpy()
    assert np.any(folded != per_step)
    np.testing.assert_array_equal(v.reshape(3, -1)[:, 0], got.v[:, 0].numpy())
    np.testing.assert_allclose(v.reshape(3, -1), got.v.numpy(), atol=0,
                               rtol=4 * 2.0 ** -24)
    np.testing.assert_allclose(srel.reshape(3, -1), got.srel.numpy(),
                               atol=0, rtol=4 * 2.0 ** -24)
    assert np.any(v.reshape(3, -1) != got.v.numpy())


def test_fma32_rounds_once():
    """_fma32 against exact rational arithmetic, at the ties where an f64
    sum rounded again to f32 would be off (a double rounding)."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.uniform(-4, 4, 2000).astype(np.float32)
    b = rng.uniform(0.5, 1, 2000).astype(np.float32)
    c = (rng.uniform(-1, 1, 2000) * 2.0 ** rng.integers(-40, 3, 2000)
         ).astype(np.float32)
    got = vp._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()

    want = []
    for x, y, z in zip(a, b, c):
        q = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        cands = [np.float32(float(q))]
        cands += [np.nextafter(cands[0], np.float32(s)) for s in (-np.inf,
                                                                   np.inf)]
        dist = [abs(Fraction(float(t)) - q) for t in cands]
        lo = min(dist)
        ties = [t for t, d in zip(cands, dist) if d == lo]
        want.append(min(ties, key=lambda t: int(t.view(np.int32)) & 1))
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def _numpy_bisect(m, n, steps, piece, sms):
    """P6 at a K3 rung, written out row by row in f64 with numpy: the
    column's running average V_r = A_r V_{r-1} + B_r walked in row order
    (restarting at 0 at each warp's first row without the hand-off), the
    Srel Kahan pair along the columns, the vcarry sums a thread."""
    has = set(steps).__contains__
    plan = sc.cols_plan(n, m, sms)
    k, seg = plan.chunk // 512, plan.chunk // 16
    rows = plan.chunks * plan.chunk
    r = np.arange(rows)
    pieces = -(-rows // piece)
    acc = np.empty((7, pieces), np.float32)
    acc[:, 0] = (np.arange(7) + 1).astype(np.float32) + np.float32(0.5)
    for p in range(1, pieces):
        acc[:, p] = acc[:, p - 1] * np.float32(0.9999)      # vcarry
    hs = -(-n // vp.SLAB)
    st = 1.0 / (((r % vp.SLAB) * hs + r // vp.SLAB).astype(np.float64) - 0.5)
    v = np.empty((m, n), np.float32)
    srel = np.empty((m, n), np.float32)
    xs = np.zeros(n)
    comp = np.zeros(n)
    w = np.zeros((rows // k, 2))
    for j in range(m):
        out = st * 0.999 + acc[j % 7][r // piece].astype(np.float64)
        x = np.empty(rows)
        if has("scan"):
            a = 1 / (2 + np.abs(st)) if has("div_pos") else np.full(rows, .5)
            b = (1 - a) * out
            prev = 0.0
            for i in range(rows):
                if i >= n:
                    x[i] = prev                     # the identity map
                    continue
                if i % seg == 0 and not (has("handoff") and i > 0):
                    prev = 0.0
                prev = x[i] = a[i] * prev + b[i]
        else:
            x = np.where(r < n, out, 0.0)
        st = x
        w[:, 0] = w[:, 0] * 0.999 + x.reshape(-1, k)[:, 0]
        w[:, 1] = w[:, 1] * 0.999 + x.reshape(-1, k)[:, -1]
        term = (np.log(np.maximum(np.abs(x[:n]), vp.TINY)) if has("log_pos")
                else x[:n])
        y = term - comp
        t = xs + y
        comp, xs = (t - xs) - y, t
        v[j] = x[:n]
        srel[j] = xs if has("log_pos") else x[:n] + 1
    return v, srel, w, xs


@pytest.mark.parametrize("steps", vp.ladder()[len(vp.TPU_STEPS):],
                         ids=vp.K3_STEPS)
def test_bisect_k3_steps_match_numpy(steps):
    """bisect_ref's K3 steps (the kernel's order: threads' compositions,
    warp scans, the carry warp's scan, the chunks' carries) against
    _numpy_bisect's row order, f64, at 3000 rows on 2 SMs: 2 chunks of
    1536 rows (the second cut short), 3 rows a thread.  The f64 sinks
    within 1e-12 relative, the f32 tables within one f32 ulp (a
    different order of additions rounds to the other neighbour at a tie);
    barriers leave the values as vcarry's."""
    m, n, sms, piece = 4, 3000, 2, 1000
    plan = sc.cols_plan(n, m, sms)
    assert (plan.chunk, plan.chunks) == (1536, 2)
    got = vp.bisect_ref(m, n, steps, piece=piece, sms=sms)
    want = _numpy_bisect(m, n, steps, piece, sms)
    for g, w_, rtol in zip(got, want, (2.0 ** -23,) * 2 + (1e-12,) * 2):
        np.testing.assert_allclose(g.numpy(), w_, rtol=rtol, atol=0)
    err, ok = vp.mix_errors(got, vp.MixOut(*(torch.from_numpy(x) for x in
                                              want)), ("div_pos",))
    assert ok
    if steps[-1] == "barriers":
        before = vp.bisect_ref(m, n, steps[:-1], piece=piece, sms=sms)
        assert all(torch.equal(a, b) for a, b in zip(got, before))
    if "handoff" in steps:                  # the average crosses chunks
        cut = vp.bisect_ref(m, n, steps[:-1], piece=piece, sms=sms)
        assert not torch.equal(got.v[:, 1536:1540], cut.v[:, 1536:1540])
        assert torch.equal(got.v[:, :96], cut.v[:, :96])


def test_bisect_ref_any_combination():
    """The plain version takes any combination: div_pos and handoff
    without the scan, and barriers, leave the values alone; log_pos
    without xscratch makes Srel the log of |V| alone."""
    m, n = 3, 1500
    base = vp.bisect_ref(m, n, ("smem",))
    for extra in (("div_pos",), ("handoff",), ("barriers",),
                  ("div_pos", "handoff", "barriers")):
        other = vp.bisect_ref(m, n, ("smem",) + extra)
        assert torch.equal(base.v, other.v) and torch.equal(base.srel,
                                                            other.srel)
    lg = vp.bisect_ref(m, n, ("smem", "log_pos"))
    assert torch.equal(lg.v, base.v)
    torch.testing.assert_close(lg.srel, base.v.double().log().float(),
                               rtol=2.0 ** -23, atol=0)
    sc_only = vp.bisect_ref(m, n, ("scan",))
    assert not torch.equal(sc_only.v, vp.bisect_ref(m, n).v)
    with pytest.raises(ValueError, match="each at most once"):
        vp.bisect_ref(m, n, ("smem", "smem"))
    with pytest.raises(ValueError, match="each at most once"):
        vp.bisect_ref(m, n, ("cost",))


def test_ladder_and_bits():
    """Nine rungs, each the one before it and one more step, in
    BISECT_STEPS' order; each rung's bits those of its steps."""
    rungs = vp.ladder()
    assert len(rungs) == 9 and rungs[0] == ("smem",)
    assert rungs[-1] == vp.BISECT_STEPS
    for before, rung in zip(rungs, rungs[1:]):
        assert rung[:-1] == before
    assert [vp.steps_bits(r) for r in rungs] == [2 ** i - 1
                                                 for i in range(1, 10)]
    assert vp.steps_bits(("scan", "smem")) == 33
    assert [vp.bisect_exact(r) for r in rungs] == [True] * 6 + [False] * 3
    assert [name for name, _, _ in tool.ladder_rungs()] == (
        ["mix"] + list(vp.BISECT_STEPS) + ["staged"] + list(tool.BRANCH))


@pytest.mark.parametrize("steps,staged,n,fits", [
    ((), False, 1 << 21, True), ((), True, 1 << 20, True),
    ((), True, 1 << 21, True), (vp.BISECT_STEPS, False, 1 << 21, True),
    (("smem", "xscratch"), False, 1 << 16, True),
    (("xscratch",), True, 1 << 20, False)])
def test_mix_plan_shared_memory(steps, staged, n, fits):
    """K3's 8.5 bytes a row of state, 16 more with xscratch's pair, 16
    more with staged's two buffers (201 KB at a chunk of 8192), and the
    piece table; a (steps, chunk) that does not fit is refused."""
    plan = sc.cols_plan(n, 1024, 132)
    pieces = -(-plan.chunks * plan.chunk // vp.PIECE)
    want = (8.5 + (16 if "xscratch" in steps else 0)
            + (16 if staged else 0)) * plan.chunk + 4 * (
                (7 * pieces + 3) & ~3)
    assert vp.mix_smem(steps, staged, plan.chunk, pieces) == want
    if fits:
        assert vp.mix_plan("f", steps, staged, 1024, n, vp.PIECE,
                           132)[2] == want
    else:
        with pytest.raises(ValueError, match="shared memory"):
            vp.mix_plan("f", steps, staged, 1024, n, vp.PIECE, 132)
    if n == 1 << 20 and staged and not steps:
        assert 200_000 < want < 210_000


def test_mix_plan_refuses():
    with pytest.raises(ValueError, match="n % 4"):
        vp.mix_plan("f", (), True, 4, 40002, vp.PIECE, 132)
    with pytest.raises(ValueError, match="piece"):
        vp.mix_plan("f", (), False, 4, 4096, 16, 132)
    with pytest.raises(ValueError, match="shared memory"):
        vp.mix_plan("f", ("smem", "xscratch"), False, 4, 1 << 21, 1000, 132)
    assert vp.mix_plan("f", (), True, 9, 40000, 1000, 132)[0].chunks == 79


def test_branch_rungs_and_bits():
    """The branch from the top rung: the nine steps with each lever alone
    (bits 512 and 1024 above the nine steps'), then with both; each
    launch's name; each rung's increment counted against the top rung."""
    rungs = vp.branch()
    assert rungs == [vp.BISECT_STEPS + (x,) for x in vp.LEVERS] + [
        vp.BISECT_STEPS + vp.LEVERS]
    assert vp.LEVERS == ("storewarps", "early")
    assert [vp.steps_bits(r) for r in rungs] == [1023, 1535, 2047]
    assert vp.steps_bits(("early", "smem")) == 1025
    assert not any(vp.bisect_exact(r) for r in rungs)
    assert [vp.probe_name(r) for r in rungs] == [
        "bisect_storewarps", "bisect_early", "bisect_storewarps_early"]
    assert tool.BRANCH == ("storewarps", "early", "storewarps_early")
    assert vp.probe_name(vp.BISECT_STEPS) == vp.probe_name(("smem",)) \
        == "bisect"
    assert [vp.probe_name((), mode) for mode in vp.MIX_MODES] == [
        "mix", "mix_staged"]
    assert set(vp.PROBES) >= {vp.probe_name(r) for r in vp.ladder() + rungs}
    assert "mix_staged" in vp.PROBES
    before = tool.rung_before()
    assert before["smem"] == "mix" and before["handoff"] == "log_pos"
    assert [before[x] for x in tool.BRANCH] == ["handoff"] * 3
    assert not set(vp.MIX_MODES) & set(before)
    assert tool.TOP == "handoff" and all(map(tool.in_branch, tool.BRANCH))
    assert not tool.in_branch(tool.TOP)
    with pytest.raises(ValueError, match="each at most once"):
        vp.steps_bits(("early", "early"))


@pytest.mark.parametrize("steps", vp.branch(), ids=tool.BRANCH)
def test_branch_plain_version_is_the_top_rungs(steps):
    """A lever moves work between warps and changes no arithmetic: a
    branch rung's plain version is bisect_ref at all nine steps, exactly,
    at 2 chunks of 1536 rows (the second cut short)."""
    got = vp.bisect_ref(4, 3000, steps, piece=1000, sms=2)
    want = vp.bisect_ref(4, 3000, vp.BISECT_STEPS, piece=1000, sms=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert vp.mix_errors(got, want, steps) == (0.0, True)


@pytest.mark.parametrize("steps,staged,n,fits", [
    (vp.BISECT_STEPS, False, 1 << 16, True),
    (vp.branch()[0], False, 1 << 16, True),
    (vp.branch()[1], False, 1 << 16, True),
    (vp.branch()[0], False, 1 << 20, False),
    (vp.branch()[1], False, 1 << 20, True),
    (vp.branch()[2], False, 1 << 16, True),
    (vp.branch()[2], False, 1 << 20, False),
    ((), True, 1 << 16, True), ((), True, 1 << 20, True),
    ((), True, 1 << 21, True)],
    ids=["top-2^16", "storewarps-2^16", "early-2^16", "storewarps-2^20",
         "early-2^20", "both-2^16", "both-2^20", "staged-2^16",
         "staged-2^20", "staged-2^21"])
def test_branch_and_staged_plan(steps, staged, n, fits):
    """storewarps' block: 16 row warps, the carry warp and 8 store warps
    (800 threads, with early's poll warp 832; at most 1024), and two
    columns of V at K3's vslot (17 bytes a row) beside the top rung's 24.5
    and the piece table: 22 KB at (2^16, 1024), but 340 KB at 2^20 rows
    (chunks of 8192), refused.  early's alone: the top rung's and a poll
    warp (576 threads), no more shared memory.  staged's two staging buffers, 16 bytes a row, fit at both of
    K3's shapes and at (2^21, 4)'s two waves of chunks (9216 rows)."""
    plan = sc.cols_plan(n, 1024, 132)
    pieces = -(-plan.chunks * plan.chunk // vp.PIECE)
    table = 4 * ((7 * pieces + 3) & ~3)
    slots = plan.chunk + plan.chunk // 16
    want = (8 * slots + (16 * plan.chunk if steps else 0) + table
            + (16 * plan.chunk if staged else 0)
            + (16 * slots if "storewarps" in steps else 0))
    assert vp.mix_smem(steps, staged, plan.chunk, pieces) == want
    threads = vp.mix_threads(steps)
    assert threads == (800 + 32 * ("early" in steps) if "storewarps" in steps
                       else 576 if "early" in steps else 544 if steps
                       else 512) <= vp.THREADS_MAX
    assert tool.rung_fits(steps, staged, n, 1024, 132) == fits
    if fits:
        assert vp.mix_plan("f", steps, staged, 1024, n, vp.PIECE,
                           132)[2] == want <= vp.SMEM_MAX - vp.MIX_STATIC
    else:
        with pytest.raises(ValueError, match=f"{steps[-1] if steps else ''}"
                                             ".* at a chunk of 8192"
                                             ".* shared memory"):
            vp.mix_plan("f", steps, staged, 1024, n, vp.PIECE, 132)
    if staged and n == 1 << 21:
        assert plan.chunks > 132              # two waves of chunks


def test_mix_plan_refuses_too_many_threads(monkeypatch):
    """A block over 1024 threads is refused before the launch would be."""
    monkeypatch.setattr(vp, "STORE_WARPS", 16)
    assert vp.mix_threads(vp.branch()[0]) == 1056
    with pytest.raises(ValueError, match="1056 threads"):
        vp.mix_plan("f", vp.branch()[0], 0, 1024, 1 << 16, vp.PIECE, 132)
    vp.mix_plan("f", vp.BISECT_STEPS, 0, 1024, 1 << 16, vp.PIECE, 132)


def test_fill_period_on_synthetic_times():
    """time = fill + m x period: two m give both exactly (no residual),
    more m their least-squares line and its largest residual; fits() takes
    every rung timed at every m of an n, and K3, and the hop as the fill
    over the chunks."""
    fill, period, resid = tool.fill_period([(1024, 0.25 + 1024 * 0.9e-3),
                                            (256, 0.25 + 256 * 0.9e-3)])
    assert fill == pytest.approx(0.25) and period == pytest.approx(0.9)
    assert resid == pytest.approx(0, abs=1e-9)
    ms_, t = [256, 512, 1024], [0.40, 0.71, 1.30]
    fill, period, resid = tool.fill_period(list(zip(ms_, t)))
    slope, icept = np.polyfit(ms_, t, 1)
    assert period == pytest.approx(1e3 * slope)
    assert fill == pytest.approx(icept)
    assert resid == pytest.approx(
        1e3 * max(abs(y - icept - slope * x) for x, y in zip(ms_, t)))
    assert resid > 1                          # not a line: 0.31 then 0.59
    for bad in ([(1024, 1.0)], [(256, 0.4), (256, 0.5)]):
        with pytest.raises(ValueError, match="two or more m"):
            tool.fill_period(bad)

    def shape(m, times, k3):
        return {"n": 65536, "m": m, "chunks": 128, "k3_ms": k3,
                "rungs": {x: {"ms": t} for x, t in times.items()}}
    long_ = {"65536": shape(1024, {"mix": 0.30, "handoff": 1.20,
                                   "scan": 0.7, "early": 1.1}, 1.30)}
    short = {"65536x256": shape(256, {"mix": 0.09, "handoff": 0.42,
                                      "storewarps": 0.3, "early": 0.4},
                                0.47),
             "65536x512": shape(512, {"mix": 0.16, "handoff": 0.68,
                                      "early": 0.63}, 0.75)}
    got = tool.fits(long_, short)["65536"]
    assert set(got) == {"K3", "mix", "handoff", "early"}
    assert got["handoff"]["period_us"] == pytest.approx(
        1e3 * np.polyfit([1024, 256, 512], [1.20, 0.42, 0.68], 1)[0])
    assert got["handoff"]["resid_us"] < 1e-6   # on its line
    assert got["early"]["resid_us"] > 1
    assert got["K3"]["hop_us"] == pytest.approx(
        got["K3"]["fill_ms"] * 1e3 / 128)
    assert "handoff" in tool.fit_summary(got)
    assert "residual" in tool.fit_summary(got)
    assert tool.fits(long_, {})  == {}         # one m: nothing to fit


def test_mix_errors_tolerances():
    """Bitwise without div_pos / log_pos; else the f64 sinks within 1e-12
    relative and the f32 tables within one f32 ulp; a NaN (a value the
    kernel never wrote) always fails."""
    want = vp.bisect_ref(3, 1000, vp.BISECT_STEPS)
    got = vp.MixOut(*(None if x is None else x.clone() for x in want))
    assert vp.mix_errors(got, want, vp.BISECT_STEPS) == (0.0, True)
    got.v[1, 7] = torch.nextafter(got.v[1, 7], torch.tensor(math.inf))
    got.xs[3] *= 1 + 5e-13
    err, ok = vp.mix_errors(got, want, vp.BISECT_STEPS)
    assert ok and err > 0
    assert not vp.mix_errors(got, want, vp.ladder()[4])[1]
    got.xs[3] *= 1 + 5e-12
    assert not vp.mix_errors(got, want, vp.BISECT_STEPS)[1]
    got.xs[3] = want.xs[3]
    got.v[2, 9] = math.nan
    assert not vp.mix_errors(got, want, vp.BISECT_STEPS)[1]


def test_ladder_flops():
    """The mix's 3 f64 operations a cell; the top rung at one row a thread
    (2^16 rows) 75, at 16 (2^20 rows) ~56: the scan's per-thread steps
    spread over the rows."""
    assert tool.ladder_flops((), 1) == 3
    assert tool.ladder_flops(vp.BISECT_STEPS, 1) == 75
    assert tool.ladder_flops(vp.BISECT_STEPS, 16) == pytest.approx(
        3 + 4 + 4 / 16 + 4 + (45 + 17) / 16 + 21 + 20 + 2 / 16)


def test_device_timed_on_the_cpu():
    """On the CPU device_timed is timed(): the host clock for both times,
    the last call's result."""
    calls = []
    k_ms, call_ms, out = tool.device_timed(
        lambda: calls.append(1) or len(calls), torch.device("cpu"), reps=3)
    assert k_ms == call_ms >= 0 and out == 4 and len(calls) == 4


def test_tool_ladder_on_the_cpu():
    """The tool's ladder on the CPU at a tiny size: every rung of P5 and P6
    timed twice with its increment, K3's time beside it (the CPU's, which
    mean nothing)."""
    res = {}
    out = tool.ladder(torch.device("cpu"), "cpu", ((1024, 4),), res, reps=1)
    sh = out["1024"]
    assert set(sh["rungs"]) == {name for name, _, _ in tool.ladder_rungs()}
    assert sh["rungs"]["mix"]["inc_us_col"] is None
    assert sh["rungs"]["staged"].get("inc_us_col") is None
    for name in vp.BISECT_STEPS:
        row = sh["rungs"][name]
        assert {"ms_fwd", "ms_rev", "ms", "noise_ms", "us_col",
                "host_ms"} <= set(row)
        assert row["inc_us_col"] is not None
    assert sh["k3_ms"] > 0 and sh["top_share"] > 0 and "mismatch" not in res


def _ladder_readings(times, noise=0.002, piecewise=0.2):
    """A shape's ladder readings, the rungs of ladder_rungs() in order as
    far as ``times`` goes (the branch left out, as at 2^20
    rows, unless given)."""
    ms = dict(zip([name for name, _, _ in tool.ladder_rungs()], times))
    n, m = tool.K3_SHAPES[1]
    return {"n": n, "m": m, "piecewise_ms": piecewise,
            "rungs": {name: {"ms": t, "noise_ms": noise}
                      for name, t in ms.items()}}


@pytest.mark.parametrize("drop,noise,ok", [
    (0.0, 0.002, True), (0.01, 0.002, True), (0.05, 0.002, False),
    (0.05, 0.03, True), (0.2, 0.03, False)])
def test_impossible_ladder_rung_faster_than_the_one_before(drop, noise, ok):
    """A rung faster than the rung before it by more than twice the larger
    noise (at least LADDER_FLOOR of its time) is reported: the compiler
    removed work.  Here barriers runs ``drop`` ms under vcarry."""
    times = [0.34, 0.34, 0.37, 0.37, 0.37, 0.37 - drop, 0.72, 0.75, 0.95,
             1.2, 0.47]
    res = _readings()
    res["ladder"] = {"65536": _ladder_readings(times, noise)}
    bad = tool.impossible(res)
    assert (bad == []) == ok
    assert ok or any("barriers" in b and "rung before" in b for b in bad)


def test_impossible_ladder_faster_than_piecewise():
    """P5's mix under P1 piecewise at the same shape (it stores the same
    bytes and more) is reported; staged is held to the byte rate alone."""
    times = [0.30, 0.34, 0.35, 0.35, 0.35, 0.40, 0.72, 0.75, 0.95, 1.2, 0.05]
    res = _readings()
    res["ladder"] = {"65536": _ladder_readings(times, piecewise=0.34)}
    bad = tool.impossible(res)
    assert any(b.startswith("ladder 65536 mix") and "piecewise" in b
               for b in bad)
    assert any(b.startswith("ladder 65536 staged") and "GB/s" in b
               for b in bad)
    assert not any("smem" in b for b in bad)


def _branch_readings(branch, staged=0.25, noise=0.002):
    """Readings at (2^16, 1024) with the branch: the ladder at times an
    H100 reads, staged at ``staged``, the three branch rungs at
    ``branch`` ms."""
    times = [0.2875, 0.2866, 0.3165, 0.3166, 0.3284, 0.41, 0.6845, 0.7009,
             0.907, 1.1565, staged] + list(branch)
    return _ladder_readings(times, noise, piecewise=0.1704)


@pytest.mark.parametrize("branch,staged,ok", [
    ((1.10, 1.30, 1.20), 0.25, True),        # all slower: no finding
    ((0.80, 0.70, 0.65), 0.25, True),
    ((0.80, 0.20, 0.65), 0.25, False),       # under staged and mix
    ((0.80, 0.26, 0.65), 0.27, True),        # within 5% of staged
    ((0.15, 0.70, 0.65), 0.25, False)])      # under P1 piecewise too
def test_impossible_branch_rung_faster_than_the_mix(branch, staged, ok):
    """A branch rung is held to the faster of P5's modes, here staged or
    mix (it does their work and more), within twice the larger noise or
    LADDER_FLOOR, and to P1 piecewise; it may be slower than the top
    rung."""
    res = _readings()
    res["ladder"] = {"65536": _branch_readings(branch, staged)}
    bad = tool.impossible(res)
    assert (bad == []) == ok
    assert ok or any("faster than the faster of P5's modes" in b
                     for b in bad)
    if branch[0] == 0.15:
        assert any("storewarps" in b and "piecewise" in b for b in bad)


def test_impossible_reads_the_short_ladder():
    """The (2^16, 256) ladder's readings are held to the same rules, under
    their own label."""
    res = _readings()
    res["ladder"] = {"65536": _branch_readings((0.9, 0.85, 0.8))}
    short = _branch_readings((0.9, 0.85, 0.8))
    short["rungs"]["storewarps"]["ms"] = 0.05
    res["ladder_short"] = {"65536x256": short}
    bad = tool.impossible(res)
    assert bad and all(b.startswith("ladder 65536x256 storewarps")
                       for b in bad)


def _ladder_sass(drop=None):
    """cuobjdump -sass text of the P5 / P6 kernels, each rung with its
    marks, a branch rung the top rung's and its own; ``drop`` (a rung's
    name) gives that rung the rung before it's (the rungs after it keep
    theirs)."""
    counts = {"mix": {}, "staged": {"UBLKCP.G.S": 4},
              "barriers": {"BAR.SYNC.DEFER_BLOCKING": 64},
              "scan": {"SHFL.UP": 44}, "div_pos": {"MUFU.RCP64H": 15},
              "log_pos": {"MUFU.RCP64H": 28},
              "handoff": {"ATOMG.E.ADD.STRONG.GPU": 1,
                          "LDG.E.64.STRONG.GPU": 2},
              "storewarps": {"BAR.ARV": 2}}
    lines, acc, addr = ["\tcode for sm_90a"], Counter(
        {"BAR.SYNC.DEFER_BLOCKING": 3, "MUFU.RCP64H": 3}), 0
    for name, steps, staged in tool.ladder_rungs():
        ops = Counter(acc)
        parts = name.split("_") if tool.in_branch(name) else [name]
        for part in parts:                      # a branch rung: its levers'
            ops.update(counts.get(part, {}))
        if not staged and not tool.in_branch(name):
            acc = Counter(ops)
        if name == drop:
            for part in parts:
                ops.subtract(counts.get(part, {}))
        lines.append(f"\t\tFunction : _ZN45_GLOBAL__N__d5eaa224_12_vpu_probe_"
                     f"cu_f64d4cb410mix_kernelILi{vp.steps_bits(steps)}ELb"
                     f"{int(staged)}EEEvPKfPfS3_PdS4_S4_Piiiiiiii")
        for op, c in ops.items():
            for _ in range(c):
                lines.append(f"        /*{addr:04x}*/                   {op} "
                             "R4, R4 ;   /* 0x000fe40000000800 */")
                addr += 16
    return "\n".join(lines) + "\n"


def test_ladder_work_counts_each_rungs_marks():
    """Every rung's mark counted in its kernel against the rung before:
    the named barriers, the scan's SHFL.UP, div_pos's and log_pos's
    MUFU.RCP64H, the hand-off's ATOMG and strong poll, staged's bulk
    copies against P5 mix."""
    rows, short = tool.ladder_work(_ladder_sass())
    assert short == []
    assert rows["barriers BAR.SYNC"] == {"count": 67, "before": 3, "need": 2}
    assert rows["log_pos MUFU.RCP64H"]["before"] == 18
    assert rows["staged UBLKCP"] == {"count": 4, "before": 0, "need": 2}
    assert rows["storewarps BAR.ARV"] == {"count": 2, "before": 0, "need": 2}
    assert rows["storewarps_early BAR.ARV"] == rows["storewarps BAR.ARV"]
    assert rows["early SHFL.UP (top)"] == {"count": 44, "before": 0,
                                           "need": 20}
    assert set(rows) == {f"{r} {mark}" for r, marks in
                         tool.LADDER_MARKS.items() for mark, _ in marks} | {
        f"{r} {mark} (top)" for r in tool.BRANCH
        for mark in tool.top_marks()} | {"storewarps_early BAR.ARV"}


@pytest.mark.parametrize("rung", ["barriers", "scan", "div_pos", "log_pos",
                                  "handoff", "staged", "storewarps",
                                  "storewarps_early"])
def test_ladder_work_reports_a_missing_step(rung):
    _, short = tool.ladder_work(_ladder_sass(drop=rung))
    assert short and all(s.startswith(f"sass {rung}:") for s in short)


def test_ladder_work_reports_missing_kernels():
    text = _ladder_sass()
    cut = text.index("mix_kernelILi63ELb0")          # the scan rung
    start = text.rindex("\t\tFunction", 0, cut)
    end = text.index("\t\tFunction", cut)
    _, short = tool.ladder_work(text[:start] + text[end:])
    assert "sass scan: not in the library" in short


def test_mix_bisect_refuse_the_cpu_and_other_rungs():
    before = dict(vp.LAUNCHES)
    for call in (lambda: vp.mix_cuda(4, 1024, device="cpu"),
                 lambda: vp.mix_cuda(4, 1024, "staged", device="cpu"),
                 lambda: vp.bisect_cuda(4, 1024, ("smem",), device="cpu")):
        with pytest.raises(ValueError, match="not a CUDA device"):
            call()
    assert vp.LAUNCHES == before
    assert {"mix", "bisect"} <= set(vp.LAUNCHES)
    with pytest.raises(ValueError, match="not a rung"):
        vp.bisect_cuda(4, 1024, ("scan",), device="cuda:0")
    with pytest.raises(ValueError, match="mode"):
        vp.mix_cuda(4, 1024, "piecewise", device="cuda:0")


def test_tool_ladder_runs_the_branch_on_the_cpu():
    """The tool's short ladders (FIT_RUNGS, SIZES' ladder_short) on the
    CPU: each branch rung's output equal to the top rung's, its increment
    over the top rung, P5's modes without one; the fit from the three
    m."""
    res = {}
    cpu = torch.device("cpu")
    long_ = tool.ladder(cpu, "cpu", ((1024, 4),), res, reps=1,
                        names=tool.FIT_RUNGS)
    short = tool.ladder_short(cpu, "cpu", tool.SIZES["cpu"]["ladder_short"],
                              res, reps=1)
    assert list(short) == ["1024x2", "1024x3"]
    sh = short["1024x2"]
    assert list(sh["rungs"]) == [x for x, _, _ in tool.ladder_rungs()
                                 if x in tool.FIT_RUNGS]
    assert all(sh["rungs"][x]["equal_top"] for x in tool.BRANCH)
    assert sh["rungs"]["log_pos"]["inc_us_col"] is None    # no div_pos here
    assert sh["rungs"]["handoff"]["inc_us_col"] is not None
    assert sh["rungs"]["early"]["inc_us_col"] == pytest.approx(
        sh["rungs"]["early"]["us_col"] - sh["rungs"]["handoff"]["us_col"])
    assert sh["rungs"]["staged"].get("inc_us_col") is None
    assert "mismatch" not in res
    fit = tool.fits(long_, short)["1024"]
    assert set(fit) == {"K3"} | set(tool.FIT_RUNGS)
    assert all(f["resid_us"] >= 0 for f in fit.values())
    res.update(ladder=long_, ladder_short=short)
    assert tool.fit_ms(res, "1024") == "4, 2, 3"


# -- the wrappers, the builder, the tool -----------------------------------------

@pytest.mark.parametrize("call", [
    lambda: vp.write_floor_cuda(4, 1024, device="cpu"),
    lambda: vp.alu_cuda("fma", device="cpu"),
    lambda: vp.alu_blocks("fma", device="cpu"),
    lambda: vp.smem_cuda("load1", device="cpu"),
    lambda: vp.overlap_cuda(4, 1024, device="cpu")],
    ids=["write_floor", "alu", "alu_blocks", "smem", "overlap"])
def test_cuda_wrappers_refuse_the_cpu(call):
    """Nothing falls back to a plain version: a CPU device raises."""
    before = dict(vp.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        call()
    assert vp.LAUNCHES == before


def test_alu_rtol():
    """The stated tolerances: f32 1e-5, recip and logf 1e-4, f64 1e-12."""
    assert vp.alu_rtol("fma", torch.float32) == 1e-5
    assert vp.alu_rtol("recip", torch.float32) == 1e-4
    assert vp.alu_rtol("log", torch.float32) == 1e-4
    assert {vp.alu_rtol(op, torch.float64)
            for op in vp.ALU_OPS[torch.float64]} == {1e-12}


def test_alu_wrappers_check_ops():
    with pytest.raises(ValueError, match="no op"):
        vp.alu_ref("div_pos", torch.float32)
    with pytest.raises(ValueError, match="no op"):
        vp.alu_ref("roll", torch.float64)
    for op in ("log", "roll"):
        with pytest.raises(ValueError):
            vp._check_alu("f", op, torch.float32, 4, 1, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        vp._check_alu("f", "fma", torch.float32, 8, 3, 1)
    assert vp._check_alu("f", "fma", torch.float64, 16, 3, 8) == 24


def test_builder_keeps_k1_k3_and_builds_the_probes(tmp_path, monkeypatch):
    """ops/_nvcc.py builds both modules' sources: K1-K3 keep their names
    and targets, the probes' library is named by its own source and
    row_walk.cuh (which it includes for div_pos / log_pos), and an edit
    of the header renames all four libraries."""
    assert sc.KERNELS == ("fill_grid", "fill_table", "fill_table_cols")
    for name in sc.KERNELS:
        assert _nvcc.LIBRARIES[name].source == sc.SOURCES[name]
        assert _nvcc.target(name, sc.SOURCES[name]).parent == _nvcc.BUILD_DIR
    src = vp.SOURCES["vpu_probe"]
    assert src.parent == sc.SOURCES["fill_grid"].parent
    assert b'#include "row_walk.cuh"' in src.read_bytes()
    assert "stb_vpu_write_full" in src.read_text()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in src.parent.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    sources = {**{n: csrc / p.name for n, p in sc.SOURCES.items()},
               "vpu_probe": csrc / src.name}
    before = {n: _nvcc.target(n, p) for n, p in sources.items()}
    assert before["vpu_probe"] == _nvcc.target("vpu_probe", src)
    assert before["vpu_probe"].name.startswith("vpu_probe_")
    header = csrc / "row_walk.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _nvcc.target(n, p) for n, p in sources.items()}
    assert all(after[n] != before[n] for n in sources)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "_build").mkdir()
    for out in after.values():          # every library present: no nvcc
        (tmp_path / "_build" / out.name).write_bytes(b"")
    built = _nvcc.build_all(sources)
    assert set(built) == set(sources) and all(p.exists()
                                              for p in built.values())


def test_tool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])


def test_tool_runs_without_jax():
    """--device cpu runs every probe's plain version at a tiny size with
    jax and the JAX package unimportable, and prints one JSON object."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['libstb_tpu'] = None\n"
            "sys.path.insert(0, 'tools')\n"
            "import vpu_probe_torch\n"
            "vpu_probe_torch.main(['--device', 'cpu'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu, host clock"
    assert set(out["write"]) == {"full", "piecewise", "onecol",
                                 "piecewise_512"}
    assert {f"{'f32' if d == torch.float32 else 'f64'}_{op}_u{u}"
            for d, ops in vp.ALU_OPS.items() for op in ops
            for u in vp.ALU_U.get(op, (8,))} == set(out["alu"])
    assert len(out["smem"]) == 2 * len(vp.SMEM_MODES)
    assert set(out["floors"]["kernels"]) == {"K1", "K2", "K3_1048576",
                                             "K3_65536"}
    assert "[cpu, host clock]" in res.stderr


def _readings(fma=16e12, div=2e12, log=0.6e12, chains=2.0, stores=3.0,
              both=3.5, write_ms=2.5):
    n, m = tool.K3_SHAPES[0]
    alu = {f"f64_fma_u{u}": {"dtype": "f64", "ops_per_s": fma * u / 16}
           for u in (4, 8, 16)}
    alu["f64_div_pos_u8"] = {"dtype": "f64", "ops_per_s": div}
    alu["f64_log_pos_u8"] = {"dtype": "f64", "ops_per_s": log}
    write = {"full": {"mode": "full", "n": n, "m": m, "ms": write_ms,
                      "bytes": 8 * n * m, "GBps": 8 * n * m / write_ms / 1e6},
             "piecewise": {"mode": "piecewise", "n": n, "m": m, "ms": 3.0,
                           "bytes": 8 * n * m,
                           "GBps": 8 * n * m / 3.0 / 1e6}}
    ov = {"128": {"iters": 128, "chains_ms": chains, "stores_ms": stores,
                  "both_ms": both, "fraction": (chains + stores - both)
                  / min(chains, stores)}}
    return {"alu": alu, "write": write, "overlap": ov,
            "overlap_shape": [n, m]}


def test_floors_take_the_fraction_unclamped():
    """A fraction a little past 1 (noise) is used as read, not clamped:
    the combined floor then sits under the larger one by (f - 1) of the
    smaller; impossible() bounds it instead."""
    res = _readings(chains=2.0, stores=3.0, both=2.96)
    fl = tool.floors(res)
    assert fl["overlap_fraction"] == pytest.approx(1.02)
    k3 = fl["kernels"]["K3_1048576"]
    w, i = k3["write_floor_ms"], k3["issue_floor_ms"]
    assert k3["floor_ms"] == pytest.approx(max(w, i) - 0.02 * min(w, i))
    assert tool.impossible(res) == []


def test_floors_from_readings():
    """The issue floor prices a cell's other f64 work at the best FMA rate
    and its divides and log at theirs, less the add each probe step
    carries; the write floor is K3's piecewise time or the full rate; the
    overlap fraction sets max or sum."""
    res = _readings()
    fl = tool.floors(res)
    assert fl["f64_fma_per_s"] == 16e12 and fl["overlap_fraction"] == 0.75
    cell = (11 - 3) / 16e12 + 2 / 2e12 + 1 / 0.6e12
    k1 = fl["kernels"]["K1"]
    assert k1["cells"] == 64 * 16384 * 1024
    assert k1["issue_floor_ms"] == pytest.approx(k1["cells"] * cell * 1e3)
    assert k1["write_from"] == "full"
    assert k1["write_floor_ms"] == pytest.approx(2.5 * 64 * 16384 / (1 << 20))
    k3 = fl["kernels"]["K3_1048576"]
    assert k3["write_from"] == "piecewise" and k3["write_floor_ms"] == 3.0
    w, i = k3["write_floor_ms"], k3["issue_floor_ms"]
    assert k3["floor_ms"] == pytest.approx(max(w, i) + 0.25 * min(w, i))
    assert fl["kernels"]["K3_65536"]["write_from"] == "full"


def test_impossible_readings_fail():
    """A byte rate or an op rate above 105% of the data sheet is reported;
    the readings just under it are not."""
    assert tool.impossible(_readings()) == []
    assert tool.impossible(_readings(fma=17.8e12)) == []
    bad = tool.impossible(_readings(fma=18e12, write_ms=2.4))
    assert any(b.startswith("alu f64_fma_u16") for b in bad)
    assert any(b.startswith("write full") for b in bad)
    assert tool.impossible(_readings(stores=2.4, both=2.4))


@pytest.mark.parametrize("both,ok", [(2.95, True), (2.0, False),
                                     (5.2, False), (5.05, True)])
def test_impossible_overlap_fraction(both, ok):
    """Chains 2 ms, stores 3 ms: a fraction over 1.05 (both faster than
    the stores alone by more than noise: work removed) or under -0.05
    (both slower than the sum) is reported."""
    bad = tool.impossible(_readings(chains=2.0, stores=3.0, both=both))
    assert (bad == []) == ok
    assert ok or any("fraction" in b for b in bad)


def test_impossible_reports_mismatches_and_missing_steps():
    res = _readings()
    res["mismatch"] = ["alu f32_mul_u8: relative error 0.0016"]
    res["sass"] = {"kernels": {}, "short": ["sass alu_f32_recip_u8: 0 "
                                            "MUFU.RCP < 64"]}
    assert tool.impossible(res) == res["mismatch"] + res["sass"]["short"]


def _sass(counts):
    """cuobjdump -sass text of the probes' P2 / P4 kernels with ``counts``
    ({kernel key: count of its mark}; the rest at their loop's steps)."""
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a",
             "", "\tcode for sm_90a"]
    addr = 0

    def emit(name, body):
        nonlocal addr
        lines.append(f"\t\tFunction : _ZN45_GLOBAL__N__d5eaa224_12_vpu_"
                     f"probe_cu_f64d4cb4{name}")
        lines.append('\t.headerflags\t@"EF_CUDA_SM90"')
        for op in ["LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;"] + body + [
                "@!P0 BRA 0x40 ;", "EXIT ;"]:
            lines.append(f"        /*{addr:04x}*/                   {op}"
                         "   /* 0x000fe40000000800 */")
            addr += 16
        lines.append("        ..........")
    for d, ops in vp.ALU_OPS.items():
        t = "f" if d == torch.float32 else "d"
        for op in ops:
            for u in vp.ALU_U.get(op, (8,)):
                key = f"alu_{'f32' if t == 'f' else 'f64'}_{op}_u{u}"
                mark = tool.SASS_MARKS[(t, op)]
                need = 8 * u * (2 if op == "shfl" else 1)
                n = counts.get(key, need)
                body = [f"{mark} R4, R4, R6 ;"] * n + ["DADD R2, R2, R4 ;"]
                if key == "alu_f64_div_u8":     # a predicated mark counts
                    body[0] = f"@P1 {mark} R5, R4 ;"
                emit(f"10alu_kernelI{t}Li{vp.OP_CODES[op]}ELi{u}EEEvPT_"
                     f"ddddi", body)
    for alu in (0, 1):
        for store in (0, 1):
            if alu or store:
                n = counts.get(f"overlap_store{store}", 32) if alu else 0
                emit(f"14overlap_kernelILb{alu}ELb{store}EEEvPfS1_Pdiiiiiddd",
                     ["DFMA R4, R4, 0.5, R6 ;"] * n + ["STG.E [R2], R4 ;"])
    emit("11smem_kernelILi0ELb1EEEvPddii", ["LDS.64 R4, [R2] ;"])
    return "\n".join(lines) + "\n"


def test_compiled_work_counts_each_kernels_steps():
    """Every P2 / P4 kernel's mark at its loop's steps passes; MUFU.RCP64H
    is not counted as MUFU.RCP; the stores-alone P4 kernel and P3's are
    not held to a chain."""
    rows, short = tool.compiled_work(_sass({}))
    assert short == []
    assert rows["alu_f64_fma_u16"] == {"mark": "DFMA", "count": 128,
                                       "need": 128}
    assert rows["alu_f64_shfl_u8"]["need"] == 128
    assert rows["overlap_store1"]["count"] == 32
    assert len(rows) == sum(len(vp.ALU_U.get(op, (8,)))
                            for ops in vp.ALU_OPS.values() for op in ops) + 2
    assert tool.sass_opcodes("") == {}


@pytest.mark.parametrize("key,count", [("alu_f32_recip_u8", 32),
                                       ("alu_f32_roll_u8", 0),
                                       ("alu_f64_log_pos_u8", 63),
                                       ("overlap_store0", 8)])
def test_compiled_work_reports_folded_steps(key, count):
    """A kernel with fewer marks than its loop's steps (ptxas cancelling
    rcp(rcp(x)), a rotation by 32 dropped, a chain cut short) is a
    shortfall."""
    rows, short = tool.compiled_work(_sass({key: count}))
    assert rows[key]["count"] == count
    assert short == [f"sass {key}: {count} {rows[key]['mark']} < "
                     f"{rows[key]['need']}"]


def test_compiled_work_reports_missing_kernels():
    text = _sass({})
    cut = text.index("alu_kernelIfLi5")          # the f32 roll kernel
    start = text.rindex("\t\tFunction", 0, cut)
    end = text.index("\t\tFunction", cut)
    _, short = tool.compiled_work(text[:start] + text[end:])
    assert short == ["sass alu_f32_roll_u8: not in the library"]


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", vp.WRITE_MODES)
def test_write_floor_kernel_matches_ref(cuda_device, mode):
    for n, m in ((40000, 9), (1 << 21, 4)):
        got = vp.write_floor_cuda(m, n, mode, device=cuda_device)
        want = vp.write_floor_ref(m, n, mode, device=cuda_device)
        for g, w in zip(got, want):
            assert g is w is None or torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_alu_kernel_matches_ref(cuda_device, dtype):
    for op in vp.ALU_OPS[dtype]:
        for u in vp.ALU_U.get(op, (8,)):
            got = vp.alu_cuda(op, dtype, u, 8, 8, device=cuda_device)
            want = vp.alu_ref(op, dtype, u, 8, 8, got.numel(), cuda_device)
            torch.testing.assert_close(got, want, rtol=vp.alu_rtol(op, dtype),
                                       atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", vp.SMEM_MODES)
def test_smem_and_overlap_kernels_match_ref(cuda_device, mode):
    for pad in (True, False):
        got = vp.smem_cuda(mode, pad, steps=3, device=cuda_device)
        want = vp.smem_ref(mode, torch.float64, vp.headline_chunk(
            torch.cuda.get_device_properties(
                cuda_device).multi_processor_count), 3,
            got.numel() // vp.ROW_THREADS, cuda_device)
        assert torch.equal(got, want)
    got = vp.overlap_cuda(9, 40000, 16, device=cuda_device)
    want = vp.overlap_ref(9, 40000, 16, device=cuda_device)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_mix_and_bisect_kernels_match_ref(cuda_device):
    """P5 in both modes and every P6 rung against bisect_ref (f64) at a
    short last chunk and at two waves of chunks."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, m in ((40000, 9), (1 << 21, 4)):
        want = vp.mix_ref(m, n, sms=sms, device=cuda_device)
        for mode in vp.MIX_MODES:
            got = vp.mix_cuda(m, n, mode, device=cuda_device)
            assert vp.mix_errors(got, want)[1]
        for steps in vp.ladder():
            got = vp.bisect_cuda(m, n, steps, device=cuda_device)
            want = vp.bisect_ref(m, n, steps, sms=sms, device=cuda_device)
            assert vp.mix_errors(got, want, steps)[1]


@pytest.mark.cuda
def test_branch_kernels_equal_the_top_rung(cuda_device):
    """Each branch rung's outputs bitwise the top rung's, at a short last
    chunk and at (2^16, 64), with cols_plan's blocks and with a quarter of
    them (each block several chunks in turn); the branch refused at 2^21
    rows, where its columns of V do not fit."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, m in ((40000, 9), (1 << 16, 64)):
        top = vp.bisect_cuda(m, n, vp.BISECT_STEPS, device=cuda_device)
        blocks = max(1, vp.cols_plan(n, m, sms).blocks // 4)
        for steps in vp.branch():
            for b in (None, blocks):
                got = vp.bisect_cuda(m, n, steps, device=cuda_device,
                                     blocks=b)
                assert all(torch.equal(g, t) for g, t in zip(got, top))
    with pytest.raises(ValueError, match="shared memory"):
        vp.bisect_cuda(4, 1 << 21, vp.branch()[0], device=cuda_device)


@pytest.mark.cuda
def test_staged_kernel_matches_ref_over_waves(cuda_device):
    """P5 staged, its two buffers, bitwise equal to mix_ref and to P5 mix
    at a short last chunk, at (2^16, 64), and over two waves of chunks at
    (2^21, 4), where a block's buffers carry on from chunk to chunk."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, m in ((40000, 9), (1 << 16, 64), (1 << 21, 4)):
        want = vp.mix_ref(m, n, sms=sms, device=cuda_device)
        got = vp.mix_cuda(m, n, "staged", device=cuda_device)
        assert vp.mix_errors(got, want) == (0.0, True)
        mix = vp.mix_cuda(m, n, "mix", device=cuda_device)
        assert all(torch.equal(g, o) for g, o in zip(got, mix))
    assert vp.cols_plan(1 << 21, 4, sms).chunks > sms
