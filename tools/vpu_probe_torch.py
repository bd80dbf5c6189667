#!/usr/bin/env python
"""The card's floors for the Stirling fills K1-K3: the PyTorch/CUDA
counterpart of tools/vpu_probe.py (its main(): the write floor, the issue
rates, the on-chip memory's access cost) and of its overlap_probe, at the
JAX tool's shapes translated to the card (ops/vpu_probe_cuda.py):

  write    P1 at K3's headline table, (n, m) = (2^20, 1024) f32 x 2 (the
           TPU probe's grid (1024,) of 2 x (256, 32, 128) blocks): full
           (the card's write floor), piecewise (K3's store pattern), onecol
           (V alone); piecewise again at (2^16, 1024)
  alu      P2: every op in f32 and f64 at u = 8 streams, the FMA also at 4
           and 16, 2048 x 8 steps a stream, one full wave of blocks
  smem     P3: K3's row state (f64, its headline chunk, one 512-thread
           block an SM), load1 / load8 / store1 / store8, with and without
           the pad, 1024 steps (one a K3 column); ns per warp access an SM
  overlap  P4: K3's geometry at (2^20, 1024), FMA chains of 64, 128 and 256
           steps a column: the chains alone, the stores alone, both
  ladder   P5 (mix, staged) and every rung of P6's ladder (ops/
           vpu_probe_cuda.py: ladder(), from K3's memory mix step by step
           to K3's structure) and of its branch from the top rung
           (branch(): the top rung with storewarps, with early and with
           both, levers that move work between warps; storewarps left out
           at 2^20 rows, where it does not fit) at both of K3's shapes,
           beside K3
           itself (a = 0.5, f32) in the same process: each rung's time, us
           a column and increment over the rung before (a branch rung's
           over the top rung), timed twice (every rung, then again in the
           reverse order; the time is the mean of the two medians, the
           noise their difference), and the share of K3's time the top
           rung reaches; then P5, the top rung, the branch and K3 at
           (2^16, 256) and (2^16, 512) too, and from the three m each
           one's fill and period (a column pipeline takes fill + m x
           period: the fill is chunks x the hop from chunk to chunk) and
           the line's largest residual

and from them the floors of K1 at its benchmark shape (64 x 16384 x 1024),
K2 at (16384, 1024) and K3 at (2^20, 1024) and (2^16, 1024):

  write floor  K3: its store pattern's time (P1 piecewise); K1, K2: their
               bytes at the card's write rate (P1 full)
  issue floor  a cell's f64 work over the measured rates: 2 div_pos + 1
               log_pos + the cell's other f64 arithmetic (CELL_F64, counted
               from csrc/row_walk.cuh and csrc/fill_table_cols.cu)
  overlap      f = (t_chains + t_stores - t_both) / min(t_chains, t_stores)
               at the chain length where the two are closest: 1 if the card
               runs the two at once (the floors take their max), 0 if one
               after the other (they add)

Times are CUDA events, the median of 5 after a warm call; the ladder's are
each call's device time alone, queued behind a spin (device_timed), with
the host gap a call between events adds beside them.  The card's name,
power limit and SM clock under load (nvidia-smi, sampled while an FMA probe
runs) are printed beside the rates.  A reading that cannot stand fails the
run (impossible()):

  * a rate above 105% of the data sheet's peak (3.35 TB/s; 17e12 f64 and
    33.5e12 f32 FMA/s): the compiler removed work;
  * a timed call's output that differs from its plain version
    (ops/vpu_probe_cuda.py's *_ref, on the same card at the same shape;
    P2's within vp.alu_rtol): the kernel computed something else;
  * a P2 or P4 kernel whose compiled code (cuobjdump -sass of the library)
    holds fewer of its op's instructions than the steps of its unrolled
    loop (SASS_MARKS): the compiler folded steps away.  Most orbits reach
    their fixed point or cycle (roll has period 32) long before the 2048 x
    8 steps, so their values cannot show a step that was skipped; the
    instructions can;
  * an overlap fraction outside [-0.05, 1.05];
  * a ladder rung faster than the rung before it by more than the noise
    (twice the larger of the two rungs' noise, at least LADDER_FLOOR of
    the time), a branch rung faster than the faster of P5's modes by as
    much, or a P6 rung faster than P1 piecewise at the same shape
    (by more than LADDER_FLOOR): the compiler removed work;
  * a P6 rung whose compiled code lacks its step's mark (LADDER_MARKS,
    counted against the rung before it), a branch rung without the marks
    the ladder asks of the top rung (top_marks) or storewarps without its
    arrivals, or P5 staged without its bulk copies.

P5 / P6 outputs are held to their plain versions (bisect_ref) bitwise,
or where div_pos / log_pos are in play (vp.mix_errors) the f64 sinks
within 1e-12 relative and the f32 tables within one f32 ulp; a branch
rung's to the top rung's bitwise.

Readable lines go to stderr, one JSON object to stdout.

--device cpu runs the plain versions at a tiny size, for the tests only:
those times are the CPU's and mean nothing.

Usage:  python tools/vpu_probe_torch.py [--device cuda]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from libstb_tpu_torch.ops import _nvcc
from libstb_tpu_torch.ops import stirling_cuda as sc
from libstb_tpu_torch.ops import vpu_probe_cuda as vp

HBM_BPS = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.float64: 17e12, torch.float32: 33.5e12}   # FMA/s
PLAUSIBLE = 1.05                        # of a peak: more means lost work
OVERLAP_RANGE = (-0.05, 1.05)           # the overlap fraction's, with noise

K1_SHAPE = (64, 1 << 14, 1024)          # bench.py:77, (G, n, m)
K2_SHAPE = (1 << 14, 1024)              # phase 5c, (n, m)
K3_SHAPES = ((1 << 20, 1024), (1 << 16, 1024))   # bench.py:108-140, 6c
# f64 arithmetic a cell beside its two div_pos and one log_pos: K1 / K2's
# row step (row_walk.cuh, walk_rows, lean body: numer 2, denom 2, U 1,
# fmax 1, the log's -d1 or *1/(n-1-a) 1, Kahan 4); K3's (fill_table_cols.cu:
# row_map twice at 4, the composition 2, the replay 1, store_row's Kahan 4)
CELL_F64 = {"K1": 11, "K2": 11, "K3": 15}

# a ladder rung may be this much faster than the rung before it (or P1
# piecewise) without a finding, whatever the measured noise: the TPU
# flags' rungs add ~nothing, and neighbours of equal work differ by up to
# ~3% between medians of 5 at (2^16, 1024) on an H100
LADDER_FLOOR = 0.05
# device_timed's head start for the card, ~20 ms at an H100's 1980 MHz:
# the host queues a reading's calls meanwhile (a call's host work is under
# 0.5 ms)
SPIN_CYCLES = 40_000_000


# f64 operations a cell of each ladder step (a divide or log counted as 20,
# as chip_smoke.FILL_FLOPS): the mix's multiply, add and Srel's + 1; the
# Kahan step; per thread (/ k rows) the vcarry sums, the warp scan's 5
# composition steps and the entering value, per row B = (1 - A) out, the
# composition and the replay; the divide and its 2 + |state|; the log;
# per thread the hand-off's entering value
def ladder_flops(steps, k: int) -> float:
    """f64 operations a cell of P6 at ``steps`` with k rows a thread."""
    has = set(steps).__contains__
    f = 3.0
    f += 4 if has("xscratch") else 0
    f += 4 / k if has("vcarry") else 0
    f += (4 + (3 * (k - 1) + 15 + 2) / k) if has("scan") else 0
    f += 21 if has("div_pos") else 0
    f += 20 if has("log_pos") else 0
    f += 2 / k if has("handoff") else 0
    return f


SIZES = {
    "cuda": dict(write=K3_SHAPES, alu_r=2048, smem_steps=1024,
                 overlap_iters=(64, 128, 256), overlap_shape=K3_SHAPES[0],
                 ladder=K3_SHAPES,
                 ladder_short=((1 << 16, 256), (1 << 16, 512))),
    "cpu": dict(write=((1024, 4), (512, 4)), alu_r=2, smem_steps=1,
                overlap_iters=(8, 16), overlap_shape=(1024, 4),
                ladder=((1024, 4), (2048, 3)),
                ladder_short=((1024, 2), (1024, 3))),
}
CPU_THREADS = 64                        # P2's threads on the CPU
CPU_SMEM_CHUNK = 1024                   # P3's chunk on the CPU


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu, host clock"
    return _smi(device, "name,power.limit")


def _smi(device, query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         f"--id={device.index}"], capture_output=True, text=True, check=True)
    return res.stdout.strip()


def timed(fn, device, reps=5):
    """(median ms over ``reps`` runs after a warm call, last result):
    CUDA events on a card, the host clock on the CPU."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def device_timed(fn, device, reps=5):
    """(device ms, call ms, last result).  Device ms: the median over
    ``reps`` calls of the card's time for one call's work, each call
    queued behind a spin of SPIN_CYCLES, so that its pair of CUDA events
    brackets the kernels it launched and not the host's time to launch
    them; fails if the spin ended before the host had queued every call.
    Call ms: timed(fn), whose window opens on an idle card and so also
    holds the wrapper's host work.  On the CPU both are timed()'s."""
    call_ms, out = timed(fn, device, reps)
    if device.type != "cuda":
        return call_ms, call_ms, out
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spun = torch.cuda.Event()
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SPIN_CYCLES)
    spun.record()
    for start, end in pairs:
        start.record()
        out = fn()
        end.record()
    if spun.query():
        raise RuntimeError(f"device_timed: the card ran out of its "
                           f"{SPIN_CYCLES}-cycle spin before the host had "
                           f"queued {reps} calls")
    torch.cuda.synchronize(device)
    return (float(np.median([s.elapsed_time(e) for s, e in pairs])),
            call_ms, out)


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


def _mismatch(res, what):
    """Record that a timed call's output differs from its plain version."""
    res.setdefault("mismatch", []).append(what)


def write_floors(device, card, shapes, res, reps=5):
    """P1's modes at shapes[0], piecewise at the others: ms and GB/s.  On
    the card each mode's output is held bitwise to write_floor_ref."""
    on_card = device.type == "cuda"
    rows = {}
    n, m = shapes[0]
    out = (torch.empty((m, n), device=device),
           torch.empty((m, n), device=device)) if on_card else None
    todo = [(mode, n, m) for mode in vp.WRITE_MODES] + [
        ("piecewise", n_, m_) for n_, m_ in shapes[1:]]
    for mode, n_, m_ in todo:
        if on_card:
            o = out if (n_, m_) == (n, m) else None
            fn = (lambda: vp.write_floor_cuda(m_, n_, mode, device=device,
                                              out=o))
        else:
            fn = (lambda: vp.write_floor_ref(m_, n_, mode, device=device))
        ms, got = timed(fn, device, reps)
        nbytes = (1 if mode == "onecol" else 2) * 4 * m_ * n_
        key = mode if (n_, m_) == (n, m) else f"{mode}_{n_}"
        if on_card:
            want = vp.write_floor_ref(m_, n_, mode, device=device)
            if not all(g is w is None or torch.equal(g, w)
                       for g, w in zip(got, want)):
                _mismatch(res, f"write {key}")
            del want
        del got
        rows[key] = {"mode": mode, "n": n_, "m": m_, "ms": ms,
                     "bytes": nbytes, "GBps": nbytes / (ms * 1e6)}
        _say(f"write {mode:9s} (n, m) = ({n_}, {m_}): {ms:.4f} ms = "
             f"{nbytes / (ms * 1e6):.1f} GB/s [{card}]")
    del out
    return rows


def alu_rates(device, card, r, res, reps=5):
    """P2 for every op: ms, ops/s (one op = one step of one stream of one
    thread), threads.  On the card each op's sums are held to alu_ref
    within vp.alu_rtol (rel_err)."""
    rows = {}
    for dtype, ops in vp.ALU_OPS.items():
        dt = "f32" if dtype == torch.float32 else "f64"
        for op in ops:
            for u in vp.ALU_U.get(op, (8,)):
                if device.type == "cuda":
                    blocks = vp.alu_blocks(op, dtype, u, device)
                    threads = blocks * vp.ALU_THREADS
                    fn = (lambda: vp.alu_cuda(op, dtype, u, r, vp.ALU_UNROLL,
                                              device))
                else:
                    threads = CPU_THREADS
                    fn = (lambda: vp.alu_ref(op, dtype, u, r, vp.ALU_UNROLL,
                                             threads, device))
                ms, got = timed(fn, device, reps)
                ops_n = threads * u * r * vp.ALU_UNROLL
                rate = ops_n / (ms * 1e-3)
                key = f"{dt}_{op}_u{u}"
                rows[key] = {"dtype": dt, "op": op, "u": u,
                             "threads": threads, "ms": ms, "ops": ops_n,
                             "ops_per_s": rate}
                if device.type == "cuda":
                    want = vp.alu_ref(op, dtype, u, r, vp.ALU_UNROLL,
                                      vp.ALU_PERIOD, device)[
                        torch.arange(threads, device=device) % vp.ALU_PERIOD]
                    err = ((got - want).abs() / want.abs()).max().item()
                    rows[key]["rel_err"] = err
                    if not (torch.isfinite(got).all()
                            and err <= vp.alu_rtol(op, dtype)):
                        _mismatch(res, f"alu {key}: relative error {err:.3g}")
                _say(f"alu {dt} {op:7s} u={u:2d}: {rate / 1e12:.4f} T ops/s "
                     f"({ms:.4f} ms, {threads} threads) [{card}]")
    return rows


def smem_costs(device, card, steps, res, reps=5):
    """P3 in f64 at K3's headline chunk, each mode with and without the
    pad: ms and ns per warp access of one SM (one block an SM).  On the
    card each output is held bitwise to smem_ref."""
    rows = {}
    on_card = device.type == "cuda"
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if on_card else 1
    chunk = vp.headline_chunk(sms) if on_card else CPU_SMEM_CHUNK
    k = chunk // vp.ROW_THREADS
    for mode in vp.SMEM_MODES:
        w = vp.smem_rows(mode)
        want = (vp.smem_ref(mode, torch.float64, chunk, steps, sms, device)
                if on_card else None)
        for pad in (True, False):
            if on_card:
                fn = (lambda: vp.smem_cuda(mode, pad, chunk, steps,
                                           device=device))
            else:
                fn = (lambda: vp.smem_ref(mode, torch.float64, chunk, steps,
                                          1, device))
            ms, got = timed(fn, device, reps)
            key = f"{mode}_{'pad' if pad else 'nopad'}"
            if on_card and not torch.equal(got, want):
                _mismatch(res, f"smem {key}")
            accesses = (vp.ROW_THREADS // 32) * steps * (k // w)
            ns = ms * 1e6 / accesses
            rows[key] = {
                "mode": mode, "pad": pad, "chunk": chunk, "steps": steps,
                "ms": ms, "warp_accesses_an_sm": accesses,
                "ns_per_warp_access": ns}
            _say(f"smem {mode} {'pad  ' if pad else 'nopad'} (chunk {chunk}, "
                 f"f64): {ns:.4f} ns per warp access an SM ({ms:.4f} ms) "
                 f"[{card}]")
    return rows


def overlap(device, card, shape, iters_list, res, reps=5):
    """P4: the chains alone, the stores alone, both, at each chain length;
    the overlap fraction at each.  On the card each output is held
    bitwise to overlap_ref."""
    n, m = shape
    on_card = device.type == "cuda"
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if on_card else 132
    out = (torch.empty((m, n), device=device),
           torch.empty((m, n), device=device)) if on_card else None
    rows = {}
    for iters in iters_list:
        t = {}
        for name, alu, store in (("chains", True, False),
                                 ("stores", False, True),
                                 ("both", True, True)):
            if on_card:
                fn = (lambda: vp.overlap_cuda(m, n, iters, alu, store, device,
                                              out if store else None))
            else:
                fn = (lambda: vp.overlap_ref(m, n, iters if alu else 0, store,
                                             device=device))
            t[name], got = timed(fn, device, reps)
            if on_card:
                want = vp.overlap_ref(m, n, iters if alu else 0, store, sms,
                                      device)
                if not all(torch.equal(g, w) for g, w in zip(
                        got if store else [got], want if store else [want])):
                    _mismatch(res, f"overlap {iters} {name}")
                del want
            del got
        frac = ((t["chains"] + t["stores"] - t["both"])
                / min(t["chains"], t["stores"]))
        rows[str(iters)] = {"iters": iters, **{f"{k}_ms": v
                                               for k, v in t.items()},
                            "fraction": frac}
        _say(f"overlap (n, m) = ({n}, {m}), {iters} FMA steps a column: "
             f"chains {t['chains']:.4f} ms, stores {t['stores']:.4f} ms, "
             f"both {t['both']:.4f} ms: overlap fraction {frac:.4f} [{card}]")
    del out
    return rows


TOP = vp.BISECT_STEPS[-1]               # the ladder's top rung, by its step
# the branch's rungs, by their levers
BRANCH = tuple("_".join(st[len(vp.BISECT_STEPS):]) for st in vp.branch())


def ladder_rungs():
    """[(name, steps, staged)]: P5's mix, P6's rungs in order (each named
    by the step it adds), P5 staged beside the ladder, and the branch from
    the top rung (BRANCH: each named by its levers)."""
    return ([("mix", (), False)]
            + [(st[-1], st, False) for st in vp.ladder()]
            + [("staged", (), True)]
            + [(name, st, False) for name, st in zip(BRANCH, vp.branch())])


def rung_before():
    """{P6 rung: the rung its increment and its marks count against}: the
    ladder's rung before it (mix for the first), the top rung for a branch
    rung."""
    names = [st[-1] for st in vp.ladder()]
    return {**dict(zip(names, ["mix"] + names)),
            **{name: TOP for name in BRANCH}}


def in_branch(name: str) -> bool:
    return name in BRANCH


def rung_fits(steps, staged, n, m, sms, piece=vp.PIECE) -> bool:
    """Whether the kernel takes (steps, staged) at (n, m) (vp.mix_plan):
    storewarps' two columns of V do not fit beside K3's state at 2^20
    rows."""
    try:
        vp.mix_plan("ladder", steps, staged, m, n, piece, sms)
    except ValueError:
        return False
    return True


def ladder_summary(shape_row) -> str:
    """One shape's ladder as text: each rung's us a column (+ over the rung
    before)."""
    return ", ".join(
        f"{name} {r['us_col']:.4f}" + ("" if r.get("inc_us_col") is None
                                       else f" ({r['inc_us_col']:+.4f})")
        for name, r in shape_row["rungs"].items())


def ladder(device, card, shapes, res, reps=5, names=None):
    """P5 and P6's ladder and branch at each (n, m) of ``shapes`` beside K3
    (a = 0.5, f32) and P1 piecewise: per rung ms, a call's device time
    (device_timed; the mean of a forward and a reverse pass, each a median
    of ``reps``), noise_ms (their difference), us a column and its
    increment over the rung before (rung_before), host_ms (a call's time
    between CUDA events less its device time: the wrapper's host work),
    the plain version's host time and the largest difference from it;
    top_share, the top rung's device time over K3's.  ``names``: the rungs
    to run (all of ladder_rungs() if None); a rung the kernel does not
    take at a shape (rung_fits) is left out there.  On the card each
    output is held to bisect_ref (vp.mix_errors) and each branch rung's
    to the top rung's bitwise (equal_top)."""
    on_card = device.type == "cuda"
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if on_card else 132
    before = rung_before()
    rows = {}
    for n, m in shapes:
        rungs = [r for r in ladder_rungs() if (names is None or r[0] in names)
                 and rung_fits(r[1], r[2], n, m, sms)]
        a32 = torch.full((1,), vp.A_SMEM, device=device)
        k3 = (sc.fill_table_cols_cuda if on_card else sc.fill_table_cols_ref)
        k3_ms, k3_call_ms, got = device_timed(lambda: k3(a32[0], n, m),
                                              device, reps)
        del got
        plan = vp.cols_plan(n, m, sms)
        bufs = (torch.empty((m, n), device=device),
                torch.empty((m, n), device=device),
                torch.empty((plan.chunks * vp.ROW_THREADS, 2),
                            dtype=torch.float64, device=device),
                torch.empty(n, dtype=torch.float64, device=device))
        pw_ms = None
        if on_card:
            pw_ms, _, got = device_timed(
                lambda: vp.write_floor_cuda(m, n, "piecewise", device=device,
                                            out=bufs[:2]), device, reps)
            del got
        entry, top_out = {}, None
        for name, steps, staged in rungs + rungs[::-1]:
            if on_card:
                out = tuple(b if i < 2 or (i == 2 and "vcarry" in steps) or (
                    i == 3 and "xscratch" in steps) else None
                    for i, b in enumerate(bufs))
                for b in out:
                    if b is not None:
                        b.fill_(float("nan"))
                if steps:
                    fn = (lambda: vp.bisect_cuda(m, n, steps, a=a32,
                                                 device=device, out=out))
                else:
                    fn = (lambda: vp.mix_cuda(m, n, name, device=device,
                                              out=out[:2]))
            else:
                fn = (lambda: vp.bisect_ref(m, n, steps, device=device))
            ms, call_ms, got = device_timed(fn, device, reps)
            if name in entry:
                row = entry[name]
                row["ms_rev"] = ms
                row["ms"] = (row["ms_fwd"] + ms) / 2
                row["noise_ms"] = abs(row["ms_fwd"] - ms)
                row["us_col"] = row["ms"] * 1e3 / m
                row["host_ms"] = (row["call_ms_fwd"] + call_ms) / 2 - row["ms"]
                continue
            row = entry[name] = {"steps": list(steps), "staged": staged,
                                 "ms_fwd": ms, "call_ms_fwd": call_ms}
            if name == TOP and any(in_branch(r[0]) for r in rungs):
                top_out = tuple(None if g is None else g.clone()
                                for g in got)
            elif in_branch(name) and top_out is not None:
                row["equal_top"] = all(
                    g is t is None or (g is not None and t is not None
                                       and torch.equal(g, t))
                    for g, t in zip(got, top_out))
                if not row["equal_top"]:
                    _mismatch(res, f"ladder {name} at ({n}, {m}) differs "
                                   f"from the top rung {TOP}")
            if on_card:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                want = vp.bisect_ref(m, n, steps, sms=sms, device=device)
                torch.cuda.synchronize(device)
                row["plain_ms"] = (time.perf_counter() - t0) * 1e3
                err, ok = vp.mix_errors(tuple(got), want, steps)
                row["max_abs_err"] = err
                row["exact"] = vp.bisect_exact(steps)
                if not ok:
                    _mismatch(res, f"ladder {name} at ({n}, {m}): largest "
                                   f"difference {err:.3g}")
                del want
            del got
        del top_out
        for name, row in entry.items():
            if not row["staged"]:
                row["inc_us_col"] = (row["us_col"]
                                     - entry[before[name]]["us_col"]
                                     if before.get(name) in entry else None)
        rows[str(n)] = {"n": n, "m": m, "k3_ms": k3_ms,
                        "k3_us_col": k3_ms * 1e3 / m,
                        "k3_host_ms": k3_call_ms - k3_ms,
                        "piecewise_ms": pw_ms, "chunk": plan.chunk,
                        "chunks": plan.chunks, "rungs": entry,
                        "top_share": (entry[TOP]["ms"] / k3_ms
                                      if TOP in entry else None)}
        for name, row in entry.items():
            inc = row.get("inc_us_col")
            _say(f"ladder ({n}, {m}) {name:10s} {row['ms']:.4f} ms "
                 f"(+-{row['noise_ms']:.4f}) = {row['us_col']:.4f} us a "
                 f"column" + ("" if inc is None else f", {inc:+.4f} over "
                              f"{before[name]}") + f"; host gap "
                 f"{row['host_ms']:.4f} ms [{card}]")
        _say(f"ladder ({n}, {m}): K3 {k3_ms:.4f} ms = "
             f"{k3_ms * 1e3 / m:.4f} us a column (host gap "
             f"{k3_call_ms - k3_ms:.4f} ms), P1 piecewise "
             + ("not timed" if pw_ms is None else f"{pw_ms:.4f} ms")
             + ("" if rows[str(n)]["top_share"] is None else
                f"; the top rung reaches "
                f"{100 * rows[str(n)]['top_share']:.2f}% of K3")
             + f" [{card}]")
        del bufs
    return rows


# the rungs timed again at shorter m of K3_SHAPES[1]'s n (SIZES'
# ladder_short): the three m give each one's fill and period (fill_period);
# log_pos, the rung before the hand-off, splits the hand-off's increment
# into the two
FIT_RUNGS = ("mix", "log_pos", TOP) + BRANCH + ("staged",)


def ladder_short(device, card, shapes, res, reps=5):
    """FIT_RUNGS' ladder (ladder(names=FIT_RUNGS)) at each (n, m) of
    ``shapes``, keyed "<n>x<m>"."""
    return {f"{n}x{m}": ladder(device, card, ((n, m),), res, reps,
                               names=FIT_RUNGS)[str(n)]
            for n, m in shapes}


def fill_period(points):
    """The least-squares line through [(m, ms)]: a column pipeline takes
    fill + m x period, the fill (chunks x a hop from chunk to chunk, paid
    once a call) and the period (a column's chain): (fill ms, period us,
    the largest distance of a point from the line in us, 0 through two
    points)."""
    ms_ = np.array([m for m, _ in points], dtype=np.float64)
    t = np.array([t for _, t in points], dtype=np.float64)
    if len(points) < 2 or np.ptp(ms_) == 0:
        raise ValueError(f"fill_period: two or more m needed, not {points}")
    slope, icept = np.polyfit(ms_, t, 1)
    resid = np.abs(t - (icept + slope * ms_)).max()
    return float(icept), float(slope * 1e3), float(resid * 1e3)


def fits(long_rows, short_rows):
    """Each rung's, and K3's, fill and period from its times at one n in
    the ladders (ladder's rows and ladder_short's), over the rungs timed
    at every m of that n: {n: {name: {"fill_ms", "period_us", "resid_us",
    "hop_us"}}}, resid_us fill_period's residual, hop_us the fill over
    the chunks."""
    by_n = {}
    for sh in list(long_rows.values()) + list(short_rows.values()):
        by_n.setdefault(str(sh["n"]), []).append(sh)
    out = {}
    for key, shs in by_n.items():
        if len({sh["m"] for sh in shs}) < 2:
            continue
        names = [x for x in shs[-1]["rungs"]
                 if all(x in sh["rungs"] for sh in shs)]
        times = {"K3": [(sh["m"], sh["k3_ms"]) for sh in shs]}
        times.update({x: [(sh["m"], sh["rungs"][x]["ms"]) for sh in shs]
                      for x in names})
        out[key] = {}
        for name, pts in times.items():
            fill, period, resid = fill_period(pts)
            out[key][name] = {"fill_ms": fill, "period_us": period,
                              "resid_us": resid,
                              "hop_us": fill * 1e3 / shs[0]["chunks"]}
    return out


def fit_ms(res, key) -> str:
    """The m the fits at n = ``key`` were taken from, as text."""
    return ", ".join(str(sh["m"]) for part in ("ladder", "ladder_short")
                     for sh in res[part].values() if str(sh["n"]) == key)


def fit_summary(fit_rows) -> str:
    """The fits of one n as text: name fill ms + period us a column (the
    hop, the residual)."""
    return ", ".join(f"{name} {f['fill_ms']:.4f} ms + {f['period_us']:.4f} "
                     f"us a column (hop {f['hop_us']:.4f} us, residual "
                     f"{f['resid_us']:.4f} us)"
                     for name, f in fit_rows.items())


# P2's and P4's kernels in the compiled library, by their mangled names,
# and the instruction that marks one step of each: the step's own FMA,
# multiply or shuffle; the hardware reciprocal each divide starts from
# (and f64 log and log_pos, whose reductions divide); for logf, whose
# polynomial has no hardware seed, the conversion of its exponent to f32.
# The unrolled loop holds ALU_UNROLL x u steps (P4: 8 x 4 chains); a
# double shuffle is two 32-bit ones.
_KERNEL = re.compile(r"(alu_kernelI([fd])Li(\d+)ELi(\d+)EE|"
                     r"overlap_kernelILb([01])ELb([01])EE)")
_OP_NAMES = {code: op for op, code in vp.OP_CODES.items()}
SASS_MARKS = {("f", "fma"): "FFMA", ("f", "mul"): "FMUL",
              ("f", "log"): "I2FP.F32.S32", ("f", "recip"): "MUFU.RCP",
              ("f", "div"): "MUFU.RCP", ("f", "roll"): "SHFL.IDX",
              ("d", "fma"): "DFMA", ("d", "mul"): "DMUL",
              ("d", "div_pos"): "MUFU.RCP64H", ("d", "log_pos"): "MUFU.RCP64H",
              ("d", "div"): "MUFU.RCP64H", ("d", "log"): "MUFU.RCP64H",
              ("d", "shfl"): "SHFL.UP", "overlap": "DFMA"}
_SASS_OP = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def sass_opcodes(text: str) -> dict:
    """{function name: Counter of opcodes} of cuobjdump -sass output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            cur = funcs.setdefault(line.split("Function : ", 1)[1].strip(),
                                   Counter())
            continue
        hit = _SASS_OP.match(line)
        if hit and cur is not None:
            cur[hit.group(1)] += 1
    return funcs


def _count(ops: Counter, mark: str) -> int:
    return sum(c for op, c in ops.items()
               if op == mark or op.startswith(mark + "."))


def compiled_work(text: str):
    """Each P2 / P4 kernel's count of its step's mark (SASS_MARKS) in the
    cuobjdump -sass ``text`` against the steps of its unrolled loop:
    ({kernel: {"mark", "count", "need"}}, [shortfalls])."""
    rows, short = {}, []
    for name, ops in sass_opcodes(text).items():
        hit = _KERNEL.search(name)
        if not hit:
            continue
        if hit.group(2):
            t, op, u = hit.group(2), _OP_NAMES[int(hit.group(3))], \
                int(hit.group(4))
            key = f"alu_{'f32' if t == 'f' else 'f64'}_{op}_u{u}"
            mark = SASS_MARKS[(t, op)]
            need = vp.ALU_UNROLL * u * (2 if op == "shfl" else 1)
        else:
            if hit.group(5) == "0":          # the stores alone: no chain
                continue
            key = f"overlap_store{hit.group(6)}"
            mark, need = SASS_MARKS["overlap"], 8 * 4
        rows[key] = {"mark": mark, "count": _count(ops, mark), "need": need}
        if rows[key]["count"] < need:
            short.append(f"sass {key}: {rows[key]['count']} {mark} < {need}")
    want = {f"alu_{'f32' if d == torch.float32 else 'f64'}_{op}_u{u}"
            for d, ops in vp.ALU_OPS.items() for op in ops
            for u in vp.ALU_U.get(op, (8,))} | {"overlap_store0",
                                                 "overlap_store1"}
    short += [f"sass {k}: not in the library" for k in sorted(want - set(rows))]
    return rows, short


# P5 / P6's kernels by their template arguments (the steps' bits,
# staged), and the mark of each step that its values cannot show, counted
# in the rung's kernel against the rung before it (P5 staged: against P5
# mix; a branch rung: against the top rung): the named barriers, the
# scan's shuffles (a double is two), the divide's hardware reciprocal
# (log_pos's reduction divides too), the hand-off's ticket and its relaxed
# poll, storewarps' arrivals (at full and at empty), staged's bulk copies.
# A branch rung also holds every mark the ladder asks of the top rung:
# each at least its needs summed over the nine steps above P5 mix's count.
_MIX = re.compile(r"mix_kernelILi(\d+)ELb([01])EE")
LADDER_MARKS = {"barriers": (("BAR.SYNC", 2),),
                "scan": (("SHFL.UP", 20),),
                "div_pos": (("MUFU.RCP64H", 1),),
                "log_pos": (("MUFU.RCP64H", 1),),
                "handoff": (("ATOMG", 1), ("LDG.E.64.STRONG.GPU", 1)),
                "storewarps": (("BAR.ARV", 2),),
                "staged": (("UBLKCP", 2),)}


def _count_prefix(ops: Counter, mark: str) -> int:
    return sum(c for op, c in ops.items() if op.startswith(mark))


def top_marks() -> dict:
    """{mark: need}: the marks of the ladder's nine steps, their needs
    summed (what the top rung holds over P5 mix)."""
    need = Counter()
    for step in vp.BISECT_STEPS:
        for mark, n in LADDER_MARKS.get(step, ()):
            need[mark] += n
    return dict(need)


def ladder_work(text: str):
    """Each ladder rung's marks (LADDER_MARKS) in the cuobjdump -sass
    ``text``, against the rung before it (a branch rung's against the top
    rung), and each branch rung's top_marks() against P5 mix: ({"rung
    mark": {"count", "before", "need"}}, [shortfalls]); a rung's kernel
    missing from the library is a shortfall."""
    kern = {}
    for name, ops in sass_opcodes(text).items():
        hit = _MIX.search(name)
        if hit:
            kern[(int(hit.group(1)), hit.group(2) == "1")] = ops
    rows, short = {}, []
    mix = kern.get((0, False))
    top = kern.get((vp.steps_bits(vp.BISECT_STEPS), False))
    prev = None

    def hold(key, ops, mark, base, need):
        count = _count_prefix(ops, mark)
        before = _count_prefix(base, mark) if base is not None else 0
        rows[key] = {"count": count, "before": before, "need": need}
        if count - before < need:
            short.append(f"sass {key.split()[0]}: {count} {mark} against "
                         f"{before} in the rung before, < +{need}")

    for name, steps, staged in ladder_rungs():
        key = (vp.steps_bits(steps), staged)
        if key not in kern:
            short.append(f"sass {name}: not in the library")
            continue
        base = mix if staged else top if in_branch(name) else prev
        for part in name.split("_") if in_branch(name) else (name,):
            for mark, need in LADDER_MARKS.get(part, ()):
                hold(f"{name} {mark}", kern[key], mark, base, need)
        if in_branch(name):
            for mark, need in top_marks().items():
                hold(f"{name} {mark} (top)", kern[key], mark, mix, need)
        elif not staged:
            prev = kern[key]
    return rows, short


def sass_check(device):
    """compiled_work() and ladder_work() of the probes' library
    (cuobjdump -sass beside nvcc); None on the CPU."""
    if device.type != "cuda":
        return None
    dump = Path(_nvcc.nvcc()).with_name("cuobjdump")
    lib = _nvcc.build_all(vp.SOURCES)["vpu_probe"]
    text = subprocess.run([str(dump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    rows, short = compiled_work(text)
    lrows, lshort = ladder_work(text)
    return {"kernels": rows, "ladder": lrows, "short": short + lshort}


def floors(res):
    """The write, issue and combined floors of K1-K3 from the readings."""
    alu = res["alu"]
    r_fma = max(v["ops_per_s"] for k, v in alu.items()
                if k.startswith("f64_fma_"))
    r_div = alu["f64_div_pos_u8"]["ops_per_s"]
    r_log = alu["f64_log_pos_u8"]["ops_per_s"]
    # the div_pos and log_pos probes' steps each carry one add (x + 1,
    # + 1.54), priced at the FMA rate and taken off
    cell_s = {kern: (cnt - 3) / r_fma + 2 / r_div + 1 / r_log
              for kern, cnt in CELL_F64.items()}
    full = res["write"]["full"]
    write_bps = full["bytes"] / (full["ms"] * 1e-3)
    ov = min(res["overlap"].values(),
             key=lambda x: abs(x["chains_ms"] - x["stores_ms"]))
    f = ov["fraction"]               # impossible() bounds it, unclamped here
    g, n1, m1 = K1_SHAPE
    shapes = [("K1", g * n1 * m1, None), ("K2", K2_SHAPE[0] * K2_SHAPE[1],
                                          None)]
    for n, m in K3_SHAPES:
        shapes.append(("K3", n * m, n))
    rows = {}
    for kern, cells, n in shapes:
        piece = next((v for v in res["write"].values()
                      if v["mode"] == "piecewise" and v["n"] == n), None)
        w_ms = (piece["ms"] * cells / (piece["n"] * piece["m"]) if piece
                else 8 * cells / write_bps * 1e3)
        i_ms = cells * cell_s[kern] * 1e3
        both = max(w_ms, i_ms) + (1 - f) * min(w_ms, i_ms)
        key = kern if n is None else f"{kern}_{n}"
        rows[key] = {"cells": cells, "write_floor_ms": w_ms,
                     "write_from": "piecewise" if piece else "full",
                     "issue_floor_ms": i_ms, "floor_ms": both,
                     "cell_ns": cell_s[kern] * 1e9}
    return {"f64_fma_per_s": r_fma, "f64_div_pos_per_s": r_div,
            "f64_log_pos_per_s": r_log, "write_Bps": write_bps,
            "overlap_fraction": f, "overlap_iters": ov["iters"],
            "kernels": rows}


def _ladders(res):
    """(label, shape row) of every ladder the readings hold."""
    for part in ("ladder", "ladder_short"):
        yield from (res.get(part) or {}).items()


def _ladder_impossible(key, sh):
    """One shape's ladder readings that cannot stand: a byte rate over the
    device memory's; a P6 rung faster than P1 piecewise; a ladder rung
    faster than the rung before it by more than the noise (twice the
    larger of the two rungs' noise, at least LADDER_FLOOR of its time); a
    branch rung faster than the faster of P5's modes by as much (it does
    their work and more)."""
    bad = []
    nbytes = 2 * 4 * sh["n"] * sh["m"]
    rungs = sh["rungs"]
    before = rung_before()
    floor = min((rungs[x] for x in vp.MIX_MODES if x in rungs),
                key=lambda r: r["ms"], default=None)
    for name, _, staged in ladder_rungs():
        row = rungs.get(name)
        if row is None:
            continue
        if nbytes / (row["ms"] * 1e-3) > PLAUSIBLE * HBM_BPS:
            bad.append(f"ladder {key} {name}: "
                       f"{nbytes / (row['ms'] * 1e6):.1f} GB/s")
        if staged:
            continue
        pw = sh.get("piecewise_ms")
        if pw and row["ms"] < (1 - LADDER_FLOOR) * pw:
            bad.append(f"ladder {key} {name}: {row['ms']:.4f} ms, "
                       f"faster than P1 piecewise's {pw:.4f}")
        ref = (floor if in_branch(name) else rungs.get(before.get(name)))
        if ref is None:
            continue
        slack = max(2 * max(row["noise_ms"], ref["noise_ms"]),
                    LADDER_FLOOR * ref["ms"])
        if ref["ms"] - row["ms"] > slack:
            what = ("the faster of P5's modes" if in_branch(name)
                    else "the rung before")
            bad.append(f"ladder {key} {name}: {row['ms']:.4f} ms, faster "
                       f"than {what} ({ref['ms']:.4f}) by more than "
                       f"{slack:.4f}")
    return bad


def impossible(res):
    """The readings that cannot stand: a byte rate over the device
    memory's or an op rate over the FMA rate of its type (PLAUSIBLE x the
    data sheet), an overlap fraction outside OVERLAP_RANGE, a timed
    output unequal to its plain version, a kernel whose compiled code
    lacks its steps."""
    bad = []
    for k, v in res["write"].items():
        if v["GBps"] * 1e9 > PLAUSIBLE * HBM_BPS:
            bad.append(f"write {k}: {v['GBps']:.1f} GB/s")
    for k, v in res["alu"].items():
        peak = PEAK_OPS[torch.float32 if v["dtype"] == "f32"
                        else torch.float64]
        if v["ops_per_s"] > PLAUSIBLE * peak:
            bad.append(f"alu {k}: {v['ops_per_s']:.4g} ops/s")
    n, m = res["overlap_shape"]
    lo, hi = OVERLAP_RANGE
    for k, v in res["overlap"].items():
        for part in ("stores", "both"):
            bps = 2 * 4 * n * m / (v[f"{part}_ms"] * 1e-3)
            if bps > PLAUSIBLE * HBM_BPS:
                bad.append(f"overlap {k} {part}: {bps / 1e9:.1f} GB/s")
        if not lo <= v["fraction"] <= hi:
            bad.append(f"overlap {k}: fraction {v['fraction']:.4f} outside "
                       f"[{lo}, {hi}]")
    for key, sh in _ladders(res):
        bad += _ladder_impossible(key, sh)
    bad += res.get("mismatch", [])
    if res.get("sass"):
        bad += res["sass"]["short"]
    return bad


def clocks_under_load(device, fn, reps=200):
    """nvidia-smi's SM clock and its maximum, MHz, sampled while ``reps``
    calls of ``fn`` run on the card."""
    if device.type != "cuda":
        return None
    for _ in range(reps):
        fn()
    smi = _smi(device, "clocks.sm,clocks.max.sm")
    torch.cuda.synchronize(device)
    sm, top = (int(x.split()[0]) for x in smi.split(","))
    return {"sm_mhz": sm, "max_sm_mhz": top}


def run(device, card, sizes):
    """Every measurement at ``sizes`` (SIZES[...]); the readings, the
    floors, and on the card the checks that impossible() reads."""
    res = {"device": card, "torch": torch.__version__}
    res["sass"] = sass_check(device)
    res["write"] = write_floors(device, card, sizes["write"], res)
    res["alu"] = alu_rates(device, card, sizes["alu_r"], res)
    res["clocks_sm_under_load"] = clocks_under_load(device, lambda: vp.alu_cuda(
        "fma", torch.float64, 8, sizes["alu_r"], vp.ALU_UNROLL,
        device=device))
    res["smem"] = smem_costs(device, card, sizes["smem_steps"], res)
    res["overlap_shape"] = list(sizes["overlap_shape"])
    res["overlap"] = overlap(device, card, sizes["overlap_shape"],
                             sizes["overlap_iters"], res)
    res["ladder"] = ladder(device, card, sizes["ladder"], res)
    res["ladder_short"] = ladder_short(device, card, sizes["ladder_short"],
                                       res)
    res["fit"] = fits(res["ladder"], res["ladder_short"])
    for key, f in res["fit"].items():
        _say(f"ladder fill + period at n = {key} (m = "
             f"{fit_ms(res, key)}): {fit_summary(f)} [{card}]")
    res["floors"] = floors(res)
    for kern, f in res["floors"]["kernels"].items():
        _say(f"{kern}: write floor {f['write_floor_ms']:.4f} ms "
             f"({f['write_from']}), issue floor {f['issue_floor_ms']:.4f} ms "
             f"({f['cell_ns'] * 1e3:.4f} ps a cell), with the overlap "
             f"{f['floor_ms']:.4f} ms [{card}]")
    clk = res["clocks_sm_under_load"]
    if clk:
        _say(f"SM clock under load {clk['sm_mhz']} MHz of "
             f"{clk['max_sm_mhz']} [{card}]")
    if res["sass"]:
        _say("compiled steps (mark: count / need): " + ", ".join(
            f"{k} {v['mark']} {v['count']}/{v['need']}"
            for k, v in sorted(res["sass"]["kernels"].items())))
        _say("ladder marks (count, the rung before, need): " + ", ".join(
            f"{k} {v['count']}/{v['before']}/+{v['need']}"
            for k, v in res["sass"]["ladder"].items()))
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("vpu_probe_torch: --device cuda but no CUDA "
                             "device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    card = card_label(device)
    _say(f"# vpu_probe_torch device={device} [{card}] torch "
         f"{torch.__version__} cuda {torch.version.cuda}")
    res = run(device, card, SIZES["cuda" if device.type == "cuda"
                                  else "cpu"])
    print(json.dumps(res), flush=True)
    bad = impossible(res) if device.type == "cuda" else []
    if bad:
        raise SystemExit("vpu_probe_torch: readings above the data sheet "
                         f"(work removed?): {bad}")
    return res


if __name__ == "__main__":
    main()
