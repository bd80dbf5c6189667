#!/usr/bin/env python
"""On-card measurements of the port that chip_smoke.py's gates do not
take: the PyTorch/CUDA counterpart of tools/extra_bench.py, its seven
workloads at its shapes (each function's keyword defaults; the tests call
them small).

  make      production stirling.make at (2^20, 1024): the wall time, and
            apart the parts of the route it takes: the fill (K3, CUDA
            events) and, on a card, the anchored S1 (the f64 host anchors,
            their copy, the fill of the pair on the card); beside them the
            host route's S1 (s1_host, its hi/lo split, the pair's copy)
  ensure    ensure(2^19 -> 2^20), a refill through make: the wall time and
            the peak of allocated device memory beside the old and new
            tables' bytes; against a fresh make at 2^20, which it must
            equal bitwise on a card (same kernel, same discount)
  xfer      the 8 MB S1 hi/lo pair of a 2^20-row table copied to the card
            from pageable and from pinned host memory
  sparse    sample_a over 2^20 + 17 occupied pairs (psample.h:101-115's
            getval workload, streamed in chunks): samples/s, pair-terms/s,
            and the streamed curve's time apart
  hsa       hsa_sweep (the item-order oracle, 6 x 400 items, 32 chains)
  hsapairs  the staged pair-major HSA at check.c scale (10^5 items)
  ctw       ctw_sweep_rel at check.c scale by the point-query route
            (m_sel 0) and the row route

A device time is the best of three CUDA-event pairs after a warm call
(utils/metrics.device_timer); a wall time is the median of three on the
host clock around work that ends in a synchronize, after a warm call.
Every line names the card and its power limit; with --device cpu every
time is the host clock's.

Usage:  python tools/extra_bench_torch.py [--only make,ensure,...]
        [--device cuda]
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

WORKLOADS = ("make", "ensure", "xfer", "sparse", "hsa", "hsapairs", "ctw")


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or a note
    that the times are the CPU's."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu, host clock"
    idx = (torch.cuda.current_device() if device.index is None
           else device.index)
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={idx}"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn, device):
    """(host-clock seconds, result) of fn(), the device drained before
    and after."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def median_wall(fn, device):
    """The median of three wall_s times of fn(), after a warm call."""
    wall_s(fn, device)
    return sorted(wall_s(fn, device)[0] for _ in range(3))[1]


def table_bytes(tab) -> int:
    return sum(x.numel() * x.element_size()
               for x in (tab.vtab, tab.srel, tab.s1_hi, tab.s1_lo)
               if x is not None)


def _make(n, m, a, device):
    from libstb_tpu_torch.core import stirling

    return stirling.make(n, m, 2 * n, 2 * m, a, use_asympt=True,
                         device=device)


def bench_make(device, card, n=1 << 20, m=1024, discounts=(0.45, 0.5, 0.55)):
    """make(n, m)'s wall time, the median over ``discounts`` after a warm
    make, and its parts apart at the middle discount: the fill by the
    route make takes; the anchored S1's parts (n a multiple of 32): the
    f64 host anchors, their host-to-device copy and the pair's fill on
    ``device`` (device_timer); and the host route's: s1_host and the hi/lo
    split on the host and the pair's copy (pageable, as make copies it).
    ``s1_route`` says which of the two S1 routes make takes."""
    from libstb_tpu_torch.core import stirling
    from libstb_tpu_torch.ops import stirling_cuda
    from libstb_tpu_torch.utils import metrics

    device = torch.device(device)
    wall_s(lambda: _make(n, m, 0.31, device), device)
    wall = sorted(wall_s(lambda a=a: _make(n, m, a, device), device)[0]
                  for a in discounts)[1]
    a = discounts[1]
    route = stirling.fill_route(device, n, m)
    s1_route = stirling.s1_route(device, torch.float32, n)
    fill = (stirling_cuda.fill_table_cols if route == "fill_table_cols"
            else stirling_cuda.fill_table)
    a_t = torch.tensor(a, dtype=torch.float32, device=device)
    fill_s = metrics.device_timer(lambda a_t: fill(a_t, n, m), a_t)
    out = dict(route=route, s1_route=s1_route, wall_ms=wall * 1e3,
               fill_ms=fill_s * 1e3)
    parts = f"{route} fill {fill_s * 1e3:.4f} ms"
    if n % stirling._S1_CHUNK == 0:
        anc_s = median_wall(lambda: stirling._s1_anchors(a, n), device)
        ahi, alo = stirling._s1_anchors(a, n)
        acopy_s = median_wall(lambda: (torch.as_tensor(ahi, device=device),
                                       torch.as_tensor(alo, device=device)),
                              device)
        dev_anchors = [torch.as_tensor(x, device=device) for x in (ahi, alo)]
        afill_s = metrics.device_timer(
            lambda hi, lo, a_t: stirling._s1_device_fill(hi, lo, a_t, n),
            *dev_anchors, a_t)
        out.update(anchors_ms=anc_s * 1e3, anchor_h2d_ms=acopy_s * 1e3,
                   s1_fill_ms=afill_s * 1e3)
        parts += (f"; anchored S1: host anchors {anc_s * 1e3:.4f} ms, "
                  f"anchor copy ({ahi.nbytes + alo.nbytes} B, pageable) "
                  f"{acopy_s * 1e3:.4f} ms, pair fill on {device.type} "
                  f"{afill_s * 1e3:.4f} ms")
    s1_s = median_wall(lambda: stirling.s1_host(a, n), device)
    s1 = stirling.s1_host(a, n)
    split_s = median_wall(lambda: stirling._split_hi_lo(s1), device)
    hi, lo = stirling._split_hi_lo(s1)
    h2d_s = median_wall(lambda: (torch.as_tensor(hi, device=device),
                                 torch.as_tensor(lo, device=device)), device)
    out.update(s1_host_ms=s1_s * 1e3, split_ms=split_s * 1e3,
               h2d_ms=h2d_s * 1e3)
    nbytes = n * m * 8
    print(f"make({n},{m}) production wall: {wall * 1e3:.4f} ms "
          f"({nbytes / wall / 1e9:.1f} GB/s of V + Srel incl. S1; S1 route "
          f"{s1_route}); apart: {parts}; host route: s1_host "
          f"{s1_s * 1e3:.4f} ms + hi/lo split {split_s * 1e3:.4f} ms, "
          f"S1 pair copy ({hi.nbytes + lo.nbytes} B, pageable) "
          f"{h2d_s * 1e3:.4f} ms [{card}]", flush=True)
    return out


def bench_ensure(device, card, n=1 << 20, m=1024):
    """ensure(n / 2 -> n) at width m: wall time; on a card the peak of
    allocated memory over the call beside what was allocated before it
    and the old and new tables' bytes; the grown table against a fresh
    make at n bitwise, at the discount ensure passes on (the table's own,
    as its f32 value); the fresh make's time."""
    from libstb_tpu_torch.core import stirling

    device = torch.device(device)
    cuda = device.type == "cuda"
    wall_s(lambda: _make(n, m, 0.33, device), device)          # warm
    small = _make(n // 2, m, 0.52, device)
    _sync(device)
    old = table_bytes(small)
    if cuda:
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    grow_s, grown = wall_s(lambda: stirling.ensure(small, n - 2, m - 2),
                           device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if grown.n_max != n or grown.m_max != m:
        raise AssertionError(f"ensure grew to ({grown.n_max}, "
                             f"{grown.m_max}), not ({n}, {m})")
    new = table_bytes(grown)
    a = float(small.a)         # ensure refills at the table's f32 discount
    del small
    fresh_s, fresh = wall_s(lambda: _make(n, m, a, device), device)
    equal = all(torch.equal(getattr(grown, k), getattr(fresh, k))
                for k in ("vtab", "srel", "s1_hi", "s1_lo"))
    del grown, fresh
    fresh_s = min(fresh_s, wall_s(lambda: _make(n, m, 0.521, device),
                                  device)[0])
    gb = 1e-9
    mem = (f"peak allocated {peak * gb:.4f} GB ({before * gb:.4f} GB "
           f"before the call; old table {old * gb:.4f} GB + new "
           f"{new * gb:.4f} GB = {(old + new) * gb:.4f} GB)" if cuda
           else f"old table {old * gb:.4f} GB, new {new * gb:.4f} GB "
           "(peak: no card)")
    print(f"ensure({n // 2} -> {n}, m={m}): {grow_s * 1e3:.4f} ms vs fresh "
          f"make {fresh_s * 1e3:.4f} ms; {mem}; bitwise equal to the fresh "
          f"make: {equal} [{card}]", flush=True)
    return dict(wall_ms=grow_s * 1e3, fresh_ms=fresh_s * 1e3, peak=peak,
                before=before if cuda else None, old=old, new=new,
                equal_fresh=equal)


def bench_xfer(device, card, n=1 << 20):
    """The S1 hi/lo pair of an n-row f32 table copied to ``device`` from
    pageable and (on a card) from pinned host memory."""
    from libstb_tpu_torch.core import stirling

    device = torch.device(device)
    hi, lo = stirling._split_hi_lo(stirling.s1_host(0.5, n))
    nbytes = hi.nbytes + lo.nbytes
    out = {}
    for kind in ("pageable", "pinned"):
        if kind == "pinned" and device.type != "cuda":
            continue
        src = [torch.from_numpy(x) for x in (hi, lo)]
        if kind == "pinned":
            src = [x.pin_memory() for x in src]

        def copy(src=src, pinned=kind == "pinned"):
            return [torch.empty(x.shape, dtype=x.dtype, device=device)
                    .copy_(x, non_blocking=pinned) for x in src]

        out[kind] = median_wall(copy, device)
    print(f"S1 hi/lo pair ({nbytes} B) to {device}: " + ", ".join(
        f"{k} {s * 1e3:.4f} ms = {nbytes / s / 1e9:.3f} GB/s"
        for k, s in out.items()) + f" [{card}]", flush=True)
    return {f"{k}_ms": s * 1e3 for k, s in out.items()}


def sparse_inputs(P, C, device):
    """The sparse workload's pairs (tools/extra_bench.py's seed 4): ns
    (P,) in [2, 90), ts (C, P) in [1, 30) capped at n, T (C, 1)."""
    rng = np.random.default_rng(4)
    ns = rng.integers(2, 90, P)
    ts = np.minimum(rng.integers(1, 30, (C, P)), ns[None])
    T = ts.sum(axis=1, dtype=np.float32).reshape(C, 1)
    return tuple(torch.as_tensor(x, device=device) for x in (ns, ts, T))


def bench_sparse(device, card, P=(1 << 20) + 17, C=4, iters=8,
                 grid_shape=(96, 32, 16)):
    """``iters`` sample_a moves of C chains over P occupied pairs on a
    make_grid(n, m, g=G) grid, and apart the curve each move streams
    (chunks of 2^16 pairs, as sample_a takes from 2^18 pairs)."""
    from libstb_tpu_torch.core import agrid, rng
    from libstb_tpu_torch.samplers import hyper
    from libstb_tpu_torch.utils import metrics

    device = torch.device(device)
    n, m, g = grid_shape
    grid = agrid.make_grid(n, m, g=g, device=device)
    ns, ts, T = sparse_inputs(P, C, device)
    b = torch.full((C, 1), 10.0, device=device)

    def run():
        gen = rng.generator(0, device)
        a = torch.full((C,), 0.5, device=device)
        for _ in range(iters):
            a, _ = hyper.sample_a(gen, a, grid, ns, ts, T, b)
        return a

    a = run()
    dt = median_wall(run, device)
    curve_s = metrics.device_timer(
        lambda ns, ts: grid.data_curve_sparse(ns, ts, chunk=1 << 16), ns, ts)
    sps = C * iters / dt
    print(f"sparse sample_a (CSR, {P} pairs, C={C}, {iters} moves, grid "
          f"{n}x{m} g={g}): {sps:.4g} samples/s = {sps * P:.4g} "
          f"pair-terms/s; {dt / iters * 1e3:.4f} ms a move, of which the "
          f"streamed curve {curve_s * 1e3:.4f} ms [{card}]", flush=True)
    return dict(samples_per_s=sps, pair_terms_per_s=sps * P,
                move_ms=dt / iters * 1e3, curve_ms=curve_s * 1e3, a=a)


def bench_hsa(device, card, n_groups=6, n_per_group=400, C=32, sweeps=2):
    """hsa_sweep, the item-order histogram oracle, over crp_generate(2,
    n_groups, 20, n_per_group) data."""
    from libstb_tpu_torch.core import rng
    from libstb_tpu_torch.models import pyp

    device = torch.device(device)
    data = pyp.crp_generate(2, n_groups, 20, n_per_group, 0.5, 10.0)
    L = data.data_cat.size
    a = torch.full((C,), 0.5, device=device)
    b = torch.full((C,), 10.0, device=device)
    hist0, T0 = pyp.init_hsa(data, C, device)

    def run():
        gen = rng.generator(0, device)
        h, T = hist0, T0
        for _ in range(sweeps):
            h, T = pyp.hsa_sweep(gen, h, T, a, b, data)
        return T

    dt = median_wall(run, device)
    ips = C * L * sweeps / dt
    print(f"HSA (item-sequential oracle, N={L}, C={C}): {ips:.4g} "
          f"item-updates/s -- small-scale oracle only; TI/CTW are the "
          f"scale kernels [{card}]", flush=True)
    return dict(item_updates_per_s=ips)


def bench_hsa_pairs(device, card, n_groups=100, n_per_group=1000, C=32,
                    sweeps=2):
    """The staged pair-major HSA at check.c scale: native crp_generate(1,
    n_groups, 20, n_per_group, 0.5, 10.0)."""
    from libstb_tpu_torch import native
    from libstb_tpu_torch.core import rng
    from libstb_tpu_torch.models import pyp

    device = torch.device(device)
    data = native.crp_generate(1, n_groups, 20, n_per_group, 0.5, 10.0)
    L = data.data_cat.size
    a = torch.full((C,), 0.5, device=device)
    b = torch.full((C,), 10.0, device=device)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec, skip_first=False)
    hp0, T0 = pyp.init_hsa_pairs(data, C, device, order=order)
    s_max = hp0.shape[-1] - 1

    def run():
        gen = rng.generator(0, device)
        hp, T = hp0, T0
        for _ in range(sweeps):
            hp, T = pyp.hsa_sweep_pairs_staged(
                gen, hp, T, a, b, data, jvec[order], ivec[order],
                nvec[order], stages)
        return T

    dt = median_wall(run, device)
    ips = C * L * sweeps / dt
    print(f"HSA pair-major staged (N={L}, C={C}, s_max={s_max}): "
          f"{ips:.4g} item-updates/s ({dt / sweeps * 1e3:.4f} ms/sweep) "
          f"[{card}]", flush=True)
    return dict(item_updates_per_s=ips, ms_per_sweep=dt / sweeps * 1e3)


def bench_ctw(device, card, n_groups=100, n_per_group=1000, C=32, sweeps=4):
    """ctw_sweep_rel (window 10) at check.c scale on a make(n_max,
    min(n_max, 1024)) table, by both Srel routes."""
    from libstb_tpu_torch import native
    from libstb_tpu_torch.core import rng, stirling
    from libstb_tpu_torch.models import pyp

    device = torch.device(device)
    data = native.crp_generate(1, n_groups, 20, n_per_group, 0.5, 10.0)
    L = data.data_cat.size
    n_max = int(data.n.max()) + 2
    m_max = min(n_max, 1024)
    tab = stirling.make(n_max, m_max, n_max + 64, m_max + 64, 0.5,
                        use_asympt=True, device=device)
    a = torch.full((C,), 0.5, device=device)
    b = torch.full((C,), 10.0, device=device)
    t0, T0 = pyp.init_state(data, C, device)
    out = {}
    for m_sel in (0, pyp.ctw_m_sel(tab, data, window=10)):
        def run(m_sel=m_sel):
            gen = rng.generator(0, device)
            t, T = t0, T0
            for _ in range(sweeps):
                t, T = pyp.ctw_sweep_rel(gen, t, T, a, b, tab, data,
                                         window=10, m_sel=m_sel)
            return T

        dt = median_wall(run, device)
        out[m_sel] = C * L * sweeps / dt
        print(f"CTW(rel,w=10) N={L} C={C} m_sel={m_sel}: {out[m_sel]:.4g} "
              f"item-updates/s [{card}]", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", type=str, default=",".join(WORKLOADS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    which = args.only.split(",")
    unknown = set(which) - set(WORKLOADS)
    if unknown:
        raise SystemExit(f"extra_bench_torch: unknown workload(s) "
                         f"{sorted(unknown)}; choose from {WORKLOADS}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("extra_bench_torch: --device cuda but no CUDA "
                         "device")
    card = card_label(device)
    print(f"# extra_bench_torch device={device} [{card}] torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    benches = dict(make=bench_make, ensure=bench_ensure, xfer=bench_xfer,
                   sparse=bench_sparse, hsa=bench_hsa,
                   hsapairs=bench_hsa_pairs, ctw=bench_ctw)
    return {w: benches[w](device, card) for w in WORKLOADS if w in which}


if __name__ == "__main__":
    main()
