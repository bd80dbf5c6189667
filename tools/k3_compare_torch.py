#!/usr/bin/env python3
"""K3 (libstb_tpu_torch/csrc/fill_table_cols.cu) on one CUDA card: its
time beside other builds of K3 in the same process, and K2 against K3
around the routing cutoff.

  python tools/k3_compare_torch.py [--crossover] [--ladder] [SOURCE.cu ...]

Each SOURCE is another K3 source file, built here with the package's nvcc
flags (csrc/ on the include path) into libstb_tpu_torch/_build/.  Two C
interfaces are known: the cooperative kernel of the port's first K3
(``stb_fill_table_cols_f32(a, v, s, scratch, n, m, with_srel, stream)``,
recognised by its cudaLaunchCooperativeKernel) and the chunked pipeline's
(the package's own), whose geometry comes from stirling_cuda.cols_plan;
a source that also exports ``stb_fill_table_cols_gmem_f32`` (the same
pipeline with its row state in device memory) is timed both ways.  An
older K3 is taken from git, for example

  git show 471bc28:libstb_tpu_torch/csrc/fill_table_cols.cu > chip_tmp/k3_pr2.cu

The fills are f32 at a = 0.5, at (2^16, 1024) and (2^20, 1024), timed
with CUDA events (median of 5) in turns: every build, then again in the
reverse order.  --crossover also times K2 and K3 at n = r m for r = 2..8
(median of 7).  --ladder also runs P6's ladder at (2^16, 1024)
(tools/vpu_probe_torch.py's ladder: P5's mix, then each step toward K3,
then the branch of levers from the top rung, every output held to its
plain version) and prints each rung's us a column, a call's device time
without its host work, beside every K3 build's, a call's time with its
host work; each branch rung's time over the top rung's; and P5, the top
rung, the branch and K3 again at (2^16, 256) and (2^16, 512), with each
one's fill and period (time = fill + m x period) from the three m and the
line's residual.  Every line carries
the card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from libstb_tpu_torch.ops import _nvcc  # noqa: E402
from libstb_tpu_torch.ops import stirling_cuda as sc  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tools"))
import vpu_probe_torch as vpt  # noqa: E402

SHAPES = ((1 << 16, 1024), (1 << 20, 1024))
SHORT_M = (256, 512)                    # --ladder's other m, for the fits
CROSS_M = (64, 100, 200, 256, 512, 1024, 2048, 4096)


def build(path: str):
    """The library built from ``path``; the fills it offers, by name."""
    src = open(path, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _nvcc.BUILD_DIR / f"compare_{os.path.basename(path)}_{tag}.so"
    if not out.exists():
        _nvcc.BUILD_DIR.mkdir(exist_ok=True)
        subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I",
                        str(_nvcc.CSRC), "-o", str(out), path], check=True)
    lib = ctypes.CDLL(str(out))
    name = os.path.basename(path)
    if b"cudaLaunchCooperativeKernel" in src:
        return {name: _coop(lib.stb_fill_table_cols_f32)}
    fills = {name: _chunked(lib.stb_fill_table_cols_f32, False)}
    if b"stb_fill_table_cols_gmem_f32" in src:
        fills[f"{name} (state in device memory)"] = _chunked(
            lib.stb_fill_table_cols_gmem_f32, True)
    return fills


def _coop(fn):
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]

    def fill(a, n, m):
        v = torch.empty((m, n), dtype=a.dtype, device=a.device)
        s = torch.empty_like(v)
        scratch = torch.empty(4 * n + 2048, dtype=torch.float64,
                              device=a.device)
        _nvcc.run(fn.__name__, fn, a.device, a.data_ptr(), v.data_ptr(),
                  s.data_ptr(), scratch.data_ptr(), n, m, 1)
    return fill


def _chunked(fn, gmem):
    fn.argtypes = [ctypes.c_void_p] * (6 if gmem else 5) + [
        ctypes.c_int] * (6 if gmem else 7) + [ctypes.c_void_p]

    def fill(a, n, m):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        p = sc.cols_plan(n, m, sms)
        v = torch.empty((m, n), dtype=a.dtype, device=a.device)
        s = torch.empty_like(v)
        halo = torch.full((p.halo_len,), float("nan"), dtype=torch.float64,
                          device=a.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
        ptrs = [a.data_ptr(), v.data_ptr(), s.data_ptr(), halo.data_ptr(),
                ticket.data_ptr()]
        if gmem:
            state = torch.empty(3 * p.chunks * p.chunk, dtype=torch.float64,
                                device=a.device)
            _nvcc.run(fn.__name__, fn, a.device, *ptrs, state.data_ptr(), n,
                      m, 1, p.chunk, p.chunks, p.blocks)
        else:
            _nvcc.run(fn.__name__, fn, a.device, *ptrs, n, m, 1, p.chunk,
                      p.chunks, p.blocks, p.smem)
    return fill


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--ladder", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_compare_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    a32 = torch.tensor(0.5, device=dev)
    fills = {}
    for path in args.sources:
        fills.update(build(path))
    fills["K3 (package)"] = lambda a, n, m: sc.fill_table_cols_cuda(a, n, m)
    order = list(fills) + list(fills)[::-1]
    k3_times = {}
    for n, m in SHAPES:
        times = {name: [] for name in fills}
        for name in order:
            times[name].append(cs.cuda_ms(lambda: fills[name](a32, n, m), 5))
        b_ms, b_by = cs.bound(n * m, 4)
        for name, (t1, t2) in times.items():
            print(f"({n}, {m}) {name}: {t1:.4f} / {t2:.4f} ms = "
                  f"{100 * b_ms / t1:.2f} / {100 * b_ms / t2:.2f}% of the "
                  f"bound {b_ms:.4f} ms ({b_by}); {1e3 * t1 / m:.3f} us a "
                  f"column [{card}]", flush=True)
        k3_times[(n, m)] = {name: sum(t) / 2 for name, t in times.items()}
        torch.cuda.empty_cache()
    if args.ladder:
        n, m = SHAPES[0]
        res = {}
        sh = vpt.ladder(dev, card, (SHAPES[0],), res)[str(n)]
        short = vpt.ladder_short(dev, card, [(n, x) for x in SHORT_M], res)
        if res.get("mismatch"):
            raise SystemExit(f"k3_compare_torch: {res['mismatch']}")
        print(f"({n}, {m}) P6's ladder, us a column (+ over the rung "
              f"before): {vpt.ladder_summary(sh)} [{card}]")
        top = sh["rungs"][vpt.TOP]["ms"]
        print(f"({n}, {m}) the branch over the top rung, us a column: "
              + ", ".join(f"{x} {1e3 * (sh['rungs'][x]['ms'] - top) / m:+.4f}"
                          for x in vpt.BRANCH) + f" [{card}]")
        for x in SHORT_M:
            print(f"({n}, {x}) us a column: "
                  f"{vpt.ladder_summary(short[f'{n}x{x}'])} [{card}]")
        print(f"({n}, {m}, {', '.join(map(str, SHORT_M))}) fill + m x "
              f"period: "
              f"{vpt.fit_summary(vpt.fits({str(n): sh}, short)[str(n)])} "
              f"[{card}]")
        print(f"({n}, {m}) the ladder's K3: {sh['k3_ms']:.4f} ms of device "
              f"time a call, host gap {sh['k3_host_ms']:.4f} ms; the top "
              f"rung's {top:.4f} ms is {100 * sh['top_share']:.2f}% of it "
              f"[{card}]", flush=True)
        for name, ms in k3_times[(n, m)].items():
            print(f"({n}, {m}) {name}: {1e3 * ms / m:.4f} us a column a "
                  f"call (host work included); the top rung's device time is "
                  f"{100 * top / ms:.2f}% of it [{card}]", flush=True)
    if args.crossover:
        for m in CROSS_M:
            for r in range(2, 9):
                n = r * m
                k2 = cs.cuda_ms(lambda: sc.fill_table_cuda(a32, n, m), 7)
                k3 = cs.cuda_ms(lambda: sc.fill_table_cols_cuda(a32, n, m),
                                7)
                print(f"({n}, {m}) n = {r} m: K2 {k2:.4f} ms, K3 {k3:.4f} "
                      f"ms, K3 / K2 {k3 / k2:.3f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
