"""Port parity: the single-table fills (libstb_tpu_torch.ops.stirling_cuda
fill_table / fill_table_cols, kernels K2 / K3) vs the JAX Pallas kernels
run in interpret mode (libstb_tpu.ops.stirling_pallas).

On the CPU the port's fills are their plain versions; the CUDA kernels'
own cases are marked ``cuda`` and skip without a device (chip_smoke.py
runs the same comparisons on the card)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import stirling as jst
from libstb_tpu.ops import stirling_pallas as sp
from libstb_tpu_torch.core import stirling as tst
from libstb_tpu_torch.ops import _nvcc
from libstb_tpu_torch.ops import stirling_cuda as sc

torch.set_num_threads(1)

A1, N1, M1 = 0.4321, 200, 64
COLS_CASES = [            # tests/test_pallas.py:119-124
    (0.4321, 200, 64, 128),     # N not a multiple of chunks
    (0.55, 512, 48, 256),       # two sublanes of chunks
    (0.05, 384, 32, 128),       # small discount
    (0.0, 256, 24, 128),        # a == 0 (DP limit)
]
# edge shapes: m = 1, n < m, a = 0, m not a multiple of 8 / 32 / the
# thread count, n not a multiple of a warp's 32-row group
EDGE_CASES = [(0.0, 5, 1), (0.3, 3, 9), (0.5, 77, 33), (0.9, 40, 50),
              (0.2, 1, 1), (0.55, 3000, 1500)]
# tile edges of K2's row walk (32 columns a tile, the halo read 32 rows at
# a time): m = 1, m < 32, m = 32, 33, 65; n = 1, 2, n < 32, n = 33
TILE_EDGES = [(0.4321, n, m) for n, m in (
    (20, 1), (33, 1), (20, 17), (33, 32), (20, 33), (33, 33), (33, 65),
    (1, 65), (2, 33), (100, 65))]
# narrow tables that fill_route sends to K3 (n >= 4 m): m = 1, 2, 17
NARROW_CASES = [(0.4321, 20, 1), (0.4321, 33, 1), (0.0, 700, 1),
                (0.3, 40, 2), (0.9, 100, 2), (0.5, 300, 17), (0.0, 1000, 17)]
# chunk edges of K3's pipeline (chunks of 512 rows below 2^16 rows): n one
# below and one above a chunk, and three chunks, at m = 1, 2, 40
CHUNK_EDGES = [(0.37, n, m) for m in (1, 2, 40) for n in (511, 513, 1500)]


@pytest.fixture(scope="module")
def pallas_table():
    vt, sr = sp.fill_table(A1, N1, M1, row_block=32, interpret=True)
    return np.asarray(vt), np.asarray(sr)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _a(a, dtype=torch.float64, device="cpu"):
    return torch.tensor(a, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_table_ref_matches_pallas(pallas_table, dtype):
    """The bounds of tests/test_pallas.py:81-96: V rtol 2e-5 on live
    cells, |dSrel| < 1e-4, identical -inf pattern; diagonal = -S1 within
    2e-5."""
    pv, ps = pallas_table
    tv, ts = (x.double().numpy() for x in sc.fill_table(_a(A1, dtype),
                                                         N1, M1))
    assert tv.shape == ts.shape == (N1, M1)
    live = np.isfinite(tv) & (tv > 0)
    np.testing.assert_allclose(pv[live], tv[live], rtol=2e-5)
    assert np.abs(pv[np.isfinite(tv) & (tv == 0)]).max() < 1e-25
    fin = np.isfinite(ts)
    assert np.max(np.abs(ps[fin] - ts[fin])) < 1e-4
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(ts))
    s1 = jst.s1_host(A1, M1)
    np.testing.assert_allclose(np.diagonal(ts)[1:], -s1[1:], atol=2e-5)


@pytest.mark.parametrize("a,N,M,chunks", COLS_CASES)
def test_cols_ref_matches_pallas(a, N, M, chunks):
    """The bounds of tests/test_pallas.py:125-145: V rtol 3e-5 on live
    cells, Srel error scaled by max(1, |s|) below 1e-4, V exactly 0 and
    Srel -inf above the diagonal.  The port's layout is (M, N)."""
    vt_p, sr_p, _ = sp.fill_table_cols(a, N, M, chunks=chunks,
                                       interpret=True)
    pv = np.asarray(sp.unfold_cols(vt_p, N, chunks))
    ps = np.asarray(sp.unfold_cols(sr_p, N, chunks))
    tv, ts = sc.fill_table_cols(_a(a, torch.float32), N, M)
    assert tv.shape == ts.shape == (M, N)
    tv, ts = tv.T.double().numpy(), ts.T.double().numpy()
    live = np.isfinite(tv) & (tv != 0)
    np.testing.assert_allclose(pv[live], tv[live], rtol=3e-5)
    fin = np.isfinite(ts)
    err = np.abs(ps[fin] - ts[fin]) / np.maximum(1.0, np.abs(ts[fin]))
    assert np.max(err) < 1e-4
    above = ~fin
    np.testing.assert_array_equal(tv[above], 0.0)
    np.testing.assert_array_equal(pv[above], 0.0)
    assert np.all(np.isneginf(ps[above]))


@pytest.mark.parametrize("a,N,M", EDGE_CASES)
def test_plain_fills_are_fill_rows(a, N, M):
    """Both plain versions are fill_rows at one discount in their kernel's
    layout, held to the JAX fill_rows at rtol 1e-12 in f64, with the
    sentinels V(., 1) = +inf, V = 0 and Srel = -inf above the diagonal,
    and no NaN."""
    v, s = sc.fill_table(_a(a), N, M)
    vc, scol = sc.fill_table_cols(_a(a), N, M)
    assert torch.equal(vc, v.T) and torch.equal(scol, s.T)
    assert vc.is_contiguous() and scol.is_contiguous()
    jv, js, _ = (np.asarray(x) for x in jst.fill_rows(a, N, M,
                                                     dtype=jnp.float64))
    np.testing.assert_array_equal(np.isneginf(s.numpy()), np.isneginf(js))
    np.testing.assert_array_equal(v.numpy() == 0, jv == 0)
    assert np.all(np.isposinf(v.numpy()[:, 0]))
    assert not (torch.isnan(v).any() or torch.isnan(s).any())
    fin = np.isfinite(js)
    np.testing.assert_allclose(s.numpy()[fin], js[fin], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-12)


def test_nosrel_paths():
    for fill in (sc.fill_table, sc.fill_table_cols):
        v, s = fill(_a(0.3, torch.float32), 64, 16, with_srel=False)
        assert s is None
        assert torch.equal(v, fill(_a(0.3, torch.float32), 64, 16)[0])


def test_cuda_launchers_reject_cpu_tensors():
    before = dict(sc.LAUNCHES)
    for fn in (sc.fill_table_cuda, sc.fill_table_cols_cuda):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            fn(_a(0.5), 16, 8)
    sc.fill_table(_a(0.5), 16, 8)
    sc.fill_table_cols(_a(0.5), 16, 8)
    assert sc.LAUNCHES == before


@pytest.mark.parametrize("device,n,m,build_v,route", [
    ("cpu", 100, 10, True, "fill_rows"),
    ("cpu", 1 << 20, 1024, True, "fill_rows"),
    ("cuda", 39, 10, True, "fill_table"),
    ("cuda", 3 * 1024, 1024, True, "fill_table"),
    ("cuda", 4 * 1024 - 1, 1024, True, "fill_table"),
    ("cuda", 4 * 1024, 1024, True, "fill_table_cols"),
    ("cuda", 3, 1, True, "fill_table"),
    ("cuda", 4, 1, True, "fill_table_cols"),
    ("cuda", 7, 2, True, "fill_table"),
    ("cuda", 68, 17, True, "fill_table_cols"),
    ("cuda", (1 << 16) - 1, 1024, True, "fill_table_cols"),
    ("cuda", 1 << 16, 1024, True, "fill_table_cols"),
    ("cuda", 2048, 1024, True, "fill_table"),
    ("cuda", 16384, 64, True, "fill_table_cols"),
    ("cuda", (1 << 24) - 1, 8, True, "fill_table_cols"),
    ("cuda", 1 << 24, 8, True, "fill_table"),
    ("cuda", 1 << 16, 64, False, "fill_table_cols"),
    ("cuda", 20000, 14337, True, "fill_table_cols"),
    ("cuda", 20000, 14337, False, "fill_table_cols"),
    ("cuda", 20000, 14336, True, "fill_table"),
    ("cuda:1", 1000, 200, True, "fill_table_cols"),
])
def test_fill_route(device, n, m, build_v, route):
    """On a CUDA device every fill is a kernel: K3 from n = 4 m (below
    2^24, set from the crossover measured on the card) or past K2's widest
    table, K2 otherwise, whether or not V is kept; the plain fill only on
    the CPU."""
    assert tst.fill_route(device, n, m, build_v) == route


def test_sources_named_and_flags():
    """Each kernel builds from its own source in the package, for sm_90a,
    into a .so named by the kernel and a hash of source and flags."""
    for name, src in sc.SOURCES.items():
        assert src.is_file() and src.parent.name == "csrc"
        assert f"extern \"C\" int stb_{name}_f32" in src.read_text()
        assert _nvcc.target(name, src).name.startswith(f"{name}_")
    assert "stirling_pallas.py:_kernel_folded" in (
        sc.SOURCES["fill_table"].read_text())
    assert "stirling_pallas.py:_kernel_cols" in (
        sc.SOURCES["fill_table_cols"].read_text())
    assert len({_nvcc.target(n, sc.SOURCES[n]) for n in sc.KERNELS}) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,v_rtol,s_atol", [
    (torch.float32, 2e-5, 1e-4), (torch.float64, 1e-12, 1e-10)])
@pytest.mark.parametrize("a,N,M", [(A1, N1, M1)] + EDGE_CASES + TILE_EDGES
                         + NARROW_CASES + CHUNK_EDGES)
def test_kernels_match_ref(cuda_device, dtype, v_rtol, s_atol, a, N, M):
    v64, s64 = sc.fill_table_ref(_a(a), N, M)
    at = _a(a, dtype, cuda_device)
    for fill, t in ((sc.fill_table_cuda, False),
                    (sc.fill_table_cols_cuda, True)):
        v, s = fill(at, N, M)
        torch.cuda.synchronize()
        v, s = v.double().cpu(), s.double().cpu()
        if t:
            v, s = v.T, s.T
        live = torch.isfinite(v64) & (v64 > 0)
        torch.testing.assert_close(v[live], v64[live], rtol=v_rtol, atol=0)
        assert bool((v[torch.isfinite(v64) & (v64 == 0)] == 0).all())
        assert bool(torch.isposinf(v[:, 0]).all())
        fin = torch.isfinite(s64)
        # scaled by max(1, |Srel|): one f32 rounding of |Srel| ~ 1e4 at
        # m ~ 1500 is 5e-4 absolute
        err = (s[fin] - s64[fin]).abs() / s64[fin].abs().clamp(min=1.0)
        assert err.max().item() < s_atol
        assert torch.equal(torch.isneginf(s), torch.isneginf(s64))
        assert not bool(torch.isnan(v).any() or torch.isnan(s).any())


def test_target_hashes_included_headers(tmp_path):
    """K1, K2 and K3 include csrc/row_walk.cuh (K3 for its hand-off and
    its divide and log): editing the header renames all three libraries,
    so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in sc.SOURCES["fill_grid"].parent.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    sources = {name: csrc / path.name for name, path in sc.SOURCES.items()}
    before = {name: _nvcc.target(name, sources[name]) for name in sc.KERNELS}
    header = csrc / "row_walk.cuh"
    for name in sc.KERNELS:
        assert b'#include "row_walk.cuh"' in sources[name].read_bytes()
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: _nvcc.target(name, sources[name]) for name in sc.KERNELS}
    assert after["fill_grid"] != before["fill_grid"]
    assert after["fill_table"] != before["fill_table"]
    assert after["fill_table_cols"] != before["fill_table_cols"]
    assert all(after[n].name.startswith(f"{n}_") for n in sc.KERNELS)


# past K3's resident capacity (132 blocks of 9216 rows with Srel)
PAST_CAPACITY = 132 * 9216 + 1


@pytest.mark.parametrize("m", [1, 2, 17, 1024])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 1 << 16, 1 << 20, 1 << 21,
                               PAST_CAPACITY])
def test_cols_plan_chunks(n, m):
    """K3's chunks cover every row once and in order, each chunk's
    producer (the chunk before it) holds the lower ticket, the shared
    memory a block asks for stays within the 227 KB a block may have, one
    block an SM at most, and past the resident capacity the chunks run in
    two waves or more."""
    for with_srel in (True, False):
        plan = sc.cols_plan(n, m, 132, with_srel)
        assert (plan.n, plan.m) == (n, m)
        assert plan.chunk % sc.COLS_ROW_STEP == 0 and plan.chunk > 0
        rows = [plan.rows(c) for c in range(plan.chunks)]
        assert rows[0].start == 0 and rows[-1].stop == n
        assert all(len(r) > 0 for r in rows)
        assert all(rows[c].stop == rows[c + 1].start
                   for c in range(plan.chunks - 1))
        assert all(len(r) == plan.chunk for r in rows[:-1])
        assert [plan.ticket(c) for c in range(plan.chunks)] == list(
            range(plan.chunks))
        assert all(plan.ticket(c - 1) < plan.ticket(c)
                   for c in range(1, plan.chunks))
        per_row = 8 * 17 / 16 + (16 if with_srel else 0)
        assert plan.smem == plan.chunk * per_row
        assert plan.smem <= 232448 - 1024
        assert 1 <= plan.blocks == min(plan.chunks, 132)
        assert plan.waves == -(-plan.chunks // plan.blocks)
        assert plan.halo_len == max(1, (plan.chunks - 1) * m)
        if n >= PAST_CAPACITY:
            assert plan.waves >= 2
        if n <= 132 * 9216:
            assert plan.waves == 1


def test_cols_plan_geometry():
    """Chunks of 512 rows (one for each of a block's 512 row threads) up
    to 2^16 rows on 132 SMs, then about n / 132 rounded up to 512, capped
    by the shared memory with Srel, 9216 rows, whether Srel is built or
    not (so V is the same either way)."""
    assert sc.cols_plan(1 << 16, 1024, 132)[3:] == (512, 128, 128)
    assert sc.cols_plan(1 << 20, 1024, 132)[3:] == (8192, 128, 128)
    assert sc.cols_plan(1 << 21, 16, 132)[3:] == (9216, 228, 132)
    assert sc.cols_plan(1 << 21, 16, 132, False)[3:] == (9216, 228, 132)
    assert sc.cols_plan(1000, 200, 1)[3:] == (1024, 1, 1)
    assert sc.cols_plan(1 << 23, 8, 132, False).smem == 9216 * 17 // 2
    for args in ((0, 5, 132), (5, 0, 132), (5, 5, 0)):
        with pytest.raises(ValueError):
            sc.cols_plan(*args)


def test_source_bytes_follows_includes_once(tmp_path):
    """Quoted includes are followed recursively, each file once, so a
    cycle or a header included twice ends."""
    (tmp_path / "a.cu").write_bytes(b'#include "b.cuh"\n#include <math.h>\n'
                                    b'  # include "c.cuh"\n')
    (tmp_path / "b.cuh").write_bytes(b'#include "c.cuh"\nB\n')
    (tmp_path / "c.cuh").write_bytes(b'#include "b.cuh"\nC\n')
    got = _nvcc.source_bytes(tmp_path / "a.cu", set())
    assert got.count(b"B\n") == 1 and got.count(b"C\n") == 1
    assert got.startswith((tmp_path / "a.cu").read_bytes())


@pytest.mark.cuda
def test_kernels_reject_unsupported(cuda_device):
    with pytest.raises(TypeError):
        sc.fill_table(torch.tensor(0.5, dtype=torch.float16,
                                   device=cuda_device), 8, 8)
    with pytest.raises(ValueError):
        sc.fill_table(torch.tensor(0.5, device=cuda_device), 20000, 14337)
    with pytest.raises(ValueError):
        sc.fill_table_cols(torch.tensor(0.5, device=cuda_device), 1 << 24, 8)
