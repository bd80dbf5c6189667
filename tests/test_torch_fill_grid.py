"""Port parity: the grid fill (libstb_tpu_torch.ops.stirling_cuda) vs the
JAX Pallas kernel run in interpret mode (libstb_tpu.ops.stirling_pallas).

On the CPU the port's fill is its plain version; the CUDA kernel's own
cases are marked ``cuda`` and skip without a device (chip_smoke.py runs
the same comparisons on the card)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstb_tpu.core import stirling as jst
from libstb_tpu.ops import stirling_pallas as sp
from libstb_tpu_torch.ops import stirling_cuda as sc

torch.set_num_threads(1)

AVEC = np.linspace(0.0, 0.9, 8)
N, M = 160, 48
# tile edges of the row walk (TILE_W = 32 columns a tile, the halo read 32
# rows at a time): m = 1, m < W, m = W, m = W + 1, m = 2W + 1; n = 1, n < 32,
# n = 33
TILE_EDGES = [(20, 1), (33, 1), (20, 17), (33, 32), (20, 33), (33, 33),
              (33, 65), (1, 65), (2, 33), (100, 65)]


@pytest.fixture(scope="module")
def pallas():
    vt, sr = sp.fill_grid(jnp.asarray(AVEC, jnp.float32), N, M,
                          row_block=32, interpret=True)
    return np.asarray(vt), np.asarray(sr)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ref_matches_pallas(pallas, dtype):
    """The bounds of tests/test_pallas.py:25-56: V rtol 2e-5 on live
    cells, |dSrel| < 1e-4, identical -inf pattern, diagonal = -S1 within
    2e-5."""
    pv, ps = pallas
    tv, ts = (x.double().numpy() for x in sc.fill_grid(
        torch.tensor(AVEC, dtype=dtype), N, M))
    live = np.isfinite(tv) & (tv > 0)
    np.testing.assert_allclose(pv[live], tv[live], rtol=2e-5)
    assert np.abs(pv[np.isfinite(tv) & (tv == 0)]).max() < 1e-25
    fin = np.isfinite(ts)
    assert np.max(np.abs(ps[fin] - ts[fin])) < 1e-4
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(ts))
    for g, a in enumerate(AVEC):
        s1 = jst.s1_host(float(a), M)
        np.testing.assert_allclose(np.diagonal(ts[g, :M, :M])[1:], -s1[1:],
                                   atol=2e-5)


def test_ref_is_fill_rows_per_discount():
    v, s = sc.fill_grid_ref(torch.tensor(AVEC), 60, 20)
    for g, a in enumerate(AVEC):
        jv, js, _ = jst.fill_rows(float(a), 60, 20, dtype=jnp.float64)
        fin = np.isfinite(np.asarray(js))
        np.testing.assert_allclose(v[g].numpy(), np.asarray(jv), rtol=1e-12)
        np.testing.assert_allclose(s[g].numpy()[fin], np.asarray(js)[fin],
                                   rtol=1e-12, atol=1e-12)


def test_nosrel_path():
    vt, sr = sc.fill_grid(torch.tensor([0.3, 0.6], dtype=torch.float32),
                          64, 16, with_srel=False)
    assert sr is None
    v_full, _ = sc.fill_grid(torch.tensor([0.3, 0.6], dtype=torch.float32),
                             64, 16)
    assert torch.equal(vt, v_full)
    jv, jsr = sp.fill_grid(jnp.asarray([0.3, 0.6], jnp.float32), 64, 16,
                           row_block=16, with_srel=False, interpret=True)
    assert jsr is None
    v64 = np.asarray(jst.fill_rows(0.3, 64, 16, dtype=jnp.float64)[0])
    live = np.isfinite(v64) & (v64 > 0)
    np.testing.assert_allclose(vt[0].numpy()[live], v64[live], rtol=2e-5)
    np.testing.assert_allclose(vt.numpy()[:, live], np.asarray(jv)[:, live],
                               rtol=2e-5)


def test_row_count_trimmed():
    """The Pallas fill pads rows to its block and trims; the port writes
    exactly n_max rows."""
    jv, js = sp.fill_grid(jnp.asarray([0.5], jnp.float32), 50, 16,
                          row_block=16, interpret=True)
    vt, sr = sc.fill_grid(torch.tensor([0.5], dtype=torch.float32), 50, 16)
    assert vt.shape == sr.shape == jv.shape == js.shape == (1, 50, 16)
    live = np.isfinite(vt.numpy()) & (vt.numpy() > 0)
    np.testing.assert_allclose(vt.numpy()[live], np.asarray(jv)[live],
                               rtol=2e-5)


@pytest.mark.parametrize("g", [1, 64])
@pytest.mark.parametrize("n,m", TILE_EDGES + [(N, M), (16384, 1024),
                                              (40, 8193), (12288, 12288)])
def test_tile_plan_covers_columns(g, n, m):
    """Every column of every table lies in exactly one tile, every tile
    has exactly one ticket, and a tile's producer (the tile to its left)
    has the lower ticket, so the kernel's in-order claims cannot wait on
    a tile nobody holds."""
    plan = sc.tile_plan(g, n, m, 132)
    assert plan.tiles == -(-m // sc.TILE_W)
    cols = [c for t in range(plan.tiles) for c in plan.columns(t)]
    assert cols == list(range(m))
    tickets = [plan.ticket(gi, t) for gi in range(g)
               for t in range(plan.tiles)]
    assert sorted(tickets) == list(range(g * plan.tiles))
    for k in range(g * plan.tiles):
        gi, t = plan.tile_of(k)
        assert plan.ticket(gi, t) == k
        if t > 0:
            assert plan.ticket(gi, t - 1) < k
    assert plan.halo_len == max(1, g * (plan.tiles - 1) * n)


@pytest.mark.parametrize("g,n,m,sms,blocks", [
    (64, 16384, 1024, 132, 2048),       # K1 bench shape: 2048 tiles
    (1, 16384, 1024, 132, 32),          # K2: 32 tiles, one warp an SM
    (1, 5, 1, 132, 1),                  # one column
    (96, 300, 300, 132, 960),           # a gate grid: 960 tiles
    (64, 16384, 8192, 132, 2112),       # more tiles than fit: warps loop
    (2, 12288, 12288, 132, 768),        # past 8192 columns: 384 tiles a table
    (2, 8200, 8193, 132, 514),          # a ragged last tile of one column
    (8, 16384, 16384, 132, 2112),       # 4096 tiles: warps loop
    (3, 10, 100, 1, 12),                # one SM
])
def test_tile_plan_geometry(g, n, m, sms, blocks):
    """One block a tile, up to 16 one-warp blocks an SM."""
    plan = sc.tile_plan(g, n, m, sms)
    assert plan.blocks == blocks
    assert 1 <= plan.blocks <= min(g * plan.tiles, 16 * sms)


def test_tile_plan_rejects_empty():
    for args in ((0, 5, 5, 132), (1, 0, 5, 132), (1, 5, 0, 132),
                 (1, 5, 5, 0)):
        with pytest.raises(ValueError):
            sc.tile_plan(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,v_rtol,s_atol", [
    (torch.float32, 2e-5, 1e-4), (torch.float64, 1e-12, 1e-10)])
@pytest.mark.parametrize("g,n,m", [(len(AVEC), N, M)] + [
    (g, n, m) for g in (1, 64) for n, m in TILE_EDGES])
def test_kernel_matches_ref(cuda_device, dtype, v_rtol, s_atol, g, n, m):
    avec = torch.linspace(0.0, 0.9, g, dtype=dtype, device=cuda_device)
    v, s = sc.fill_grid(avec, n, m)
    torch.cuda.synchronize()
    v64, s64 = sc.fill_grid_ref(avec.double().cpu(), n, m)
    _assert_close_tables(v, s, v64, s64, v_rtol, s_atol)


def _assert_close_tables(v, s, v64, s64, v_rtol, s_atol):
    v, s = v.double().cpu(), s.double().cpu()
    live = torch.isfinite(v64) & (v64 > 0)
    torch.testing.assert_close(v[live], v64[live], rtol=v_rtol, atol=0)
    assert bool((v[torch.isfinite(v64) & (v64 == 0)] == 0).all())
    assert bool(torch.isposinf(v[:, :, 0]).all())
    fin = torch.isfinite(s64)
    assert (s[fin] - s64[fin]).abs().max().item() < s_atol
    assert torch.equal(torch.isneginf(s), torch.isneginf(s64))
    assert not bool(torch.isnan(v).any() or torch.isnan(s).any())


@pytest.mark.cuda
def test_kernel_nosrel_and_ragged_m(cuda_device):
    avec = torch.tensor([0.1, 0.7], dtype=torch.float32, device=cuda_device)
    v, s = sc.fill_grid(avec, 300, 1500, with_srel=False)   # ragged tile
    assert s is None
    v64, _ = sc.fill_grid_ref(avec.double().cpu(), 300, 1500, False)
    live = torch.isfinite(v64) & (v64 > 0)
    torch.testing.assert_close(v.double().cpu()[live], v64[live], rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_kernel_rejects_unsupported(cuda_device):
    with pytest.raises(TypeError):
        sc.fill_grid(torch.zeros(2, dtype=torch.float16,
                                 device=cuda_device), 8, 8)
    with pytest.raises(ValueError):
        sc.fill_grid(torch.zeros(2, 2, device=cuda_device), 8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(300, 8193), (2048, 12288)])
def test_kernel_past_8192_columns(cuda_device, n, m):
    """K1 has no width limit: tables wider than 8192 columns, one with a
    last tile of a single column, against the f64 plain fill."""
    avec = torch.tensor([0.2, 0.7], dtype=torch.float32, device=cuda_device)
    v, s = sc.fill_grid(avec, n, m)
    torch.cuda.synchronize()
    v64, s64 = sc.fill_grid_ref(avec.double().cpu(), n, m)
    _assert_close_tables(v, s, v64, s64, 1e-4, 5e-2)
