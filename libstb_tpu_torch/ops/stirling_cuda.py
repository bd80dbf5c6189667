"""Stirling table fills: the hand-written CUDA kernels and their plain
versions.

Three kernels, each the port of one Pallas kernel of
libstb_tpu/ops/stirling_pallas.py:

* K1 ``fill_grid`` (csrc/fill_grid.cu): V and Srel for a grid of
  discounts, (G, n, m) row-major;
* K2 ``fill_table`` (csrc/fill_table.cu): one discount by the row walk,
  (n, m) row-major;

  K1 and K2 share the row walk of csrc/row_walk.cuh: each table's columns
  are cut into tiles of ``TILE_W``, one warp walks a tile over n, and the
  tile's edge 1/V reaches the tile to its right through a halo column.
  ``tile_plan`` sets the geometry (tiles, one-warp blocks) and the ticket
  order the kernel claims tiles in;
* K3 ``fill_table_cols`` (csrc/fill_table_cols.cu): one discount by a
  parallel scan over n, one column at a time, written column-major
  (m, n).  The rows are cut into chunks, one block a chunk for every
  column, and each chunk's last V reaches the next chunk through a halo;
  ``cols_plan`` sets the geometry (chunks, blocks, waves, shared memory).

Each public function runs where its discount tensor lies: on the CPU the
``*_ref`` plain version (core/stirling.fill_rows, the same function the
JAX package runs off the TPU), on a CUDA device the ``*_cuda`` launcher,
which launches the kernel or raises.  Nothing falls back from a kernel to
a plain version.

Each kernel is its own library of ops/_nvcc.py, built on first use;
``LAUNCHES[name]`` counts each kernel's launches, so a run can show that
its fills went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import stirling
from . import _nvcc

__all__ = ["fill_grid", "fill_grid_cuda", "fill_grid_ref", "tile_plan",
           "fill_table", "fill_table_cuda", "fill_table_ref", "cols_plan",
           "fill_table_cols", "fill_table_cols_cuda", "fill_table_cols_ref",
           "KERNELS", "LAUNCHES", "SOURCES"]

_ARGTYPES = {
    # (a or avec, V, Srel, scratch..., ints..., stream)
    "fill_grid": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "fill_table": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "fill_table_cols": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}
KERNELS = tuple(_ARGTYPES)
LAUNCHES = {name: 0 for name in KERNELS}
_LIBS = {name: _nvcc.register(name, _nvcc.pair(name, args), LAUNCHES)
         for name, args in _ARGTYPES.items()}
SOURCES = {name: lib.source for name, lib in _LIBS.items()}
# The widest table K2 takes: the limit of its first design (a shared row
# of f64 1/V per block), which the tiled walk no longer needs but which is
# all K2 has been tested at; core/stirling.fill_route sends a wider table
# to K3 below 2^24 rows.  K1 has no width limit (chip_smoke.py phase 2d
# holds it to the f64 fill at 12288 and 8193 columns).
TABLE_MAX_M = 14336
_MAX_N_F32 = 1 << 24                  # the TPU kernels' f32 row-index bound
# K3 takes n < 2^24 rows, the bound of the JAX kernel it replaces
COLS_MAX_N = 1 << 24
# K3 geometry (csrc/fill_table_cols.cu): a block is 16 row warps and a
# carry warp, a chunk the same number of rows for each of the 512 row
# threads; a block keeps its chunk's row state in shared memory, V with a
# pad every 16 rows and Srel's Kahan pair (24.5 bytes a row, 8.5 without
# Srel), within the 227 KB a block may have less 1 KB of static arrays
COLS_ROW_STEP = 512
COLS_SMEM_MAX = 232448 - 1024

# K1/K2 geometry (csrc/row_walk.cuh): a tile is one warp's 32 columns (and
# reads its left neighbour's halo 32 rows at a time); a block is one warp,
# and an SM is given at most 16 of them, four to each of its schedulers
TILE_W = 32
_BLOCKS_PER_SM = 16


def _check(fn: str, a: torch.Tensor, shape, n_max: int, m_max: int):
    if n_max < 1 or m_max < 1:
        raise ValueError(f"{fn}: empty table ({n_max}, {m_max})")
    if a.dtype == torch.float32 and n_max >= _MAX_N_F32:
        raise ValueError(f"{fn}: n_max={n_max} >= 2^24 in f32")
    _nvcc.check(fn, a.device, {"the discount": (a, a.dtype, shape)},
                real=a.dtype)


# -- K1/K2 geometry: tiles of columns, a halo column between them -----------

class TilePlan(NamedTuple):
    """The launch geometry of K1/K2 for G tables of (n, m): ``tiles``
    tiles of TILE_W columns a table, ``blocks`` one-warp blocks claiming
    the G * tiles tickets in order.  Ticket k is tile t = k // G
    of table g = k % G (csrc/row_walk.cuh), so the tile to a tile's left,
    its producer, always has the lower ticket."""
    g: int
    n: int
    m: int
    tiles: int
    blocks: int

    def ticket(self, g: int, t: int) -> int:
        return t * self.g + g

    def tile_of(self, k: int):
        """(g, t) of ticket ``k``."""
        return k % self.g, k // self.g

    def columns(self, t: int) -> range:
        return range(t * TILE_W, min((t + 1) * TILE_W, self.m))

    @property
    def halo_len(self) -> int:
        """f64 halo: one column of n rows per tile boundary (at least 1)."""
        return max(1, self.g * (self.tiles - 1) * self.n)


def tile_plan(g: int, n: int, m: int, sms: int) -> TilePlan:
    """K1/K2's geometry on a card of ``sms`` SMs: one-warp blocks, one a
    tile up to _BLOCKS_PER_SM an SM; a warp that outlives its first tile
    claims the next ticket."""
    if min(g, n, m, sms) < 1:
        raise ValueError(f"tile_plan: empty ({g}, {n}, {m}) or {sms} SMs")
    tiles = -(-m // TILE_W)
    return TilePlan(g, n, m, tiles, min(g * tiles, sms * _BLOCKS_PER_SM))


def _walk(name: str, a: torch.Tensor, shape, with_srel: bool):
    """Allocate the tables of ``shape`` ((G, n, m) for K1, (n, m) for K2)
    and the walk's scratch (the halo, NaN until written, and the ticket
    counter), and launch the kernel, whose dimensions are the shape's."""
    g = shape[0] if len(shape) == 3 else 1
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = tile_plan(g, *shape[-2:], sms)
    vtab = torch.empty(shape, dtype=a.dtype, device=a.device)
    srel = torch.empty_like(vtab) if with_srel else None
    halo = torch.full((plan.halo_len,), float("nan"), dtype=torch.float64,
                      device=a.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
    _LIBS[name].launch(a.dtype, a.device, a.data_ptr(), vtab.data_ptr(),
                       srel.data_ptr() if with_srel else None,
                       halo.data_ptr(), ticket.data_ptr(), *shape,
                       int(with_srel), plan.tiles, plan.blocks)
    return vtab, srel


# -- K1: the discount grid ---------------------------------------------------

def fill_grid_ref(avec: torch.Tensor, n_max: int, m_max: int,
                  with_srel: bool = True):
    """Plain PyTorch fill of the G tables: (V, Srel) of shape
    (G, n_max, m_max), Srel None without ``with_srel``."""
    vtab, srel, _ = stirling.fill_rows(avec, n_max, m_max, dtype=avec.dtype,
                                       with_srel=with_srel)
    return vtab, srel


def fill_grid_cuda(avec: torch.Tensor, n_max: int, m_max: int,
                   with_srel: bool = True):
    """Launch K1 on ``avec``'s device; same outputs as fill_grid_ref."""
    _check("fill_grid_cuda", avec, (None,), n_max, m_max)
    return _walk("fill_grid", avec, (avec.shape[0], n_max, m_max), with_srel)


def fill_grid(avec: torch.Tensor, n_max: int, m_max: int,
              with_srel: bool = True):
    """V (and Srel) tables for every discount in ``avec``: (G, n_max,
    m_max) each, row i holding n=i+1 and column j holding m=j+1.  Runs
    where ``avec`` lies: the plain fill on the CPU, K1 on a CUDA device."""
    if avec.device.type == "cpu":
        return fill_grid_ref(avec, n_max, m_max, with_srel)
    return fill_grid_cuda(avec, n_max, m_max, with_srel)


# -- K2: one table by the row walk -------------------------------------------

def fill_table_ref(a: torch.Tensor, n_max: int, m_max: int,
                   with_srel: bool = True):
    """Plain PyTorch fill of one table at the 0-dim discount ``a``:
    (V, Srel) of shape (n_max, m_max), Srel None without ``with_srel``."""
    vtab, srel, _ = stirling.fill_rows(a, n_max, m_max, dtype=a.dtype,
                                       with_srel=with_srel)
    return vtab, srel


def fill_table_cuda(a: torch.Tensor, n_max: int, m_max: int,
                    with_srel: bool = True):
    """Launch K2 on ``a``'s device; same outputs as fill_table_ref."""
    _check("fill_table_cuda", a, None, n_max, m_max)
    if a.numel() != 1:
        raise ValueError("fill_table_cuda: one discount only")
    if m_max > TABLE_MAX_M:
        raise ValueError(f"fill_table_cuda: m_max={m_max} > {TABLE_MAX_M}, "
                         "the widest table tested on the card")
    return _walk("fill_table", a, (n_max, m_max), with_srel)


def fill_table(a: torch.Tensor, n_max: int, m_max: int,
               with_srel: bool = True):
    """V (and Srel) of one table at discount ``a`` (a 0-dim tensor in the
    table's dtype), (n_max, m_max) row-major.  Runs where ``a`` lies: the
    plain fill on the CPU, K2 on a CUDA device."""
    if a.device.type == "cpu":
        return fill_table_ref(a, n_max, m_max, with_srel)
    return fill_table_cuda(a, n_max, m_max, with_srel)


# -- K3: one table by columns, a parallel scan over n -------------------------

class ColsPlan(NamedTuple):
    """The launch geometry of K3 for an (n, m) table: ``chunks`` chunks of
    ``chunk`` rows (the last one partial), one block a chunk for every
    column, ``blocks`` blocks claiming the chunks in row order.  Chunk c's
    ticket is c and its producer, the chunk before it, holds ticket c - 1
    (csrc/fill_table_cols.cu), so a producer always runs before its
    consumer; past the blocks on the card the chunks run in waves."""
    n: int
    m: int
    with_srel: bool
    chunk: int
    chunks: int
    blocks: int

    def rows(self, c: int) -> range:
        return range(c * self.chunk, min((c + 1) * self.chunk, self.n))

    def ticket(self, c: int) -> int:
        return c

    @property
    def waves(self) -> int:
        return -(-self.chunks // self.blocks)

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block asks for: its chunk's row state."""
        return _cols_smem(self.chunk, self.with_srel)

    @property
    def halo_len(self) -> int:
        """f64 halo: V at the last row of every chunk but the last, for
        every column (at least 1)."""
        return max(1, (self.chunks - 1) * self.m)


def _cols_smem(chunk: int, with_srel: bool) -> int:
    return 8 * (chunk + chunk // 16) + (16 * chunk if with_srel else 0)


def cols_plan(n: int, m: int, sms: int, with_srel: bool = True) -> ColsPlan:
    """K3's geometry on a card of ``sms`` SMs: n split evenly over the SMs
    in chunks of whole COLS_ROW_STEPs, each at most what a block's shared
    memory holds with Srel; one block an SM, up to one a chunk."""
    if min(n, m, sms) < 1:
        raise ValueError(f"cols_plan: empty ({n}, {m}) or {sms} SMs")
    step = COLS_ROW_STEP
    # one cap with or without Srel, so that V does not depend on it
    cap = COLS_SMEM_MAX // _cols_smem(step, True) * step
    chunk = min(max(-(-n // (sms * step)) * step, step), cap)
    chunks = -(-n // chunk)
    return ColsPlan(n, m, bool(with_srel), chunk, chunks, min(chunks, sms))


def fill_table_cols_ref(a: torch.Tensor, n_max: int, m_max: int,
                        with_srel: bool = True):
    """Plain PyTorch fill in K3's layout: (V, Srel) of shape (m_max,
    n_max), [j, i] holding n = i+1, m = j+1."""
    vtab, srel = fill_table_ref(a, n_max, m_max, with_srel)
    return (vtab.T.contiguous(),
            srel.T.contiguous() if srel is not None else None)


def fill_table_cols_cuda(a: torch.Tensor, n_max: int, m_max: int,
                         with_srel: bool = True):
    """Launch K3 on ``a``'s device; same outputs as fill_table_cols_ref."""
    _check("fill_table_cols_cuda", a, None, n_max, m_max)
    if a.numel() != 1:
        raise ValueError("fill_table_cols_cuda: one discount only")
    if n_max >= COLS_MAX_N:
        raise ValueError(f"fill_table_cols_cuda: n_max={n_max} >= 2^24")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = cols_plan(n_max, m_max, sms, with_srel)
    vtab = torch.empty((m_max, n_max), dtype=a.dtype, device=a.device)
    srel = torch.empty_like(vtab) if with_srel else None
    halo = torch.full((plan.halo_len,), float("nan"), dtype=torch.float64,
                      device=a.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
    _LIBS["fill_table_cols"].launch(
        a.dtype, a.device, a.data_ptr(), vtab.data_ptr(),
        srel.data_ptr() if with_srel else None, halo.data_ptr(),
        ticket.data_ptr(), n_max, m_max, int(with_srel), plan.chunk,
        plan.chunks, plan.blocks, plan.smem)
    return vtab, srel


def fill_table_cols(a: torch.Tensor, n_max: int, m_max: int,
                    with_srel: bool = True):
    """V (and Srel) of one table at discount ``a``, column-major (m_max,
    n_max).  Runs where ``a`` lies: the plain fill on the CPU, K3 on a
    CUDA device."""
    if a.device.type == "cpu":
        return fill_table_cols_ref(a, n_max, m_max, with_srel)
    return fill_table_cols_cuda(a, n_max, m_max, with_srel)
