// Single-table Stirling fill by the row walk (V ratios + Srel) for Hopper
// (sm_90a): kernel K2.
//
// Replaces the TPU kernel libstb_tpu/ops/stirling_pallas.py:_kernel_folded
// (the body of fill_table): one discount, the V ratio table and Srel by the
// log-ratio form of the increment, log(U(n-1, m) / (n-1 - a)), which loses
// nothing to cancellation where K1's difference of two large logs does;
// S1 as one scalar Kahan pair; rows past the diagonal run a lean body.
// Layout (n_max, m_max) row-major.
//
// The walk is row_walk.cuh at G = 1: the m columns are cut into tiles of
// 32, one warp a tile, the edge 1/V handed from tile to tile through a
// halo column, so a table of width m runs on ceil(m / 32) warps spread over
// the SMs with no barrier.  Its time is about (n + 32 (tiles - 1)) row
// steps of one warp; see row_walk.cuh.
#include "row_walk.cuh"

extern "C" int stb_fill_table_f32(const float* a, float* v, float* s,
                                  double* halo, int* ticket, int n,
                                  int m, int with_srel, int tiles, int blocks,
                                  void* stream) {
  return row_walk::launch<float, true>(a, v, s, halo, ticket, 1, n, m,
                                       with_srel, tiles, blocks, stream);
}

extern "C" int stb_fill_table_f64(const double* a, double* v, double* s,
                                  double* halo, int* ticket, int n,
                                  int m, int with_srel, int tiles, int blocks,
                                  void* stream) {
  return row_walk::launch<double, true>(a, v, s, halo, ticket, 1, n, m,
                                        with_srel, tiles, blocks, stream);
}
