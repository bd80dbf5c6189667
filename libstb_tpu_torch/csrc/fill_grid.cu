// Discount-grid Stirling table fill (V ratios + Srel) for Hopper (sm_90a):
// kernel K1.
//
// Replaces the TPU kernel libstb_tpu/ops/stirling_pallas.py:_kernel (the
// body of fill_grid): for every discount a_g of the grid, the V ratio
// table and Srel by the difference form of the increment,
// log U(n-1, m) - log(n-1 - a), with S1 Kahan-summed in the kernel to set
// the fresh diagonal.  Layout (G, n_max, m_max) row-major.
//
// The walk itself is row_walk.cuh: each table's columns are cut into tiles
// of 32, one warp walks a tile over n with its state in registers and the
// left neighbour by shuffle, tiles hand their edge 1/V to the right through
// a halo column (a wavefront), and warps claim tiles by ticket.  At the
// benchmark shape (64 x 16384 x 1024) that is 2048 tiles spread over all
// 132 SMs; see row_walk.cuh for what bounds the walk.
#include "row_walk.cuh"

extern "C" int stb_fill_grid_f32(const float* avec, float* v, float* s,
                                 double* halo, int* ticket, int g, int n,
                                 int m, int with_srel, int tiles, int blocks,
                                 void* stream) {
  return row_walk::launch<float, false>(avec, v, s, halo, ticket, g, n, m,
                                        with_srel, tiles, blocks, stream);
}

extern "C" int stb_fill_grid_f64(const double* avec, double* v, double* s,
                                 double* halo, int* ticket, int g, int n,
                                 int m, int with_srel, int tiles, int blocks,
                                 void* stream) {
  return row_walk::launch<double, false>(avec, v, s, halo, ticket, g, n, m,
                                         with_srel, tiles, blocks, stream);
}
