// Single-table Stirling fill by columns, with a parallel scan over n, for
// Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel libstb_tpu/ops/stirling_pallas.py:_kernel_cols
// (the body of fill_table_cols).  A row walk over n = 2^20 rows is 2^20
// dependent steps; this kernel instead fills one column m at a time, and
// along n that column's recurrence is affine in the unknown column:
//
//   V(n, m) = A_n V(n-1, m) + B_n,
//   B_n = 1 / (1/V(n-1, m-1) + n-1 - (m-1) a),   A_n = (n-1 - m a) B_n,
//
// the ratio recurrence of K1/K2 with the left column known.  Affine maps
// compose associatively, (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2), so a
// column is a prefix scan of maps.  Srel(n, m) = Srel(n, m-1) + log V(n, m)
// then accumulates ALONG m, as a Kahan (sum, comp) pair per row.
//
// Structure: one cooperative persistent kernel (cudaLaunchCooperativeKernel)
// walks the columns; grid.sync() separates its phases.  Rows split into
// contiguous segments, one per warp (warps of a block hold neighbouring
// segments); a warp takes its segment 32 rows at a time, lane l on row
// r0 + l, and composes the 32 maps by a shuffle scan.  Per column m >= 2:
//
//   phase 1: each warp composes the maps of its segment; the block
//            composes its warps' maps and publishes one map per block;
//   grid.sync()
//   phase 2: each block composes the maps of the blocks before it (the
//            value entering the block), each warp adds its block's earlier
//            warps, then replays its segment: scan, apply to the carried
//            V, store V(., m) and Srel(., m) (coalesced: the table is
//            column-major, (m_max, n_max), so a column is contiguous) and
//            1/V(., m) for the next column;
//   grid.sync()
//
// Sentinels, none computed from inf - inf:
//   * column m = 1 is assigned: V = +inf, Srel = 0, 1/V = 0;
//   * column m = 2 then gets B_n = 1 / (0 + n-1 - a): the closed form
//     1/(r - a), r = n-1, of the TPU kernel.  (The form B = vL/(1 + c vL)
//     with vL = V(n-1, 1) = +inf would give inf/inf = NaN in IEEE f64.)
//   * row n = 1 is forced to the map (0, 0): V(1, m) = 0 for m >= 2;
//   * above the diagonal 1/V(n-1, m-1) = +inf, so B = 1/inf = 0 and
//     (A, B) = (0, 0): V = 0 exactly, log V = -inf, Srel = -inf;
//   * the Kahan compensation is set to 0 where the running sum is not
//     finite: -inf - (-inf) would write NaN.
//
// Precision: maps, the carried V, 1/V and the Srel pair are f64 whatever
// the table type, and each cell is rounded once to T on its store.
//
// Bound on this card: the tables cost 2 sizeof(T) bytes a cell to write;
// the f64 state (1/V of two columns and the Srel pair, 32 bytes a row)
// is read and written once per column and stays in the 50 MB L2 up to
// about 2^20 rows.  Each cell costs two f64 divides (B and 1/V), one f64
// log and two shuffle scans of 5 steps, and each column two grid barriers.
// Fusing phase 1 of column m+1 into the replay of column m (the TPU
// kernel's structure) would halve the barriers and the map work.
#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;        // scratch holds this many block maps
constexpr int kBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Map {                            // x -> A x + B
  double A, B;
};

// ``first`` applied first, then ``then``
__device__ __forceinline__ Map after(Map first, Map then) {
  return {then.A * first.A, then.A * first.B + then.B};
}

// inclusive scan over the lanes: lane l gets map_l o ... o map_0
__device__ __forceinline__ Map warp_scan(Map m, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double pa = __shfl_up_sync(kFull, m.A, off);
    const double pb = __shfl_up_sync(kFull, m.B, off);
    if (lane >= off) m = after({pa, pb}, m);
  }
  return m;
}

// the map of row r (n = r+1) in column m >= 2, from 1/V of column m-1
__device__ __forceinline__ Map row_map(const double* rprev,
                                       int r, int n, double a, double m) {
  if (r >= n) return {1.0, 0.0};        // padding row: identity
  if (r == 0) return {0.0, 0.0};        // V(1, m) = 0
  const double rr = static_cast<double>(r);
  const double b = 1.0 / (rprev[r - 1] + (rr - (m - 1.0) * a));
  return {(rr - m * a) * b, b};
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fill_table_cols_kernel(const T* __restrict__ a_ptr, T* __restrict__ vout,
                       T* __restrict__ sout, double* scratch,
                       int n, int m_max, int with_srel, int seg) {
  // scratch is written and read by different blocks within this launch, so
  // it is not __restrict__: its loads must not take the non-coherent
  // read-only path; grid.sync() orders them against the other blocks' stores
  cg::grid_group grid = cg::this_grid();
  __shared__ double wA[kWarps], wB[kWarps];   // this block's warp maps
  __shared__ double xA[kWarps], xB[kWarps];   // reduction of block maps
  __shared__ double vin[kWarps];              // V entering each warp
  const double inf = static_cast<double>(INFINITY);
  const double a = static_cast<double>(*a_ptr);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nblk = gridDim.x;
  double* rbuf0 = scratch;                    // 1/V, even columns
  double* rbuf1 = scratch + n;                // 1/V, odd columns
  double* sacc = scratch + 2 * static_cast<size_t>(n);
  double* scomp = scratch + 3 * static_cast<size_t>(n);
  double* aggA = scratch + 4 * static_cast<size_t>(n);
  double* aggB = aggA + kMaxBlocks;
  const int r0 = (blockIdx.x * kWarps + warp) * seg;  // this warp's rows

  // column m = 1
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < n;
       r += nblk * kThreads) {
    vout[r] = static_cast<T>(inf);
    rbuf0[r] = 0.0;
    if (with_srel) {
      sout[r] = T(0);
      sacc[r] = 0.0;
      scomp[r] = 0.0;
    }
  }
  grid.sync();

  for (int j = 1; j < m_max; ++j) {           // column m = j+1
    const double m = static_cast<double>(j + 1);
    const double* rprev = (j & 1) ? rbuf0 : rbuf1;
    double* rcur = (j & 1) ? rbuf1 : rbuf0;

    // phase 1: the map of each warp's segment, then of each block
    Map agg = {1.0, 0.0};
    for (int g = 0; g < seg; g += 32) {
      const Map s = warp_scan(row_map(rprev, r0 + g + lane, n, a, m), lane);
      agg = after(agg, {__shfl_sync(kFull, s.A, 31),
                        __shfl_sync(kFull, s.B, 31)});
    }
    if (lane == 0) {
      wA[warp] = agg.A;
      wB[warp] = agg.B;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      Map b = {1.0, 0.0};
      for (int w = 0; w < kWarps; ++w) b = after(b, {wA[w], wB[w]});
      aggA[blockIdx.x] = b.A;
      aggB[blockIdx.x] = b.B;
    }
    grid.sync();

    // the map of all rows before this block: thread t composes block maps
    // [t k, (t+1) k) below blockIdx.x, in order, then the threads' maps
    // are composed in thread order
    const int per = (nblk + kThreads - 1) / kThreads;
    Map e = {1.0, 0.0};
    const int q_end = min((static_cast<int>(threadIdx.x) + 1) * per,
                          static_cast<int>(blockIdx.x));
    for (int q = threadIdx.x * per; q < q_end; ++q)
      e = after(e, {aggA[q], aggB[q]});
    e = warp_scan(e, lane);
    if (lane == 31) {
      xA[warp] = e.A;
      xB[warp] = e.B;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      Map b = {1.0, 0.0};
      for (int w = 0; w < kWarps; ++w) b = after(b, {xA[w], xB[w]});
      // V entering warp w = the composed map applied to V(row -1) := 0
      // (row 0's map is (0, 0), so the value is the map's B either way)
      for (int w = 0; w < kWarps; ++w) {
        vin[w] = b.B;
        b = after(b, {wA[w], wB[w]});
      }
    }
    __syncthreads();

    // phase 2: replay this warp's segment
    double v = vin[warp];
    for (int g = 0; g < seg; g += 32) {
      const int r = r0 + g + lane;
      const Map s = warp_scan(row_map(rprev, r, n, a, m), lane);
      const double vn = s.A * v + s.B;
      v = __shfl_sync(kFull, vn, 31);
      if (r < n) {
        const size_t o = static_cast<size_t>(j) * n + r;
        vout[o] = static_cast<T>(vn);
        rcur[r] = 1.0 / vn;                   // +inf above the diagonal
        if (with_srel) {
          const double sa = sacc[r];
          const double y = log(vn) - scomp[r];
          const double t = sa + y;
          scomp[r] = isfinite(t) ? (t - sa) - y : 0.0;
          sacc[r] = t;
          sout[o] = static_cast<T>(t);
        }
      }
    }
    grid.sync();
  }
}

template <typename T>
int launch(const T* a, T* v, T* s, double* scratch, int n, int m,
           int with_srel, void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fill_table_cols_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block co-resident (grid.sync), at most kBlocksPerSm per SM, and
  // no more blocks than 32-row groups of work need
  const int rows_per_block = kThreads;        // one 32-row group a warp
  int nblk = sms * std::min(per_sm, kBlocksPerSm);
  nblk = std::min(nblk, (n + rows_per_block - 1) / rows_per_block);
  nblk = std::max(1, std::min(nblk, kMaxBlocks));
  const long long warps = static_cast<long long>(nblk) * kWarps;
  int seg = static_cast<int>((n + warps * 32 - 1) / (warps * 32)) * 32;
  void* args[] = {&a, &v, &s, &scratch, &n, &m, &with_srel, &seg};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fill_table_cols_kernel<T>), dim3(nblk),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stb_fill_table_cols_f32(const float* a, float* v, float* s,
                                       double* scratch, int n, int m,
                                       int with_srel, void* stream) {
  return launch<float>(a, v, s, scratch, n, m, with_srel, stream);
}

extern "C" int stb_fill_table_cols_f64(const double* a, double* v, double* s,
                                       double* scratch, int n, int m,
                                       int with_srel, void* stream) {
  return launch<double>(a, v, s, scratch, n, m, with_srel, stream);
}
