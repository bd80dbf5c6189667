// Single-table Stirling fill by the row walk (V ratios + Srel) for Hopper
// (sm_90a): kernel K2.
//
// Replaces the TPU kernel libstb_tpu/ops/stirling_pallas.py:_kernel_folded
// (the body of fill_table).  For one discount a it walks n = 1..n_max in
// order and writes one row of both tables per step:
//
//   V(n, m)    = (1 + (n-1 - m a) V(n-1, m)) / (1/V(n-1, m-1) + n-1 - (m-1) a)
//   Srel(n, m) = Srel(n-1, m) + log(U(n-1, m) / (n-1 - a)),
//   U(n, m)    = (n - m a) + 1/V(n, m),
//
// the log-ratio form of the Srel increment: the ratio lies near 1, where
// log loses nothing to cancellation (the difference log U - log(n-1-a) of
// K1 cancels two large logs).  The increments are summed as a Kahan
// (sum, comp) pair; S1 is Kahan-summed as one scalar pair in every thread
// and sets the fresh diagonal Srel(n, n) = -S1(n).  Sentinels: V(., 1) =
// +inf, 1/V = +inf and V = 0 above the diagonal, Srel = -inf above the
// diagonal.  Layout (n_max, m_max) row-major, row i holding n = i+1.
//
// Layout of work: one thread block walks n; thread t owns columns t,
// t+blockDim, ... (a warp writes 32 consecutive cells) and keeps each
// column's V, 1/V and Kahan pair in registers across the row loop.  The
// left neighbour's 1/V(n-1, m-1) goes through a double-buffered shared row
// of f64, one __syncthreads() per row.  Rows past the last column's
// diagonal (n > m_max) run a lean body: no diagonal test and no S1 update.
//
// Precision: the recurrence is carried in f64 whatever the table type, and
// each cell is rounded once to T on its store (in f32 the V recurrence
// drifts linearly in n, past 1e-4 relative by n = 16384; see fill_grid.cu).
// IEEE division gives 1/inf = 0 and exact zeros above the diagonal; cells
// on and above the diagonal are assigned, never computed, so no NaN forms.
// Build without -use_fast_math.
//
// Bound on this card: one block on one of the 132 SMs, so the walk is
// bound by the latency of one row step (two f64 divides, one f64 log, one
// block barrier), not by bandwidth.  Splitting m across the blocks of a
// thread-block cluster, with the halo 1/V exchanged through distributed
// shared memory, is the next step.
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(1024)
fill_table_kernel(const T* __restrict__ a_ptr, T* __restrict__ vout,
                  T* __restrict__ sout, int n_max, int m_max, int with_srel) {
  using A = double;                                  // carried precision
  extern __shared__ unsigned char smem_raw[];
  A* rbuf = reinterpret_cast<A*>(smem_raw);          // [2][m_max] of 1/V
  const A inf = static_cast<A>(INFINITY);
  const A tiny = 1e-30;
  const A a = static_cast<A>(*a_ptr);

  A v[K], r[K], sacc[K], scomp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    // row n = 1: V = [inf, 0, ...], 1/V = [0, inf, ...], Srel = [0, -inf, ...]
    v[k] = c == 0 ? inf : A(0);
    r[k] = c == 0 ? A(0) : inf;
    sacc[k] = c == 0 ? A(0) : -inf;
    scomp[k] = A(0);
    if (c < m_max) {
      vout[c] = static_cast<T>(v[k]);
      if (with_srel) sout[c] = static_cast<T>(sacc[k]);
      rbuf[c] = r[k];
    }
  }
  A s1 = A(0), s1c = A(0);                           // Kahan pair for S1
  __syncthreads();

  for (int i = 1; i < n_max; ++i) {                  // row i holds n = i+1
    const A* rprev = rbuf + ((i - 1) & 1) * m_max;
    A* rnext = rbuf + (i & 1) * m_max;
    const A nm1 = static_cast<A>(i);                 // n - 1
    const A nma = nm1 - a;                           // n-1 - a > 0
    const bool lean = i >= m_max;                    // past every diagonal
    const size_t row = static_cast<size_t>(i) * m_max;
    if (with_srel && !lean) {
      const A y1 = log(fmax(nma, tiny)) - s1c;       // S1(n) - S1(n-1)
      const A t1 = s1 + y1;
      s1c = (t1 - s1) - y1;
      s1 = t1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c >= m_max) continue;
      const A am = static_cast<A>(c + 1) * a;        // m a
      const A am1 = static_cast<A>(c) * a;           // (m-1) a
      const A rleft = c == 0 ? A(0) : rprev[c - 1];  // 1/V(n-1, m-1)
      const A numer = A(1) + (nm1 - am) * v[k];
      const A denom = rleft + (nm1 - am1);
      const A vn = numer / denom;
      const A rn = denom / numer;
      if (with_srel) {
        if (c < i) {                                 // 1 <= m <= n-1: update
          const A u = (nm1 - am) + r[k];             // U(n-1, m)
          const A y = log(fmax(u / nma, tiny)) - scomp[k];
          const A t = sacc[k] + y;
          scomp[k] = (t - sacc[k]) - y;
          sacc[k] = t;
        } else {                                     // fresh diagonal / above
          sacc[k] = c == i ? -s1 : -inf;
          scomp[k] = A(0);
        }
        sout[row + c] = static_cast<T>(sacc[k]);
      }
      v[k] = vn;
      r[k] = rn;
      vout[row + c] = static_cast<T>(vn);
      rnext[c] = rn;
    }
    __syncthreads();
  }
}

template <typename T, int K>
int launch_k(const T* a, T* v, T* s, int n, int m, int with_srel,
             cudaStream_t stream) {
  int threads = (m + K - 1) / K;
  threads = ((threads + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      fill_table_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_table_kernel<T, K><<<1, threads, smem, stream>>>(a, v, s, n, m,
                                                        with_srel);
  return static_cast<int>(cudaGetLastError());
}

// Columns per thread: the smallest K with ceil(m / K) <= 1024 threads.  The
// shared row takes 16 m bytes, so m <= 14336 (224 KB of the 227 KB).
template <typename T>
int launch(const T* a, T* v, T* s, int n, int m, int with_srel,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 1024) return launch_k<T, 1>(a, v, s, n, m, with_srel, st);
  if (m <= 2048) return launch_k<T, 2>(a, v, s, n, m, with_srel, st);
  if (m <= 4096) return launch_k<T, 4>(a, v, s, n, m, with_srel, st);
  if (m <= 8192) return launch_k<T, 8>(a, v, s, n, m, with_srel, st);
  if (m <= 14336) return launch_k<T, 16>(a, v, s, n, m, with_srel, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int stb_fill_table_f32(const float* a, float* v, float* s, int n,
                                  int m, int with_srel, void* stream) {
  return launch<float>(a, v, s, n, m, with_srel, stream);
}

extern "C" int stb_fill_table_f64(const double* a, double* v, double* s,
                                  int n, int m, int with_srel, void* stream) {
  return launch<double>(a, v, s, n, m, with_srel, stream);
}
