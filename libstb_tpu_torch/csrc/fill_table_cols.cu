// Single-table Stirling fill by columns, with a parallel scan over n, for
// Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel libstb_tpu/ops/stirling_pallas.py:_kernel_cols
// (the body of fill_table_cols).  A row walk over n = 2^20 rows is 2^20
// dependent steps; this kernel instead fills one column m at a time, and
// along n that column's recurrence is affine in the unknown column:
//
//   V(n, m) = A_n V(n-1, m) + B_n,       c = n-1 - (m-1) a,
//   B_n = 1 / (1/V(n-1, m-1) + c) = V(n-1, m-1) / (1 + c V(n-1, m-1)),
//   A_n = (n-1 - m a) B_n,
//
// the ratio recurrence of K1/K2 with the left column known.  Affine maps
// compose associatively, (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2), so a
// column is a prefix scan of maps.  Srel(n, m) = Srel(n, m-1) + log V(n, m)
// then accumulates ALONG m, as a Kahan (sum, comp) pair per row.
//
// Structure: a chained column pipeline.  The rows are cut into contiguous
// chunks of ``chunk`` rows (ops/stirling_cuda.py: cols_plan); a block owns
// one chunk and walks ALL the columns m = 2..m_max over it before it
// claims another.  Its 16 row warps own the rows, warp w the w-th segment
// of chunk / 16 rows and lane l of it k = chunk / 512 consecutive rows;
// its 17th warp, the carry warp, owns the hand-off.  Per column, per
// block:
//
//   1. compose: each thread composes the maps of its k rows in order and
//      the warp scans its 32 threads' maps (one 5-step shuffle scan);
//      meanwhile the carry warp polls the halo for the carry, V at the last
//      row of the chunk before, until it is not NaN;
//   -- barrier 1 --
//   2. the carry warp scans the 16 warps' maps, publishes V at its own
//      chunk's last row (the chunk's map applied to the carry: one FMA a
//      hop, before any replay) and hands each warp the maps of the warps
//      before it; meanwhile the row warps store column m-1: V and Srel,
//      one row a lane, coalesced (the table is column-major, (m_max,
//      n_max), so a column is contiguous), Srel's Kahan pair moved on by
//      log V;
//   -- barrier 2 --
//   3. replay: each thread applies its k maps in order to the V entering
//      it (the carry through the maps of the rows before it) and writes
//      the new V to the row state.
//
// A thread's consecutive rows keep the sequential work (a map and its
// composition, one FMA to apply it) in registers and leave one shuffle
// scan a column; the store pass turns the rows back to one a lane for the
// log and the coalesced stores, and it hides the carry warp's work.  Two
// barriers a column (named, since the two kinds of warp reach them at
// different points) and no grid barrier: the blocks walk the columns in
// lockstep down the pipeline, chunk c one hop behind chunk c-1, so the
// chain's latency is paid once a fill (chunks + m_max steps), not once a
// column.
//
// The hand-off is row_walk.cuh's: halo[c][j], V at the last row of chunk c
// in column j, lives in a column the wrapper filled with NaN (V is +inf, 0
// or finite positive, never NaN; an aligned 8-byte relaxed store is
// single-copy atomic, so a value that is not NaN is complete).  Chunks are
// claimed by an atomic ticket in row order, so a chunk's producer, the
// chunk before it, holds a lower ticket and runs: no deadlock for any n or
// grid, including more chunks than resident blocks, which run in waves.
// A wait of more than ~2^27 polls traps, so a fault in the hand-off is a
// launch error, not a hung card.
//
// The chunk's first row R0 needs V(R0-1, m-1), a row of the chunk before,
// whose block publishes its carry before it replays: that row of its
// state is not ordered against this read.  It is the carry this block
// received in the previous column, which warp 0 holds in a register (the
// V that entered it); likewise lane 0 of every warp takes the row above
// its segment from the V that entered the warp in the previous column,
// and lane l > 0 from lane l-1 by shuffle, so no row is read across
// threads from the state.
//
// The row state lives in dynamic shared memory for the chunk's life: V of
// the previous column (one pad double every 16, so a thread's k rows and
// its neighbours' fall in different banks) and Srel's Kahan pair, 24.5
// bytes a row (8.5 without Srel).  It is updated in place: a thread reads
// its row's old V before it writes the new one and carries it to its next
// row in a register.
//
// Sentinels, none computed from inf - inf or fed to a divide:
//   * column m = 1 is assigned: V = +inf, Srel = 0; column m = 2 then
//     takes the closed form B = 1/(n-1 - a) of the TPU kernel;
//   * above the diagonal (m > n, row n = 1 included) the map is assigned
//     (0, 0): V = 0 exactly, Srel = -inf, and the Kahan compensation 0;
//   * rows past n (the last chunk's padding) have the identity map.
// Every divide is row_walk.cuh's div_pos and every log its log_pos, which
// see only finite positive operands (selects feed them 1 elsewhere).
//
// Precision: maps, the carried V and the Srel pair are f64 whatever the
// table type, and each cell is rounded once to T on its store.
//
// Bound on this card: the tables cost 2 sizeof(T) bytes a cell to write,
// 2.56 ms at (2^20, 1024) in f32.  Each cell costs ~65 f64 instructions
// (the map's divide twice, composed and replayed, the log, the Kahan
// update), so a full chunk (8192 rows on each of 128 SMs at 2^20 rows) is
// bound by the f64 pipe, ~8192 x 65 / 64 cycles of one SM a column; measured
// on an H100 it runs at about half that rate (PERF.md, Findings).  Below
// ~2^17 rows a chunk is 512 rows, one a thread, and a column costs the
// latency of the chain of one column: a divide, two shuffle scans, two
// barriers and the replay, ~1.4 us.
#include <cuda_runtime.h>
#include <math.h>

#include "row_walk.cuh"

namespace {

using row_walk::div_pos;
using row_walk::load_relaxed;
using row_walk::log_pos;
using row_walk::store_relaxed;

constexpr int kWarps = 16;             // warps on the rows
constexpr int kRowThreads = kWarps * 32;
constexpr int kThreads = kRowThreads + 32;   // and one warp for the carry
constexpr int kChunkStep = kRowThreads; // a chunk is k rows a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarMaps = 1, kBarCarry = 2;   // named barriers, all threads

// the named barrier ``id``: every thread of the block arrives, the row
// warps and the carry warp each at their own point of the code
__device__ __forceinline__ void bar(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

struct Map {                            // x -> A x + B
  double A, B;
};

// ``first`` applied first, then ``then``
__device__ __forceinline__ Map after(Map first, Map then) {
  return {then.A * first.A, then.A * first.B + then.B};
}

// inclusive scan over the first kLanes lanes: lane l gets map_l o ... o
// map_0
template <int kLanes = 32>
__device__ __forceinline__ Map warp_scan(Map m, int lane) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const double pa = __shfl_up_sync(kFull, m.A, off);
    const double pb = __shfl_up_sync(kFull, m.B, off);
    if (lane >= off) m = after({pa, pb}, m);
  }
  return m;
}

// where row i of the chunk keeps its V: one pad double every 16 rows
__device__ __forceinline__ int vslot(int i) { return i + (i >> 4); }

// the map of row r (n = r+1) in column j (m = j+1 >= 2), from prev =
// V(n-1, m-1); ja = (m-1) a, j1a = m a
__device__ __forceinline__ Map row_map(double prev, int r, int n, int j,
                                       double ja, double j1a) {
  const double rr = static_cast<double>(r);
  const double c = rr - ja;             // n-1 - (m-1) a
  const bool above = j > r;             // m > n: V = 0 (row n = 1 too)
  // B = V / (1 + c V); V(., 1) = +inf gives the closed form 1 / c
  const double num = above || j == 1 ? 1.0 : prev;
  const double den = above ? 1.0 : j == 1 ? c : c * prev + 1.0;
  const double b = div_pos(num, den);
  if (r >= n) return {1.0, 0.0};        // padding row: identity
  return {above ? 0.0 : (rr - j1a) * b, above ? 0.0 : b};
}

// Scratch, allocated by the wrapper:
//   halo   [chunks-1][m_max] f64, filled with NaN
//   ticket one int32, zeroed
// and the dynamic shared memory, per block: V at vslot(i) (chunk + chunk
// / 16 f64), then with Srel its sum and compensation (chunk f64 each).
template <typename T, bool kSrel>
__global__ void __launch_bounds__(kThreads, 1)
cols_kernel(const T* __restrict__ a_ptr, T* __restrict__ vout,
            T* __restrict__ sout, double* halo, int* ticket, int n,
            int m_max, int chunk, int chunks) {
  extern __shared__ double state[];
  __shared__ double wA[kWarps], wB[kWarps];   // the warps' segment maps
  __shared__ double xA[kWarps], xB[kWarps];   // the maps of the warps before
  __shared__ double cin;                      // the carry, V(R0-1, m)
  __shared__ int next;
  const double inf = static_cast<double>(INFINITY);
  const double a = static_cast<double>(*a_ptr);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;          // kWarps: the carry warp
  const int seg = chunk / kWarps;             // rows a warp
  const int k = seg / 32;                     // rows a thread
  const int w0 = warp * seg;                  // this warp's first row
  const int t0 = w0 + lane * k;               // this thread's first row
  double* vst = state;
  double* sacc = state + vslot(chunk);
  double* scomp = sacc + chunk;

  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
    __syncthreads();
    const int c = next;
    if (c >= chunks) return;
    const int R0 = c * chunk;

    // column m = 1
    for (int i = threadIdx.x; i < chunk; i += kThreads) {
      vst[vslot(i)] = inf;
      if (kSrel) {
        sacc[i] = 0.0;
        scomp[i] = 0.0;
      }
      if (R0 + i < n) {
        vout[R0 + i] = static_cast<T>(inf);
        if (kSrel) sout[R0 + i] = T(0);
      }
    }
    __syncthreads();

    if (warp == kWarps) {
      // the carry warp: per column, wait for the carry (before the row
      // warps need it), then compose the warps' maps, publish this chunk's
      // last V and hand each warp the maps of the warps before it
      const size_t h = static_cast<size_t>(c) * m_max;
      const double* hin = halo + (c > 0 ? h - m_max : 0);   // chunk c-1
      double* hout = halo + h;
      for (int j = 1; j < m_max; ++j) {
        double carry = 0.0;             // V(R0-1, m); row -1 := 0
        if (lane == 0 && c > 0) {
          for (unsigned polls = 0;; ++polls) {
            carry = load_relaxed(hin + j);
            if (!isnan(carry)) break;
            if (polls > (1u << 27)) __trap();
            __nanosleep(64);
          }
        }
        bar(kBarMaps);
        Map p = lane < kWarps ? Map{wA[lane], wB[lane]} : Map{1.0, 0.0};
        p = warp_scan<kWarps>(p, lane);
        const double ba = __shfl_sync(kFull, p.A, kWarps - 1);
        const double bb = __shfl_sync(kFull, p.B, kWarps - 1);
        if (lane == 0) {
          if (c + 1 < chunks) store_relaxed(hout + j, ba * carry + bb);
          cin = carry;
        }
        if (lane + 1 < kWarps) {
          xA[lane + 1] = p.A;
          xB[lane + 1] = p.B;
        }
        bar(kBarCarry);
      }
      continue;
    }

    // the row warps.  V and Srel of row i of the chunk (one a lane) in
    // column jc to the tables, coalesced; Srel's Kahan pair moves on by
    // log V
    auto store_row = [&](int jc, int i, double vn) {
      const int r = R0 + i;
      const size_t o = static_cast<size_t>(jc) * n + r;
      if (r < n) vout[o] = static_cast<T>(vn);
      if (kSrel) {
        const bool live = jc <= r && r < n;   // V finite positive
        const double sa = sacc[i];
        const double y = log_pos(live ? vn : 1.0) - scomp[i];
        const double t = sa + y;
        scomp[i] = live ? (t - sa) - y : 0.0;
        const double sn = live ? t : -inf;
        sacc[i] = sn;
        if (r < n) sout[o] = static_cast<T>(sn);
      }
    };
    // the store pass of column jc, from the state (one row a thread: the
    // lane's row is the thread's, whose V is in v)
    auto store_column = [&](int jc, double v) {
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const int q = w0 + 32 * i + lane;
        store_row(jc, q, k == 1 ? v : vst[vslot(q)]);
      }
    };

    double v = inf;                     // V(t0 + k - 1, m-1)
    double vw = inf;                    // V(w0 - 1, m-1)
    for (int j = 1; j < m_max; ++j) {   // column m = j+1
      const double ja = static_cast<double>(j) * a;
      const double j1a = static_cast<double>(j + 1) * a;

      // 1. compose this thread's rows, then the warp's threads.  The row
      // before the thread's first, V(t0-1, m-1), is the last row of the
      // lane before, or for lane 0 the V that entered the warp in the last
      // column (for warp 0, the carry: the last row of the chunk before)
      const double vl = __shfl_up_sync(kFull, v, 1);
      const double p0 = lane == 0 ? vw : vl;
      const Map m0 = row_map(p0, R0 + t0, n, j, ja, j1a);
      Map agg = m0;
#pragma unroll 4
      for (int i = 1; i < k; ++i) {
        const double old = vst[vslot(t0 + i - 1)];
        agg = after(agg, row_map(old, R0 + t0 + i, n, j, ja, j1a));
      }
      const Map incl = warp_scan(agg, lane);
      if (lane == 31) {
        wA[warp] = incl.A;
        wB[warp] = incl.B;
      }
      bar(kBarMaps);

      // 2. while the carry warp works: column m-1 to the tables
      if (j > 1) store_column(j - 1, v);
      const double ea = __shfl_up_sync(kFull, incl.A, 1);
      const double eb = __shfl_up_sync(kFull, incl.B, 1);
      bar(kBarCarry);

      // 3. replay this thread's rows from the V entering it
      vw = warp == 0 ? cin : xA[warp] * cin + xB[warp];
      v = lane == 0 ? vw : ea * vw + eb;
      double prev = p0;
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const double old = vst[vslot(t0 + i)];
        const Map mp =
            i == 0 ? m0 : row_map(prev, R0 + t0 + i, n, j, ja, j1a);
        v = mp.A * v + mp.B;
        vst[vslot(t0 + i)] = v;
        prev = old;
      }
    }
    // 4. the last column
    if (m_max > 1) {
      __syncwarp();
      store_column(m_max - 1, v);
    }
  }
}

template <typename T, bool kSrel>
cudaError_t go(const T* a, T* v, T* s, double* halo, int* ticket, int n,
               int m, int chunk, int chunks, int blocks, int smem,
               cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      cols_kernel<T, kSrel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cols_kernel<T, kSrel><<<blocks, kThreads, smem, st>>>(
      a, v, s, halo, ticket, n, m, chunk, chunks);
  return cudaGetLastError();
}

// One launch of ``blocks`` blocks over ``chunks`` chunks of ``chunk`` rows,
// each block asking for ``smem`` bytes of dynamic shared memory; the
// geometry comes from the wrapper.  Returns a cudaError_t as int.
template <typename T>
int launch(const T* a, T* v, T* s, double* halo, int* ticket, int n, int m,
           int with_srel, int chunk, int chunks, int blocks, int smem,
           void* stream) {
  const long long need =
      8LL * (chunk + chunk / 16) + (with_srel ? 16LL * chunk : 0);
  if (n < 1 || m < 1 || chunk < kChunkStep || chunk % kChunkStep != 0 ||
      chunks < 1 || static_cast<long long>(chunks) * chunk < n ||
      static_cast<long long>(chunks - 1) * chunk >= n || blocks < 1 ||
      blocks > chunks || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_srel ? go<T, true>(a, v, s, halo, ticket, n, m, chunk, chunks,
                              blocks, smem, st)
                : go<T, false>(a, v, s, halo, ticket, n, m, chunk, chunks,
                               blocks, smem, st));
}

}  // namespace

extern "C" int stb_fill_table_cols_f32(const float* a, float* v, float* s,
                                       double* halo, int* ticket, int n,
                                       int m, int with_srel, int chunk,
                                       int chunks, int blocks, int smem,
                                       void* stream) {
  return launch<float>(a, v, s, halo, ticket, n, m, with_srel, chunk, chunks,
                       blocks, smem, stream);
}

extern "C" int stb_fill_table_cols_f64(const double* a, double* v, double* s,
                                       double* halo, int* ticket, int n,
                                       int m, int with_srel, int chunk,
                                       int chunks, int blocks, int smem,
                                       void* stream) {
  return launch<double>(a, v, s, halo, ticket, n, m, with_srel, chunk,
                        chunks, blocks, smem, stream);
}
