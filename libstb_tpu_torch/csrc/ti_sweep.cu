// The table-indicator (TI) Gibbs sweep of models/pyp._ti_run for Hopper
// (sm_90a): every step of one sweep in one launch.
//
// No TPU kernel stands behind it: the JAX package's sweep
// (libstb_tpu/models/pyp.py: ti_sweep_blocked) is XLA code, a scan over
// the schedule's steps that XLA compiles into one program.  The port's
// plain version, models/pyp._ti_run_ref, runs the same steps as a Python
// loop of ~38 small PyTorch operations a step; at the Quick-start's shape
// (S = 100 steps, C = 16384 chains, W = 4 slots) the host's launches, not
// the device, set its pace.
//
// A lane is one (chain, slot).  At step s it reads its cell t[c, flat[s,
// w]] and its block-start total T[c, grp[s, w]], decides the removal
// (dec) with the first uniform, reads V(n, t+1) and decides the addition
// (inc) with the second uniform; its delta inc - dec then goes to the cell
// and to the total.  The arithmetic is the plain loop's, operation for
// operation and in its order, through the round-to-nearest intrinsics, so
// that nvcc contracts nothing into an FMA and t and T come out bitwise
// equal to the plain loop's for the same uniforms
// (tests/test_torch_ti_kernel.py).
//
// V(n, t+1) comes by one of two routes, a template flag (the wrapper picks
// it, models/pyp.ti_route):
//   * rows: a gather from the V rows that ti.prepare built, (C, P * mq),
//     or one row at stride 0 for a single table;
//   * grid: the four-tap Catmull-Rom interpolation of AGridTable.V from
//     the grid's vtab itself, at the lane-step that reads it.  Each chain
//     locates its discount once (stencil base and weights, as
//     AGridTable._locate and agrid._catmull_weights compute them with
//     PyTorch on a card), and a lane-step sums w_k * vtab[g - 1 + k, n -
//     1, m - 1] in V's order.  The route is taken only where V's clamps
//     and asymptote cannot apply (every n <= n_max, every m <= m_max),
//     so that it equals the rows bitwise.
//
// The loop's step semantics:
//   * every slot of a step reads the state as it stood at the start of the
//     step: a step is two phases between barriers, (A) every lane computes
//     its delta into a stage, (B) every lane adds its delta to its cell and
//     its total by an atomic add, so T adds that repeat a group within a
//     step (cat mode) accumulate in any order with the same integer sum;
//   * a lane writes the state only through its delta: a pad slot points at
//     item 0's cell and has delta 0, and adds nothing, so it cannot undo a
//     live lane's update of the same cell.
//
// Layout: a block holds ``cpb`` chains of ``tpc`` threads each; thread l of
// a chain takes slots l, l + tpc, ... (ops/ti_cuda.py: sweep_plan).  A
// chain's counts and totals (cells + groups ints) and its stage (W ints)
// stay in shared memory across all S steps, loaded once from t and T and
// written once to the new tensors.  Where one chain's row does not fit in
// a block's shared memory, the state lives in the output tensors instead
// (read past L1, ``__ldcg``, since the adds are made in L2) and the stage
// in a scratch of (C, W) ints; the arithmetic is the same.
//
// What bounds it: the bytes are the uniforms, (S, 2, C, W) read once (52 MB
// in f32 at the Quick-start's shape), t and T read and written once, and
// on the rows route one gathered sector of V a lane-step (6.6e6 x 32
// bytes): ~0.1 ms at 3.35 TB/s.  On the grid route the four taps a
// lane-step come from L2 (the vtab of a K1 grid, 64 x 512 x 128 f32 =
// 16.8 MB, fits in its 50 MB, and the rows the counts read in ~1 MB of
// it), so the device-memory bytes are the uniforms, t and T: ~0.06 ms.
// Against that stand S dependent steps, each at least one dependent load
// (the V index depends on the state) and two barriers: ~1 us a step, so
// ~0.1 ms at S = 100.  All chains are resident at once
// (16384 x 4 lanes fill the card in one wave), so the sweep costs about S
// step latencies.  The design keeps the state on chip, reads each step's
// uniforms coalesced (lanes run along the contiguous (c, w) of a row), and
// has each step ask L2 for the next step's uniforms before it needs them,
// so that a step waits for one dependent load, the V gather or taps.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // the most threads a block has

template <typename F>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float x, float y) {
    return __fadd_rn(x, y);
  }
  static __device__ __forceinline__ float sub(float x, float y) {
    return __fsub_rn(x, y);
  }
  static __device__ __forceinline__ float mul(float x, float y) {
    return __fmul_rn(x, y);
  }
  static __device__ __forceinline__ float div(float x, float y) {
    return __fdiv_rn(x, y);
  }
  static __device__ __forceinline__ float of(int x) {
    return __int2float_rn(x);
  }
  static __device__ __forceinline__ float floor(float x) {
    return floorf(x);
  }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double x, double y) {
    return __dadd_rn(x, y);
  }
  static __device__ __forceinline__ double sub(double x, double y) {
    return __dsub_rn(x, y);
  }
  static __device__ __forceinline__ double mul(double x, double y) {
    return __dmul_rn(x, y);
  }
  static __device__ __forceinline__ double div(double x, double y) {
    return __ddiv_rn(x, y);
  }
  static __device__ __forceinline__ double of(int x) {
    return __int2double_rn(x);
  }
  static __device__ __forceinline__ double floor(double x) {
    return ::floor(x);
  }
};

// A discount grid's V table and its axis (core/agrid.AGridTable): vtab
// (g_max, n_max, m_max), a0 the first discount and inv_da 1 / its step,
// each as PyTorch on a card meets them in AGridTable._locate (a Python
// scalar rounded to F; a division by one a product by its reciprocal;
// ops/ti_cuda.grid_scalars); both hold F values, in a double.
template <typename F>
struct Grid {
  const F* vtab;
  double a0, inv_da;
  int g_max, n_max, m_max;
};

// A chain's four-point stencil: the offset of plane g - 1 and the weights.
template <typename F>
struct Stencil {
  long long base;
  F w[4];
};

// AGridTable._locate and agrid._catmull_weights at discount a, operation
// for operation: pos = (a - a0) * inv_da, g = floor(pos) clamped to [1,
// g_max - 3], t = pos - g, then the weights as written there.
template <typename F>
__device__ Stencil<F> locate(const Grid<F>& q, F a) {
  using R = Rn<F>;
  const F pos = R::mul(R::sub(a, static_cast<F>(q.a0)),
                       static_cast<F>(q.inv_da));
  long long g = static_cast<long long>(R::floor(pos));
  g = min(max(g, 1LL), static_cast<long long>(q.g_max - 3));
  const F t = R::sub(pos, static_cast<F>(g));
  const F t2 = R::mul(t, t);
  const F t3 = R::mul(t2, t);
  const F h = F(0.5);
  Stencil<F> st;
  st.base = (g - 1) * q.n_max * q.m_max;
  st.w[0] = R::mul(h, R::sub(R::add(-t3, R::mul(t2, F(2))), t));
  st.w[1] = R::mul(h, R::add(R::sub(R::mul(t3, F(3)), R::mul(t2, F(5))),
                             F(2)));
  st.w[2] = R::mul(h, R::add(R::add(R::mul(t3, F(-3)), R::mul(t2, F(4))),
                             t));
  st.w[3] = R::mul(h, R::sub(t3, t2));
  return st;
}

// AGridTable.V(n, m) at the stencil's discount for n <= n_max, m <= m_max:
// 0 where m < 2 or n < m, else sum_k w_k * vtab[g - 1 + k, n - 1, m - 1]
// from 0, each product and sum rounded on its own.
template <typename F>
__device__ __forceinline__ F grid_v(const Grid<F>& q, const Stencil<F>& st,
                                    long long n, int m) {
  using R = Rn<F>;
  if (m < 2 || n < m) return F(0);
  const long long plane = static_cast<long long>(q.n_max) * q.m_max;
  const F* p = q.vtab + st.base + (n - 1) * q.m_max + (m - 1);
  F acc = F(0);
  for (int k = 0; k < 4; ++k) {
    acc = R::add(acc, R::mul(st.w[k], __ldg(p + k * plane)));
  }
  return acc;
}

template <typename F>
struct Args {
  const int* t_in;            // (C, cells) counts t
  const int* T_in;            // (C, groups) totals T
  int* t_out;
  int* T_out;
  int* stage;                 // (C, W) scratch, the state off chip only
  const F* a;                 // (C,)
  const F* b;                 // (C,)
  const F* vrows;             // rows: row c at c * vstride, P * mq wide
  Grid<F> grid;               // grid: the table V is interpolated from
  const F* u;                 // (S, 2, C, W)
  const F* nf;                // (S, W) n[j, i] as F
  const F* H;                 // (S, W) H[i] as F
  const long long* flat;      // (S, W) cell j * D + i
  const long long* grp;       // (S, W) group j
  const long long* cnt;       // (S, W) n[j, i]
  const long long* vbase;     // (S, W) the pair's offset in a V row
  const unsigned char* live;  // (S, W) the slot may be resampled
  long long vstride;
  int C, S, W, cells, groups, mq, legacy, tpc, cpb;
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <bool kOnChip>
__device__ __forceinline__ int read_state(const int* p) {
  if constexpr (kOnChip) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

template <typename F, bool kOnChip, bool kGrid>
__global__ void __launch_bounds__(kThreads) ti_kernel(const Args<F> p) {
  extern __shared__ int smem[];
  using R = Rn<F>;
  const int row = p.cells + p.groups + p.W;   // a chain's ints on chip
  const int c0 = blockIdx.x * p.cpb;
  const int nc = min(p.cpb, p.C - c0);
  const int local = threadIdx.x / p.tpc;
  const int lane = threadIdx.x - local * p.tpc;
  const bool on = local < nc;
  const int c = c0 + local;

  // the block's chains: into shared memory, or copied to the outputs
  const long long t0 = static_cast<long long>(c0) * p.cells;
  const long long g0 = static_cast<long long>(c0) * p.groups;
  for (int i = threadIdx.x; i < nc * p.cells; i += blockDim.x) {
    if (kOnChip) {
      const int k = i / p.cells;
      smem[k * row + (i - k * p.cells)] = p.t_in[t0 + i];
    } else {
      p.t_out[t0 + i] = p.t_in[t0 + i];
    }
  }
  for (int i = threadIdx.x; i < nc * p.groups; i += blockDim.x) {
    if (kOnChip) {
      const int k = i / p.groups;
      smem[k * row + p.cells + (i - k * p.groups)] = p.T_in[g0 + i];
    } else {
      p.T_out[g0 + i] = p.T_in[g0 + i];
    }
  }
  int* ts = kOnChip ? smem + local * row
                    : p.t_out + static_cast<long long>(c) * p.cells;
  int* Ts = kOnChip ? ts + p.cells
                    : p.T_out + static_cast<long long>(c) * p.groups;
  int* stage = kOnChip ? ts + p.cells + p.groups
                       : p.stage + static_cast<long long>(c) * p.W;
  __syncthreads();

  const F a = on ? p.a[c] : F(0);
  const F b = on ? p.b[c] : F(0);
  const F* vrow =
      kGrid ? nullptr : p.vrows + static_cast<long long>(c) * p.vstride;
  Stencil<F> st{};
  if (kGrid && on) st = locate(p.grid, a);
  const long long CW = static_cast<long long>(p.C) * p.W;
  for (int s = 0; s < p.S; ++s) {
    if (on) {
      // (A) every slot's delta from the state at the start of the step
      for (int w = lane; w < p.W; w += p.tpc) {
        const long long sw = static_cast<long long>(s) * p.W + w;
        const F* us = p.u + 2 * s * CW + static_cast<long long>(c) * p.W + w;
        if (s + 1 < p.S) {
          prefetch_l2(us + 2 * CW);
          prefetch_l2(us + 3 * CW);
        }
        const bool ls = p.live[sw] != 0;
        const F nif = p.nf[sw];
        const int ti = read_state<kOnChip>(ts + p.flat[sw]);
        const int Tj = read_state<kOnChip>(Ts + p.grp[sw]);
        const int dec =
            (ti > 1 && R::mul(R::sub(nif, F(1)), us[0]) < R::of(ti - 1) && ls)
                ? 1 : 0;
        const int ti2 = ti - dec;
        const int Tj2 = Tj - dec;
        // V(n, t+1), m capped at mq: m > n reads 0 on both routes (the
        // rows' last column is 0 like V)
        const int mi = min(ti2, p.mq - 1);
        const F v = kGrid ? grid_v(p.grid, st, p.cnt[sw], mi + 1)
                          : vrow[p.vbase[sw] + mi];
        const F ti2f = R::of(ti2);
        const F gap = R::sub(nif, ti2f);
        const F denom = p.legacy ? R::add(gap, F(1)) : (gap < F(1) ? F(1)
                                                                   : gap);
        const F one = R::mul(
            R::div(R::mul(R::mul(p.H[sw], R::add(b, R::mul(R::of(Tj2), a))),
                          ti2f),
                   denom),
            v);
        const int inc = (us[CW] < R::div(one, R::add(one, F(1))) && ls &&
                         ti2 < p.cnt[sw]) ? 1 : 0;
        stage[w] = inc - dec;
      }
    }
    __syncthreads();
    if (on) {
      // (B) the deltas, each to its cell and its total
      for (int w = lane; w < p.W; w += p.tpc) {
        const int d = stage[w];
        if (d != 0) {
          const long long sw = static_cast<long long>(s) * p.W + w;
          atomicAdd(ts + p.flat[sw], d);
          atomicAdd(Ts + p.grp[sw], d);
        }
      }
    }
    __syncthreads();
  }

  if (kOnChip) {
    for (int i = threadIdx.x; i < nc * p.cells; i += blockDim.x) {
      const int k = i / p.cells;
      p.t_out[t0 + i] = smem[k * row + (i - k * p.cells)];
    }
    for (int i = threadIdx.x; i < nc * p.groups; i += blockDim.x) {
      const int k = i / p.groups;
      p.T_out[g0 + i] = smem[k * row + p.cells + (i - k * p.groups)];
    }
  }
}

// One launch of ``blocks`` blocks of ``cpb`` chains x ``tpc`` threads;
// ``smem`` bytes of dynamic shared memory a block hold its chains' state,
// or 0: the state in the outputs.  The geometry comes from the wrapper.
// Returns a cudaError_t as int.
template <typename F, bool kGrid>
int launch_route(const Args<F>& p, int blocks, int smem, cudaStream_t st) {
  const int threads = p.tpc * p.cpb;
  if (smem == 0) {
    ti_kernel<F, false, kGrid><<<blocks, threads, 0, st>>>(p);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        ti_kernel<F, true, kGrid>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ti_kernel<F, true, kGrid><<<blocks, threads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grid route where p.grid.vtab is set, else the rows route.
template <typename F>
int launch(const Args<F>& p, int blocks, int smem, void* stream) {
  const long long row = 4LL * (p.cells + p.groups + p.W);
  const bool grid = p.grid.vtab != nullptr;
  if (p.C < 1 || p.S < 0 || p.W < 1 || p.cells < 1 || p.groups < 1 ||
      p.mq < 1 || p.tpc < 1 || p.cpb < 1 || p.tpc * p.cpb > kThreads ||
      blocks < 1 || static_cast<long long>(blocks) * p.cpb < p.C ||
      (smem != 0 && smem < row * p.cpb) ||
      (smem == 0 && p.stage == nullptr) ||
      (grid ? (p.grid.g_max < 4 || p.grid.n_max < p.mq - 1 ||
               p.grid.m_max < p.mq)
            : p.vrows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return grid ? launch_route<F, true>(p, blocks, smem, st)
              : launch_route<F, false>(p, blocks, smem, st);
}

// AGridTable.V(n[k], m[k]; a[c]) into out[c, k] for C chains and K
// queries, each in the grid's bounds: the grid route's interpolation
// alone, so that a card test can hold it to V bitwise.
template <typename F>
__global__ void grid_v_kernel(const Grid<F> q, const F* a,
                              const long long* n, const long long* m, int C,
                              int K, F* out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(C) * K) return;
  const int c = static_cast<int>(i / K);
  const int k = static_cast<int>(i - static_cast<long long>(c) * K);
  out[i] = grid_v(q, locate(q, a[c]), n[k], static_cast<int>(m[k]));
}

template <typename F>
int grid_values(const F* vtab, const F* a, const long long* n,
                const long long* m, F* out, double a0, double inv_da,
                int g_max, int n_max, int m_max, int C, int K,
                void* stream) {
  if (C < 1 || K < 1 || g_max < 4 || n_max < 1 || m_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid<F> q{vtab, a0, inv_da, g_max, n_max, m_max};
  const long long total = static_cast<long long>(C) * K;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  grid_v_kernel<F><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, a, n, m, C, K,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int sweep(const int* t_in, const int* T_in, int* t_out, int* T_out,
          int* stage, const F* a, const F* b, const F* vrows,
          const F* vtab, const F* u, const F* nf, const F* H,
          const long long* flat, const long long* grp, const long long* cnt,
          const long long* vbase, const unsigned char* live,
          long long vstride, double a0, double inv_da, int g_max, int n_max,
          int m_max, int C, int S, int W, int cells, int groups, int mq,
          int legacy, int tpc, int cpb, int blocks, int smem, void* stream) {
  const Args<F> p{t_in, T_in, t_out, T_out, stage, a, b, vrows,
                  Grid<F>{vtab, a0, inv_da, g_max, n_max, m_max}, u, nf, H,
                  flat, grp, cnt, vbase, live, vstride, C, S, W, cells,
                  groups, mq, legacy, tpc, cpb};
  return launch<F>(p, blocks, smem, stream);
}

}  // namespace

#define STB_TI_SWEEP(SUFFIX, F)                                               \
  extern "C" int stb_ti_sweep_##SUFFIX(                                       \
      const int* t_in, const int* T_in, int* t_out, int* T_out, int* stage,   \
      const F* a, const F* b, const F* vrows, const F* vtab, const F* u,      \
      const F* nf, const F* H, const long long* flat, const long long* grp,   \
      const long long* cnt, const long long* vbase,                           \
      const unsigned char* live, long long vstride, double a0,                \
      double inv_da, int g_max, int n_max, int m_max, int C, int S, int W,    \
      int cells, int groups, int mq, int legacy, int tpc, int cpb,            \
      int blocks, int smem, void* stream) {                                   \
    return sweep<F>(t_in, T_in, t_out, T_out, stage, a, b, vrows, vtab, u,    \
                    nf, H, flat, grp, cnt, vbase, live, vstride, a0, inv_da,  \
                    g_max, n_max, m_max, C, S, W, cells, groups, mq, legacy,  \
                    tpc, cpb, blocks, smem, stream);                          \
  }                                                                           \
  extern "C" int stb_ti_grid_v_##SUFFIX(                                      \
      const F* vtab, const F* a, const long long* n, const long long* m,      \
      F* out, double a0, double inv_da, int g_max, int n_max, int m_max,      \
      int C, int K, void* stream) {                                           \
    return grid_values<F>(vtab, a, n, m, out, a0, inv_da, g_max, n_max,       \
                          m_max, C, K, stream);                               \
  }

STB_TI_SWEEP(f32, float)
STB_TI_SWEEP(f64, double)
