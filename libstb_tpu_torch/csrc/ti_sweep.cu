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
// (dec) with the first uniform, gathers V(n, t+1) from the V rows that
// ti.prepare built, and the addition (inc) with the second uniform; its
// delta inc - dec then goes to the cell and to the total.  The arithmetic
// is the plain loop's, operation for operation and in its order, through
// the round-to-nearest intrinsics, so that nvcc contracts nothing into an
// FMA and t and T come out bitwise equal to the plain loop's for the same
// uniforms (tests/test_torch_ti_kernel.py).
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
// one gathered sector of V a lane-step (6.6e6 x 32 bytes): ~0.1 ms at 3.35
// TB/s.  Against that stand S dependent steps, each at least one gather
// from device memory (the V index depends on the state) and two barriers:
// ~1 us a step, so ~0.1 ms at S = 100.  All chains are resident at once
// (16384 x 4 lanes fill the card in one wave), so the sweep costs about S
// step latencies.  The design keeps the state on chip, reads each step's
// uniforms coalesced (lanes run along the contiguous (c, w) of a row), and
// has each step ask L2 for the next step's uniforms before it needs them,
// so that a step waits for one load from device memory, the V gather.
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
};

template <typename F>
struct Args {
  const int* t_in;            // (C, cells) counts t
  const int* T_in;            // (C, groups) totals T
  int* t_out;
  int* T_out;
  int* stage;                 // (C, W) scratch, the state off chip only
  const F* a;                 // (C,)
  const F* b;                 // (C,)
  const F* vrows;             // row c at c * vstride, P * mq wide
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

template <typename F, bool kOnChip>
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
  const F* vrow = p.vrows + static_cast<long long>(c) * p.vstride;
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
        // V(n, t+1): m > n reads the block's last column, which is 0 like V
        const F v = vrow[p.vbase[sw] + min(ti2, p.mq - 1)];
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
template <typename F>
int launch(const Args<F>& p, int blocks, int smem, void* stream) {
  const long long row = 4LL * (p.cells + p.groups + p.W);
  if (p.C < 1 || p.S < 0 || p.W < 1 || p.cells < 1 || p.groups < 1 ||
      p.mq < 1 || p.tpc < 1 || p.cpb < 1 || p.tpc * p.cpb > kThreads ||
      blocks < 1 || static_cast<long long>(blocks) * p.cpb < p.C ||
      (smem != 0 && smem < row * p.cpb) ||
      (smem == 0 && p.stage == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = p.tpc * p.cpb;
  if (smem == 0) {
    ti_kernel<F, false><<<blocks, threads, 0, st>>>(p);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        ti_kernel<F, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ti_kernel<F, true><<<blocks, threads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int sweep(const int* t_in, const int* T_in, int* t_out, int* T_out,
          int* stage, const F* a, const F* b, const F* vrows, const F* u,
          const F* nf, const F* H, const long long* flat,
          const long long* grp, const long long* cnt,
          const long long* vbase, const unsigned char* live,
          long long vstride, int C, int S, int W, int cells, int groups,
          int mq, int legacy, int tpc, int cpb, int blocks, int smem,
          void* stream) {
  const Args<F> p{t_in, T_in, t_out, T_out, stage, a, b, vrows, u, nf, H,
                  flat, grp, cnt, vbase, live, vstride, C, S, W, cells,
                  groups, mq, legacy, tpc, cpb};
  return launch<F>(p, blocks, smem, stream);
}

}  // namespace

extern "C" int stb_ti_sweep_f32(
    const int* t_in, const int* T_in, int* t_out, int* T_out, int* stage,
    const float* a, const float* b, const float* vrows, const float* u,
    const float* nf, const float* H, const long long* flat,
    const long long* grp, const long long* cnt, const long long* vbase,
    const unsigned char* live, long long vstride, int C, int S, int W,
    int cells, int groups, int mq, int legacy, int tpc, int cpb, int blocks,
    int smem, void* stream) {
  return sweep<float>(t_in, T_in, t_out, T_out, stage, a, b, vrows, u, nf, H,
                      flat, grp, cnt, vbase, live, vstride, C, S, W, cells,
                      groups, mq, legacy, tpc, cpb, blocks, smem, stream);
}

extern "C" int stb_ti_sweep_f64(
    const int* t_in, const int* T_in, int* t_out, int* T_out, int* stage,
    const double* a, const double* b, const double* vrows, const double* u,
    const double* nf, const double* H, const long long* flat,
    const long long* grp, const long long* cnt, const long long* vbase,
    const unsigned char* live, long long vstride, int C, int S, int W,
    int cells, int groups, int mq, int legacy, int tpc, int cpb, int blocks,
    int smem, void* stream) {
  return sweep<double>(t_in, T_in, t_out, T_out, stage, a, b, vrows, u, nf,
                       H, flat, grp, cnt, vbase, live, vstride, C, S, W,
                       cells, groups, mq, legacy, tpc, cpb, blocks, smem,
                       stream);
}
