// Probes of the card's floors for kernels K1-K3, for Hopper (sm_90a): the
// port of tools/vpu_probe.py, whose Pallas probes measured the same
// things on the TPU.  None of them computes a function of the system; each
// measures what bounds one (ops/vpu_probe_cuda.py binds them; the tool
// tools/vpu_probe_torch.py and chip_smoke.py's phase 19 run them).
//
// P1 write floor (replaces tools/vpu_probe.py:write_floor).  Writes only
//    constants, f32, (m, n) column-major like K3's tables: V[j, :] = 1 + j%7,
//    Srel[j, :] = 2 + j%7.  Bound by the device memory's write rate.
//    * full: 16-byte stores over both arrays, coalesced: the card's write
//      floor for 2 x 4 m n bytes;
//    * piecewise: K3's store pattern (fill_table_cols.cu, step 2): the rows
//      cut into cols_plan's chunks, one block of 16 row warps a chunk with
//      K3's shared memory (so K3's residency), walking the columns j = 0..m-1
//      and storing one f32 a lane a column to each output.  As the TPU probe
//      the values change every ``piece`` rows: piece p of a column holds
//      acc_p, acc_0 = 1 + j%7, acc_{p+1} = acc_p 0.9999 + 1e-5 (one f32
//      FMA, as XLA evaluates the TPU probe's body on the CPU), Srel acc_p +
//      1;
//    * onecol: the same pattern for V alone (K3 without Srel), constant
//      1 + j%7.
// P2 issue rate (replaces tools/vpu_probe.py:alu_kernel).  Each thread runs
//    u independent register streams of one op for ``reps`` x 8 steps and
//    writes their sum; x_i(0) = (x0 + i dx) c, c = 1 + (t%3) eps from the
//    arguments, so no chain folds.  The orbits are the TPU probe's, each
//    contractive or of period 2, so values stay in range: fma x -> 0.5 x +
//    0.75, mul x -> 1.0000001 x, log x -> log x + 1.54, recip x -> 1/x
//    (rcp.approx.ftz.f32, the TPU's approximate reciprocal, times ``one``,
//    a 1 from the arguments: ptxas cancels rcp(rcp(x)) pairs, and the
//    product, on the FMA pipe, costs the MUFU-bound step nothing), div x ->
//    (x+1)/x,
//    roll (one-lane rotation, __shfl_sync); in f64 the ops K1-K3 issue:
//    fma, mul, row_walk.cuh's div_pos and log_pos, CUDA's IEEE '/' and log
//    beside them, and shfl (__shfl_up_sync of a double, the scans' step).
//    Bound by the op's issue rate: one wave of the most 256-thread blocks
//    each SM holds (the wrapper asks the occupancy API), so every scheduler
//    has as many warps as the registers allow to hide the op's latency, and
//    no tail wave.
// P3 shared-memory access (replaces tools/vpu_probe.py:vmem_kernel).  K3's
//    row state, f64: one 512-thread block an SM, a chunk of rows, each thread
//    owning k = chunk / 512 consecutive rows, a pad every 16 rows
//    (fill_table_cols.cu: vslot).  Per step each thread runs acc = 0.999 acc
//    + state[row] over its rows (load) or acc = 0.999 acc + 1, state[row] =
//    acc (store), one row (load1 / store1) or two, 16 bytes (load8 / store8),
//    an access; the pad is one row for scalar accesses (K3's) and two for
//    vector ones (which keeps them aligned).  Bound by the shared memory's
//    wavefronts (a warp's scalar f64 access moves 256 bytes, two of its 128
//    bytes a cycle): without the pad a warp's 32 rows k apart fall in one
//    bank.
// P4 overlap (replaces tools/vpu_probe.py:overlap_probe).  K3's residency
//    (one 17-warp block an SM over cols_plan's chunks) and its column loop:
//    per column every row thread runs 4 dependent f64 FMA chains of
//    ``iters`` steps (x -> 0.5 x + 0.75 from (x0 + i dx) c_j, c_j = 1 +
//    (j%3) eps), sums them, and stores its share of the two output columns
//    (V = acc, Srel = acc + 1 in f32), then the block meets at a barrier, as
//    K3's does twice a column.  Variants: the chains alone (the sums go to a
//    per-thread sink), the stores alone (no chain), both.  Bound by the
//    larger of the two, if the card overlaps them.
//
// Every probe launches on the caller's stream and returns its
// cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <math.h>

#include "row_walk.cuh"

namespace {

using row_walk::div_pos;
using row_walk::log_pos;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 16;               // K3's row warps
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kCarryThreads = kRowThreads + 32;   // and K3's carry warp

// rounded arithmetic that the compiler does not contract into an FMA, so
// the plain versions' separate multiply and add give the same bits
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// 1 + (t % 3) eps in T, as the TPU probes' c = 1 + (j % 3) 1e-6
template <typename T>
__device__ __forceinline__ T scale_of(int t, double eps) {
  return add_rn(T(1), mul_rn(static_cast<T>(t % 3), static_cast<T>(eps)));
}

// stream i's start: (x0 + i dx) rounded to T, times c
template <typename T>
__device__ __forceinline__ T start_of(int i, double x0, double dx, T c) {
  return mul_rn(static_cast<T>(__dadd_rn(x0, __dmul_rn(dx, double(i)))), c);
}

cudaError_t allow_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// -- P1: the write floor ------------------------------------------------------

constexpr int kFullThreads = 256;
constexpr int kFullVecs = 4;                // float4 stores a thread a column

__global__ void __launch_bounds__(kFullThreads)
write_full(float* __restrict__ v, float* __restrict__ s, long long n4,
           int m) {
  for (int j = blockIdx.y; j < m; j += gridDim.y) {
    const float c = static_cast<float>(j % 7);
    const float4 a = make_float4(1.0f + c, 1.0f + c, 1.0f + c, 1.0f + c);
    const float4 b = make_float4(2.0f + c, 2.0f + c, 2.0f + c, 2.0f + c);
    float4* vj = reinterpret_cast<float4*>(v) + static_cast<size_t>(j) * n4;
    float4* sj = reinterpret_cast<float4*>(s) + static_cast<size_t>(j) * n4;
#pragma unroll
    for (int q = 0; q < kFullVecs; ++q) {
      const long long i = static_cast<long long>(blockIdx.x) *
                              (kFullThreads * kFullVecs) +
                          q * kFullThreads + threadIdx.x;
      if (i < n4) {
        vj[i] = a;
        sj[i] = b;
      }
    }
  }
}

// dynamic shared memory: K3's chunk state (unused but for its size, which
// gives K3's one block an SM), of which the first 7 x pieces floats hold
// the piece values of the 7 column residues
template <bool kSrel>
__global__ void __launch_bounds__(kRowThreads, 1)
write_rows(float* __restrict__ v, float* __restrict__ s, int n, int m,
           int chunk, int chunks, int piece, int pieces) {
  extern __shared__ float tab[];
  if (threadIdx.x < 7) {
    float acc = 1.0f + static_cast<float>(threadIdx.x);
    for (int p = 0; p < pieces; ++p) {
      tab[threadIdx.x * pieces + p] = acc;
      acc = fmaf(acc, 0.9999f, 1e-5f);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = chunk / kRowWarps;          // rows a warp
  const int k = seg / 32;                     // rows a lane, 32 apart
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int r0 = c * chunk + warp * seg + lane;
    const int p0 = r0 / piece;
    for (int j = 0; j < m; ++j) {
      const float* tj = tab + (j % 7) * pieces;
      float* vj = v + static_cast<size_t>(j) * n;
      float* sj = kSrel ? s + static_cast<size_t>(j) * n : nullptr;
      int p = p0;
      int next = (p0 + 1) * piece;            // the next piece's first row
      float val = tj[p];
      for (int i = 0, r = r0; i < k && r < n; ++i, r += 32) {
        if (r >= next) {                      // piece >= 32: one step at most
          ++p;
          next += piece;
          val = tj[p];
        }
        vj[r] = val;
        if (kSrel) sj[r] = __fadd_rn(val, 1.0f);
      }
    }
  }
}

// -- P2: issue rates ----------------------------------------------------------

constexpr int kAluThreads = 256;
constexpr int kAluUnroll = 8;               // steps a loop trip

enum AluOp : int {
  kFma = 0, kMul, kLog, kRecip, kDiv, kRoll, kDivPos, kLogPos, kShfl
};

template <int kOp>
__device__ __forceinline__ float step(float x, float one) {
  if constexpr (kOp == kFma) {
    return fmaf(x, 0.5f, 0.75f);              // = x 0.5 + 0.75: x 0.5 exact
  } else if constexpr (kOp == kMul) {
    return x * 1.0000001f;
  } else if constexpr (kOp == kLog) {
    return logf(x) + 1.54f;
  } else if constexpr (kOp == kRecip) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r * one;
  } else if constexpr (kOp == kDiv) {
    return (x + 1.0f) / x;
  } else {
    static_assert(kOp == kRoll, "f32 op");
    return __shfl_sync(kFull, x, (threadIdx.x + 1) & 31);
  }
}

template <int kOp>
__device__ __forceinline__ double step(double x, double) {
  if constexpr (kOp == kFma) {
    return fma(x, 0.5, 0.75);
  } else if constexpr (kOp == kMul) {
    return x * 1.0000001;
  } else if constexpr (kOp == kDivPos) {
    return div_pos(x + 1.0, x);
  } else if constexpr (kOp == kLogPos) {
    return log_pos(x) + 1.54;
  } else if constexpr (kOp == kDiv) {
    return (x + 1.0) / x;
  } else if constexpr (kOp == kLog) {
    return log(x) + 1.54;
  } else {
    static_assert(kOp == kShfl, "f64 op");
    return __shfl_up_sync(kFull, x, 1);
  }
}

template <typename T, int kOp, int kU>
__global__ void __launch_bounds__(kAluThreads)
alu_kernel(T* __restrict__ out, double x0, double dx, double eps,
           double one, int reps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const T c = scale_of<T>(t, eps);
  const T one_t = static_cast<T>(one);
  T x[kU];
#pragma unroll
  for (int i = 0; i < kU; ++i) x[i] = start_of<T>(i, x0, dx, c);
  for (int q = 0; q < reps; ++q) {
#pragma unroll
    for (int s = 0; s < kAluUnroll; ++s) {
#pragma unroll
      for (int i = 0; i < kU; ++i) x[i] = step<kOp>(x[i], one_t);
    }
  }
  T acc = x[0];
#pragma unroll
  for (int i = 1; i < kU; ++i) acc = add_rn(acc, x[i]);
  out[t] = acc;
}

// u = 8 for every op, as the TPU probe; the FMA also at 4 and 16 streams
template <typename T, int kOp>
const void* alu_by_u(int u) {
  if (u == 8) return reinterpret_cast<const void*>(&alu_kernel<T, kOp, 8>);
  if constexpr (kOp == kFma) {
    if (u == 4) return reinterpret_cast<const void*>(&alu_kernel<T, kOp, 4>);
    if (u == 16)
      return reinterpret_cast<const void*>(&alu_kernel<T, kOp, 16>);
  }
  return nullptr;
}

const void* alu_fn(int f64, int op, int u) {
  if (!f64) {
    switch (op) {
      case kFma: return alu_by_u<float, kFma>(u);
      case kMul: return alu_by_u<float, kMul>(u);
      case kLog: return alu_by_u<float, kLog>(u);
      case kRecip: return alu_by_u<float, kRecip>(u);
      case kDiv: return alu_by_u<float, kDiv>(u);
      case kRoll: return alu_by_u<float, kRoll>(u);
      default: return nullptr;
    }
  }
  switch (op) {
    case kFma: return alu_by_u<double, kFma>(u);
    case kMul: return alu_by_u<double, kMul>(u);
    case kDivPos: return alu_by_u<double, kDivPos>(u);
    case kLogPos: return alu_by_u<double, kLogPos>(u);
    case kDiv: return alu_by_u<double, kDiv>(u);
    case kLog: return alu_by_u<double, kLog>(u);
    case kShfl: return alu_by_u<double, kShfl>(u);
    default: return nullptr;
  }
}

// -- P3: shared-memory accesses at K3's row-state layout ----------------------

enum SmemMode : int { kLoad1 = 0, kLoad8, kStore1, kStore8 };

// K3's row state is f64: a 16-byte access moves two rows
template <int kMode, bool kPad>
__global__ void __launch_bounds__(kRowThreads, 1)
smem_kernel(double* __restrict__ out, double eps, int chunk, int steps) {
  extern __shared__ __align__(16) double st[];
  constexpr bool kVec = kMode == kLoad8 || kMode == kStore8;
  constexpr int kW = kVec ? 2 : 1;            // rows an access
  constexpr int kPadN = kPad ? kW : 0;        // rows of pad a 16 rows
  auto slot = [](int i) { return i + (i >> 4) * kPadN; };
  const int k = chunk / kRowThreads;          // rows a thread
  const int t0 = threadIdx.x * k;             // K3's w0 + lane k
  const int len = slot(chunk);
  for (int i = threadIdx.x; i < len; i += kRowThreads) st[i] = 0.0;
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = scale_of<double>(t, eps);
  constexpr double kDecay = 0.999;
  for (int s = 0; s < steps; ++s) {
    if constexpr (kMode == kLoad1) {
      for (int i = 0; i < k; ++i)
        acc = add_rn(mul_rn(acc, kDecay), st[slot(t0 + i)]);
    } else if constexpr (kMode == kLoad8) {
      for (int i = 0; i < k; i += 2) {
        const double2 blk =
            *reinterpret_cast<const double2*>(st + slot(t0 + i));
        acc = add_rn(mul_rn(acc, kDecay), blk.x);
        acc = add_rn(mul_rn(acc, kDecay), blk.y);
      }
    } else if constexpr (kMode == kStore1) {
      for (int i = 0; i < k; ++i) {
        acc = add_rn(mul_rn(acc, kDecay), 1.0);
        st[slot(t0 + i)] = acc;
      }
    } else {
      for (int i = 0; i < k; i += 2) {
        double2 blk;
        blk.x = acc = add_rn(mul_rn(acc, kDecay), 1.0);
        blk.y = acc = add_rn(mul_rn(acc, kDecay), 1.0);
        *reinterpret_cast<double2*>(st + slot(t0 + i)) = blk;
      }
    }
    // a step's accesses are neither hoisted out of the step loop nor, for
    // the stores, dropped as overwritten by the next step's
    asm volatile("" ::: "memory");
  }
  out[t] = acc;
}

template <int kMode>
const void* smem_by_pad(int pad) {
  return pad ? reinterpret_cast<const void*>(&smem_kernel<kMode, true>)
             : reinterpret_cast<const void*>(&smem_kernel<kMode, false>);
}

const void* smem_fn(int mode, int pad) {
  switch (mode) {
    case kLoad1: return smem_by_pad<kLoad1>(pad);
    case kLoad8: return smem_by_pad<kLoad8>(pad);
    case kStore1: return smem_by_pad<kStore1>(pad);
    case kStore8: return smem_by_pad<kStore8>(pad);
    default: return nullptr;
  }
}

// -- P4: overlap of K3's column chain with its stores -------------------------

template <bool kAlu, bool kStore>
__global__ void __launch_bounds__(kCarryThreads, 1)
overlap_kernel(float* __restrict__ v, float* __restrict__ s,
               double* __restrict__ sink, int n, int m, int chunk,
               int chunks, int iters, double x0, double dx, double eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;          // kRowWarps: the carry warp
  const int seg = chunk / kRowWarps;
  const int k = seg / 32;
  double total = 0.0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int r0 = c * chunk + warp * seg + lane;
    for (int j = 0; j < m; ++j) {
      if (warp < kRowWarps) {
        const double cj = scale_of<double>(j, eps);
        double x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = start_of<double>(i, x0, dx, cj);
        if (kAlu) {
          for (int it = 0; it < iters; it += 8) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
#pragma unroll
              for (int i = 0; i < 4; ++i) x[i] = fma(x[i], 0.5, 0.75);
            }
          }
        }
        const double acc = add_rn(add_rn(add_rn(x[0], x[1]), x[2]), x[3]);
        if (kStore) {
          const float fv = static_cast<float>(acc);
          const float fs = static_cast<float>(add_rn(acc, 1.0));
          float* vj = v + static_cast<size_t>(j) * n;
          float* sj = s + static_cast<size_t>(j) * n;
          for (int i = 0, r = r0; i < k && r < n; ++i, r += 32) {
            vj[r] = fv;
            sj[r] = fs;
          }
        } else {
          total = add_rn(total, acc);
        }
      }
      __syncthreads();
    }
  }
  if (!kStore && warp < kRowWarps)
    sink[blockIdx.x * kRowThreads + threadIdx.x] = total;
}

}  // namespace

extern "C" int stb_vpu_write_full(float* v, float* s, int n, int m,
                                  void* stream) {
  if (n < 4 || n % 4 != 0 || m < 1 || v == nullptr || s == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const int per_block = kFullThreads * kFullVecs;
  const dim3 grid(static_cast<unsigned>((n4 + per_block - 1) / per_block),
                  static_cast<unsigned>(m < 65535 ? m : 65535));
  write_full<<<grid, kFullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, s, n4, m);
  return static_cast<int>(cudaGetLastError());
}

// s == nullptr: V alone (onecol)
extern "C" int stb_vpu_write_rows(float* v, float* s, int n, int m,
                                  int chunk, int chunks, int blocks,
                                  int smem, int piece, void* stream) {
  const long long pieces = (static_cast<long long>(n) + piece - 1) /
                           (piece > 0 ? piece : 1);
  if (n < 1 || m < 1 || v == nullptr || chunk < kRowThreads ||
      chunk % kRowThreads != 0 || chunks < 1 ||
      static_cast<long long>(chunks) * chunk < n || blocks < 1 ||
      blocks > chunks || piece < 32 ||
      smem < 7 * 4 * pieces || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = s ? reinterpret_cast<const void*>(&write_rows<true>)
                     : reinterpret_cast<const void*>(&write_rows<false>);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(pieces);
  if (s)
    write_rows<true><<<blocks, kRowThreads, smem, st>>>(v, s, n, m, chunk,
                                                        chunks, piece, np);
  else
    write_rows<false><<<blocks, kRowThreads, smem, st>>>(v, s, n, m, chunk,
                                                         chunks, piece, np);
  return static_cast<int>(cudaGetLastError());
}

// blocks of kAluThreads a SM that the op's kernel can keep resident
extern "C" int stb_vpu_alu_occupancy(int f64, int op, int u,
                                     int* blocks_per_sm) {
  const void* fn = alu_fn(f64, op, u);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kAluThreads, 0));
}

extern "C" int stb_vpu_alu(int f64, int op, int u, void* out, double x0,
                           double dx, double eps, double one, int reps,
                           int blocks, void* stream) {
  const void* fn = alu_fn(f64, op, u);
  if (fn == nullptr || out == nullptr || reps < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&out, &x0, &dx, &eps, &one, &reps};
  const cudaError_t err =
      cudaLaunchKernel(fn, dim3(blocks), dim3(kAluThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stb_vpu_smem(int mode, int pad, double* out, double eps,
                            int chunk, int steps, int blocks, void* stream) {
  const void* fn = smem_fn(mode, pad);
  const int w = mode == kLoad8 || mode == kStore8 ? 2 : 1;
  const int k = chunk / kRowThreads;
  if (fn == nullptr || out == nullptr || chunk < kRowThreads ||
      chunk % kRowThreads != 0 || k % w != 0 || steps < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes =
      static_cast<long long>(chunk + chunk / 16 * (pad ? w : 0)) * 8;
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(bytes);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&out, &eps, &chunk, &steps};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(kRowThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// alu, store: which variant; v and s with store, sink (blocks x 512 f64)
// without
extern "C" int stb_vpu_overlap(int alu, int store, float* v, float* s,
                               double* sink, int n, int m, int chunk,
                               int chunks, int blocks, int smem, int iters,
                               double x0, double dx, double eps,
                               void* stream) {
  if ((!alu && !store) || n < 1 || m < 1 || chunk < kRowThreads ||
      chunk % kRowThreads != 0 || chunks < 1 ||
      static_cast<long long>(chunks) * chunk < n || blocks < 1 ||
      blocks > chunks || iters < 0 || iters % 8 != 0 || smem < 0 ||
      smem > 232448 || (store && (v == nullptr || s == nullptr)) ||
      (!store && sink == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      !store ? reinterpret_cast<const void*>(&overlap_kernel<true, false>)
      : alu  ? reinterpret_cast<const void*>(&overlap_kernel<true, true>)
             : reinterpret_cast<const void*>(&overlap_kernel<false, true>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&v, &s, &sink, &n, &m, &chunk, &chunks, &iters,
                  &x0, &dx, &eps};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(kCarryThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
