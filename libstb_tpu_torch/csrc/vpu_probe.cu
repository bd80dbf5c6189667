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
// P5 mix (replaces tools/vpu_probe.py:mix_floor).  K3's memory mix with
//    next to no arithmetic, in K3's residency: cols_plan's chunks, one block
//    of 16 row warps a chunk for all m columns, thread l of warp w owning
//    k = chunk / 512 consecutive rows, their state f64 in dynamic shared
//    memory at K3's vslot.  Per column each thread moves its rows' state
//    on, out = state 0.999 + acc_p (acc_p: P1 piecewise's piece values, f32;
//    the rounded multiply and add of the plain version, no FMA), and the
//    warp stores the column, V = out and Srel = out + 1 in f32, one row a
//    lane (rows 32 apart, read back from the state: K3's transpose), as K3's
//    store pass does.  ``staged``: the column goes to a staging area in
//    shared memory instead and, after a barrier, one thread copies it whole
//    to each table with one bulk copy (cp.async.bulk, the Tensor Memory
//    Accelerator's linear copy): the counterpart of the TPU's whole-block
//    copy.  The area has two buffers, the column's parity picking one, and
//    one barrier a column: thread 0 waits for the reads of the column
//    before's copies just before it, so the copies overlap the next
//    column's work.  Bound by the bytes written, as K3's store pattern (P1
//    piecewise) is.
// P6 bisect (replaces tools/vpu_probe.py:bisect_probe).  P5's mix with one
//    template flag a step of a ladder from the mix to K3
//    (ops/vpu_probe_cuda.py: BISECT_STEPS), each rung adding one step:
//    first the TPU probe's own flags on the card, smem (the discount a
//    scalar read from device memory, added to the column's acc_0 as the
//    TPU's 0.5), xscratch (K3's Srel Kahan pair, two more f64 a row in
//    shared memory: K3's 24.5 bytes a row, moved on by V each column and
//    its sum written to a sink), initbranch (a first pass over each chunk
//    that sets the state to 1 / (rvec - 0.5), rvec the TPU's transposed
//    row index, and stores V = inf, Srel = 0 over column 0 before the loop
//    overwrites it), vcarry (the pieces' acc decaying x 0.9999 with no
//    + 1e-5, and two carried sums w1, w2 of each thread's first and last
//    row, written to a sink); the TPU flag ``cost`` (XLA's CostEstimate, a
//    scheduling hint) has no counterpart in a hand-written launch.  Then
//    K3's own structure (fill_table_cols.cu): barriers (its two named
//    barriers a column, with the 17th, carry warp present), scan (each
//    row's map (A, B) = (0.5, (1 - A) out), composed over a thread's rows,
//    one 5-step shuffle scan over the warp, and the rows replayed from the
//    value entering them: V_r = A V_{r-1} + B, a running average of the mix
//    down the warp's segment), div_pos (A = div_pos(1, 2 + |state|),
//    row_walk.cuh's divide, as row_map), log_pos (Srel the Kahan sum of
//    log_pos|V| along the columns, as K3's store_row), handoff (chunks
//    claimed by an atomic ticket; the carry warp polls a NaN-filled halo
//    for the V that enters the chunk, scans the 16 warps' maps, publishes
//    the chunk's last V and hands each warp the maps before it: the
//    average runs down the whole column, chunk c one hop behind chunk
//    c-1).  Every multiply and add is rounded as the plain version's.
//    Bound, as K3: by the bytes written for the first rungs; with the
//    scan, at many rows a thread by the f64 work a row issues (the
//    composition, the replay, the divide, the log), at one row a thread
//    by the latency of each column's chain (scan, barriers, log, hand-off),
//    which is what the rungs' increments measure.  A branch from the top
//    rung (ops/vpu_probe_cuda.py: branch()) has the top rung with each
//    lever of LEVERS alone and with both, each lever moving work between
//    warps with the top rung's arithmetic, so its values: storewarps (8 more warps take the
//    store pass, log_pos, the Kahan pair and the two f32 stores of column
//    j-1, from a double-buffered column of V in shared memory that the row
//    warps fill where the store pass was, between the two barriers, handed
//    over by full / empty named barriers, while the row warps go on with
//    column j), early (one more warp polls, without the carry warp's
//    __nanosleep, for the V entering the chunk from the end of the column
//    before on, and hands it to the carry warp at a named barrier after
//    the carry warp's scan, so a hop from chunk to chunk is the poll, that
//    barrier, one multiply-add and the store).
//
// Every probe launches on the caller's stream and returns its
// cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <math.h>

#include "row_walk.cuh"

namespace {

using row_walk::div_pos;
using row_walk::load_relaxed;
using row_walk::log_pos;
using row_walk::store_relaxed;

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

// -- P5 / P6: K3's column mix, and the ladder from it to K3 -------------------

// the steps of P6's ladder as template bits, in the ladder's order; then
// the levers of the branch from its top rung
enum LadderStep : int {
  kStSmem = 1, kStXscratch = 2, kStInit = 4, kStVcarry = 8, kStBars = 16,
  kStScan = 32, kStDivPos = 64, kStLogPos = 128, kStHandoff = 256,
  kStStoreWarps = 512, kStEarly = 1024
};
constexpr int kStTop = 511;                 // the ladder's top: all nine steps
constexpr int kBarMaps = 1, kBarCarry = 2;  // K3's named barriers
// storewarps' hand-over of a column: a full and an empty barrier a buffer
// (ids base + buffer), the row warps arriving at full and waiting at
// empty, the store warps the other way round; early's poll warp hands the
// carry warp the V entering the chunk at kBarPoll
constexpr int kBarFull = 3, kBarEmpty = 5, kBarPoll = 7;
constexpr int kStoreWarps = 8;            // vpu_probe_cuda.STORE_WARPS
constexpr int kStoreThreads = kStoreWarps * 32;
constexpr int kHandThreads = kRowThreads + kStoreThreads;
constexpr double kTiny = 1e-300;            // log_pos's floor for |V|

// a P5 / P6 block's threads from barriers on (below them the row warps
// alone; vpu_probe_cuda.mix_threads): the row warps, the carry warp,
// storewarps' store warps, early's poll warp
constexpr int mix_block(int steps) {
  return kCarryThreads + ((steps & kStStoreWarps) ? kStoreThreads : 0) +
         ((steps & kStEarly) ? 32 : 0);
}

// named barrier ``id`` over ``count`` threads (K3's: the row warps and
// the carry warp), waiting or arriving only
__device__ __forceinline__ void bar(int id, int count = kCarryThreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

struct Map {                                // x -> A x + B
  double A, B;
};

// ``first`` applied first, then ``then``
__device__ __forceinline__ Map after(Map first, Map then) {
  return {mul_rn(then.A, first.A), add_rn(mul_rn(then.A, first.B), then.B)};
}

// inclusive scan over the first kLanes lanes (K3's warp_scan)
template <int kLanes = 32>
__device__ __forceinline__ Map scan_maps(Map x, int lane) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const double pa = __shfl_up_sync(kFull, x.A, off);
    const double pb = __shfl_up_sync(kFull, x.B, off);
    if (lane >= off) x = after({pa, pb}, x);
  }
  return x;
}

// where row i of the chunk keeps its state: one pad double every 16 rows
__device__ __forceinline__ int vslot(int i) { return i + (i >> 4); }

// a bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from shared to device memory, and its group's commit and waits
__device__ __forceinline__ void bulk_store(float* gmem, const float* smem,
                                           int bytes) {
  const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(gmem), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {   // sources read
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {        // copies complete
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// the threads' shared-memory writes, made visible to the bulk copy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Dynamic shared memory, per block: the row state at vslot(i) (chunk +
// chunk / 16 f64), with xscratch the Kahan pair (chunk f64 each), the piece
// table (7 x pieces f32, padded to 16 bytes), then with staged the staging
// area's two buffers (each chunk f32 of V, then chunk of Srel), with
// storewarps two columns of V at vslot (f64).  Scratch from the wrapper:
// wsink [chunks][512][2] f64 (vcarry), xsink [n] f64 (xscratch), and for
// the hand-off the halo [chunks-1][m] f64 filled with NaN and the ticket,
// one zeroed int32.
template <int kSteps, bool kStaged>
__global__ void __launch_bounds__(mix_block(kSteps), 1)
mix_kernel(const float* __restrict__ a_ptr, float* __restrict__ v,
           float* __restrict__ s, double* __restrict__ wsink,
           double* __restrict__ xsink, double* halo, int* ticket, int n,
           int m, int chunk, int chunks, int piece, int pieces, int slab) {
  constexpr bool kA = kSteps & kStSmem;
  constexpr bool kX = kSteps & kStXscratch;
  constexpr bool kI = kSteps & kStInit;
  constexpr bool kV = kSteps & kStVcarry;
  constexpr bool kB = kSteps & kStBars;
  constexpr bool kS = kSteps & kStScan;
  constexpr bool kD = kSteps & kStDivPos;
  constexpr bool kL = kSteps & kStLogPos;
  constexpr bool kH = kSteps & kStHandoff;
  constexpr bool kW = kSteps & kStStoreWarps;
  constexpr bool kE = kSteps & kStEarly;
  static_assert(!kStaged || kSteps == 0, "staged: P5 alone");
  static_assert(!kH || (kB && kS), "the hand-off needs the carry warp and "
                                   "the scan");
  static_assert(kSteps <= kStTop || (kSteps & kStTop) == kStTop,
                "the levers start from the top rung");
  // kBarCarry's threads: with early the poll warp too
  constexpr int kCarryCount = kCarryThreads + (kE ? 32 : 0);
  constexpr int kPollWarp = kRowWarps + 1 + (kW ? kStoreWarps : 0);
  extern __shared__ __align__(16) double dyn[];
  __shared__ double wA[kRowWarps], wB[kRowWarps];   // the warps' maps
  __shared__ double xA[kRowWarps], xB[kRowWarps];   // the maps before each
  __shared__ double cin;                            // V entering the chunk
  __shared__ double pin;                            // early's poll warp's
  __shared__ int next;
  const int lane = threadIdx.x & 31;
  // kRowWarps: the carry warp; above it storewarps' store warps, then
  // early's poll warp (kPollWarp)
  const int warp = threadIdx.x >> 5;
  const int seg = chunk / kRowWarps;          // rows a warp
  const int k = seg / 32;                     // rows a thread
  const int w0 = warp * seg;                  // this warp's first row
  const int t0 = w0 + lane * k;               // this thread's first row
  double* st = dyn;
  double* sacc = dyn + vslot(chunk);
  double* scomp = sacc + chunk;
  float* tab = reinterpret_cast<float*>(sacc + (kX ? 2 * chunk : 0));
  float* stage = tab + ((7 * pieces + 3) & ~3);
  double* vcol = reinterpret_cast<double*>(stage);   // storewarps
  // the block's columns handed on so far (staged, storewarps): the buffer
  // is its parity
  int seq = 0;

  // the piece values of the 7 column residues: acc_0 = 1 + t (+ a),
  // acc_{p+1} = acc_p 0.9999 + 1e-5 (one f32 FMA) or, vcarry, acc_p 0.9999
  if (threadIdx.x < 7) {
    float acc = 1.0f + static_cast<float>(threadIdx.x);
    if (kA) acc = __fadd_rn(acc, *a_ptr);
    for (int p = 0; p < pieces; ++p) {
      tab[threadIdx.x * pieces + p] = acc;
      acc = kV ? __fmul_rn(acc, 0.9999f) : fmaf(acc, 0.9999f, 1e-5f);
    }
  }
  const int hs = (n + slab - 1) / slab;       // the TPU's H, rounded up

  for (int it = 0;; ++it) {
    __syncthreads();                  // the last chunk's state is read
    int c = blockIdx.x + it * gridDim.x;
    if (kH) {                         // chunks in row order, by ticket
      if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
      __syncthreads();
      c = next;
    }
    if (c >= chunks) break;
    const int R0 = c * chunk;

    // the chunk's set-up: the row state (0, or the TPU's init branch,
    // which also writes column 0), the Kahan pair
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int r = R0 + i;
      double x = 0.0;
      if (kI) {
        const long long rv = static_cast<long long>(r % slab) * hs + r / slab;
        x = 1.0 / (static_cast<double>(rv) - 0.5);
        if (r < n) {
          v[r] = INFINITY;
          s[r] = 0.0f;
        }
      }
      st[vslot(i)] = x;
      if (kX) {
        sacc[i] = 0.0;
        scomp[i] = 0.0;
      }
    }
    __syncthreads();

    // the hand-off's halo: the V entering the chunk at column j, polled
    // for (its first value in the chunk before), and the chunk's own
    const double* hin =
        kH ? halo + static_cast<size_t>(c > 0 ? c - 1 : 0) * m : halo;
    double* hout = kH ? halo + static_cast<size_t>(c) * m : halo;
    auto poll = [&](int j) {
      double x;
      for (unsigned polls = 0;; ++polls) {
        x = load_relaxed(hin + j);
        if (!isnan(x)) break;
        if (polls > (1u << 27)) __trap();
        if (!kE) __nanosleep(64);          // K3's poll; early's spins
      }
      return x;
    };

    if (kE && warp == kPollWarp) {
      // early's poll warp: from the end of column j-1 on, the V entering
      // the chunk at column j, handed to the carry warp at kBarPoll
      for (int j = 0; j < m; ++j) {
        if (lane == 0) pin = c > 0 ? poll(j) : 0.0;
        bar_arrive(kBarPoll, 64);
        bar(kBarCarry, kCarryCount);
      }
      continue;
    }

    if (kB && warp == kRowWarps) {
      // the carry warp: with the hand-off, per column, the V entering the
      // chunk (V at the last row of the chunk before), then the chunk's map
      // from the warps', the chunk's last V published, and each warp the
      // maps of the warps before it.  With early the warps' maps are
      // scanned before the V entering the chunk is taken from the poll
      // warp, so that a hop from chunk to chunk holds the poll, a barrier,
      // one multiply-add and the store
      for (int j = 0; j < m; ++j) {
        double carry = 0.0;
        if (kH && !kE && lane == 0 && c > 0) carry = poll(j);
        bar(kBarMaps);
        if (kH) {
          Map p = lane < kRowWarps ? Map{wA[lane], wB[lane]} : Map{1.0, 0.0};
          p = scan_maps<kRowWarps>(p, lane);
          const double ba = __shfl_sync(kFull, p.A, kRowWarps - 1);
          const double bb = __shfl_sync(kFull, p.B, kRowWarps - 1);
          if (kE) {
            bar(kBarPoll, 64);
            carry = pin;
          }
          if (lane == 0) {
            if (c + 1 < chunks)
              store_relaxed(hout + j, add_rn(mul_rn(ba, carry), bb));
            cin = carry;
          }
          if (lane + 1 < kRowWarps) {
            xA[lane + 1] = p.A;
            xB[lane + 1] = p.B;
          }
        }
        bar(kBarCarry, kCarryCount);
      }
      continue;
    }

    // V and Srel of row q of the chunk in column jc, to the tables or the
    // staging buffer ``sb``; with xscratch the Kahan pair moved on by
    // Srel's term
    auto store_row = [&](int jc, int q, double val, float* sb) {
      const int r = R0 + q;
      if (r >= n) return;
      const double term = kL ? log_pos(fmax(fabs(val), kTiny)) : val;
      double sum = term;
      if (kX) {
        const double sa = sacc[q];
        const double y = add_rn(term, -scomp[q]);
        const double t = add_rn(sa, y);
        scomp[q] = add_rn(add_rn(t, -sa), -y);
        sacc[q] = t;
        sum = t;
      }
      const float fv = static_cast<float>(val);
      const float fs = static_cast<float>(kL ? sum : add_rn(val, 1.0));
      if (kStaged) {
        sb[q] = fv;
        sb[chunk + q] = fs;
      } else {
        const size_t o = static_cast<size_t>(jc) * n + r;
        v[o] = fv;
        s[o] = fs;
      }
    };

    if (kW && warp > kRowWarps && warp <= kRowWarps + kStoreWarps) {
      // the store warps: column j's V from the row warps' buffer, one row a
      // lane, its log, Kahan pair and the two f32 stores, while the row
      // warps compute column j + 1
      for (int j = 0; j < m; ++j, ++seq) {
        const double* vb = vcol + (seq & 1) * vslot(chunk);
        bar(kBarFull + (seq & 1), kHandThreads);
#pragma unroll 2
        for (int q = threadIdx.x - kCarryThreads; q < chunk;
             q += kStoreThreads)
          store_row(j, q, vb[vslot(q)], nullptr);
        bar_arrive(kBarEmpty + (seq & 1), kHandThreads);
      }
      if (kX) {
        for (int q = threadIdx.x - kCarryThreads; q < chunk;
             q += kStoreThreads)
          if (R0 + q < n) xsink[R0 + q] = sacc[q];
      }
      continue;
    }

    // the row warps.  A thread's rows lie in at most two pieces: p0, and
    // from its row ``brk`` on p0 + 1
    const int p0 = (R0 + t0) / piece;
    const int brk = (p0 + 1) * piece - (R0 + t0);
    // row i's map in a column whose piece value is ``acc``, from its state
    // (without the scan V = B; rows past n: the identity, V = 0 unscanned)
    auto row = [&](int i, float acc) -> Map {
      const double old = st[vslot(i)];
      const double out = add_rn(mul_rn(old, 0.999), static_cast<double>(acc));
      const bool live = R0 + i < n;
      if (!kS) return {0.0, live ? out : 0.0};
      const double a = kD ? div_pos(1.0, add_rn(2.0, fabs(old))) : 0.5;
      const double b = mul_rn(add_rn(1.0, -a), out);
      return {live ? a : 1.0, live ? b : 0.0};
    };
    // column jc, one row a lane (the lane's row is the thread's for k = 1,
    // whose V is in vreg).  staged: column jc's buffer (its parity) is
    // written while the copies of column jc - 1 may still read the other.
    // Before the barrier thread 0 waits until they are done, so that the
    // buffer the column after this one writes is free once the threads
    // pass the barrier: the copies had column jc's work to read it in
    auto store_column = [&](int jc, double vreg) {
      float* sb = kStaged ? stage + (seq & 1) * 2 * chunk : stage;
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const int q = w0 + 32 * i + lane;
        store_row(jc, q, k == 1 ? vreg : st[vslot(q)], sb);
      }
      if (kStaged) {
        fence_async_shared();
        if (threadIdx.x == 0) bulk_wait_read();
        __syncthreads();
        if (threadIdx.x == 0) {
          const int bytes = 4 * min(chunk, n - R0);
          bulk_store(v + static_cast<size_t>(jc) * n + R0, sb, bytes);
          bulk_store(s + static_cast<size_t>(jc) * n + R0, sb + chunk,
                     bytes);
          bulk_commit();
        }
      }
      if (kStaged) ++seq;
    };
    // storewarps: the thread's rows of column jc (its V, from vreg for k
    // = 1) to the store warps' buffer, once they are done with the column
    // it held two columns before
    auto hand_column = [&](double vreg) {
      double* vb = vcol + (seq & 1) * vslot(chunk);
      if (seq >= 2) bar(kBarEmpty + (seq & 1), kHandThreads);
      for (int i = 0; i < k; ++i)
        vb[vslot(t0 + i)] = k == 1 ? vreg : st[vslot(t0 + i)];
      bar_arrive(kBarFull + (seq++ & 1), kHandThreads);
    };

    double vreg = 0.0, w1 = 0.0, w2 = 0.0;
    for (int j = 0; j < m; ++j) {
      const float* tj = tab + (j % 7) * pieces;
      const float acc0 = tj[p0];
      const float acc1 = brk < k ? tj[p0 + 1] : acc0;
      // 1. with the scan: compose this thread's rows, then the warp's
      Map m0{1.0, 0.0}, incl{1.0, 0.0};
      if (kS) {
        m0 = row(t0, acc0);
        Map agg = m0;
#pragma unroll 4
        for (int i = 1; i < k; ++i)
          agg = after(agg, row(t0 + i, i < brk ? acc0 : acc1));
        incl = scan_maps(agg, lane);
        if (kH && lane == 31) {
          wA[warp] = incl.A;
          wB[warp] = incl.B;
        }
      }
      if (kB) bar(kBarMaps); else __syncwarp();

      // 2. column j-1 to the tables (storewarps: to the store warps, in the
      // shadow of the carry warp's scan as the store pass was)
      if (j > 0) {
        if (kW) hand_column(vreg);
        else store_column(j - 1, vreg);
      }
      double ea = 1.0, eb = 0.0;
      if (kS) {
        ea = __shfl_up_sync(kFull, incl.A, 1);
        eb = __shfl_up_sync(kFull, incl.B, 1);
      }
      if (kB) bar(kBarCarry, kCarryCount); else __syncwarp();

      // 3. column j into the row state: the mix, or the rows replayed from
      // the value entering the thread (0 at each warp's first row without
      // the hand-off)
      double x = 0.0;
      if (kS) {
        const double vw =
            !kH ? 0.0
            : warp == 0 ? cin : add_rn(mul_rn(xA[warp], cin), xB[warp]);
        x = lane == 0 ? vw : add_rn(mul_rn(ea, vw), eb);
      }
      double first = 0.0;
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const Map mp =
            kS && i == 0 ? m0 : row(t0 + i, i < brk ? acc0 : acc1);
        x = kS ? add_rn(mul_rn(mp.A, x), mp.B) : mp.B;
        st[vslot(t0 + i)] = x;
        if (i == 0) first = x;
      }
      vreg = x;
      if (kV) {
        w1 = add_rn(mul_rn(w1, 0.999), first);
        w2 = add_rn(mul_rn(w2, 0.999), x);
      }
    }
    // 4. the last column, and the sinks
    __syncwarp();
    if (kW) hand_column(vreg);
    else store_column(m - 1, vreg);
    if (kV) {
      double* w = wsink + (static_cast<size_t>(c) * kRowThreads +
                           threadIdx.x) * 2;
      w[0] = w1;
      w[1] = w2;
    }
    if (kX && !kW) {
      for (int i = 0; i < k; ++i) {
        const int q = w0 + 32 * i + lane;
        if (R0 + q < n) xsink[R0 + q] = sacc[q];
      }
    }
  }
  if (kW && warp < kRowWarps) {
    // the store warps' arrivals at empty for the block's last two columns
    if (seq >= 2) bar(kBarEmpty + (seq & 1), kHandThreads);
    if (seq >= 1) bar(kBarEmpty + ((seq - 1) & 1), kHandThreads);
  }
  if (kStaged && threadIdx.x == 0) bulk_wait();
}

// the ladder's rungs, each adding the next step, and the branch's, the
// top rung and its levers: the steps' bits
template <bool kStaged>
const void* mix_by_steps(int steps) {
  if (steps == 0)
    return reinterpret_cast<const void*>(&mix_kernel<0, kStaged>);
  if constexpr (!kStaged) {
    switch (steps) {
#define STB_RUNG(b) \
  case b: return reinterpret_cast<const void*>(&mix_kernel<b, false>);
      STB_RUNG(1) STB_RUNG(3) STB_RUNG(7) STB_RUNG(15) STB_RUNG(31)
      STB_RUNG(63) STB_RUNG(127) STB_RUNG(255) STB_RUNG(511)
      STB_RUNG(kStTop | kStStoreWarps) STB_RUNG(kStTop | kStEarly)
      STB_RUNG(kStTop | kStStoreWarps | kStEarly)
#undef STB_RUNG
      default: break;
    }
  }
  return nullptr;
}

// the dynamic shared memory a P5 / P6 block needs
long long mix_smem(int steps, int staged, int chunk, int pieces) {
  const long long slots = chunk + chunk / 16;
  return 8 * slots + ((steps & kStXscratch) ? 16LL * chunk : 0) +
         4LL * ((7LL * pieces + 3) & ~3LL) + (staged ? 16LL * chunk : 0) +
         ((steps & kStStoreWarps) ? 16 * slots : 0);
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

// P5 (steps 0, staged 0 or 1) and P6's rungs (steps: the bits of
// BISECT_STEPS' first i steps, or of all nine and LEVERS' bits, staged
// 0).  a: the discount (smem), wsink (vcarry), xsink (xscratch), halo and
// ticket (handoff); ``pieces`` covers the chunks' rows, ``smem`` the
// block's dynamic shared memory.
extern "C" int stb_vpu_mix(int steps, int staged, const float* a, float* v,
                           float* s, double* wsink, double* xsink,
                           double* halo, int* ticket, int n, int m,
                           int chunk, int chunks, int blocks, int smem,
                           int piece, int pieces, int slab, void* stream) {
  const void* fn = staged ? mix_by_steps<true>(steps)
                          : mix_by_steps<false>(steps);
  const long long rows = static_cast<long long>(chunks) * chunk;
  if (fn == nullptr || n < 1 || m < 1 || v == nullptr || s == nullptr ||
      chunk < kRowThreads || chunk % kRowThreads != 0 || chunks < 1 ||
      rows < n || rows - chunk >= n || blocks < 1 || blocks > chunks ||
      piece < 32 || piece < chunk / kRowThreads || slab < 1 ||
      static_cast<long long>(pieces) * piece < rows ||
      smem < mix_smem(steps, staged, chunk, pieces) || smem > 232448 ||
      (staged && n % 4 != 0) || ((steps & kStSmem) && a == nullptr) ||
      ((steps & kStVcarry) && wsink == nullptr) ||
      ((steps & kStXscratch) && xsink == nullptr) ||
      ((steps & kStHandoff) && (halo == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (steps & kStBars) ? mix_block(steps) : kRowThreads;
  void* args[] = {&a, &v, &s, &wsink, &xsink, &halo, &ticket, &n, &m,
                  &chunk, &chunks, &piece, &pieces, &slab};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
