// The slice moves of the discount a and the concentration b
// (samplers/hyper.sample_a / sample_b) for Hopper (sm_90a): a batch of up
// to K tries of every chain's shrinking-interval slice loop in one launch.
//
// No TPU kernel stands behind it: the JAX package's move
// (libstb_tpu/samplers/slice.py) is a ``while_loop`` that XLA compiles
// into one program.  The port's generic loop, samplers/slice.slice_sample,
// is SliceSimple (lib/sslice.c:33-80) with a host read of all(done) before
// every try and each try's log posterior as ~15-25 small PyTorch
// operations: at the Gibbs cell's shape (16384 chains, ~20 tries a move)
// the host's round trips, not the device, set its pace.  This kernel runs
// K tries of the same loop on the card and writes a count of the chains
// still live; the host reads that count once a batch.
//
// A chain is ``lanes`` threads (its group count rounded up to a power of
// two, at most 32): lane l sums the groups l, l + lanes, ... of the log
// posterior's group sum, and the lanes reduce it by an xor butterfly, so
// that every lane ends with the same sum and carries the same proposal and
// the same decision.  The two densities, chosen by a template argument:
//   A (the discount, samplea.c:65-67 and the grid curve):
//       sum_i [T_i log x + lgamma(T_i + b_i / x) - lgamma(b_i / x)]
//       + curve_at(curve_c, x), Catmull-Rom over the chain's (G,) curve
//       with AGridTable._locate's clamp of the base index;
//   B (the concentration, sampleb.c:33-41):
//       -Q x + (shape - 1) log x + sum_i [lgamma(T_i + x / a) - lgamma(x / a)]
//       (a <= 0 read as 1: those chains take the conjugate draw).
// Each step is the PyTorch expression's, in its order, through the
// round-to-nearest intrinsics (no FMA contraction), so that a proposal
// rlo + u (rhi - rlo) is the plain loop's bit for bit wherever the accept
// decisions agree; only the group sum's order differs from torch.sum's.
//
// The chain state (xp, rlo, rhi, the level y, done) lives in (C,) tensors
// between launches, so that a batch continues where the one before it
// stopped; the first batch (``init``) takes x0, lo, hi and the level's
// uniform u0 instead.  The K uniforms of a batch come as K pointers in the
// kernel's parameters (ops/slice_cuda.py draws them one (C,) block a try).
//
// What bounds it: the bytes are (C, I) inputs read once and K uniforms a
// chain (~1.3 MB a batch at 16384 x 4 in f32), ~0.4 us at 3.35 TB/s; the
// work is a few lgamma a group a try.  Against that stand K dependent
// tries of a chain, each a log posterior and a butterfly: latency, one
// wave of ~16k-64k threads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a block; lanes divides it
constexpr int kBatch = 32;      // the most tries a launch, ops/slice_cuda.K

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
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float lgamma(float x) {
    return lgammaf(x);
  }
  static __device__ __forceinline__ float floor(float x) {
    return floorf(x);
  }
  static __device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
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
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double lgamma(double x) {
    return ::lgamma(x);
  }
  static __device__ __forceinline__ double floor(double x) {
    return ::floor(x);
  }
  static __device__ __forceinline__ double clamp(double x, double lo,
                                                 double hi) {
    return ::fmin(::fmax(x, lo), hi);
  }
};

enum Density { kA = 0, kB = 1 };

template <typename F>
struct Args {
  F* xp;                      // (C,) the last accepted point
  F* rlo;                     // (C,) the interval
  F* rhi;
  F* y;                       // (C,) the slice level
  unsigned char* done;        // (C,)
  int* live;                  // the chains not done after this batch
  const F* x0;                // (C,) init only: start, bounds, u0
  const F* lo;
  const F* hi;
  const F* u0;
  const F* T;                 // (C, I) at strides sT0, sT1
  const F* w;                 // A: (C, I) concentrations at sw0, sw1
  const F* curve;             // A: (C, G) at strides sc0, sc1
  const F* Q;                 // B: (C,)
  const F* a;                 // B: (C,)
  long long sT0, sT1, sw0, sw1, sc0, sc1;
  F c1;                       // A: the grid's a0; B: shape - 1
  F c2;                       // A: 1 / the grid's da
  int g_max, C, I, lanes, tries, init;
  const F* u[kBatch];         // the batch's uniforms, (C,) each
};

template <typename F, int kD>
__device__ __forceinline__ F logpost(const Args<F>& p, int c, int lane,
                                     unsigned mask, F x) {
  using R = Rn<F>;
  F s = F(0);
  const F* T = p.T + c * p.sT0;
  if constexpr (kD == kA) {
    const F lx = R::log(x);
    const F* w = p.w + c * p.sw0;
    for (int i = lane; i < p.I; i += p.lanes) {
      const F Ti = T[i * p.sT1];
      const F yv = R::div(w[i * p.sw1], x);
      s = R::add(s, R::sub(R::add(R::mul(Ti, lx), R::lgamma(R::add(Ti, yv))),
                           R::lgamma(yv)));
    }
  } else {
    const F ac = p.a[c];
    const F yv = R::div(x, ac > F(0) ? ac : F(1));
    const F lgy = R::lgamma(yv);
    for (int i = lane; i < p.I; i += p.lanes) {
      s = R::add(s, R::sub(R::lgamma(R::add(T[i * p.sT1], yv)), lgy));
    }
  }
  // x + y == y + x, so lanes l and l ^ o hold the same sum after each step
  for (int o = p.lanes >> 1; o > 0; o >>= 1) {
    s = R::add(s, __shfl_xor_sync(mask, s, o, p.lanes));
  }
  if constexpr (kD == kA) {
    // AGridTable.curve_at: pos = (x - a0) / da, taken on a card as
    // (x - a0) * (1 / da); base g = floor(pos) clamped to [1, G - 3]
    const F pos = R::mul(R::sub(x, p.c1), p.c2);
    const F gf = R::clamp(R::floor(pos), F(1), F(p.g_max - 3));
    const int g = static_cast<int>(gf);
    const F t = R::sub(pos, gf);
    const F t2 = R::mul(t, t);
    const F t3 = R::mul(t2, t);
    const F h = F(0.5);
    const F w0 = R::mul(h, R::sub(R::add(-t3, R::mul(F(2), t2)), t));
    const F w1 = R::mul(h, R::add(R::sub(R::mul(F(3), t3), R::mul(F(5), t2)),
                                  F(2)));
    const F w2 = R::mul(h, R::add(R::add(R::mul(F(-3), t3), R::mul(F(4), t2)),
                                  t));
    const F w3 = R::mul(h, R::sub(t3, t2));
    const F* cv = p.curve + c * p.sc0 + (g - 1) * p.sc1;
    F acc = R::mul(w0, cv[0]);
    acc = R::add(acc, R::mul(w1, cv[p.sc1]));
    acc = R::add(acc, R::mul(w2, cv[2 * p.sc1]));
    acc = R::add(acc, R::mul(w3, cv[3 * p.sc1]));
    return R::add(s, acc);
  } else {
    const F v = R::add(R::mul(-p.Q[c], x), R::mul(p.c1, R::log(x)));
    return R::add(v, s);
  }
}

template <typename F, int kD>
__global__ void __launch_bounds__(kThreads) slice_kernel(const Args<F> p) {
  using R = Rn<F>;
  const int c = (blockIdx.x * kThreads + threadIdx.x) / p.lanes;
  if (c >= p.C) return;       // a chain's lanes leave together
  const int lane = threadIdx.x & (p.lanes - 1);
  const unsigned mask =
      p.lanes == 32 ? 0xffffffffu
                    : ((1u << p.lanes) - 1u) << ((threadIdx.x & 31) & ~(p.lanes - 1));
  F xp, rlo, rhi, y;
  bool done;
  if (p.init) {
    xp = p.x0[c];
    rlo = p.lo[c];
    rhi = p.hi[c];
    y = R::add(logpost<F, kD>(p, c, lane, mask, xp), R::log(p.u0[c]));
    done = false;
  } else {
    xp = p.xp[c];
    rlo = p.rlo[c];
    rhi = p.rhi[c];
    y = p.y[c];
    done = p.done[c] != 0;
  }
  for (int k = 0; k < p.tries && !done; ++k) {
    const F xprop = R::add(rlo, R::mul(p.u[k][c], R::sub(rhi, rlo)));
    if (logpost<F, kD>(p, c, lane, mask, xprop) > y) {
      xp = xprop;
      done = true;
    } else if (xprop < xp) {  // shrink toward xp (sslice.c:62-68)
      rlo = xprop;
    } else if (xprop >= xp) {
      rhi = xprop;
    }
  }
  if (lane == 0) {
    p.xp[c] = xp;
    p.rlo[c] = rlo;
    p.rhi[c] = rhi;
    p.y[c] = y;
    p.done[c] = done ? 1 : 0;
    if (!done) atomicAdd(p.live, 1);
  }
}

// One launch: every chain's next ``tries`` tries.  Returns a cudaError_t as
// int.
template <typename F>
int move(int density, const Args<F>& p, void* stream) {
  if (p.C < 1 || p.I < 1 || p.lanes < 1 || p.lanes > 32 ||
      (p.lanes & (p.lanes - 1)) != 0 || p.tries < 0 || p.tries > kBatch ||
      (density == kA && p.g_max < 4) || (density != kA && density != kB))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpb = kThreads / p.lanes;
  const int blocks = (p.C + cpb - 1) / cpb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (density == kA) {
    slice_kernel<F, kA><<<blocks, kThreads, 0, st>>>(p);
  } else {
    slice_kernel<F, kB><<<blocks, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int entry(int density, F* xp, F* rlo, F* rhi, F* y, unsigned char* done,
          int* live, const F* x0, const F* lo, const F* hi, const F* u0,
          const F* T, const F* w, const F* curve, const F* Q, const F* a,
          long long sT0, long long sT1, long long sw0, long long sw1,
          long long sc0, long long sc1, double c1, double c2, int g_max,
          int C, int I,
          int lanes, int tries, int init, const void* const* u,
          void* stream) {
  Args<F> p{xp, rlo, rhi, y, done, live, x0, lo, hi, u0, T, w, curve, Q, a,
            sT0, sT1, sw0, sw1, sc0, sc1, static_cast<F>(c1),
            static_cast<F>(c2),
            g_max, C, I, lanes, tries, init, {}};
  for (int k = 0; k < kBatch; ++k) {
    p.u[k] = k < tries ? static_cast<const F*>(u[k]) : nullptr;
  }
  return move<F>(density, p, stream);
}

}  // namespace

extern "C" int stb_slice_move_f32(
    int density, float* xp, float* rlo, float* rhi, float* y,
    unsigned char* done, int* live, const float* x0, const float* lo,
    const float* hi, const float* u0, const float* T, const float* w,
    const float* curve, const float* Q, const float* a, long long sT0,
    long long sT1, long long sw0, long long sw1, long long sc0,
    long long sc1, double c1, double c2, int g_max, int C, int I, int lanes,
    int tries, int init, const void* const* u, void* stream) {
  return entry<float>(density, xp, rlo, rhi, y, done, live, x0, lo, hi, u0,
                      T, w, curve, Q, a, sT0, sT1, sw0, sw1, sc0, sc1, c1,
                      c2, g_max, C, I, lanes, tries, init, u, stream);
}

extern "C" int stb_slice_move_f64(
    int density, double* xp, double* rlo, double* rhi, double* y,
    unsigned char* done, int* live, const double* x0, const double* lo,
    const double* hi, const double* u0, const double* T, const double* w,
    const double* curve, const double* Q, const double* a, long long sT0,
    long long sT1, long long sw0, long long sw1, long long sc0,
    long long sc1, double c1, double c2, int g_max, int C, int I, int lanes,
    int tries, int init, const void* const* u, void* stream) {
  return entry<double>(density, xp, rlo, rhi, y, done, live, x0, lo, hi, u0,
                       T, w, curve, Q, a, sT0, sT1, sw0, sw1, sc0, sc1, c1,
                       c2, g_max, C, I, lanes, tries, init, u, stream);
}
