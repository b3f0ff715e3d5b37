// ReplayGain's equal-loudness filter on NVIDIA Hopper (sm_90a): the Yule
// (10th order) and Butterworth (2nd order) IIR stages in one launch.
//
// Replaces flac_tpu/replaygain/__init__.py::_iir_scan (:53-75), a jitted,
// channel-vmapped lax.scan (:73) of the float64 direct-form-I recurrence
//   y[t] = sum_{k=0..N} b[k] x[t-k] - sum_{k=1..N} a[k] y[t-k]
// from zero state, which GainAnalysis.analyze runs twice (Yule, then
// Butterworth on its output). Input: x [C, n] float64, the PCM already
// scaled to 16-bit full scale; output: [C, n] float64, the second stage's.
//
// Arithmetic: bit for bit flac_tpu's, as XLA:CPU evaluates _iir_scan's two
// jnp.dot products (checked against jax 0.9.0 on an AVX-512 host, with an
// exact-arithmetic model, replaygain.fma_reference, in the tests):
//   - the b-dot over the concatenated input history is a chain of fused
//     multiply-adds from 0.0, k = 0 (x[t]) first;
//   - the Yule a-dot over y[t-1..t-10] is XLA's vectorized row-major GEMV:
//     four lanes l = 0..3, each fma(a[5+l], y[t-5-l], fma(a[1+l], y[t-1-l],
//     0.0)); the two taps left over (y[t-9], y[t-10]) in a chain of their
//     own; the lanes reduced as (l0 + l2) + (l1 + l3), the leftover chain
//     added to that;
//   - the Butterworth a-dot (two taps) is the leftover chain alone;
//   - y = b-dot - a-dot.
// Every step is an intrinsic (__fma_rn, __dadd_rn, __dsub_rn), so nvcc's
// own contraction changes nothing.
//
// Bound: latency. The recurrence is serial in t. The Yule stage's
// loop-carried path runs from y[t-1] through lane 0's two FMAs, the three
// additions of the a-dot and the subtraction: 2 dependent FMAs and 4
// dependent additions a sample, so a channel takes at least
// n * (2 * FMA latency + 4 * add latency) on the card; flac_fp64_latency_probe
// below measures both latencies. The bytes (x read once, y written once)
// and the operations are far below that. What the design does:
//   - one thread a channel, all channels in one warp; one launch a title;
//   - both stages fused: the Yule output feeds the Butterworth stage from a
//     register and never goes to memory; the b-chains (whose inputs are known
//     ahead), the a-dot's other lanes and the Butterworth stage overlap the
//     loop-carried path;
//   - the histories live in registers (fixed-size arrays under
//     #pragma unroll), the taps in the kernel's parameter space;
//   - x is read ahead in batches of kBatch samples, the next batch loaded
//     while the current one is filtered, so no sample waits on device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kYule = 10;    // Yule order
constexpr int kButter = 2;   // Butterworth order
constexpr int kBatch = 16;   // samples read ahead a thread

struct Taps {
  double yb[kYule + 1];   // Yule b[0..10]
  double ya[kYule];       // Yule a[1..10]
  double bb[kButter + 1]; // Butterworth b[0..2]
  double ba[kButter];     // Butterworth a[1..2]
};

// hist[0] is the most recent value; push shifts the others back by one
template <int N>
__device__ __forceinline__ void push(double (&hist)[N], double v) {
#pragma unroll
  for (int k = N - 1; k > 0; --k) hist[k] = hist[k - 1];
  hist[0] = v;
}

template <int N>
__device__ __forceinline__ double fma_chain(const double (&tap)[N], const double (&hist)[N]) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc = __fma_rn(tap[k], hist[k], acc);
  return acc;
}

struct State {
  double x1[kYule + 1] = {}, y1[kYule] = {};      // Yule: x[t..t-10], y[t-1..t-10]
  double x2[kButter + 1] = {}, y2[kButter] = {};  // Butterworth on the Yule output
};

// the Yule a-dot over y[t-1..t-10] in XLA:CPU's GEMV order (see above)
__device__ __forceinline__ double yule_adot(const double (&a)[kYule], const double (&h)[kYule]) {
  double lane[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) lane[l] = __fma_rn(a[4 + l], h[4 + l], __fma_rn(a[l], h[l], 0.0));
  const double rest = __fma_rn(a[9], h[9], __fma_rn(a[8], h[8], 0.0));
  return __dadd_rn(rest, __dadd_rn(__dadd_rn(lane[0], lane[2]), __dadd_rn(lane[1], lane[3])));
}

// one sample through both stages
__device__ __forceinline__ double step(State& s, const Taps& taps, double xt) {
  push(s.x1, xt);
  const double v1 = __dsub_rn(fma_chain(taps.yb, s.x1), yule_adot(taps.ya, s.y1));
  push(s.y1, v1);
  push(s.x2, v1);
  const double v2 = __dsub_rn(fma_chain(taps.bb, s.x2), fma_chain(taps.ba, s.y2));
  push(s.y2, v2);
  return v2;
}

__global__ void __launch_bounds__(32)
equal_loudness_kernel(const double* __restrict__ x, double* __restrict__ y,
                      int32_t C, int64_t n, const __grid_constant__ Taps taps) {
  const int c = threadIdx.x;
  if (c >= C) return;
  const double* xc = x + (int64_t)c * n;
  double* yc = y + (int64_t)c * n;
  State s;
  const int64_t full = n - n % kBatch;  // samples in whole batches
  double cur[kBatch], nxt[kBatch];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cur[j] = xc[j];
  }
  for (int64_t base = 0; base < full; base += kBatch) {
    if (base + kBatch < full) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) nxt[j] = xc[base + kBatch + j];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) yc[base + j] = step(s, taps, cur[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cur[j] = nxt[j];
  }
  for (int64_t t = full; t < n; ++t) yc[t] = step(s, taps, xc[t]);
}

// one thread, `iters` dependent float64 FMAs (add = 0) or additions
// (add = 1), 8 a loop turn; out[0] keeps the chain alive
__global__ void fp64_latency_kernel(int64_t iters, int add, double m, double a, double* out) {
  double acc = a;
  if (add) {
    for (int64_t i = 0; i < iters; i += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = __dadd_rn(acc, m);
    }
  } else {
    for (int64_t i = 0; i < iters; i += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = __fma_rn(acc, m, a);
    }
  }
  out[0] = acc;
}

}  // namespace

extern "C" {

// x, y: device pointers to C x n float64, row-major; taps: host pointer to
// 26 doubles in Taps' order. Returns the launch's CUDA error code.
int flac_equal_loudness(const double* x, double* y, int32_t C, int64_t n,
                        const double* taps, cudaStream_t stream) {
  if (C < 1 || C > 32 || n < 0) return (int)cudaErrorInvalidValue;
  Taps t;
  const double* p = taps;
  for (int k = 0; k <= kYule; ++k) t.yb[k] = *p++;
  for (int k = 0; k < kYule; ++k) t.ya[k] = *p++;
  for (int k = 0; k <= kButter; ++k) t.bb[k] = *p++;
  for (int k = 0; k < kButter; ++k) t.ba[k] = *p++;
  equal_loudness_kernel<<<1, 32, 0, stream>>>(x, y, C, n, t);
  return (int)cudaGetLastError();
}

// The latency probe: one thread runs `iters` (a multiple of 8) dependent
// float64 FMAs (add = 0) or additions (add = 1); the caller times two
// lengths with CUDA events.
int flac_fp64_latency_probe(int64_t iters, int32_t add, double* out, cudaStream_t stream) {
  if (iters < 8 || iters % 8) return (int)cudaErrorInvalidValue;
  fp64_latency_kernel<<<1, 1, 0, stream>>>(iters, add, add ? 1e-300 : 0.999999, 1e-9, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
