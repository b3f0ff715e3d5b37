// ReplayGain's equal-loudness filter on NVIDIA Hopper (sm_90a): the Yule
// (10th order) and Butterworth (2nd order) IIR stages over many channels of
// unequal length in one launch, one thread block a channel, each stage on a
// warp of its own.
//
// Replaces flac_tpu/replaygain/__init__.py::_iir_scan (:53-75), a jitted,
// channel-vmapped lax.scan (:73) of the float64 direct-form-I recurrence
//   y[t] = sum_{k=0..N} b[k] x[t-k] - sum_{k=1..N} a[k] y[t-k]
// from zero state, which GainAnalysis.analyze runs twice (Yule, then
// Butterworth on its output) once a title. Input: a packed float64 buffer
// and one (offset, length) pair a channel (segment); each offset is a
// multiple of kTile and the segment is zero-padded to whole tiles, so every
// tile is full. The filter is causal: the padding changes no sample before
// the segment's end. Output: the Butterworth stage's, at the same offsets
// of a buffer of the same size (the padding's outputs are written too, and
// never returned by the launcher).
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
// own contraction changes nothing. Samples before a segment's start enter
// as 0.0, as the zero state does in flac_tpu.
//
// Bound: latency. The Yule recurrence is serial in t: its loop-carried path
// runs from y[t-1] through lane 0's two FMAs, the three additions of the
// a-dot and the subtraction, 2 dependent FMAs and 4 dependent additions a
// sample, so a channel takes at least n * (2 * FMA latency + 4 * add
// latency); flac_fp64_latency_probe below measures both latencies. The
// bytes (x read once, y written once) and the operations are far below
// that. What the design does:
//   - one block a channel, any number of channels and titles a launch, so
//     an album's channels run side by side on their own SMs;
//   - each role on its own warp (warps go to an SM's four sub-partitions by
//     their index modulo 4, so the recurrence warp issues alone on its
//     sub-partition, 15 float64 instructions a sample under its 6-deep
//     latency path):
//       warp 1, loader and Yule b-dot: lane 0 copies x tiles into a
//         shared ring of kXStages by 1D TMA bulk copies that complete on an
//         mbarrier; all 32 lanes compute the tile's b-dots time-parallel,
//         one lane a sample, into a shared bdot ring;
//       warp 0, the Yule recurrence, one lane: v1[t] = bdot[t] - a-dot,
//         the history in registers, the part of the a-dot that does not
//         wait on v1[t-1] computed a sample ahead, v1 into a shared ring;
//       warp 2, the Butterworth stage, one lane: its b-dot over v1 and its
//         two-tap a-chain (a 3-deep path, so it keeps up), the last two v1
//         and y carried in registers; y into a shared ring that a TMA bulk
//         store writes back a whole tile at a time;
//   - each ring hand-over waits on an mbarrier once a tile, never once a
//     sample.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kYule = 10;    // Yule order
constexpr int kButter = 2;   // Butterworth order
constexpr int kTile = 256;   // samples a tile; segment offsets are multiples of it
constexpr int kXStages = 4;  // x ring: kXStages - 1 tiles in flight ahead of the b-dots
constexpr int kBStages = 4;  // bdot ring (warp 1 -> warp 0)
constexpr int kVStages = 4;  // v1 ring (warp 0 -> warp 2)
constexpr int kYStages = 2;  // y ring (warp 2 -> bulk store)
constexpr int kBatch = 16;   // samples a serial lane's loop unrolls
constexpr int kThreads = 96; // warps 0, 1, 2
constexpr uint32_t kTileBytes = kTile * sizeof(double);
static_assert(kTile % kBatch == 0 && kTile % 32 == 0 && kTile >= kYule, "tile shape");

struct Taps {
  double yb[kYule + 1];   // Yule b[0..10]
  double ya[kYule];       // Yule a[1..10]
  double bb[kButter + 1]; // Butterworth b[0..2]
  double ba[kButter];     // Butterworth a[1..2]
};

struct alignas(128) Smem {
  double x[kXStages][kTile];
  double bdot[kBStages][kTile];
  double v1[kVStages][kTile];
  double y[kYStages][kTile];
  uint64_t xfull[kXStages];
  uint64_t bfull[kBStages], bempty[kBStages];
  uint64_t vfull[kVStages], vempty[kVStages];
};

// -- mbarriers and bulk copies (PTX) -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// generic-proxy accesses of shared memory before this are ordered before
// the async proxy's (the bulk copies') that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(double* dst, const double* src, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(kTileBytes),
         "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(double* dst, const double* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)), "r"(kTileBytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// -- the arithmetic (flac_tpu's order, see above) -----------------------------

// hist[0] is the most recent value; push shifts the others back by one
template <int N>
__device__ __forceinline__ void push(double (&hist)[N], double v) {
#pragma unroll
  for (int k = N - 1; k > 0; --k) hist[k] = hist[k - 1];
  hist[0] = v;
}

// The Yule a-dot over y[t-1..t-10] in XLA:CPU's GEMV order, split in two
// for the recurrence. Everything but lane 0's two FMAs reads y[t-2] and
// older, so `YuleAhead` computes it a sample early, off the loop-carried
// path: lane 2, (lane 1 + lane 3) and the leftover chain. `yule_adot` then
// adds lane 0 in the same order as the whole a-dot, ((l0 + l2) +
// (l1 + l3)) + leftover, the last sum as leftover + that.
struct YuleAhead {
  double l2, l13, rest;
};

// the part of the next sample's a-dot known once h[0] = y[t-1] is: h is
// y[t-1..t-10] before y[t] is pushed, so the next sample's y[t-1-k] is h[k-1]
__device__ __forceinline__ YuleAhead yule_ahead(const double (&a)[kYule],
                                                const double (&h)[kYule]) {
  YuleAhead r;
  const double l1 = __fma_rn(a[5], h[4], __fma_rn(a[1], h[0], 0.0));
  r.l2 = __fma_rn(a[6], h[5], __fma_rn(a[2], h[1], 0.0));
  const double l3 = __fma_rn(a[7], h[6], __fma_rn(a[3], h[2], 0.0));
  r.l13 = __dadd_rn(l1, l3);
  r.rest = __fma_rn(a[9], h[8], __fma_rn(a[8], h[7], 0.0));
  return r;
}

// the whole a-dot over h = y[t-1..t-10], from its part computed ahead
__device__ __forceinline__ double yule_adot(const double (&a)[kYule], const double (&h)[kYule],
                                            const YuleAhead& p) {
  const double l0 = __fma_rn(a[4], h[4], __fma_rn(a[0], h[0], 0.0));
  return __dadd_rn(p.rest, __dadd_rn(__dadd_rn(l0, p.l2), p.l13));
}

// -- the three roles ----------------------------------------------------------

// warp 1: x tiles in by bulk copies, every sample's Yule b-dot out, one lane
// a sample. Stage kXStages - 1 starts as zeros: it stands for the tile
// before the segment, whose last kYule samples the first tile's b-dots read.
__device__ void load_and_bdot(Smem& s, const double* __restrict__ x, int64_t ntiles,
                              const Taps& taps) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kTile; i += 32) s.x[kXStages - 1][i] = 0.0;
  __syncwarp();
  if (lane == 0) {
    fence_proxy_async();
    for (int k = 0; k < kXStages - 1 && k < ntiles; ++k) {
      mbar_arrive_expect_tx(&s.xfull[k], kTileBytes);
      bulk_load(s.x[k], x + (int64_t)k * kTile, &s.xfull[k]);
    }
  }
  double b[kYule + 1];
#pragma unroll
  for (int k = 0; k <= kYule; ++k) b[k] = taps.yb[k];
  for (int64_t k = 0; k < ntiles; ++k) {
    const int xs = (int)(k % kXStages), prev = (int)((k + kXStages - 1) % kXStages);
    const int bs = (int)(k % kBStages);
    mbar_wait(&s.xfull[xs], (uint32_t)((k / kXStages) & 1));
    if (k >= kBStages) mbar_wait(&s.bempty[bs], (uint32_t)((k / kBStages - 1) & 1));
    const double* cur = s.x[xs];
    const double* old = s.x[prev];
#pragma unroll 2
    for (int i = lane; i < kTile; i += 32) {
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m <= kYule; ++m) {
        const double xv = i >= m ? cur[i - m] : old[kTile + i - m];
        acc = __fma_rn(b[m], xv, acc);
      }
      s.bdot[bs][i] = acc;
    }
    mbar_arrive(&s.bfull[bs]);  // one arrival a lane
    __syncwarp();               // every lane is done with the previous tile
    if (lane == 0 && k + kXStages - 1 < ntiles) {
      fence_proxy_async();
      mbar_arrive_expect_tx(&s.xfull[prev], kTileBytes);
      bulk_load(s.x[prev], x + (k + kXStages - 1) * kTile, &s.xfull[prev]);
    }
  }
}

// warp 0, one lane: the Yule recurrence v1[t] = bdot[t] - a-dot(v1[t-1..t-10])
__device__ void yule_recurrence(Smem& s, int64_t ntiles, const Taps& taps) {
  double a[kYule], h[kYule] = {}, zeros[kYule] = {};
#pragma unroll
  for (int k = 0; k < kYule; ++k) a[k] = taps.ya[k];
  // the first sample's part of the a-dot: its history before h[0] is zeros
  YuleAhead ahead = yule_ahead(a, zeros);
  for (int64_t k = 0; k < ntiles; ++k) {
    const int bs = (int)(k % kBStages), vs = (int)(k % kVStages);
    mbar_wait(&s.bfull[bs], (uint32_t)((k / kBStages) & 1));
    if (k >= kVStages) mbar_wait(&s.vempty[vs], (uint32_t)((k / kVStages - 1) & 1));
    const double* bd = s.bdot[bs];
    double* out = s.v1[vs];
    for (int base = 0; base < kTile; base += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        // the next sample's part first: it waits on nothing of this one's
        const YuleAhead next = yule_ahead(a, h);
        const double v = __dsub_rn(bd[base + j], yule_adot(a, h, ahead));
        ahead = next;
        push(h, v);
        out[base + j] = v;
      }
    }
    mbar_arrive(&s.bempty[bs]);
    mbar_arrive(&s.vfull[vs]);
  }
}

// warp 2, one lane: the Butterworth stage over v1, y tiles out by bulk stores
__device__ void butterworth(Smem& s, double* __restrict__ y, int64_t ntiles, const Taps& taps) {
  const double b0 = taps.bb[0], b1 = taps.bb[1], b2 = taps.bb[2];
  const double a1 = taps.ba[0], a2 = taps.ba[1];
  double v_1 = 0.0, v_2 = 0.0, y_1 = 0.0, y_2 = 0.0;  // v1[t-1], v1[t-2], y[t-1], y[t-2]
  for (int64_t k = 0; k < ntiles; ++k) {
    const int vs = (int)(k % kVStages), ys = (int)(k % kYStages);
    mbar_wait(&s.vfull[vs], (uint32_t)((k / kVStages) & 1));
    // the store of tile k - kYStages has read its stage
    if (k >= kYStages)
      asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kYStages - 1) : "memory");
    const double* in = s.v1[vs];
    double* out = s.y[ys];
    for (int base = 0; base < kTile; base += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const double v = in[base + j];
        const double bdot = __fma_rn(b2, v_2, __fma_rn(b1, v_1, __fma_rn(b0, v, 0.0)));
        const double adot = __fma_rn(a2, y_2, __fma_rn(a1, y_1, 0.0));
        const double yt = __dsub_rn(bdot, adot);
        v_2 = v_1; v_1 = v;
        y_2 = y_1; y_1 = yt;
        out[base + j] = yt;
      }
    }
    mbar_arrive(&s.vempty[vs]);
    fence_proxy_async();
    bulk_store(y + k * kTile, out);
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// segs: S pairs (offset, length) in samples; block c filters segment c
__global__ void __launch_bounds__(kThreads)
equal_loudness_kernel(const double* __restrict__ x, double* __restrict__ y,
                      const int64_t* __restrict__ segs, const __grid_constant__ Taps taps) {
  __shared__ Smem s;
  const int64_t off = segs[2 * blockIdx.x], len = segs[2 * blockIdx.x + 1];
  const int64_t ntiles = (len + kTile - 1) / kTile;
  if (ntiles == 0) return;  // uniform across the block
  if (threadIdx.x == 0) {
    for (int i = 0; i < kXStages; ++i) mbar_init(&s.xfull[i], 1);
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(&s.bfull[i], 32);  // every lane of warp 1
      mbar_init(&s.bempty[i], 1);
    }
    for (int i = 0; i < kVStages; ++i) {
      mbar_init(&s.vfull[i], 1);
      mbar_init(&s.vempty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 1) {
    load_and_bdot(s, x + off, ntiles, taps);
  } else if (lane == 0) {
    if (warp == 0) yule_recurrence(s, ntiles, taps);
    else butterworth(s, y + off, ntiles, taps);
  }
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

// The samples a tile: segment offsets must be multiples of it, and each
// segment's buffer must hold whole tiles.
int flac_equal_loudness_tile(void) { return kTile; }

// x, y: device pointers to float64 buffers of the same size, 16-byte
// aligned; segs: a device pointer to S pairs (offset, length) of int64,
// offsets multiples of kTile, the segments' whole tiles inside the buffers
// and not overlapping (the launcher checks all of it); taps: host pointer to
// 26 doubles in Taps' order. One block a segment. Returns the launch's CUDA
// error code.
int flac_equal_loudness(const double* x, double* y, const int64_t* segs, int32_t S,
                        const double* taps, cudaStream_t stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  Taps t;
  const double* p = taps;
  for (int k = 0; k <= kYule; ++k) t.yb[k] = *p++;
  for (int k = 0; k < kYule; ++k) t.ya[k] = *p++;
  for (int k = 0; k <= kButter; ++k) t.bb[k] = *p++;
  for (int k = 0; k < kButter; ++k) t.ba[k] = *p++;
  equal_loudness_kernel<<<S, kThreads, 0, stream>>>(x, y, segs, t);
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
