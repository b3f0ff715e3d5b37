// Fixed/LPC predictor restore of the FLAC frame decoder, on NVIDIA Hopper
// (sm_90a).
//
// Replaces flac_tpu/decode/frame_decoder.py::_restore_scan (:597-629), the
// batched IIR restore that build_frame_decoder runs as a lax.scan over
// sample positions: for t < order x[t] = warm[t], then
//   x[t] = res[t] + ((sum_{j < order} c_j * x[t-1-j]) >> shift)
// in int64 (wrapping, as XLA's int64 does); rows that are not coded give 0
// (:622-623). The taps run to `order`, not to maxord: flac_tpu masks the
// coefficients j >= order to 0 (:608), so the sum is the same. A FLAC
// predictor has at most 32 taps, and so does this kernel. res is int32
// from the narrow residual scan and int64 from the wide one (whose values
// can pass 32 bits): one instantiation each.
//
// Bound: the larger of the bytes (res read once, x written once: R*T*(4+8)
// for R rows, R*T*(8+8) with int64 res) over 3.35 TB/s and the int64 multiply-adds (R*(T-order)*order)
// over the card's int32 multiply-add rate; at level 5 the bytes bound it.
// Each row is one serial chain of T dependent samples, so the design keeps
// that chain short and everything else off it:
//   - one thread a row, 32 rows a block (one warp); the caller stacks every
//     channel's rows into one launch, so 512 stereo frames are 1,024 rows on
//     32 SMs;
//   - the history is a shift register in registers with compile-time
//     indices (the sample loop is unrolled over a tile whose length is a
//     multiple of the register's width), never memory;
//   - the taps run to the warp's largest order, a warp-uniform choice among
//     widths 4, 8, 16 and 32; lanes of lower order keep zero coefficients
//     past their own; the newest sample's tap is added last and rows that
//     are not coded are masked, not branched around, so a sample's older
//     taps overlap the previous samples' and its own chain is one multiply
//     and a few adds;
//   - res comes in and x goes out through 32 x 32 shared-memory tiles: a
//     warp reads 32 consecutive samples of one row per instruction (res
//     double-buffered with cp.async, one tile ahead) and writes x the same
//     way, so both coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;  // FLAC's largest predictor order
constexpr int kRows = 32;      // rows a block: one warp, one row a lane
constexpr int kTile = 32;      // samples a staged tile

template <typename Res>
struct Tiles {
  Res res[2][kRows][kTile + 1];  // +1: a lane's row and a row's lanes
  int64_t x[kRows][kTile + 1];   // both hit distinct banks
};

// one element of sizeof(T) (4 or 8) bytes from device to shared memory
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage samples [t0, t0 + kTile) of the block's rows: lane l reads sample
// t0 + l of each row in turn
template <typename Res>
__device__ __forceinline__ void stage_res(Tiles<Res>& sm, int buf, const Res* res,
                                          int64_t row0, int64_t R, int32_t T,
                                          int32_t t0, int lane) {
  const int32_t t = t0 + lane;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < R && t < T) cp_async(&sm.res[buf][r][lane], res + (row0 + r) * T + t);
}

// one sample of the recurrence: the taps summed oldest first
template <int W, typename Res>
__device__ __forceinline__ int64_t predict(const int64_t (&c)[W],
                                           const int64_t (&h)[W], Res r,
                                           int sh) {
  uint64_t acc = 0;  // unsigned: the wrap is defined
#pragma unroll
  for (int j = W - 1; j >= 0; --j) acc += (uint64_t)c[j] * (uint64_t)h[j];
  return (int64_t)((uint64_t)(int64_t)r + (uint64_t)((int64_t)acc >> sh));
}

template <int W>
__device__ __forceinline__ void push(int64_t (&h)[W], int64_t v) {
#pragma unroll
  for (int j = W - 1; j > 0; --j) h[j] = h[j - 1];
  h[0] = v;
}

template <int W, typename Res>
__device__ void restore_rows(Tiles<Res>& sm, const Res* __restrict__ res,
                             const int64_t* __restrict__ coeffs,
                             const int64_t* __restrict__ warm,
                             int64_t* __restrict__ x, int64_t row0, int64_t R,
                             int32_t T, int32_t maxord, int lane, bool coded,
                             int32_t n, int64_t order, int sh, int64_t order_max) {
  static_assert(kTile % W == 0, "a tile returns the register to its indices");
  const int64_t b = row0 + lane;
  // rows that are not coded give 0: a mask, not a branch, so that a
  // sample's older taps can overlap the previous sample's last steps
  const int64_t keep = coded ? -1 : 0;
  int64_t c[W], h[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    c[j] = j < n ? coeffs[b * maxord + j] : 0;
    h[j] = 0;
  }
  const int32_t ntiles = (T + kTile - 1) / kTile;
  stage_res(sm, 0, res, row0, R, T, 0, lane);
  cp_async_commit();
  for (int32_t tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int32_t t0 = tile * kTile;
    if (tile + 1 < ntiles) stage_res(sm, buf ^ 1, res, row0, R, T, t0 + kTile, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int32_t tn = min(kTile, T - t0);
    const Res* rr = sm.res[buf][lane];
    int64_t* xr = sm.x[lane];
    if (tn == kTile && t0 >= order_max) {
      // every lane past its warmup: the unrolled tile
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int64_t v = predict<W>(c, h, rr[i], sh) & keep;
        push<W>(h, v);
        xr[i] = v;
      }
    } else {
      for (int i = 0; i < tn; ++i) {
        const int32_t t = t0 + i;
        int64_t v = 0;
        if (coded)
          v = t < order ? (t < maxord ? warm[b * maxord + t] : 0)
                        : predict<W>(c, h, rr[i], sh);
        push<W>(h, v);
        xr[i] = v;
      }
    }
    __syncwarp();
    // write the tile back: lane l writes sample t0 + l of each row in turn
#pragma unroll 4
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < R && lane < tn) x[(row0 + r) * T + t0 + lane] = sm.x[r][lane];
    __syncwarp();
  }
}

template <typename Res>
__global__ void __launch_bounds__(kRows) restore_scan_kernel(
    const Res* __restrict__ res, const int64_t* __restrict__ coeffs,
    const int64_t* __restrict__ order_in, const int64_t* __restrict__ shift_in,
    const int64_t* __restrict__ warm, const uint8_t* __restrict__ coded_in,
    int64_t* __restrict__ x, int64_t R, int32_t T, int32_t maxord) {
  __shared__ Tiles<Res> sm;
  const int lane = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t b = row0 + lane;
  // lanes past the last row take part in the warp's tiles and write nothing
  bool coded = false;
  int64_t order = 0;
  int32_t n = 0;
  int sh = 0;
  if (b < R) {
    coded = coded_in[b] != 0;
    order = order_in[b];
    // coefficients that take part: j < order and j < maxord (flac_tpu's
    // coefficient rows have maxord columns)
    int64_t n64 = order < maxord ? order : maxord;
    n = (int32_t)(n64 < 0 ? 0 : (n64 > kMaxOrder ? kMaxOrder : n64));
    const int64_t s = shift_in[b];
    sh = (int)(s < 0 ? 0 : (s > 63 ? 63 : s));
  }
  const unsigned full = 0xffffffffu;
  const int32_t n_max = (int32_t)__reduce_max_sync(full, coded ? (unsigned)n : 0u);
  // the last warmup sample of the warp's coded rows (orders are small and
  // non-negative; a negative order has no warmup)
  const int64_t o = coded && order > 0 ? order : 0;
  const int64_t order_max = (int64_t)__reduce_max_sync(
      full, (unsigned)(o > 0x7fffffff ? 0x7fffffff : o));
  if (n_max <= 4)
    restore_rows<4>(sm, res, coeffs, warm, x, row0, R, T, maxord, lane, coded, n,
                    order, sh, order_max);
  else if (n_max <= 8)
    restore_rows<8>(sm, res, coeffs, warm, x, row0, R, T, maxord, lane, coded, n,
                    order, sh, order_max);
  else if (n_max <= 16)
    restore_rows<16>(sm, res, coeffs, warm, x, row0, R, T, maxord, lane, coded, n,
                     order, sh, order_max);
  else
    restore_rows<32>(sm, res, coeffs, warm, x, row0, R, T, maxord, lane, coded, n,
                     order, sh, order_max);
  cp_async_wait<0>();
}

}  // namespace

// res [R, T] (int32, or int64 when res64 != 0); coeffs, warm int64 [R,
// maxord]; order, shift int64 [R]; is_coded bool [R]. Writes x int64 [R, T].
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flac_restore_scan(const void* res, const void* coeffs,
                                 const void* order, const void* shift,
                                 const void* warm, const void* is_coded,
                                 void* x, int32_t rows, int32_t T,
                                 int32_t maxord, int32_t res64, void* stream) {
  if (rows > 0) {
    const int blocks = (rows + kRows - 1) / kRows;
    if (res64)
      restore_scan_kernel<<<blocks, kRows, 0, (cudaStream_t)stream>>>(
          (const int64_t*)res, (const int64_t*)coeffs, (const int64_t*)order,
          (const int64_t*)shift, (const int64_t*)warm, (const uint8_t*)is_coded,
          (int64_t*)x, rows, T, maxord);
    else
      restore_scan_kernel<<<blocks, kRows, 0, (cudaStream_t)stream>>>(
          (const int32_t*)res, (const int64_t*)coeffs, (const int64_t*)order,
          (const int64_t*)shift, (const int64_t*)warm, (const uint8_t*)is_coded,
          (int64_t*)x, rows, T, maxord);
  }
  return (int)cudaGetLastError();
}
