// Fixed/LPC predictor restore of the FLAC frame decoder, on NVIDIA Hopper
// (sm_90a).
//
// Replaces flac_tpu/decode/frame_decoder.py::_restore_scan (:597-629), the
// batched IIR restore that build_frame_decoder runs as a lax.scan over
// sample positions: for t < order x[t] = warm[t], then
//   x[t] = res[t] + ((sum_{j < order} c_j * x[t-1-j]) >> shift)
// in int64 (wrapping, as XLA's int64 does); frames that are not coded give
// 0 (:622-623). The loop runs to `order`, not to maxord: flac_tpu masks the
// coefficients j >= order to 0 (:608), so the sum is the same.
//
// Design: one thread per frame (the scan's batch axis), the coefficients in
// registers (a FLAC predictor has at most 32), and each thread reading its
// own earlier outputs back from its row, which L1 holds. Bound: the larger
// of the bytes (res read once, x written once: B*T*(4+8)) over 3.35 TB/s and
// the int64 multiply-adds (B*(T-order)*order) over the card's int32
// instruction rate; both are far below what one serial chain per frame
// takes, so the chain's latency sets the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;  // FLAC's largest predictor order

__global__ void __launch_bounds__(32) restore_scan_kernel(
    const int32_t* __restrict__ res, const int64_t* __restrict__ coeffs,
    const int64_t* __restrict__ order_in, const int64_t* __restrict__ shift_in,
    const int64_t* __restrict__ warm, const uint8_t* __restrict__ coded_in,
    int64_t* __restrict__ x, int32_t B, int32_t T, int32_t maxord) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int64_t* xr = x + (int64_t)b * T;
  if (coded_in[b] == 0) {
    for (int32_t t = 0; t < T; ++t) xr[t] = 0;
    return;
  }
  const int32_t* rr = res + (int64_t)b * T;
  const int64_t order = order_in[b];
  // coefficients that take part: j < order and j < maxord (flac_tpu's
  // coefficient rows have maxord columns)
  int64_t n64 = order < maxord ? order : maxord;
  n64 = n64 < 0 ? 0 : (n64 > kMaxOrder ? kMaxOrder : n64);
  const int32_t n = (int32_t)n64;
  int64_t c[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j)
    c[j] = j < n ? coeffs[(int64_t)b * maxord + j] : 0;
  int64_t sh = shift_in[b];
  sh = sh < 0 ? 0 : (sh > 63 ? 63 : sh);
  const int64_t* wr = warm + (int64_t)b * maxord;
  for (int32_t t = 0; t < T; ++t) {
    int64_t xt;
    if (t < order) {
      xt = t < maxord ? wr[t] : 0;
    } else {
      uint64_t acc = 0;  // unsigned: the wrap is defined
#pragma unroll
      for (int j = 0; j < kMaxOrder; ++j)
        if (j < n) acc += (uint64_t)c[j] * (uint64_t)xr[t - 1 - j];
      xt = (int64_t)((uint64_t)(int64_t)rr[t] + (uint64_t)((int64_t)acc >> sh));
    }
    xr[t] = xt;
  }
}

}  // namespace

// res int32 [B, T]; coeffs, warm int64 [B, maxord]; order, shift int64 [B];
// is_coded bool [B]. Writes x int64 [B, T]. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flac_restore_scan(const void* res, const void* coeffs,
                                 const void* order, const void* shift,
                                 const void* warm, const void* is_coded,
                                 void* x, int32_t batch, int32_t T,
                                 int32_t maxord, void* stream) {
  if (batch > 0) {
    const int threads = 32;
    const int blocks = (batch + threads - 1) / threads;
    restore_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)res, (const int64_t*)coeffs, (const int64_t*)order,
        (const int64_t*)shift, (const int64_t*)warm, (const uint8_t*)is_coded,
        (int64_t*)x, batch, T, maxord);
  }
  return (int)cudaGetLastError();
}
