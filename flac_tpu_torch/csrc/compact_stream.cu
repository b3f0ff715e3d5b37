// Dense stream compaction of a batch of packed FLAC frames, on NVIDIA
// Hopper (sm_90a).
//
// Replaces flac_tpu/encode/packer.py::compact_stream_words (:128-195), whose
// core is a lax.scan (:181) of B dynamic_update_slices: frame f's words,
// shifted by its byte phase, are copied in frame order into one output
// buffer at word (start_f + 3) / 4, and the 1-3 head bytes of a frame that
// starts mid-word are added into the word before. Frames are byte-aligned
// (the frame tail pads to a byte, then the CRC-16). Inputs: words [B, W] of
// big-endian frame words (uint32 bits in int32), total_bits [B] int32.
// Output: stream [B * W] (the stream's bytes 4k..4k+3 are word k's
// big-endian bytes; zero from the stream's end on) and total, the stream's
// byte count, int64.
//
// Bound: bytes. The valid words are read once (sum of ceil(nbytes_f / 4)
// words), total_bits once, and the B * W output words written once, at
// 3.35 TB/s; there is no arithmetic to speak of. What the design does:
//   - one block a frame, no scan: block f finds its byte start, the sum of
//     ceil(total_bits / 8) over the frames before it, with a block-wide
//     reduction over total_bits (B is a batch, 64 to 512 entries), as
//     pack_frames_kernel scans nbits; every block also sums all B for the
//     stream's total;
//   - owner computes, no atomics: block f writes output words k from
//     ceil(start_f / 4) to ceil(end_f / 4) - 1. Each is a funnel shift of
//     two of its frame's source words, bytes past the frame's tail masked
//     to zero; where the frame ends mid-word, the block ORs in the next
//     frame's first 4 - (end_f & 3) bytes from that frame's word 0. A word
//     spans at most two frames because every frame has at least 4 bytes (a
//     FLAC frame has at least 10), which the caller guarantees;
//   - neighbouring threads take neighbouring words, so the reads of a row
//     and the writes of the stream coalesce;
//   - the words from ceil(total / 4) to B * W are zeroed by all blocks in a
//     grid stride, so the output needs no memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// word j of a frame of `nbytes` bytes, the bytes at or past the tail zeroed
__device__ __forceinline__ uint32_t frame_word(const uint32_t* __restrict__ row,
                                               int64_t j, int32_t W, int64_t nbytes) {
  const int64_t v = nbytes - 4 * j;  // the word's bytes inside the frame
  if (v <= 0 || j >= W) return 0u;
  const uint32_t w = row[j];
  return v >= 4 ? w : w & (0xFFFFFFFFu << (8 * (4 - (int)v)));
}

__device__ __forceinline__ int64_t frame_bytes(const int32_t* __restrict__ total_bits,
                                               int g) {
  return ((int64_t)total_bits[g] + 7) >> 3;
}

__global__ void __launch_bounds__(kThreads)
compact_stream_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ total_bits,
                      uint32_t* __restrict__ out, int64_t* __restrict__ total_out,
                      int32_t B, int32_t W) {
  __shared__ int64_t partial[2][kWarps];
  const int f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the frame's byte start and the stream's length
  int64_t before = 0, all = 0;
  for (int g = threadIdx.x; g < B; g += kThreads) {
    const int64_t nb = frame_bytes(total_bits, g);
    all += nb;
    if (g < f) before += nb;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(0xFFFFFFFFu, before, o);
    all += __shfl_xor_sync(0xFFFFFFFFu, all, o);
  }
  if (lane == 0) {
    partial[0][warp] = before;
    partial[1][warp] = all;
  }
  __syncthreads();
  int64_t start = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    start += partial[0][w];
    total += partial[1][w];
  }

  const int64_t nw = (int64_t)B * W;
  const int64_t nbytes = frame_bytes(total_bits, f);
  const int64_t end = start + nbytes;
  const uint32_t* __restrict__ row = words + (int64_t)f * W;
  // word k's first byte is the frame's byte 4k - start: source word k - k0
  // at byte phase ph
  const int64_t k0 = (start + 3) >> 2, k1 = (end + 3) >> 2;
  const int ph = (int)((-start) & 3);
  // the next frame's head, for the word this frame ends in mid-word
  uint32_t next_head = 0u;
  if ((end & 3) && f + 1 < B)
    next_head = frame_word(row + W, 0, W, frame_bytes(total_bits, f + 1));

  for (int64_t k = k0 + threadIdx.x; k < k1 && k < nw; k += kThreads) {
    const int64_t j = k - k0;
    uint32_t w = frame_word(row, j, W, nbytes);
    if (ph) w = (w << (8 * ph)) | (frame_word(row, j + 1, W, nbytes) >> (32 - 8 * ph));
    if (4 * k + 4 > end) w |= next_head >> (8 * (end & 3));
    out[k] = w;
  }

  // the zeros past the stream's end
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t k = ((total + 3) >> 2) + (int64_t)f * kThreads + threadIdx.x; k < nw;
       k += stride)
    out[k] = 0u;
  if (f == 0 && threadIdx.x == 0) *total_out = total;
}

}  // namespace

// words: int32 [B, W] (uint32 bits); total_bits: int32 [B]; out: int32
// [B * W]; total: int64 [1]. Returns cudaGetLastError() after the launch.
extern "C" int flac_compact_stream(const void* words, const void* total_bits, void* out,
                                   void* total, int32_t B, int32_t W, void* stream) {
  compact_stream_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)total_bits, (uint32_t*)out,
      (int64_t*)total, B, W);
  return (int)cudaGetLastError();
}
