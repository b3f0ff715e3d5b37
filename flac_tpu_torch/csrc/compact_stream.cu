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
// Bound. Bytes: the valid words are read once (sum of ceil(nbytes_f / 4)
// words), total_bits once, and the B * W output words written once, at
// 3.35 TB/s; there is no arithmetic to speak of. At the encoder's batches
// of 64 frames that is about 1.9 MB, 0.56 us, less than the launch of a
// grid that fills the card: there the launch and two dependent memory round
// trips (total_bits, then the frames' words) bound it; at 512 frames the
// instructions a word costs do. What the design does about each:
//   - output-driven: block b takes the chunks of kChunk = 512 output words
//     c = b, b + gridDim.x, ..., whatever the frames' sizes; the grid is one
//     block a chunk up to what the card holds at once (132 SMs x the
//     occupancy), so every SM has work at B = 64 (625 blocks) and a block
//     scans the starts once for several chunks at B = 512. Tiny frames
//     (constant or silent ones of 10-20 bytes, many to a chunk) balance as
//     well as full ones;
//   - shared byte starts: each block scans ceil(total_bits / 8) once in
//     int64 into shared memory (a thread's run of frames read straight from
//     total_bits, a warp scan, the warp totals, two barriers): every frame's
//     byte start, and the stream's total in starts[B]. B is bounded by what
//     shared memory holds (kMaxFrames);
//   - owner computes, 16-byte stores: thread t owns words 4t .. 4t + 3 of a
//     chunk and stores them as one uint4. It finds the frame f of its first
//     byte by a binary search over the shared starts. When all 16 bytes lie
//     inside f (all but one group a frame boundary), its 5 source words are
//     loaded at once and each output word is a funnel shift
//     (__funnelshift_l) of two of them at the frame's byte phase: a few
//     dozen instructions a group. Otherwise (crossing_words) each word
//     advances f, and every load of the 4 words is issued, predicated,
//     before any is used; a word is masked past f's tail and, where it
//     crosses into frame f + 1, that frame's head is ORed in. A word spans
//     at most two frames because every frame holds at least 4 bytes (a FLAC
//     frame holds at least 10), which the caller guarantees;
//   - the zero tail in the same pass: words at or past ceil(total / 4) are
//     stored as zeros without any load, by the thread that owns them;
//   - programmatic dependent launch: the kernel is launched with
//     cudaLaunchAttributeProgrammaticStreamSerialization, so its launch and
//     block dispatch overlap the tail of the kernel before it on the stream
//     (pack_frames_kernel on the encoder's dense route, whose implicit
//     trigger at block exit is enough); griddepcontrol.wait holds every
//     read of words and total_bits, and every write, until that kernel has
//     finished and its writes are visible.
// tools/torch_compact_variants.py builds edited copies of this file (other
// block sizes, one block a chunk, no programmatic dependent launch) and
// times them against it on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 4;  // output words a block takes at a time
// shared memory holds (B + 1) int64 starts: 16,385 entries, 128 KB
constexpr int kMaxFrames = 16384;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// the largest f in [0, B) with starts[f] <= byte (starts[0] = 0 <= byte)
__device__ __forceinline__ int frame_of(const int64_t* starts, int B, int64_t byte) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= byte) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int64_t frame_bytes(const int32_t* __restrict__ total_bits,
                                               int g) {
  return ((int64_t)__ldg(total_bits + g) + 7) >> 3;
}

// The 4 words at stream bytes b0 .. b0 + 15 (b0 < total) when they cross a
// frame's end or the stream's, f the frame of byte b0: every load first,
// then the shifts. Word i: frame f's bytes from o on (f advanced to the
// word's frame), o = b0 + 4i - start_f at phase q = o & 3, is the funnel
// shift of source words j = o / 4 and j + 1 (the latter only at a phase and
// inside the frame); where fewer than 4 of its bytes are f's (keep < 4) the
// rest are masked and frame f + 1's word 0 is ORed in. Past the stream's end
// a, b, h stay 0 and keep 4: a zero.
__device__ __forceinline__ void crossing_words(const uint32_t* __restrict__ words,
                                               const int64_t* starts, int B, int W,
                                               int64_t total, int64_t b0, int f,
                                               uint32_t w[4]) {
  uint32_t a[4] = {0u, 0u, 0u, 0u}, b[4] = {0u, 0u, 0u, 0u}, h[4] = {0u, 0u, 0u, 0u};
  int shift[4] = {0, 0, 0, 0}, keep[4] = {4, 4, 4, 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t byte = b0 + 4 * i;
    if (byte < total) {
      while (starts[f + 1] <= byte) ++f;
      const int o = (int)(byte - starts[f]), nb = (int)(starts[f + 1] - starts[f]);
      const int j = o >> 2;
      const uint32_t* __restrict__ row = words + (int64_t)f * W;
      a[i] = __ldg(row + j);
      if ((o & 3) && 4 * (j + 1) < nb) b[i] = __ldg(row + j + 1);
      // frame f + 1 holds at least 4 bytes, so its word 0 covers the rest
      if (nb - o < 4 && f + 1 < B) h[i] = __ldg(row + W);
      shift[i] = 8 * (o & 3);
      keep[i] = min(nb - o, 4);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = __funnelshift_l(b[i], a[i], shift[i]);
    if (keep[i] < 4)
      w[i] = (w[i] & (0xFFFFFFFFu << (32 - 8 * keep[i]))) | (h[i] >> (8 * keep[i]));
  }
}

// Block b takes the chunks of kChunk output words c = b, b + gridDim.x, ...;
// thread t owns words 4t .. 4t + 3 of each.
__global__ void __launch_bounds__(kThreads)
compact_stream_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ total_bits,
                      uint32_t* __restrict__ out, int64_t* __restrict__ total_out,
                      int32_t B, int32_t W) {
  extern __shared__ int64_t starts[];  // [B + 1]: byte starts, then the total
  __shared__ int64_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  wait_for_previous_grid();

  // byte starts: thread t sums its run of `per` frames straight from
  // total_bits, a warp scan, the warp totals; then it writes its run
  const int per = (B + kThreads - 1) / kThreads;
  const int g0 = min((int)threadIdx.x * per, B), g1 = min(g0 + per, B);
  int64_t local = 0;
#pragma unroll 4
  for (int g = g0; g < g1; ++g) local += frame_bytes(total_bits, g);
  int64_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int64_t run = incl - local, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int64_t s = warp_sum[w];
    if (w < warp) run += s;
    total += s;
  }
  for (int g = g0; g < g1; ++g) {
    starts[g] = run;
    run += frame_bytes(total_bits, g);
  }
  if (threadIdx.x == 0) starts[B] = total;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = total;

  // a thread's 4 words k0 .. k0 + 3, at stream bytes b0 = 4 k0 on, then one
  // 16-byte store
  const int64_t nw = (int64_t)B * W;
  const int64_t nv = (total + 3) >> 2;  // words holding stream bytes
  const int64_t nchunks = (nw + kChunk - 1) / kChunk;
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int64_t k0 = c * kChunk + 4 * threadIdx.x;
    if (k0 >= nw) break;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (k0 < nv) {
      const int64_t b0 = 4 * k0;
      const int f = frame_of(starts, B, b0);
      const int64_t start = starts[f], end = starts[f + 1];
      if (b0 + 16 <= end) {
        // all 16 bytes inside frame f: source words j .. j + 4 (the last
        // only at a phase and inside the frame), one funnel shift a word
        const int o = (int)(b0 - start), nb = (int)(end - start), j = o >> 2;
        const uint32_t* __restrict__ src = words + (int64_t)f * W + j;
        uint32_t s[5];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = __ldg(src + i);
        s[4] = (o & 3) && 4 * (j + 4) < nb ? __ldg(src + 4) : 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __funnelshift_l(s[i + 1], s[i], 8 * (o & 3));
      } else {
        crossing_words(words, starts, B, W, total, b0, f, w);
      }
    }
    if (k0 + 4 <= nw) {
      *reinterpret_cast<uint4*>(out + k0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + i < nw) out[k0 + i] = w[i];
    }
  }
}

// An empty kernel launched as the compaction is: the least a launch of its
// grid costs on the card, with or without programmatic dependent launch.
__global__ void __launch_bounds__(kThreads) launch_probe_kernel() {
  wait_for_previous_grid();
}

// The grid for nw output words: one block a chunk, at most as many as the
// card holds at once (then each block takes several chunks, and its scan
// of the starts once). Cached for the last device and shared memory size.
cudaError_t grid_for(int64_t nw, size_t smem, int* blocks) {
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != cached_dev) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached_smem = 0;
  }
  if (e == cudaSuccess && smem + kWarps * sizeof(int64_t) > kStaticSmemLimit)
    e = cudaFuncSetAttribute(compact_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && smem != cached_smem)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_stream_kernel, kThreads,
                                                      smem);
  if (e != cudaSuccess) {
    cached_dev = -1;
    return e;
  }
  cached_dev = dev;
  cached_smem = smem;
  const int64_t nchunks = (nw + kChunk - 1) / kChunk;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(nchunks < cap ? nchunks : cap);
  return cudaSuccess;
}

// Launches `kernel` on `blocks` blocks of kThreads with `args` (pointers to
// its parameters), allowed to overlap the kernel before it on the stream
// when pdl is nonzero.
cudaError_t launch(const void* kernel, unsigned int blocks, size_t smem, int pdl,
                   void* stream, void** args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

}  // namespace

extern "C" int flac_compact_stream_max_frames() { return kMaxFrames; }

// words: int32 [B, W] (uint32 bits); total_bits: int32 [B]; out: int32
// [B * W], 16-byte aligned; total: int64 [1]. 1 <= B <= kMaxFrames,
// W < 2^28 (a frame's byte offsets fit an int) and B * W < 2^31. Returns the
// launch's CUDA error (0 when it was queued).
extern "C" int flac_compact_stream(const void* words, const void* total_bits, void* out,
                                   void* total, int32_t B, int32_t W, void* stream) {
  if (B < 1 || B > kMaxFrames || W < 1 || W >= (1 << 28) || (int64_t)B * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(B + 1) * sizeof(int64_t);
  int blocks = 0;
  cudaError_t e = grid_for((int64_t)B * W, smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  const uint32_t* w = (const uint32_t*)words;
  const int32_t* tb = (const int32_t*)total_bits;
  uint32_t* o = (uint32_t*)out;
  int64_t* t = (int64_t*)total;
  void* args[] = {&w, &tb, &o, &t, &B, &W};
  e = launch((const void*)compact_stream_kernel, (unsigned int)blocks, smem, 1, stream, args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The number of blocks the compaction launches for B x W words on the
// current device, or -1 on a CUDA error.
extern "C" int flac_compact_stream_blocks(int32_t B, int32_t W) {
  int blocks = 0;
  return grid_for((int64_t)B * W, (size_t)(B + 1) * sizeof(int64_t), &blocks) == cudaSuccess
             ? blocks
             : -1;
}

// Launches launch_probe_kernel on `blocks` blocks, with programmatic
// dependent launch when pdl is nonzero. Returns the launch's CUDA error.
extern "C" int flac_compact_launch_probe(int32_t blocks, int32_t pdl, void* stream) {
  void* none[1] = {nullptr};
  const cudaError_t e = launch((const void*)launch_probe_kernel, (unsigned int)blocks, 0, pdl,
                               stream, none);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
