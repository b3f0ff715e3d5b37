// The FLAC field packer's pack stage on NVIDIA Hopper (sm_90a): one kernel
// that turns a batch of frames' (value, nbits) fields into their packed
// big-endian 32-bit words, with the CRC-16 of each frame computed from the
// words and inserted into its last 16 bits.
//
// Replaces flac_tpu/encode/packer.py::_pack_words_pallas (the banded fill,
// call at :443) and _pack_words_pallas_multi (the merged-slot fill, call at
// :678), together with what flac_tpu's pack() stage runs around them
// (flac_tpu/encode/frame_encoder.py:843-868): the prefix sum of nbits, the
// two merge rounds of pack_fields_pallas_merged, crc16_from_words and
// insert_crc16. The outputs are theirs bit for bit: words [B, maxwords]
// int32 and total_bits [B] int32. Two instantiations share the code:
//   banded  field i (<= 33 significant bits, ending at bit e_i) gives c1 to
//           word we-1 and c0 to word we, we = (e_i - 1) >> 5;
//   merged  a thread merges its quads of fields in registers (two pairwise
//           rounds of packer._merge_round) into a merged slot of <= 63
//           significant bits and up to three spill slots, each giving up to
//           three contributions to words we-2 .. we.
// Every contribution is bit-disjoint from the others (values are pre-masked
// to their nbits), so OR equals the sum the plain versions take, in any
// order. Contributions outside [0, maxwords) are dropped.
//
// Design. One thread block (256 threads) a frame. The TPU kernels' (frame
// group x word tile x field chunk) grid, tile-bound binary searches and
// nonzero bitmap only scheduled a grid that runs in order; here
//   1. the block walks the frame's fields in chunks of 2,048 (8 consecutive
//      fields a thread, two merge quads): it loads nbits, takes a block-wide
//      exclusive scan (warp shuffles, then the 8 warp totals) for every
//      field's end bit, and carries the running total to the next chunk, so
//      no cumsum runs outside and the block writes total_bits itself;
//   2. each thread ORs its contributions into a shared-memory tile of the
//      frame's words: consecutive contributions to one word are merged in a
//      register and go in with one shared atomicOr when the word changes
//      (the words of a thread's nonzero contributions never decrease);
//   3. with the CRC (the mode pack() launches), thread t folds a run of
//      consecutive tile words into A_t = sum_i w_i x^(32 (last - i)) mod G
//      by Horner's rule with four 256-entry byte tables in shared memory,
//      then multiplies A_t by tbl[last] = x^(32 (W - 1 - last) + 16) mod G:
//      the sum of crc16_from_words' per-word products, rearranged. An XOR
//      block reduction, the pad fix-up by inv[4W - nbytes + 2] and the
//      insertion (an add, as insert_crc16) follow in shared memory;
//   4. the tile goes out in one coalesced pass: every word is written, so the
//      output needs no memset.
// Frames whose words exceed the shared tile (kMaxTileWords) are split into
// word tiles, one block each: such a block scans the frame's nbits itself and
// loads values only for the threads whose contributions can reach its tile;
// with the CRC it writes a partial, and crc_finish_kernel (one thread a
// frame) combines the partials and inserts the CRC into device memory.
//
// Bound: memory. A call reads values (8 bytes) and nbits (4) of every field
// once, and writes the words and total_bits once; the CRC's integer work
// (about 100 operations a word in crc16_from_words' bit loops, a dozen in the
// table form here) stays under that. What holds it back is the walk: a block
// takes its frame's chunks in order, a load round trip and two barriers a
// chunk, so a frame costs that chain however few frames run beside it, and a
// small batch (64 frames on 132 SMs) is bound by it, not by memory. Loading
// the next chunk ahead in registers cost more occupancy at 512 frames than
// it hid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFieldsPerThread = 8;                  // two merge quads
constexpr int kChunk = kThreads * kFieldsPerThread;  // fields a block step
constexpr int kMaxTileWords = 49152;                 // 192 KB of shared memory
constexpr uint32_t kG16 = 0x18005u;                  // x^16 + x^15 + x^2 + 1
constexpr unsigned kFull = 0xFFFFFFFFu;

// v mod G for v < 2^(top + 1)
__device__ __forceinline__ uint32_t reduce_g16(uint32_t v, int top) {
  for (int bit = top; bit >= 16; --bit) v ^= ((v >> bit) & 1u) * (kG16 << (bit - 16));
  return v;
}

// a * b mod G for a, b < 2^16 (a carryless product of < 31 bits, reduced)
__device__ __forceinline__ uint32_t mulmod_g16(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) p ^= ((b >> i) & 1u) * (a << i);
  return reduce_g16(p, 30);
}

// the CRC-16 (crc < 2^16) added into a frame's last 16 bits, as insert_crc16:
// word we gets crc << (32 - rr), word max(we - 1, 0) gets crc >> rr when the
// CRC straddles two words (rr < 16); row holds the frame's n words
__device__ __forceinline__ void insert_crc(uint32_t* row, int32_t n, int32_t end,
                                           uint32_t crc) {
  if (end <= 0) return;                // no frame to sign
  const int32_t we = (end - 1) >> 5;
  const int32_t rr = end - (we << 5);  // [1, 32]
  if (we < n) row[we] += crc << (32 - rr);
  const int32_t w1 = we >= 1 ? we - 1 : 0;
  if (rr < 16 && w1 < n) row[w1] += crc >> rr;
}

// crc of a frame from the XOR of its words' products (< 2^16) and its bit
// count: the pad fix-up of crc16_from_words (pad bytes after the message =
// 4W - nbytes + 2), its index kept inside inv
__device__ __forceinline__ uint32_t finish_crc(uint32_t acc, int32_t total,
                                               const int32_t* inv, int32_t maxwords) {
  const int32_t nbytes = (total + 7) >> 3;
  int64_t pad = 4 * (int64_t)maxwords - nbytes + 2;
  const int64_t ninv = 4 * (int64_t)maxwords + 3;
  pad = pad < 0 ? 0 : (pad >= ninv ? ninv - 1 : pad);
  return mulmod_g16(acc, (uint32_t)inv[pad] & 0xFFFFu);
}

// row[f0 .. f0 + kFieldsPerThread) of a frame's n fields, zeros past its end
template <typename T>
__device__ __forceinline__ void load_fields(const T* row, int32_t f0, int32_t n,
                                            T* out) {
#pragma unroll
  for (int j = 0; j < kFieldsPerThread; ++j) out[j] = f0 + j < n ? row[f0 + j] : T(0);
}

struct Slot {
  uint64_t v;  // < 2^63
  int32_t e;   // end bit
  int32_t s;   // significant bits
};

// packer._merge_round on one pair (L ends before R): R joins L's value when
// the two fit in 63 bits, else R spills
__device__ __forceinline__ void merge_pair(const Slot& L, const Slot& R, Slot& M,
                                           Slot& S) {
  const int64_t d = (int64_t)R.e - (int64_t)L.e;
  const bool fit = L.s == 0 || (int64_t)L.s + d <= 63;
  const int dc = d < 0 ? 0 : (d > 63 ? 63 : (int)d);
  if (fit) {
    M.v = (L.s > 0 ? L.v << dc : 0ull) | R.v;
    M.e = R.e;
    M.s = L.s > 0 ? L.s + (int32_t)d : R.s;
  } else {
    M = L;
  }
  S.v = fit ? 0ull : R.v;
  S.e = R.e;
  S.s = fit ? 0 : R.s;
}

// A thread's contributions, merged per word in a register. put() takes
// them in order; a change of word sends the pending one to the tile.
struct WordSink {
  uint32_t* tile;
  int32_t w_lo, w_hi;
  int32_t idx = INT32_MIN;
  uint32_t val = 0u;
  __device__ __forceinline__ void flush() {
    if (val != 0u && idx >= w_lo && idx < w_hi) atomicOr(tile + (idx - w_lo), val);
  }
  __device__ __forceinline__ void put(int32_t w, uint32_t c) {
    if (c == 0u) return;
    if (w != idx) {
      flush();
      idx = w;
      val = c;
    } else {
      val |= c;
    }
  }
  // the <= 3 contributions of a slot of <= 63 significant bits ending at e
  __device__ __forceinline__ void put_slot(uint64_t v, int32_t e) {
    if (v == 0ull) return;
    const int32_t we = (e - 1) >> 5;
    const int32_t r = e - (we << 5);           // [1, 32]
    const uint64_t v1 = v >> r;                // shift in [1, 32]
    put(we - 2, (uint32_t)(v1 >> 32));
    put(we - 1, (uint32_t)v1);
    put(we, (uint32_t)((v & 0xFFFFFFFFull) << (32 - r)));  // shift in [0, 31]
  }
};

// One thread's kFieldsPerThread consecutive fields (nbits, values, end bits)
// into the sink: the banded fill's c1, c0 of each field, or the merged
// fill's slots of each quad.
template <bool MERGED>
__device__ __forceinline__ void put_fields(WordSink& sink, const int32_t* nb,
                                           const int64_t* v, const int32_t* e) {
  if constexpr (MERGED) {
#pragma unroll
    for (int q = 0; q < kFieldsPerThread; q += 4) {
      Slot f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t n = nb[q + j];
        f[j].v = n > 0 ? (uint64_t)v[q + j] : 0ull;
        f[j].e = e[q + j];
        f[j].s = n < 33 ? n : 33;
      }
      Slot m0, s0, m1, s1, m, s2;
      merge_pair(f[0], f[1], m0, s0);
      merge_pair(f[2], f[3], m1, s1);
      merge_pair(m0, m1, m, s2);
      sink.put_slot(s0.v, s0.e);
      sink.put_slot(s1.v, s1.e);
      if (m.e <= s2.e) {  // the spilled right half ends last
        sink.put_slot(m.v, m.e);
        sink.put_slot(s2.v, s2.e);
      } else {
        sink.put_slot(s2.v, s2.e);
        sink.put_slot(m.v, m.e);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFieldsPerThread; ++j) {
      if (nb[j] <= 0) continue;  // an empty field contributes nothing
      const int32_t we = (e[j] - 1) >> 5;
      const int32_t r = e[j] - (we << 5);  // [1, 32]
      const uint64_t u = (uint64_t)v[j];
      sink.put(we - 1, (uint32_t)(u >> r));
      sink.put(we, (uint32_t)(u << (32 - r)));  // low 32 bits kept
    }
  }
}

template <bool MERGED, bool CRC>
__global__ void __launch_bounds__(kThreads)
pack_frames_kernel(const int64_t* __restrict__ values,
                   const int32_t* __restrict__ nbits,
                   uint32_t* __restrict__ words, int32_t* __restrict__ total_bits,
                   const int32_t* __restrict__ tbl, const int32_t* __restrict__ inv,
                   uint32_t* __restrict__ partials, int32_t nfields,
                   int32_t maxwords, int32_t tile_words, int32_t ntiles) {
  extern __shared__ uint32_t tile[];
  __shared__ int32_t warp_sum[kWarps];
  __shared__ uint32_t warp_xor[kWarps];
  // b * x^16, x^24, x^32, x^40 mod G for every byte b
  __shared__ uint16_t crc_tab[CRC ? 4 : 1][256];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t frame = blockIdx.x / ntiles;
  const int32_t w_lo = (int32_t)(blockIdx.x % ntiles) * tile_words;
  const int32_t w_hi = min(maxwords, w_lo + tile_words);
  const int32_t nw = w_hi - w_lo;
  const bool whole = ntiles == 1;  // the tile is the whole frame

  for (int i = threadIdx.x; i < nw; i += kThreads) tile[i] = 0u;
  if constexpr (CRC) {
    for (int b = threadIdx.x; b < 256; b += kThreads) {
      uint32_t t = reduce_g16((uint32_t)b << 16, 23);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        crc_tab[k][b] = (uint16_t)t;
        t = reduce_g16(t << 8, 23);
      }
    }
  }
  __syncthreads();

  const int64_t* vrow = values + frame * (int64_t)nfields;
  const int32_t* nrow = nbits + frame * (int64_t)nfields;
  WordSink sink{tile, w_lo, w_hi};
  int32_t carry = 0;  // bits of the frame before this chunk
  for (int32_t base = 0; base < nfields; base += kChunk) {
    const int32_t f0 = base + (int32_t)threadIdx.x * kFieldsPerThread;
    int32_t nb[kFieldsPerThread];
    int64_t v[kFieldsPerThread];
    load_fields(nrow, f0, nfields, nb);
    if (whole) load_fields(vrow, f0, nfields, v);
    int32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kFieldsPerThread; ++j) sum += nb[j];
    int32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int32_t before = 0, chunk_bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t s = warp_sum[w];
      before += w < warp ? s : 0;
      chunk_bits += s;
    }
    __syncthreads();  // warp_sum is written again by the next chunk
    int32_t e[kFieldsPerThread];
    int32_t run = carry + before + incl - sum;
#pragma unroll
    for (int j = 0; j < kFieldsPerThread; ++j) {
      run += nb[j];
      e[j] = run;
    }
    carry += chunk_bits;
    bool take = true;
    if (!whole) {
      // contributions land in words [we(first) - 2, we(last)]
      const int32_t lo = ((e[0] - 1) >> 5) - 2;
      const int32_t hi = (e[kFieldsPerThread - 1] - 1) >> 5;
      take = hi >= w_lo && lo < w_hi && f0 < nfields;
      if (take) load_fields(vrow, f0, nfields, v);
    }
    if (take) put_fields<MERGED>(sink, nb, v, e);
  }
  sink.flush();
  if (w_lo == 0 && threadIdx.x == 0) total_bits[frame] = carry;
  __syncthreads();

  if constexpr (CRC) {
    // thread t folds tile words [t k, t k + k); k odd keeps the lanes'
    // shared-memory reads on distinct banks
    const int32_t k = ((nw + kThreads - 1) / kThreads) | 1;
    const int32_t lo = (int32_t)threadIdx.x * k;
    const int32_t hi = min(lo + k, nw);
    uint32_t part = 0u;
    if (lo < hi) {
      uint32_t acc = 0u;
      for (int32_t i = lo; i < hi; ++i) {
        const uint32_t w = tile[i];
        acc = crc_tab[3][acc >> 8] ^ crc_tab[2][acc & 0xFFu] ^ crc_tab[1][w >> 24] ^
              crc_tab[0][(w >> 16) & 0xFFu] ^ (w & 0xFFFFu);
      }
      part = mulmod_g16(acc, (uint32_t)tbl[w_lo + hi - 1] & 0xFFFFu);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part ^= __shfl_xor_sync(kFull, part, o);
    if (lane == 0) warp_xor[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t acc = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc ^= warp_xor[w];
      if (whole)
        insert_crc(tile, nw, carry, finish_crc(acc, carry, inv, maxwords));
      else
        partials[blockIdx.x] = acc;
    }
    __syncthreads();
  }

  uint32_t* out = words + frame * (int64_t)maxwords + w_lo;
  for (int i = threadIdx.x; i < nw; i += kThreads) out[i] = tile[i];
}

// The tiled path's CRC: one thread a frame XORs its tiles' partials, applies
// the pad fix-up and adds the CRC into the frame's words in device memory.
__global__ void crc_finish_kernel(uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ total_bits,
                                  const int32_t* __restrict__ inv,
                                  const uint32_t* __restrict__ partials, int64_t batch,
                                  int32_t maxwords, int32_t ntiles) {
  const int64_t frame = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (frame >= batch) return;
  uint32_t acc = 0u;
  for (int32_t t = 0; t < ntiles; ++t) acc ^= partials[frame * ntiles + t];
  const int32_t total = total_bits[frame];
  insert_crc(words + frame * (int64_t)maxwords, maxwords, total,
             finish_crc(acc, total, inv, maxwords));
}

template <bool MERGED, bool CRC>
cudaError_t launch(const void* values, const void* nbits, void* words, void* total_bits,
                   const void* tbl, const void* inv, void* partials, int64_t batch,
                   int32_t nfields, int32_t maxwords, int32_t tile_words,
                   int32_t ntiles, cudaStream_t stream) {
  const int32_t tile = maxwords < tile_words ? maxwords : tile_words;
  if (tile * 4 > 48 * 1024) {  // above 48 KB only after this, on each device
    const cudaError_t err = cudaFuncSetAttribute(
        pack_frames_kernel<MERGED, CRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tile * 4);
    if (err != cudaSuccess) return err;
  }
  pack_frames_kernel<MERGED, CRC><<<(unsigned int)(batch * ntiles), kThreads,
                                    (size_t)tile * 4, stream>>>(
      (const int64_t*)values, (const int32_t*)nbits, (uint32_t*)words,
      (int32_t*)total_bits, (const int32_t*)tbl, (const int32_t*)inv,
      (uint32_t*)partials, nfields, maxwords, tile, ntiles);
  return cudaGetLastError();
}

}  // namespace

// Words of one block's shared tile at most: a frame with more words is
// split into tiles of this many words (or of a smaller tile_words).
extern "C" int flac_pack_frames_tile_words() { return kMaxTileWords; }

// values int64 [B, F] (pre-masked to their nbits), nbits int32 [B, F]; out:
// words int32 [B, maxwords] and total_bits int32 [B], every element written.
// merged selects the merged-slot fill. With crc, tbl int32 [maxwords] and
// inv int32 [4 maxwords + 3] are crc16_word_tables(maxwords), and the CRC-16
// is inserted into each frame's (zero) last 16 bits; a frame of more than
// tile_words words (0: flac_pack_frames_tile_words()) is split into tiles,
// and then partials (uint32 [B, ntiles]) take each tile's share of the CRC
// for flac_pack_frames_crc_finish. Returns cudaGetLastError().
extern "C" int flac_pack_frames(const void* values, const void* nbits, void* words,
                                void* total_bits, const void* tbl, const void* inv,
                                void* partials, int64_t batch, int32_t nfields,
                                int32_t maxwords, int32_t tile_words, int32_t merged,
                                int32_t crc, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (nfields <= 0 || maxwords <= 0) return (int)cudaErrorInvalidValue;
  if (tile_words <= 0 || tile_words > kMaxTileWords) tile_words = kMaxTileWords;
  const int32_t ntiles = (maxwords + tile_words - 1) / tile_words;
  if (batch * ntiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  if (crc && ntiles > 1 && partials == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (merged)
    err = crc ? launch<true, true>(values, nbits, words, total_bits, tbl, inv, partials,
                                   batch, nfields, maxwords, tile_words, ntiles, s)
              : launch<true, false>(values, nbits, words, total_bits, tbl, inv, partials,
                                    batch, nfields, maxwords, tile_words, ntiles, s);
  else
    err = crc ? launch<false, true>(values, nbits, words, total_bits, tbl, inv, partials,
                                    batch, nfields, maxwords, tile_words, ntiles, s)
              : launch<false, false>(values, nbits, words, total_bits, tbl, inv,
                                     partials, batch, nfields, maxwords, tile_words,
                                     ntiles, s);
  return (int)err;
}

// The tiled path's second kernel: after flac_pack_frames with crc on a frame
// of ntiles > 1 tiles, combines partials [B, ntiles] and inserts each
// frame's CRC-16 into words [B, maxwords]. Returns cudaGetLastError().
extern "C" int flac_pack_frames_crc_finish(void* words, const void* total_bits,
                                           const void* inv, const void* partials,
                                           int64_t batch, int32_t maxwords,
                                           int32_t ntiles, void* stream) {
  if (batch > 0) {
    const int threads = 128;
    crc_finish_kernel<<<(unsigned int)((batch + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)words, (const int32_t*)total_bits, (const int32_t*)inv,
        (const uint32_t*)partials, batch, maxwords, ntiles);
  }
  return (int)cudaGetLastError();
}
