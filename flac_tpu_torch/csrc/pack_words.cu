// Packed-frame word fills for the FLAC field packer, on NVIDIA Hopper
// (sm_90a): the banded fill (flac_pack_words) and the merged-slot fill
// (flac_pack_words_multi, further down).
//
// Replaces flac_tpu/encode/packer.py::_pack_words_pallas, the Pallas banded
// word fill for the TPU. Same function: frame b's word w is the OR of c0 over
// the fields whose last bit lies in word w and c1 over the fields whose last
// bit lies in word w+1. A field holds at most 33 significant bits
// (packer.MAX_SIG_BITS), so it touches at most two words, and the
// contributions of different fields are bit-disjoint (values are pre-masked
// to their nbits): OR equals the sum the TPU kernel takes, and the result
// does not depend on the order of the atomics.
//
// Design: one thread per field, grid-stride. Each thread turns its field's
// (value, end) into the two word contributions and atomicOr's them into the
// zeroed output. A field's length is its end less the previous field's end,
// which a neighbouring thread has just read, so nbits is not read at all. The TPU's (8-frame x 256-word x 1024-field) grid
// and one-hot compare-select-adds existed because a TPU grid runs in order
// and scatters serialize on it; here the fields are independent threads.
// Zero-length fields exit at once, so thousands of them in one word cost
// nothing, and contributions of 0 issue no atomic.
//
// Bound: memory. Per call it reads B*F*(8+4) bytes (values, ends) and
// writes B*maxwords*4; the atomics land on words that neighbouring threads
// share, and resolve in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack_words_kernel(const int64_t* __restrict__ values,
                                  const int32_t* __restrict__ ends,
                                  unsigned int* __restrict__ words,
                                  int64_t nfields, int32_t fields_per_frame,
                                  int32_t maxwords) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nfields; i += stride) {
    const int64_t frame = i / fields_per_frame;
    const int32_t end = ends[i];
    // an empty field (nbits == 0) ends where the previous one ends
    const int32_t start = i == frame * fields_per_frame ? 0 : ends[i - 1];
    if (end <= start) continue;               // so end >= 1 below
    const int32_t we = (end - 1) >> 5;        // word holding the last bit
    const int32_t r = end - (we << 5);        // its bits in that word, [1, 32]
    const uint64_t v = (uint64_t)values[i];
    // both shift amounts stay inside [0, 63]: a full-width shift is undefined
    const uint32_t c0 = (uint32_t)(v << (32 - r));   // low 32 bits kept
    const uint32_t c1 = (uint32_t)(v >> r);
    unsigned int* row = words + frame * (int64_t)maxwords;
    // contributions outside [0, maxwords) are dropped, as in the plain version
    if (c0 != 0u && we < maxwords) atomicOr(row + we, c0);
    if (c1 != 0u && we >= 1 && we - 1 < maxwords) atomicOr(row + we - 1, c1);
  }
}

// Merged-slot fill. Replaces flac_tpu/encode/packer.py::_pack_words_pallas_multi
// (call at :678), which the merged packer launches once per slot array
// (spill 1, spill 2, merged; pack_fields_pallas_merged :553-581). A slot
// holds a merged value of <= 63 significant bits that ends at bit `end`;
// contribution j (NCON of them) lands in word we - j. The three arrays'
// contributions are bit-disjoint (packer.py:514-516), so OR-ing all three
// launches into one zeroed buffer gives the sum flac_tpu takes.
//
// Design: one thread per slot, grid-stride; the contributions are formed in
// registers and atomicOr'ed, zeros skipped. The TPU kernel's tile bounds and
// its scalar-prefetched nonzero bitmap (for the spill arrays, almost always
// all zero) only schedule a sequential grid: here an all-zero slot exits
// after one 8-byte load. Bound: memory, as the banded fill. Over the three
// launches each of the F slots (F/2 + F/4 + F/4) has its value (8 bytes) and
// end (4 bytes) read once; the words are written once.
template <int NCON>
__global__ void pack_words_multi_kernel(const int64_t* __restrict__ values,
                                        const int32_t* __restrict__ ends,
                                        unsigned int* __restrict__ words,
                                        int64_t nslots, int32_t slots_per_frame,
                                        int32_t maxwords) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nslots; i += stride) {
    const uint64_t v = (uint64_t)values[i];   // < 2^63: never negative
    if (v == 0u) continue;
    const int32_t end = ends[i];              // >= 1 for a nonzero value
    const int32_t we = (end - 1) >> 5;
    const int32_t r = end - (we << 5);        // [1, 32]
    uint32_t c[3];
    c[0] = (uint32_t)((v & 0xFFFFFFFFull) << (32 - r));  // shift in [0, 31]
    const uint64_t v1 = v >> r;                         // shift in [1, 32]
    c[1] = (uint32_t)v1;
    c[2] = (uint32_t)(v1 >> 32);
    unsigned int* row = words + (i / slots_per_frame) * (int64_t)maxwords;
#pragma unroll
    for (int j = 0; j < NCON; ++j) {
      const int32_t w = we - j;
      if (c[j] != 0u && w >= 0 && w < maxwords) atomicOr(row + w, c[j]);
    }
  }
}

}  // namespace

// values int64 [B, S] (merged slots, < 2^63), ends int32 [B, S] (each slot's
// end bit), words int32 [B, maxwords]: OR'ed into, not cleared (the caller
// zeroes it once for the three launches of a batch). Returns
// cudaGetLastError().
extern "C" int flac_pack_words_multi(const void* values, const void* ends,
                                     void* words, int64_t batch,
                                     int32_t slots_per_frame, int32_t maxwords,
                                     void* stream) {
  const int64_t nslots = batch * (int64_t)slots_per_frame;
  if (nslots > 0) {
    const int threads = 256;
    int64_t blocks = (nslots + threads - 1) / threads;
    const int64_t max_blocks = 132 * 32;
    if (blocks > max_blocks) blocks = max_blocks;
    pack_words_multi_kernel<3><<<(unsigned int)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
        (const int64_t*)values, (const int32_t*)ends, (unsigned int*)words,
        nslots, slots_per_frame, maxwords);
  }
  return (int)cudaGetLastError();
}

// values int64 [B, F] (pre-masked, <= 33 significant bits), ends (the
// inclusive prefix sum of nbits along F) int32 [B, F], words int32
// [B, maxwords] zeroed by the caller. Launches on `stream`; returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int flac_pack_words(const void* values, const void* ends,
                               void* words, int64_t batch,
                               int32_t fields_per_frame, int32_t maxwords,
                               void* stream) {
  const int64_t nfields = batch * (int64_t)fields_per_frame;
  if (nfields > 0) {
    const int threads = 256;
    int64_t blocks = (nfields + threads - 1) / threads;
    const int64_t max_blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
    if (blocks > max_blocks) blocks = max_blocks;
    pack_words_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int64_t*)values, (const int32_t*)ends, (unsigned int*)words,
        nfields, fields_per_frame, maxwords);
  }
  return (int)cudaGetLastError();
}
