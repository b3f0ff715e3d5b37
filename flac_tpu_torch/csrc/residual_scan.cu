// Residual/verbatim window scan of the FLAC frame decoder, on NVIDIA Hopper
// (sm_90a).
//
// Replaces flac_tpu/decode/frame_decoder.py::_narrow_residual_scan (:130-293,
// the lax.scan at :290-291), which reads one subframe of every frame of a
// batch: Rice partitions (parameter, escape, unary run, LSBs), escaped raw
// samples and verbatim samples. The scan's batch axis becomes threads: one
// thread per frame, which keeps the scan's step structure exactly, because
// `ovf` decides which frames go to the host decoder and must equal
// flac_tpu's on every frame:
//   - U=4 samples a step from a 256-bit window of 8 uint32 limbs held in
//     registers and carried across steps; one window slide per sample;
//   - up to 3 word refills at the end of each step;
//   - ovf on a unary run of >= 48 zeros, a Rice fold q * 2^k >= 2^30, or a
//     step that spends more bits than its window held.
// All arithmetic is int32/uint32 as in flac_tpu; every 32-bit shift amount
// stays in [0, 31] (frame_decoder.py:177-179 masks with & 31 for the same
// reason), the funnel shifts are __funnelshift_l and the unary run __clz.
//
// Bound: memory in principle (the batch's subframe bits read once, res
// written once), but each thread is one serial chain of T/4 dependent steps,
// so the kernel sits far above that bound: latency, not bytes, sets its
// time. Blocks of 32 threads spread the B chains over as many SMs as
// possible; at B=512 there are only 512 chains for 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kU = 4;      // samples per step
constexpr int kNload = 3;  // word refills per step
constexpr int kLimbs = 8;  // 32-bit limbs of the window

// bits [r, r + 32) of the 64-bit a:b, r in [0, 32)
__device__ __forceinline__ uint32_t funnel(uint32_t a, uint32_t b, int r) {
  return __funnelshift_l(b, a, (unsigned)r);
}

// sign-extend the low n bits of v, as flac_tpu's int32 shift pair
__device__ __forceinline__ int32_t se32(uint32_t v, int32_t n) {
  const int32_t sh = n > 0 ? 32 - n : 0;
  if (sh < 0) return 0;
  return (int32_t)(v << sh) >> sh;
}

__global__ void __launch_bounds__(32) residual_scan_kernel(
    const uint32_t* __restrict__ words, int64_t nwords,
    const int64_t* __restrict__ pos_in, const uint8_t* __restrict__ coded_in,
    const uint8_t* __restrict__ verb_in, const int64_t* __restrict__ ebps_in,
    const int64_t* __restrict__ order_in, const int64_t* __restrict__ plen_in,
    const int64_t* __restrict__ pesc_in, const int64_t* __restrict__ ps_in,
    int32_t* __restrict__ res, int64_t* __restrict__ pos_out,
    uint8_t* __restrict__ ovf_out, int32_t B, int32_t T) {
  const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  auto gw = [&](int32_t i) -> uint32_t {
    int64_t j = i;
    j = j < 0 ? 0 : (j > nwords - 1 ? nwords - 1 : j);
    return words[j];
  };
  const bool is_coded = coded_in[b] != 0;
  const bool is_verb = verb_in[b] != 0;
  const int32_t ebps = (int32_t)ebps_in[b];
  const int32_t order = (int32_t)order_in[b];
  const int32_t plen = (int32_t)plen_in[b];
  const int32_t pesc = (int32_t)pesc_in[b];
  const int32_t ps = (int32_t)ps_in[b];
  int64_t pos = pos_in[b];

  // initial fill: 9 words -> 8 limbs, MSB-aligned at pos
  const int32_t wi0 = (int32_t)(pos >> 5);
  const int32_t off = (int32_t)(pos & 31);
  uint32_t w[kLimbs];
  {
    uint32_t a[kLimbs + 1];
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) a[j] = gw(wi0 + j);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) w[j] = funnel(a[j], a[j + 1], off);
  }
  int32_t navail = 256 - off;
  int32_t wpos = wi0 + kLimbs;
  int32_t k = 0, rawlen = 0;
  bool ovf = false;
  int32_t* row = res + (int64_t)b * T;

  for (int32_t t0 = 0; t0 < T; t0 += kU) {
    int32_t spent = 0;
#pragma unroll
    for (int32_t jj = 0; jj < kU; ++jj) {
      const int32_t t = t0 + jj;
      if (t < T) {  // a sample past T reads nothing and slides by 0
        const bool boundary = is_coded && (ps == 0 ? t : t % ps) == 0;
        // partition parameter: always at window offset 0
        const int32_t nb = boundary ? plen : 0;
        const int32_t pv = nb > 0 ? (int32_t)(w[0] >> ((32 - nb) & 31)) : 0;
        if (boundary) k = pv;
        int32_t o = nb;
        // escape: 5-bit raw bit-length at offset <= 5
        const bool isesc_b = boundary && k == pesc;
        if (isesc_b) rawlen = (int32_t)(funnel(w[0], w[1], o) >> 27);
        o += isesc_b ? 5 : 0;
        const bool esc = k == pesc;
        const bool in_res = is_coded && t >= order;
        const bool rice_on = in_res && !esc;
        // unary run: clz over the 64 bits at offset o (o <= 10)
        const uint32_t u1 = funnel(w[0], w[1], o);
        const uint32_t u2 = funnel(w[1], w[2], o);
        const int32_t z = u1 != 0u ? __clz(u1) : 32 + __clz(u2);  // 64 if both 0
        if (rice_on && z >= 48) ovf = true;
        const int32_t q = rice_on ? min(z, 47) : 0;
        o += rice_on ? q + 1 : 0;
        // int32 fold guard: q * 2^k must stay below 2^30
        const int32_t kk = min(max(k, 0), 31);
        if (rice_on && q > (1 << max(30 - kk, 0)) - 1) ovf = true;
        // Rice LSBs: kk bits at offset o (o <= 58 -> limb 0 or 1)
        const int32_t nbk = rice_on ? kk : 0;
        const uint32_t top_k = o >= 32 ? funnel(w[1], w[2], o & 31)
                                       : funnel(w[0], w[1], o & 31);
        const uint32_t lsb = nbk > 0 ? top_k >> ((32 - nbk) & 31) : 0u;
        o += nbk;
        const int32_t folded = (int32_t)(((uint32_t)q << kk) | lsb);
        const int32_t rice_val = (folded >> 1) ^ -(folded & 1);
        // escaped raw bits: rawlen (<= 31) bits at offset <= 10
        const int32_t nbr = (in_res && esc) ? rawlen : 0;
        const uint32_t top_r = funnel(w[0], w[1], o & 31);
        const uint32_t rvu = nbr > 0 ? top_r >> ((32 - nbr) & 31) : 0u;
        const int32_t raw_val = se32(rvu, nbr);
        o += nbr;
        // verbatim: ebps bits at offset 0
        const int32_t nbv = is_verb ? ebps : 0;
        const uint32_t vv = nbv > 0 ? w[0] >> ((32 - nbv) & 31) : 0u;
        const int32_t verb_val = se32(vv, nbv);
        o += nbv;
        row[t] = rice_on ? rice_val
                 : (in_res && esc) ? raw_val : (is_verb ? verb_val : 0);
        // one window slide by o (<= 88 bits): 3-way limb select
        const int32_t jsel = o >> 5;
        const int rs = o & 31;
        uint32_t s[kLimbs + 2];
#pragma unroll
        for (int m = 0; m < kLimbs + 2; ++m)
          s[m] = funnel(m < kLimbs ? w[m] : 0u, m + 1 < kLimbs ? w[m + 1] : 0u, rs);
#pragma unroll
        for (int i = 0; i < kLimbs; ++i)
          w[i] = jsel == 0 ? s[i] : (jsel == 1 ? s[i + 1] : s[i + 2]);
        spent += o;
      }
    }
    // all consumed bits must have been inside the valid window
    if (spent > navail) ovf = true;
    navail = max(navail - spent, 0);
    // refill: insert up to kNload words at bit offset navail
#pragma unroll
    for (int l = 0; l < kNload; ++l) {
      const bool can = navail <= 256 - 32;
      const uint32_t wv = can ? gw(wpos) : 0u;
      const int32_t jw = navail >> 5;
      const int rw = navail & 31;
      const uint32_t p0 = wv >> rw;
      const uint32_t p1 = rw > 0 ? wv << ((32 - rw) & 31) : 0u;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        if (can && jw == i) w[i] |= p0;
        if (can && jw + 1 == i) w[i] |= p1;
      }
      if (can) {
        navail += 32;
        wpos += 1;
      }
    }
    pos += spent;
  }
  pos_out[b] = pos;
  ovf_out[b] = ovf ? 1 : 0;
}

}  // namespace

// words int32 [nwords] (the stream, big-endian bit order); per frame (all
// [B]): pos int64, is_coded / is_verb bool, ebps / order / plen / pesc / ps
// int64. Writes res int32 [B, T], pos_out int64 [B], ovf bool [B]. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int flac_residual_scan(const void* words, int64_t nwords,
                                  const void* pos, const void* is_coded,
                                  const void* is_verb, const void* ebps,
                                  const void* order, const void* plen,
                                  const void* pesc, const void* ps, void* res,
                                  void* pos_out, void* ovf, int32_t batch,
                                  int32_t T, void* stream) {
  if (batch > 0 && nwords > 0) {
    const int threads = 32;
    const int blocks = (batch + threads - 1) / threads;
    residual_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int64_t*)pos,
        (const uint8_t*)is_coded, (const uint8_t*)is_verb,
        (const int64_t*)ebps, (const int64_t*)order, (const int64_t*)plen,
        (const int64_t*)pesc, (const int64_t*)ps, (int32_t*)res,
        (int64_t*)pos_out, (uint8_t*)ovf, batch, T);
  }
  return (int)cudaGetLastError();
}
