// Subframe scan of the FLAC frame decoder, on NVIDIA Hopper (sm_90a): the
// subframe-header parse and the residual/verbatim window scan, one subframe
// of every frame of a batch, in one launch. Two instantiations share the
// parse and differ in the scan, as flac_tpu's two scans do:
//   - narrow (subframe_scan_kernel<false>): a window of 8 uint32 limbs, for
//     streams of at most 26 bits;
//   - wide (subframe_scan_kernel<true>): a window of 4 uint64 limbs, for
//     wider streams and scan_impl="wide".
//
// Replaces three pieces of flac_tpu/decode/frame_decoder.py:
//   - _decode_subframe's parse (:409-456): the header byte, the wasted-bits
//     unary run (a device while_loop, :94-118), the constant, the warmup,
//     LPC precision, shift and coefficients, and the entropy-coding header;
//   - _narrow_residual_scan (:130-293, the lax.scan at :290-291): Rice
//     partitions (parameter, escape, unary run, LSBs), escaped raw samples
//     and verbatim samples;
//   - the wide branch of _decode_subframe (:484-595, the lax.scan at :590):
//     the same fields, each read by one take(n) of n <= 63 bits that slides
//     the window.
// The batch axis becomes threads, one a frame. Every output equals
// flac_tpu's, the flagged frames' included, because `ovf` decides which
// frames go to the host decoder:
//   - the parse reads as flac_tpu's _read_bits does: a read of n <= 0 bits
//     gives 0 and still moves the position by n, so a wasted run longer
//     than the sample width makes `ebps`, and then the position, negative;
//     word indices follow flac_tpu's words[min(i, n - 1)] (word_index);
//   - each scan keeps flac_tpu's step structure: U=4 samples a step from a
//     256-bit window in registers, up to 3 word refills at the end of each
//     step, and its guards. Narrow: one window slide per sample, int32 and
//     uint32 arithmetic, guards on a unary run of >= 48 zeros, a Rice fold
//     q * 2^k >= 2^30 and a step that spends more bits than its window
//     held. Wide: int64 values (verbatim samples of up to 33 bits and folds
//     up to 47 * 2^30 come out whole, so its res is int64), guards on a
//     unary run of >= 48 zeros and on over-spending, once a step.
// Every shift amount stays in [0, 31] on 32-bit values and in [0, 63] on
// 64-bit ones: flac_tpu's masked branches rely on a shift by 64 giving 0,
// which C++ leaves undefined. The funnel shifts are __funnelshift_l and the
// unary runs __clz / __clzll.
//
// Bound: bytes in principle (the subframes' bits read once, res written
// once: 0.0033 ms for 512 frames of 4096 samples on an H100, narrow), but
// each thread is one serial chain of T/4 dependent steps, so the chain's
// length sets the time. The design shortens the chain:
//   - the window stays in registers: every limb update is a select, never
//     a conditional store to one limb, which the compiler would turn into a
//     store at a computed index and so move the whole window to local
//     memory;
//   - the refills never wait on device memory. A step takes at most 3
//     words and every lane runs exactly ceil(T/4) steps, so each lane
//     stages its next words into its own ring in shared memory with
//     cp.async, a chunk of 8 steps (24 words) ahead, double-buffered; the
//     step's words are read from shared memory;
//   - the partition boundary test keeps t mod ps as a counter instead of
//     dividing once a sample;
//   - the 4 samples of a step leave as one 16-byte store (narrow) or two
//     (wide) when T is a multiple of 4.
// The narrow scan inserts a step's refills at once as a 96-bit value; the
// wide scan, a first kernel, inserts its words one by one as flac_tpu's
// refill loop does (its part0 / part1 placement).
// The header parse (a few dozen dependent reads a subframe) reads device
// memory directly: it is short beside the scan, and it replaces about a
// thousand eager launches and a host synchronisation a channel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kU = 4;           // samples per step
constexpr int kNload = 3;       // word refills per step
constexpr int kLimbs = 8;       // 32-bit limbs of the window
constexpr int kWarp = 32;       // threads a block: one warp, one frame a lane
constexpr int kChunkSteps = 8;  // steps between two stagings
constexpr int kChunkWords = kNload * kChunkSteps;
constexpr int kRing = 64;       // staged words a lane (a power of two)
static_assert(kRing >= 2 * kChunkWords && (kRing & (kRing - 1)) == 0,
              "the ring holds the chunk being read and the one in flight");

struct SubOut {  // read_subframe_header's fields, in its dtypes
  int64_t* pos;
  uint8_t *is_const, *is_verb, *is_fixed, *is_lpc, *is_coded;
  int64_t *order, *wasted, *ebps, *cval, *warm, *shift, *qlp, *plen, *pesc, *ps;
};

// the word flac_tpu's words[jnp.minimum(i, n - 1)] reads: a negative index
// wraps once (i + n), is cut to int32, then clamped to [0, n - 1]
__device__ __forceinline__ int64_t word_index(int64_t i, int64_t n) {
  int64_t j = i < n - 1 ? i : n - 1;
  if (j < 0) j += n;
  const int64_t k = (int32_t)(uint32_t)(uint64_t)j;
  return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

// the next 32 bits at bit position pos, MSB-aligned (flac_tpu's _peek32)
__device__ __forceinline__ uint32_t peek32(const uint32_t* __restrict__ words,
                                           int64_t nw, int64_t pos) {
  const int64_t wi = pos >> 5;
  const uint32_t w0 = __ldg(words + word_index(wi, nw));
  const uint32_t w1 = __ldg(words + word_index(wi + 1, nw));
  return __funnelshift_l(w1, w0, (unsigned)(pos & 31));
}

// flac_tpu's _read_bits: n (<= 32) bits as an unsigned value, 0 for n <= 0
// and for n > 32 (a 33-bit side channel's warmup in a 32-bit stream: JAX's
// over-wide shift gives 0); the position moves by n either way
__device__ __forceinline__ int64_t read_bits(const uint32_t* __restrict__ words,
                                             int64_t nw, int64_t& pos, int64_t n) {
  const int64_t v =
      n > 0 && n <= 32 ? (int64_t)(peek32(words, nw, pos) >> (32 - n)) : 0;
  pos += n;
  return v;
}

__device__ __forceinline__ int64_t sign_extend(int64_t v, int64_t n) {
  return (n > 0 && v >= (int64_t(1) << (n - 1))) ? v - (int64_t(1) << n) : v;
}

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

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// flac_tpu's _narrow_residual_scan of one frame, from the first residual
// bit `pos` (the parse's end); the lane's staging ring is `ring + lane`
__device__ __forceinline__ void scan_narrow(
    const uint32_t* __restrict__ words, int64_t nw, uint32_t* ring, int lane,
    int64_t pos, bool is_coded, bool is_verb, int64_t ebps, int64_t order,
    bool rice2, int64_t ps64, int32_t T, int32_t* __restrict__ res, int32_t b,
    int64_t* __restrict__ pos_out, uint8_t* __restrict__ ovf_out) {
  const int32_t ebps32 = (int32_t)ebps;
  const int32_t order32 = (int32_t)order;
  const int32_t plen = rice2 ? 5 : 4;
  const int32_t pesc = rice2 ? 31 : 15;
  // t mod 0 is 0, as flac_tpu's jnp.mod gives it: a zero partition size
  // (a corrupt header's) reads a parameter every sample, as a size of 1 does
  const int32_t ps = ps64 == 0 ? 1 : (int32_t)ps64;

  // initial fill: 9 words -> 8 limbs, MSB-aligned at pos
  const int32_t wi0 = (int32_t)(pos >> 5);
  const int32_t off = (int32_t)(pos & 31);
  uint32_t w[kLimbs];
  {
    uint32_t a[kLimbs + 1];
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) a[j] = __ldg(words + word_index(wi0 + j, nw));
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) w[j] = funnel(a[j], a[j + 1], off);
  }
  int32_t navail = 256 - off;
  int32_t wpos = wi0 + kLimbs;
  int32_t k = 0, rawlen = 0;
  int32_t tmod = 0;  // t mod ps
  bool ovf = false;
  int32_t* row = res + (int64_t)b * T;
  const bool vec4 = (T & (kU - 1)) == 0;

  // the lane's ring: word i of the stream sits in slot i & (kRing - 1)
  uint32_t* col = ring + lane;
  int32_t staged = wpos;  // the next word index to stage
  auto stage_to = [&](int32_t end) {
    for (; staged < end; ++staged)
      cp_async4(col + (staged & (kRing - 1)) * kWarp, words + word_index(staged, nw));
    cp_async_commit();
  };
  stage_to(wpos + kChunkWords);

  for (int32_t t0 = 0, step = 0; t0 < T; t0 += kU, ++step) {
    if (step % kChunkSteps == 0) {
      // words [wpos, wpos + 24) were staged a chunk ago; stage the next 24
      stage_to(wpos + 2 * kChunkWords);
      cp_async_wait<1>();
    }
    // this step's refill words, read before the samples need them
    uint32_t refill[kNload];
#pragma unroll
    for (int l = 0; l < kNload; ++l) refill[l] = col[((wpos + l) & (kRing - 1)) * kWarp];
    int32_t spent = 0;
    int32_t outs[kU];
#pragma unroll
    for (int32_t jj = 0; jj < kU; ++jj) {
      const int32_t t = t0 + jj;
      outs[jj] = 0;
      if (t < T) {  // a sample past T reads nothing and slides by 0
        const bool boundary = is_coded && tmod == 0;
        tmod = tmod + 1 == ps ? 0 : tmod + 1;
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
        const bool in_res = is_coded && t >= order32;
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
        // verbatim: ebps bits at offset 0 (a negative ebps reads nothing
        // and moves the window back, as in flac_tpu)
        const int32_t nbv = is_verb ? ebps32 : 0;
        const uint32_t vv = nbv > 0 ? w[0] >> ((32 - nbv) & 31) : 0u;
        const int32_t verb_val = se32(vv, nbv);
        o += nbv;
        outs[jj] = rice_on ? rice_val
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
    if (vec4) {
      *reinterpret_cast<int4*>(row + t0) = make_int4(outs[0], outs[1], outs[2], outs[3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kU; ++jj)
        if (t0 + jj < T) row[t0 + jj] = outs[jj];
    }
    // all consumed bits must have been inside the valid window
    if (spent > navail) ovf = true;
    navail = max(navail - spent, 0);
    // refill: insert up to kNload words at bit offset navail. Refill l can
    // while navail + 32 l <= 224 and then takes word wpos + l, so the step
    // inserts its first `cnt` staged words at once, as the 96-bit value
    // v0:v1:v2 shifted right by navail: limb jw + k of the window takes
    // limb k of (v0:v1:v2) >> rw. Every limb is updated with a select:
    // conditional updates of w[i] for one i would let the compiler turn
    // them into a store at a computed index, which puts the whole window
    // in local memory.
    const int32_t cnt = navail > 256 - 32 ? 0 : min(kNload, ((256 - 32 - navail) >> 5) + 1);
    {
      const uint32_t v0 = cnt > 0 ? refill[0] : 0u;
      const uint32_t v1 = cnt > 1 ? refill[1] : 0u;
      const uint32_t v2 = cnt > 2 ? refill[2] : 0u;
      const int32_t jw = navail >> 5;
      const unsigned rw = navail & 31;
      const uint32_t e0 = __funnelshift_r(v0, 0u, rw);
      const uint32_t e1 = __funnelshift_r(v1, v0, rw);
      const uint32_t e2 = __funnelshift_r(v2, v1, rw);
      const uint32_t e3 = __funnelshift_r(0u, v2, rw);
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        const int32_t d = i - jw;
        w[i] |= d == 0 ? e0 : (d == 1 ? e1 : (d == 2 ? e2 : (d == 3 ? e3 : 0u)));
      }
    }
    navail += 32 * cnt;
    wpos += cnt;
    pos += spent;
  }
  cp_async_wait<0>();  // no copy may land after the block has gone
  pos_out[b] = pos;
  ovf_out[b] = ovf ? 1 : 0;
}

// n (<= 63; n <= 0 reads nothing) bits off the top of the 256-bit window
// l0:l1:l2:l3, which slides by n: flac_tpu's take(n) in the wide scan
__device__ __forceinline__ uint64_t take(uint64_t (&l)[4], int64_t n) {
  if (n <= 0) return 0;
  // n is a field width: <= 48, or a sample width <= 33 for streams of at
  // most 32 bits; the cap only keeps the shifts defined
  const int m = n > 63 ? 63 : (int)n;
  const int s = 64 - m;  // [1, 63]
  const uint64_t v = l[0] >> s;
  l[0] = (l[0] << m) | (l[1] >> s);
  l[1] = (l[1] << m) | (l[2] >> s);
  l[2] = (l[2] << m) | (l[3] >> s);
  l[3] = l[3] << m;
  return v;
}

// the wide branch of flac_tpu's _decode_subframe (:484-595) for one frame,
// from the first residual bit `pos`; the lane's staging ring is
// `ring + lane`, as in scan_narrow
__device__ __forceinline__ void scan_wide(
    const uint32_t* __restrict__ words, int64_t nw, uint32_t* ring, int lane,
    int64_t pos, bool is_coded, bool is_verb, int64_t ebps, int64_t order,
    bool rice2, int64_t ps64, int32_t T, int64_t* __restrict__ res, int32_t b,
    int64_t* __restrict__ pos_out, uint8_t* __restrict__ ovf_out) {
  const int64_t plen = rice2 ? 5 : 4;
  const int64_t pesc = rice2 ? 31 : 15;
  // t mod 0 is 0, as flac_tpu's jnp.mod gives it
  const int64_t ps = ps64 == 0 ? 1 : ps64;

  // initial fill: 8 words -> 4 limbs, MSB-aligned at pos
  const int64_t wi0 = pos >> 5;
  const int off0 = (int)(pos & 31);
  uint64_t l[4];
  {
    uint64_t a[5];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = ((uint64_t)__ldg(words + word_index(wi0 + 2 * j, nw)) << 32) |
             __ldg(words + word_index(wi0 + 2 * j + 1, nw));
    a[4] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      l[j] = off0 > 0 ? (a[j] << off0) | (a[j + 1] >> (64 - off0)) : a[j];
  }
  int64_t navail = 256 - off0;
  int64_t wpos = wi0 + 8;
  int64_t k = 0, rawlen = 0, tmod = 0;
  bool ovf = false;
  int64_t* row = res + (int64_t)b * T;
  const bool vec4 = (T & (kU - 1)) == 0;

  // the lane's ring: word i of the stream sits in slot i & (kRing - 1)
  uint32_t* col = ring + lane;
  int64_t staged = wpos;  // the next word index to stage
  auto stage_to = [&](int64_t end) {
    for (; staged < end; ++staged)
      cp_async4(col + (staged & (kRing - 1)) * kWarp, words + word_index(staged, nw));
    cp_async_commit();
  };
  stage_to(wpos + kChunkWords);

  for (int32_t t0 = 0, step = 0; t0 < T; t0 += kU, ++step) {
    if (step % kChunkSteps == 0) {
      stage_to(wpos + 2 * kChunkWords);
      cp_async_wait<1>();
    }
    int64_t spent = 0;
    int64_t outs[kU];
#pragma unroll
    for (int32_t jj = 0; jj < kU; ++jj) {
      const int32_t t = t0 + jj;
      outs[jj] = 0;
      if (t < T) {  // a sample past T reads nothing
        const bool boundary = is_coded && tmod == 0;
        tmod = tmod + 1 == ps ? 0 : tmod + 1;
        const int64_t nb = boundary ? plen : 0;
        const int64_t pv = (int64_t)take(l, nb);
        if (boundary) k = pv;
        const bool isesc_b = boundary && k == pesc;
        const int64_t nb2 = isesc_b ? 5 : 0;
        const int64_t rl = (int64_t)take(l, nb2);
        if (isesc_b) rawlen = rl;
        const bool esc = k == pesc;
        const bool in_res = is_coded && t >= order;
        const bool rice_on = in_res && !esc;
        const int64_t z = __clzll((long long)l[0]);  // 64 for 0
        if (rice_on && z >= 48) ovf = true;
        const int64_t q = rice_on ? (z < 47 ? z : 47) : 0;
        const int64_t nq = rice_on ? q + 1 : 0;
        take(l, nq);
        const int64_t nk = rice_on ? k : 0;
        const int64_t lsb = (int64_t)take(l, nk);
        // k < 32: it was read from at most 5 bits
        const int64_t folded = (q << (k > 0 ? k : 0)) | lsb;
        const int64_t rice_val = (folded >> 1) ^ -(folded & 1);
        const int64_t nr = (in_res && esc) ? rawlen : 0;
        const int64_t raw_val = sign_extend((int64_t)take(l, nr), nr);
        // verbatim: a negative ebps reads nothing and moves the position
        // back, as in flac_tpu
        const int64_t nv = is_verb ? ebps : 0;
        const int64_t verb_val = sign_extend((int64_t)take(l, nv), nv);
        outs[jj] = rice_on ? rice_val
                   : (in_res && esc) ? raw_val : (is_verb ? verb_val : 0);
        spent += nb + nb2 + nq + nk + nr + nv;
      }
    }
    if (vec4) {
      longlong2* dst = reinterpret_cast<longlong2*>(row + t0);
      dst[0] = make_longlong2(outs[0], outs[1]);
      dst[1] = make_longlong2(outs[2], outs[3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kU; ++jj)
        if (t0 + jj < T) row[t0 + jj] = outs[jj];
    }
    // all consumed bits must have been inside the valid window
    if (spent > navail) ovf = true;
    navail = navail - spent > 0 ? navail - spent : 0;
    // refill: up to kNload words, each inserted at bit offset navail: limb
    // navail >> 6 takes the word's top bits (part0), the next limb the rest
    // (part1). Each limb is updated with a select (see the narrow scan).
#pragma unroll
    for (int r = 0; r < kNload; ++r) {
      const bool can = navail <= 256 - 32;
      const uint64_t w = col[(wpos & (kRing - 1)) * kWarp];
      const int64_t j = navail >> 6;
      const int q = (int)(navail & 63);
      const uint64_t part0 = q <= 32 ? w << (32 - q) : w >> (q - 32);
      const uint64_t part1 = q > 32 ? w << (96 - q) : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        l[i] |= (can && j == i ? part0 : 0) | (can && j + 1 == i ? part1 : 0);
      navail += can ? 32 : 0;
      wpos += can ? 1 : 0;
    }
    pos += spent;
  }
  cp_async_wait<0>();  // no copy may land after the block has gone
  pos_out[b] = pos;
  ovf_out[b] = ovf ? 1 : 0;
}

// Res: int32_t (narrow) or int64_t (wide)
template <bool kWide, typename Res>
__global__ void __launch_bounds__(kWarp) subframe_scan_kernel(
    const uint32_t* __restrict__ words, int64_t nw,
    const int64_t* __restrict__ pos_in, const int64_t* __restrict__ cbps_in,
    SubOut out, Res* __restrict__ res, int64_t* __restrict__ pos_out,
    uint8_t* __restrict__ ovf_out, int32_t B, int32_t T, int32_t maxord) {
  __shared__ uint32_t ring[kRing * kWarp];  // slot s of lane l at s * 32 + l
  const int lane = threadIdx.x;
  const int32_t b = blockIdx.x * kWarp + lane;
  if (b >= B) return;

  // ---- the subframe header (flac_tpu's _decode_subframe, :411-456) -------
  int64_t pos = pos_in[b];
  const int64_t hdr = read_bits(words, nw, pos, 8);
  const int64_t stype = (hdr >> 1) & 0x3F;
  int64_t wasted = 0;
  if (hdr & 1) {
    // the wasted-bits unary run, bounded at the end of the word buffer
    const int64_t limit = nw * 32;
    int64_t q = 0;
    for (;;) {
      const uint32_t top = peek32(words, nw, pos);
      if (top != 0u) {
        const int z = __clz(top);
        q += z;
        pos += z + 1;
        break;
      }
      q += 32;
      pos += 32;
      if (pos >= limit) break;
    }
    wasted = q + 1;
  }
  const int64_t ebps = cbps_in[b] - wasted;
  const bool is_const = stype == 0;
  const bool is_verb = stype == 1;
  const bool is_fixed = (stype >> 3) == 1;
  const bool is_lpc = (stype >> 5) == 1;
  const bool is_coded = is_fixed || is_lpc;
  const int64_t order = is_fixed ? (stype & 7) : (is_lpc ? (stype & 31) + 1 : 0);
  const int64_t nconst = is_const ? ebps : 0;
  const int64_t cval = sign_extend(read_bits(words, nw, pos, nconst), nconst);
  int64_t* warm = out.warm + (int64_t)b * maxord;
  for (int32_t j = 0; j < maxord; ++j) {
    const int64_t nb = (is_coded && j < order) ? ebps : 0;
    warm[j] = sign_extend(read_bits(words, nw, pos, nb), nb);
  }
  const int64_t prec = is_lpc ? read_bits(words, nw, pos, 4) + 1 : 0;
  const int64_t nshift = is_lpc ? 5 : 0;
  const int64_t shift = sign_extend(read_bits(words, nw, pos, nshift), nshift);
  int64_t* qlp = out.qlp + (int64_t)b * maxord;
  for (int32_t j = 0; j < maxord; ++j) {
    const int64_t nb = (is_lpc && j < order) ? prec : 0;
    qlp[j] = sign_extend(read_bits(words, nw, pos, nb), nb);
  }
  const int64_t ev = read_bits(words, nw, pos, is_coded ? 6 : 0);
  const bool rice2 = ((ev >> 4) & 3) == 1;
  const int64_t ps64 = is_coded ? ((int64_t)T >> (ev & 15)) : T;
  out.pos[b] = pos;
  out.is_const[b] = is_const;
  out.is_verb[b] = is_verb;
  out.is_fixed[b] = is_fixed;
  out.is_lpc[b] = is_lpc;
  out.is_coded[b] = is_coded;
  out.order[b] = order;
  out.wasted[b] = wasted;
  out.ebps[b] = ebps;
  out.cval[b] = cval;
  out.shift[b] = shift;
  out.plen[b] = rice2 ? 5 : 4;
  out.pesc[b] = rice2 ? 31 : 15;
  out.ps[b] = ps64;

  if constexpr (kWide)
    scan_wide(words, nw, ring, lane, pos, is_coded, is_verb, ebps, order, rice2,
              ps64, T, res, b, pos_out, ovf_out);
  else
    scan_narrow(words, nw, ring, lane, pos, is_coded, is_verb, ebps, order, rice2,
                ps64, T, res, b, pos_out, ovf_out);
}

}  // namespace

// words int32 [nwords] (the stream, big-endian bit order); pos, cbps int64
// [B] (each frame's first subframe-header bit and sample width). Writes
// read_subframe_header's fields (`sub`: pos, is_const, is_verb, is_fixed,
// is_lpc, is_coded as bool [B]; order, wasted, ebps, cval, shift, plen,
// pesc, ps as int64 [B]; warm, qlp as int64 [B, maxord]), res [B, T] (int32
// for the narrow scan, int64 for the wide one, `wide` != 0), pos_out int64
// [B] (after the samples) and ovf bool [B]. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flac_subframe_scan(
    const void* words, int64_t nwords, const void* pos, const void* cbps,
    void* sub_pos, void* is_const, void* is_verb, void* is_fixed, void* is_lpc,
    void* is_coded, void* order, void* wasted, void* ebps, void* cval, void* warm,
    void* shift, void* qlp, void* plen, void* pesc, void* ps, void* res,
    void* pos_out, void* ovf, int32_t batch, int32_t T, int32_t maxord,
    int32_t wide, void* stream) {
  if (batch > 0 && nwords > 0) {
    SubOut out{(int64_t*)sub_pos, (uint8_t*)is_const, (uint8_t*)is_verb,
               (uint8_t*)is_fixed, (uint8_t*)is_lpc,  (uint8_t*)is_coded,
               (int64_t*)order,    (int64_t*)wasted,  (int64_t*)ebps,
               (int64_t*)cval,     (int64_t*)warm,    (int64_t*)shift,
               (int64_t*)qlp,      (int64_t*)plen,    (int64_t*)pesc,
               (int64_t*)ps};
    const int blocks = (batch + kWarp - 1) / kWarp;
    if (wide)
      subframe_scan_kernel<true><<<blocks, kWarp, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, nwords, (const int64_t*)pos, (const int64_t*)cbps,
          out, (int64_t*)res, (int64_t*)pos_out, (uint8_t*)ovf, batch, T, maxord);
    else
      subframe_scan_kernel<false><<<blocks, kWarp, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, nwords, (const int64_t*)pos, (const int64_t*)cbps,
          out, (int32_t*)res, (int64_t*)pos_out, (uint8_t*)ovf, batch, T, maxord);
  }
  return (int)cudaGetLastError();
}
