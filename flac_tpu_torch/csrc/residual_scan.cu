// Subframe scan of the FLAC frame decoder, on NVIDIA Hopper (sm_90a): the
// subframe-header parse and the residual/verbatim scan, one subframe of every
// frame of a batch, in one launch. Two kernels share the parse
// (parse_subframe) and differ in the scan, as flac_tpu's two scans do:
//   - narrow (subframe_scan_kernel): a window of 8 uint32 limbs, for streams
//     of at most 26 bits, one frame a thread;
//   - wide (wide_scan_kernel): int64 values, for wider streams and
//     scan_impl="wide", one frame a block of two warps.
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
//     a 256-bit window of four 64-bit limbs.
// Every output equals flac_tpu's, the flagged frames' included, because `ovf`
// decides which frames go to the host decoder:
//   - the parse reads as flac_tpu's _read_bits does: a read of n <= 0 bits
//     gives 0 and still moves the position by n, so a wasted run longer
//     than the sample width makes `ebps`, and then the position, negative;
//     word indices follow flac_tpu's words[min(i, n - 1)] (word_index);
//   - flac_tpu's scans read U=4 samples a step from their window and refill
//     it with up to 3 words at the end of each step. The narrow scan keeps
//     that step structure and its guards (a unary run of >= 48 zeros, a
//     Rice fold q * 2^k >= 2^30, a step that spends more bits than its
//     window held). The wide scan's guards are the first and the last.
// Every shift amount stays in [0, 31] on 32-bit values and in [0, 63] on
// 64-bit ones: flac_tpu's masked branches rely on a shift by 64 giving 0,
// which C++ leaves undefined. The funnel shifts are __funnelshift_l and the
// unary runs __clz / __clzll.
//
// Bound: bytes in principle (the subframes' bits read once, res written
// once), but a frame's samples are a serial chain: each sample's first bit
// is known only once the one before it has been read.
//
// The narrow scan is one chain of T/4 dependent steps a thread:
//   - the window stays in registers: every limb update is a select, never
//     a conditional store to one limb, which the compiler would turn into a
//     store at a computed index and so move the whole window to local
//     memory;
//   - the refills never wait on device memory. A step takes at most 3
//     words and every lane runs exactly ceil(T/4) steps, so each lane
//     stages its next words into its own ring in shared memory with
//     cp.async, a chunk of 8 steps (24 words) ahead, double-buffered; the
//     step's words are read from shared memory and inserted at once, as
//     one 96-bit value;
//   - the partition boundary test keeps t mod ps as a counter instead of
//     dividing once a sample;
//   - the 4 samples of a step leave as one 16-byte store.
//
// The wide scan reads the stream directly, never through a window, and
// keeps only the chain on one thread. Its fast path, chunk by chunk of 64
// samples:
//   - warp 1 stages the subframe's words into a ring in shared memory, 32
//     coalesced words a round with cp.async, and builds from them a table
//     of the zero run that starts at every bit (a byte a bit, counted over
//     up to three words), two chunks of the worst case ahead of the walk (a
//     sample spends at most 83 bits on this path);
//   - phase A: lane 0 of warp 0 walks the chunk. A Rice sample's next start
//     is s + z + 1 + k with z = table[s], so a step is a mask, one shared
//     byte load, an add and a select; a partition's parameter is read once
//     where partitions hold whole steps. It writes each sample's first bit
//     and its partition's code;
//   - phase B: warp 1 extracts the chunk's values (Rice fold and zigzag,
//     escaped raw bits, verbatim bits) while warp 0 walks the next chunk,
//     and stores the int64 res row coalesced. Named barriers hand the
//     chunks over; the entries are double-buffered.
// The walker replays flac_tpu's window bookkeeping on each step's spent bits
// (navail = 256 - (pos & 31); each step: flag if spent > navail,
// navail = max(navail - spent, 0), then up to 3 times navail += 32 while
// navail <= 224), and phase B flags a Rice unary run of >= 48 zeros. That
// is exact: flac_tpu's window holds the stream's bits [pos, pos + navail)
// and zeros after them, and the refill puts word wpos, the stream's next, at
// navail. While no step has spent more than navail bits, every take read
// stream bits, and a unary run seen in the window (zeros past navail
// included) equals the stream's whenever it ends inside the step's bits. So
// a frame the replay does not flag reads the same bits as the window, and
// its res, end position and flag equal flac_tpu's. Conversely, the first
// step where the direct reads flag also flags the window: a run of >= 48
// zeros in the stream is >= 48 zeros in the window, and a take that crosses
// navail has the same width in both, so the window's step overspends too.
// The exact path serves the other frames: those the fast path flags, those
// whose parse ends at a negative position, VERBATIM frames whose width is
// outside [1, 33] (a negative width moves the position back, which the
// window does not follow) and blocks longer than 65536 samples. One thread
// of the frame's block runs flac_tpu's wide branch step for step (scan_wide:
// the 4-limb window, 6 takes a sample, the refill loop's part0 / part1
// placement), in the same launch. The header parse (a few dozen dependent
// reads a subframe) reads device memory directly: it is short beside the
// scan, and it replaces about a thousand eager launches and a host
// synchronisation a channel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kU = 4;           // samples per step
constexpr int kNload = 3;       // word refills per step
constexpr int kLimbs = 8;       // 32-bit limbs of the window
constexpr int kWarp = 32;       // a warp; the narrow kernel's block, one frame a lane
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
// from the first residual bit `pos`, step for step: the wide kernel's exact
// path; the lane's staging ring is `ring + lane`, as in scan_narrow
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

// the fields of read_subframe_header that the scans read
struct SubHdr {
  int64_t pos, ebps, order, ps;
  bool is_coded, is_verb, rice2;
};

// flac_tpu's _decode_subframe parse (:411-456) of the subframe at bit `pos`
// of frame b; writes its fields to `out` when `write`
__device__ __forceinline__ SubHdr parse_subframe(
    const uint32_t* __restrict__ words, int64_t nw, int64_t pos, int64_t cbps,
    int32_t T, int32_t maxord, const SubOut& out, int32_t b, bool write) {
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
  const int64_t ebps = cbps - wasted;
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
    const int64_t v = sign_extend(read_bits(words, nw, pos, nb), nb);
    if (write) warm[j] = v;
  }
  const int64_t prec = is_lpc ? read_bits(words, nw, pos, 4) + 1 : 0;
  const int64_t nshift = is_lpc ? 5 : 0;
  const int64_t shift = sign_extend(read_bits(words, nw, pos, nshift), nshift);
  int64_t* qlp = out.qlp + (int64_t)b * maxord;
  for (int32_t j = 0; j < maxord; ++j) {
    const int64_t nb = (is_lpc && j < order) ? prec : 0;
    const int64_t v = sign_extend(read_bits(words, nw, pos, nb), nb);
    if (write) qlp[j] = v;
  }
  const int64_t ev = read_bits(words, nw, pos, is_coded ? 6 : 0);
  const bool rice2 = ((ev >> 4) & 3) == 1;
  const int64_t ps64 = is_coded ? ((int64_t)T >> (ev & 15)) : T;
  if (write) {
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
  }
  return SubHdr{pos, ebps, order, ps64, is_coded, is_verb, rice2};
}

__global__ void __launch_bounds__(kWarp) subframe_scan_kernel(
    const uint32_t* __restrict__ words, int64_t nw,
    const int64_t* __restrict__ pos_in, const int64_t* __restrict__ cbps_in,
    SubOut out, int32_t* __restrict__ res, int64_t* __restrict__ pos_out,
    uint8_t* __restrict__ ovf_out, int32_t B, int32_t T, int32_t maxord) {
  __shared__ uint32_t ring[kRing * kWarp];  // slot s of lane l at s * 32 + l
  const int lane = threadIdx.x;
  const int32_t b = blockIdx.x * kWarp + lane;
  if (b >= B) return;
  const SubHdr h = parse_subframe(words, nw, pos_in[b], cbps_in[b], T, maxord, out, b, true);
  scan_narrow(words, nw, ring, lane, h.pos, h.is_coded, h.is_verb, h.ebps, h.order,
              h.rice2, h.ps, T, res, b, pos_out, ovf_out);
}

// ---- the wide scan: one frame a block of two warps -------------------------
constexpr int kChunk = 64;          // samples a chunk: walked, then extracted
constexpr int kMaxSampleBits = 83;  // a fast-path sample: 5 + 48 + 30 bits
// words a chunk may read from its first sample's word on: its samples, the
// 64-bit peek past the last one and the start's bit offset
constexpr int kNeed = (kChunk * kMaxSampleBits + 64 + 31) / 32 + 4;
// the run table is built kAhead words past the walker's chunk start, so
// that the next chunk's words are built while this one is walked; the ring
// is staged kLead words past it (a build round reads two words past its
// last, and rounds take 32 words)
constexpr int kAhead = 2 * kNeed;
constexpr int kLead = kAhead + 2 * 32;
constexpr int kWRing = 1024;        // staged words (a power of two)
constexpr int kZBits = 1 << 15;     // run-table entries (one a bit, a power of two)
constexpr int kMaxFastT = 1 << 16;  // value positions fit 26 bits
constexpr int kWarpWords = kRing * kWarp;  // the block's shared words: scan_wide's ring
constexpr int kRecAt = kWRing + 4;  // rec[2][kChunk]'s first word: 16-byte aligned
constexpr int kThreads = 2 * kWarp;  // warp 0 walks, warp 1 stages, builds, extracts
// while warp 1 extracts chunk c it stages and builds for chunk c + 1's
// start, at most kNeed words past chunk c's
static_assert(kNeed + kLead + kWarp <= kWRing, "the ring holds chunk c's words and the staged ones");
static_assert((kNeed + kAhead + kWarp) * 32 <= kZBits, "the table holds chunk c's runs and the built ones");
static_assert(kRecAt + 2 * kChunk <= kWarpWords, "the ring, its mirror and rec fit the block's words");
static_assert(kChunk % kU == 0, "a chunk holds whole steps");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBarReady = 1;   // named barriers: warp 1 has built chunk c's runs
constexpr int kBarWalked = 2;  // warp 0 has walked chunk c

// frames that took the exact path since the count was last read
__device__ unsigned long long exact_frames = 0;

// the 64 bits at relative bit p of the staged ring, MSB-aligned (the ring's
// first two words are mirrored past its end, so i + 2 needs no wrap)
__device__ __forceinline__ uint64_t ring_peek64(const uint32_t* ring, int32_t p) {
  const int32_t i = (p >> 5) & (kWRing - 1);
  const int r = p & 31;
  const uint32_t hi = funnel(ring[i], ring[i + 1], r);
  const uint32_t lo = funnel(ring[i + 1], ring[i + 2], r);
  return ((uint64_t)hi << 32) | lo;
}

// the n (1..32) bits at relative bit p of the staged ring
__device__ __forceinline__ int32_t ring_bits(const uint32_t* ring, int32_t p, int n) {
  const int32_t i = (p >> 5) & (kWRing - 1);
  return (int32_t)(funnel(ring[i], ring[i + 1], p & 31) >> (32 - n));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads) wide_scan_kernel(
    const uint32_t* __restrict__ words, int64_t nw,
    const int64_t* __restrict__ pos_in, const int64_t* __restrict__ cbps_in,
    SubOut out, int64_t* __restrict__ res, int64_t* __restrict__ pos_out,
    uint8_t* __restrict__ ovf_out, int32_t B, int32_t T, int32_t maxord,
    bool exact_only) {
  // one frame a block: the ring and the table sit at fixed shared
  // addresses, so a walk step's load needs no base added
  __shared__ __align__(16) uint32_t region[kWarpWords];
  __shared__ __align__(16) uint8_t zt[kZBits];  // the run table, by bit mod kZBits
  __shared__ int32_t walked_to;  // warp 0's position after its last chunk
  __shared__ int walk_ovf, extract_ovf, stop;
  const int lane = threadIdx.x & (kWarp - 1);
  const bool walker = threadIdx.x < kWarp;
  const int32_t b = blockIdx.x;

  // every thread parses (the same reads, broadcast); thread 0 writes the fields
  const SubHdr h = parse_subframe(words, nw, pos_in[b], cbps_in[b], T, maxord, out, b,
                                  threadIdx.x == 0);
  const int64_t pos0 = h.pos;
  bool exact = exact_only || pos0 < 0 || T > kMaxFastT ||
               (h.is_verb && (h.ebps < 1 || h.ebps > 33));

  if (!exact) {
    uint32_t* ring = region;  // kWRing + 2 words
    const int32_t plen = h.rice2 ? 5 : 4;
    const int32_t pesc = h.rice2 ? 31 : 15;
    const int32_t ps = h.ps == 0 ? 1 : (int32_t)h.ps;  // t mod 0 is 0, as in flac_tpu
    const int32_t order = h.order > T ? T : (int32_t)h.order;
    const int32_t ebps = (int32_t)h.ebps;
    const bool is_coded = h.is_coded, is_verb = h.is_verb;
    const int32_t r0 = (int32_t)(pos0 & 31);  // relative bit of the first sample
    if (threadIdx.x == 0) walk_ovf = extract_ovf = stop = 0;
    __syncthreads();

    if (walker) {
      // ---- warp 0, lane 0: phase A, each sample's first bit ---------------
      int32_t r = r0;                // relative bit position
      int32_t navail = 256 - r0;     // flac_tpu's window bookkeeping
      int32_t tmod = 0, k = 0, k1 = 1, rawlen = 0;  // k1 = k + 1
      bool esc = false;
      uint32_t code = 0;  // rec's low bits: 32 | rawlen if escaped, else k
      int ovf = 0;
      // one step of flac_tpu's window bookkeeping on the bits it spent
      auto replay = [&](int32_t spent) {
        ovf |= spent > navail;
        navail = max(navail - spent, 0);
        navail += 32 * (navail > 256 - 32 ? 0 : min(kNload, ((256 - 32 - navail) >> 5) + 1));
      };
      // a partition boundary: the parameter, and an escaped partition's width
      auto boundary = [&]() {
        k = ring_bits(ring, r, plen);
        r += plen;
        esc = k == pesc;
        k1 = k + 1;
        if (esc) {
          rawlen = ring_bits(ring, r, 5);
          r += 5;
        }
        code = esc ? 32u | (uint32_t)rawlen : (uint32_t)k;
      };
      // one sample of a coded subframe (`live`: it holds a value): returns
      // its rec entry (its first bit and the partition's code) and moves r
      // to the next start. The run comes from the table, so the chain is
      // r -> mask -> one shared byte load -> add -> select; phase B reads
      // the run again for the value and the flag.
      auto walk_sample = [&](bool live) {
        const uint32_t e = ((uint32_t)r << 6) | code;
        const int32_t z = zt[r & (kZBits - 1)];
        const int32_t other = live ? r + rawlen : r;  // escaped, or no value
        r = live && !esc ? r + k1 + z : other;  // the run, its stop bit, k LSBs
        return e;
      };
      // partitions of whole steps, in whole chunks
      const bool whole_steps = ps % kU == 0 && T % kU == 0;
      for (int32_t c0 = 0; c0 < T; c0 += kChunk) {
        bar_sync(kBarReady);  // this chunk's words are staged and their runs built
        if (stop) break;
        const int32_t cend = min(c0 + kChunk, T);
        uint32_t* rec = region + kRecAt + ((c0 / kChunk) & 1) * kChunk;
        // A flagged step does not end the walk: it goes on over garbage (every
        // read stays inside the ring and the table) until warp 1 stops it,
        // and the frame takes the exact path.
        if (lane == 0) {
          if (is_coded && whole_steps) {
            // partitions of whole steps: the parameter is read once a
            // partition, and the samples between run without a branch
            int32_t r_step = r;  // the step's first bit, before its parameter
            for (int32_t s0 = c0; s0 < cend;) {
              if (tmod == 0) boundary();
              const int32_t send = min(cend, s0 + ps - tmod);
              tmod = tmod + (send - s0) == ps ? 0 : tmod + (send - s0);
              for (; s0 < send; s0 += kU) {
                uint32_t e[kU];
#pragma unroll
                for (int32_t j = 0; j < kU; ++j) e[j] = walk_sample(s0 + j >= order);
                // the step's entries leave in one store (s0 - c0 is a
                // multiple of 4)
                *reinterpret_cast<uint4*>(rec + (s0 - c0)) = make_uint4(e[0], e[1], e[2], e[3]);
                replay(r - r_step);
                r_step = r;
              }
            }
          } else if (is_coded) {  // any partition size, any T
            for (int32_t s0 = c0; s0 < cend; s0 += kU) {
              const int32_t r_step = r;
#pragma unroll
              for (int32_t j = 0; j < kU; ++j) {
                const int32_t t = s0 + j;
                if (tmod == 0 && t < cend) boundary();
                tmod = tmod + 1 == ps ? 0 : tmod + 1;
                rec[t - c0] = walk_sample(t >= order && t < cend);
              }
              replay(r - r_step);
            }
          } else {  // VERBATIM (ebps bits a sample) or nothing to read
            for (int32_t s0 = c0; s0 < cend; s0 += kU) {
              const int32_t spent = is_verb ? ebps * min(kU, cend - s0) : 0;
              replay(spent);
              r += spent;
            }
          }
          walked_to = r;
          walk_ovf = ovf;
        }
        __syncwarp();
        bar_arrive(kBarWalked);
      }
    } else {
      // ---- warp 1: staging, the run table and phase B --------------------
      const int64_t wb0 = pos0 >> 5;  // relative word 0
      int32_t staged = 0, built = 0;  // relative words
      // relative words [staged, end) go to the ring, 32 a round, one a lane,
      // and are waited for
      auto stage_to = [&](int32_t end) {
        for (; staged < end; staged += kWarp) {
          const int32_t w = staged + lane;
          const uint32_t* src = words + word_index(wb0 + w, nw);
          const int slot = w & (kWRing - 1);
          cp_async4(ring + slot, src);
          if (slot < 2) cp_async4(ring + kWRing + slot, src);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
      };
      // the run table: for every bit of relative words [built, end), the
      // zero run that starts there, counted over up to 3 words (so a run of
      // 48 or more shows as one); a word a lane, its 32 entries in two stores
      auto build_runs = [&](int32_t end) {
        for (; built < end; built += kWarp) {
          const int32_t w = built + lane;
          const int32_t i = w & (kWRing - 1);
          const uint32_t x = ring[i], y = ring[i + 1], u = ring[i + 2];
          const int32_t zy = y != 0u ? __clz(y) : 32 + __clz(u);
          uint32_t packed[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int bit = 4 * q + j;
              const uint32_t v = x << bit;
              const uint32_t z = v != 0u ? (uint32_t)__clz(v) : (uint32_t)(32 - bit + zy);
              word |= z << (8 * j);
            }
            packed[q] = word;
          }
          uint4* dst = reinterpret_cast<uint4*>(zt + ((w * 32) & (kZBits - 1)));
          dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
        }
      };
      int64_t* row = res + (int64_t)b * T;
      int ovf = 0;
      stage_to(kLead);
      build_runs(kAhead);
      bar_arrive(kBarReady);  // chunk 0 (and chunk 1) are built
      for (int32_t c0 = 0; c0 < T; c0 += kChunk) {
        bar_sync(kBarWalked);  // warp 0 has walked chunk c0
        const int32_t r1 = walked_to;
        const int32_t cend = min(c0 + kChunk, T);
        if (cend < T) {
          // the next chunk's words were built a round ago: let warp 0 go,
          // or stop it if this frame is flagged
          const bool flagged = __any_sync(kFull, ovf) || walk_ovf;
          if (flagged && lane == 0) stop = 1;
          __syncwarp();
          bar_arrive(kBarReady);
          if (flagged) break;
          stage_to((r1 >> 5) + kLead);
          build_runs((r1 >> 5) + kAhead);
        }
        // ---- phase B: chunk c0's values, 32 samples a round (the rounds
        // are independent, so they overlap) ------------------------------
        const uint32_t* rec = region + kRecAt + ((c0 / kChunk) & 1) * kChunk;
#pragma unroll
        for (int32_t q = 0; q < kChunk / kWarp; ++q) {
          const int32_t t = c0 + q * kWarp + lane;
          if (t >= cend) break;
          int64_t v = 0;
          if (is_coded && t >= order) {
            const uint32_t e = rec[t - c0];
            const int32_t n = (int32_t)(e & 31);
            int32_t p = (int32_t)(e >> 6);
            int32_t z = 0;
            if (!(e & 32u)) {  // Rice: the unary run, then the LSBs
              z = zt[p & (kZBits - 1)];
              ovf |= z >= 48;
              p += z + 1;
            }
            const uint64_t top = n > 0 ? ring_peek64(ring, p) >> (64 - n) : 0;
            if (e & 32u) {
              v = sign_extend((int64_t)top, n);
            } else {
              const int64_t folded = ((int64_t)z << n) | (int64_t)top;
              v = (folded >> 1) ^ -(folded & 1);
            }
          } else if (is_verb) {
            const int32_t p = r0 + t * ebps;
            v = sign_extend((int64_t)(ring_peek64(ring, p) >> (64 - ebps)), ebps);
          }
          row[t] = v;
        }
      }
      ovf = __any_sync(kFull, ovf);
      if (lane == 0) extract_ovf = ovf;
    }
    __syncthreads();
    if (walk_ovf || extract_ovf || stop) {
      exact = true;
    } else if (threadIdx.x == 0) {
      pos_out[b] = pos0 + (walked_to - r0);
      ovf_out[b] = 0;
    }
  }
  if (exact && threadIdx.x == 0) {
    atomicAdd(&exact_frames, 1ull);
    scan_wide(words, nw, region, 0, pos0, h.is_coded, h.is_verb, h.ebps, h.order,
              h.rice2, h.ps, T, res, b, pos_out, ovf_out);
  }
}

// one thread, `iters` dependent walk steps over a run table of runs 0 to 3
// (a Rice parameter of 8): walk_sample's chain (the table index, one shared
// byte load, the add and the select) with nothing else; out[0] keeps the
// chain alive
__global__ void walk_latency_kernel(int64_t iters, int32_t* out) {
  __shared__ uint8_t zt[kZBits];
  for (int i = threadIdx.x; i < kZBits; i += blockDim.x) zt[i] = (uint8_t)(i & 3);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t r = 0;
  const int32_t k1 = 9;
  const bool rice = iters > 0;
  for (int64_t n = 0; n < iters; ++n) {
    const int32_t z = zt[r & (kZBits - 1)];
    r = rice ? r + k1 + z : r + 1;
  }
  out[0] = r;
}

}  // namespace

// words int32 [nwords] (the stream, big-endian bit order); pos, cbps int64
// [B] (each frame's first subframe-header bit and sample width). Writes
// read_subframe_header's fields (`sub`: pos, is_const, is_verb, is_fixed,
// is_lpc, is_coded as bool [B]; order, wasted, ebps, cval, shift, plen,
// pesc, ps as int64 [B]; warm, qlp as int64 [B, maxord]), res [B, T] (int32
// for the narrow scan, int64 for the wide one), pos_out int64 [B] (after
// the samples) and ovf bool [B]. `wide`: 0 the narrow scan, 1 the wide one,
// 2 the wide one with every frame on its exact path. Launches on `stream`;
// returns cudaGetLastError().
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
    if (wide) {
      wide_scan_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, nwords, (const int64_t*)pos, (const int64_t*)cbps,
          out, (int64_t*)res, (int64_t*)pos_out, (uint8_t*)ovf, batch, T, maxord,
          wide == 2);
    } else {
      const int blocks = (batch + kWarp - 1) / kWarp;
      subframe_scan_kernel<<<blocks, kWarp, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, nwords, (const int64_t*)pos, (const int64_t*)cbps,
          out, (int32_t*)res, (int64_t*)pos_out, (uint8_t*)ovf, batch, T, maxord);
    }
  }
  return (int)cudaGetLastError();
}

// The number of frames the wide scan sent to its exact path since the last
// call, into *count; resets it. Synchronous. Returns the CUDA error.
extern "C" int flac_subframe_scan_exact_frames(unsigned long long* count) {
  const unsigned long long zero = 0;
  cudaError_t e = cudaMemcpyFromSymbol(count, exact_frames, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(exact_frames, &zero, sizeof(zero));
  return (int)e;
}

// The walk's latency probe: one thread runs `iters` dependent walk steps;
// the caller times two lengths with CUDA events.
extern "C" int flac_walk_latency_probe(int64_t iters, int32_t* out, void* stream) {
  walk_latency_kernel<<<1, kWarp, 0, (cudaStream_t)stream>>>(iters, out);
  return (int)cudaGetLastError();
}
