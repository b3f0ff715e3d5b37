// Native host runtime for flac_tpu — the C++ analog of the reference's
// hand-written kernels on the *host* side of the framework (the device side
// is JAX/XLA). Covers the sequential hot loops that back the robustness/
// fallback decoder, seek reads, analysis mode, and the MD5 stream contract:
//
//   - Rice residual block decode   (bitreader.c:775 hot loop)
//   - raw fixed-width signed reads (verbatim subframes, escaped partitions)
//   - unary + UTF-8 coded numbers  (bitreader.c:999,1054)
//   - LPC / fixed restore          (lpc.c:795, fixed.c:395)
//   - CRC-8 / CRC-16               (crc.c)
//   - frame sync scan              (stream_decoder.c:1941)
//   - the FLAC MD5 variant         (md5.c:23-33 big-endian word loading)
//
// Build: g++ -O3 -shared -fPIC (see flac_tpu/_native/__init__.py).
// Exposed as a plain C ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// Bit reading
// ---------------------------------------------------------------------------

struct BitCursor {
    const uint8_t* data;
    size_t nbytes;
    size_t bitpos;
};

static inline int read_bit(BitCursor* c) {
    size_t byte = c->bitpos >> 3;
    if (byte >= c->nbytes) return -1;
    int bit = (c->data[byte] >> (7 - (c->bitpos & 7))) & 1;
    c->bitpos++;
    return bit;
}

static inline int64_t read_bits(BitCursor* c, unsigned n) {
    // MSB-first read of up to 57 bits via a 64-bit window
    if (n == 0) return 0;
    size_t byte = c->bitpos >> 3;
    unsigned off = (unsigned)(c->bitpos & 7);
    if (((c->bitpos + n + 7) >> 3) > c->nbytes) return -1;
    uint64_t window = 0;
    unsigned avail = 0;
    while (avail < off + n) {
        window = (window << 8) | (byte < c->nbytes ? c->data[byte] : 0);
        byte++;
        avail += 8;
    }
    c->bitpos += n;
    return (int64_t)((window >> (avail - off - n)) & ((n == 64) ? ~0ULL : ((1ULL << n) - 1)));
}

static inline int64_t read_unary(BitCursor* c) {
    int64_t q = 0;
    size_t byte = c->bitpos >> 3;
    unsigned off = (unsigned)(c->bitpos & 7);
    while (byte < c->nbytes) {
        uint8_t window = (uint8_t)(c->data[byte] & (0xFFu >> off));
        if (window == 0) {
            q += 8 - off;
            c->bitpos += 8 - off;
            byte++;
            off = 0;
            continue;
        }
        // index of highest set bit from the MSB side
        unsigned lead = (unsigned)__builtin_clz((unsigned)window) - 24u;
        q += lead - off;
        c->bitpos += lead - off + 1;
        return q;
    }
    return -1;
}

// Decode `n` Rice-coded signed values with parameter `param` starting at
// absolute bit position *bitpos. Returns 0 on success, -1 on overrun;
// updates *bitpos.
int flacn_rice_read_block(const uint8_t* data, size_t nbytes, uint64_t* bitpos,
                          int64_t* out, size_t n, unsigned param) {
    BitCursor c{data, nbytes, (size_t)*bitpos};
    for (size_t i = 0; i < n; i++) {
        int64_t q = read_unary(&c);
        if (q < 0) return -1;
        uint64_t folded;
        if (param) {
            int64_t low = read_bits(&c, param);
            if (low < 0) return -1;
            folded = ((uint64_t)q << param) | (uint64_t)low;
        } else {
            folded = (uint64_t)q;
        }
        out[i] = (int64_t)(folded >> 1) ^ -(int64_t)(folded & 1);
    }
    *bitpos = c.bitpos;
    return 0;
}

// Read `n` fixed-width (`width` bits) two's-complement values.
int flacn_read_signed_array(const uint8_t* data, size_t nbytes, uint64_t* bitpos,
                            int64_t* out, size_t n, unsigned width) {
    BitCursor c{data, nbytes, (size_t)*bitpos};
    const int64_t half = width ? (1LL << (width - 1)) : 0;
    const int64_t full = width ? (1LL << width) : 0;
    for (size_t i = 0; i < n; i++) {
        if (width == 0) { out[i] = 0; continue; }
        int64_t v = read_bits(&c, width);
        if (v < 0 && width < 64) return -1;
        out[i] = (v >= half) ? v - full : v;
    }
    *bitpos = c.bitpos;
    return 0;
}

// UTF-8-style extended number (bitreader.c:999). Returns value or -1.
int64_t flacn_read_utf8(const uint8_t* data, size_t nbytes, uint64_t* bitpos) {
    BitCursor c{data, nbytes, (size_t)*bitpos};
    int64_t b0 = read_bits(&c, 8);
    if (b0 < 0) return -1;
    unsigned nfollow = 0;
    uint64_t v;
    if ((b0 & 0x80) == 0) { v = (uint64_t)b0; }
    else {
        uint8_t mask = 0x40;
        nfollow = 0;
        while (b0 & mask) { nfollow++; mask >>= 1; }
        if (nfollow == 0 || nfollow > 6) return -1;
        v = (uint64_t)(b0 & (0x3F >> nfollow));
        for (unsigned k = 0; k < nfollow; k++) {
            int64_t bk = read_bits(&c, 8);
            if (bk < 0 || (bk & 0xC0) != 0x80) return -1;
            v = (v << 6) | (uint64_t)(bk & 0x3F);
        }
    }
    *bitpos = c.bitpos;
    return (int64_t)v;
}

// ---------------------------------------------------------------------------
// Predictor restore (decoder recurrences)
// ---------------------------------------------------------------------------

// out[order..order+n) = residual + (qlp · history) >> shift; out[0..order)
// pre-filled with warmup by the caller (lpc.c:795 semantics, 64-bit path).
void flacn_lpc_restore(const int64_t* residual, size_t n, const int32_t* qlp,
                       unsigned order, int shift, int64_t* out) {
    for (size_t t = 0; t < n; t++) {
        int64_t acc = 0;
        const int64_t* h = out + order + t;
        for (unsigned j = 0; j < order; j++) acc += (int64_t)qlp[j] * h[-1 - (int)j];
        out[order + t] = residual[t] + (acc >> shift);
    }
}

void flacn_fixed_restore(const int64_t* residual, size_t n, unsigned order,
                         int64_t* out) {
    // polynomial predictors 0-4 (fixed.c:395)
    switch (order) {
    case 0:
        memcpy(out, residual, n * sizeof(int64_t));
        break;
    case 1:
        for (size_t t = 0; t < n; t++) out[1 + t] = residual[t] + out[t];
        break;
    case 2:
        for (size_t t = 0; t < n; t++)
            out[2 + t] = residual[t] + 2 * out[1 + t] - out[t];
        break;
    case 3:
        for (size_t t = 0; t < n; t++)
            out[3 + t] = residual[t] + 3 * out[2 + t] - 3 * out[1 + t] + out[t];
        break;
    case 4:
        for (size_t t = 0; t < n; t++)
            out[4 + t] = residual[t] + 4 * out[3 + t] - 6 * out[2 + t]
                         + 4 * out[1 + t] - out[t];
        break;
    }
}

// ---------------------------------------------------------------------------
// CRC (crc.c polynomials)
// ---------------------------------------------------------------------------

static uint8_t crc8_table[256];
static uint16_t crc16_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (int i = 0; i < 256; i++) {
        unsigned r8 = (unsigned)i;
        for (int k = 0; k < 8; k++) r8 = (r8 << 1) ^ ((r8 & 0x80) ? 0x107 : 0);
        crc8_table[i] = (uint8_t)r8;
        unsigned r16 = (unsigned)i << 8;
        for (int k = 0; k < 8; k++) r16 = (r16 << 1) ^ ((r16 & 0x8000) ? 0x18005 : 0);
        crc16_table[i] = (uint16_t)r16;
    }
    crc_init_done = true;
}

uint8_t flacn_crc8(const uint8_t* data, size_t n) {
    if (!crc_init_done) crc_init();
    uint8_t crc = 0;
    for (size_t i = 0; i < n; i++) crc = crc8_table[crc ^ data[i]];
    return crc;
}

static uint16_t crc16_run(const uint8_t* p, int64_t len);
static void crc16_slice_init();

uint16_t flacn_crc16(const uint8_t* data, size_t n) {
    crc16_slice_init();  // gated internally
    return crc16_run(data, (int64_t)n);
}

// Slicing-by-8 CRC-16: T[k][x] = CRC of byte x followed by k zero bytes.
// Eight table lookups consume eight message bytes per step instead of one
// (the classic Intel slicing construction, polynomial-agnostic).
static uint16_t crc16_slice[8][256];
static bool crc16_slice_done = false;

static void crc16_slice_init() {
    if (crc16_slice_done) return;
    if (!crc_init_done) crc_init();
    for (int x = 0; x < 256; x++) crc16_slice[0][x] = crc16_table[x];
    for (int k = 1; k < 8; k++)
        for (int x = 0; x < 256; x++) {
            uint16_t c = crc16_slice[k - 1][x];
            crc16_slice[k][x] = (uint16_t)((c << 8) ^ crc16_table[c >> 8]);
        }
    crc16_slice_done = true;
}

static uint16_t crc16_run(const uint8_t* p, int64_t len) {
    uint16_t crc = 0;
    int64_t j = 0;
    for (; j + 8 <= len; j += 8) {
        // fold the running CRC into the first two bytes, then eight
        // independent lookups (ILP: no serial dependency within the step)
        crc = (uint16_t)(crc16_slice[7][(crc >> 8) ^ p[j]]
                         ^ crc16_slice[6][(crc & 0xFF) ^ p[j + 1]]
                         ^ crc16_slice[5][p[j + 2]]
                         ^ crc16_slice[4][p[j + 3]]
                         ^ crc16_slice[3][p[j + 4]]
                         ^ crc16_slice[2][p[j + 5]]
                         ^ crc16_slice[1][p[j + 6]]
                         ^ crc16_slice[0][p[j + 7]]);
    }
    for (; j < len; j++)
        crc = (uint16_t)((crc << 8) ^ crc16_table[(crc >> 8) ^ p[j]]);
    return crc;
}

// Batched frame-CRC validation over one stream buffer: out[i] = CRC-16 of
// data[offsets[i] .. offsets[i]+lengths[i]). One call replaces a Python
// loop of per-frame slices + ctypes calls; with slicing-by-8 the decode
// pipeline's whole-batch CRC check drops from 32 ms to a few ms per
// 512-frame batch. Rows reaching past the buffer are clamped (the CRC
// then simply mismatches, as the corrupt-stream callers expect).
void flacn_crc16_many(const uint8_t* data, size_t nbytes,
                      const int64_t* offsets, const int64_t* lengths,
                      size_t n, uint16_t* out) {
    crc16_slice_init();  // gated internally
    for (size_t i = 0; i < n; i++) {
        int64_t off = offsets[i] < 0 ? 0 : offsets[i];
        if (off > (int64_t)nbytes) off = (int64_t)nbytes;
        int64_t len = lengths[i] < 0 ? 0 : lengths[i];
        if (off + len > (int64_t)nbytes) len = (int64_t)nbytes - off;
        out[i] = crc16_run(data + off, len);
    }
}

// ---------------------------------------------------------------------------
// Frame sync scan (byte-aligned 0xFF 0xF8/0xF9)
// ---------------------------------------------------------------------------

int64_t flacn_find_sync(const uint8_t* data, size_t n, size_t from) {
    for (size_t i = from; i + 1 < n; i++) {
        if (data[i] == 0xFF && (data[i + 1] & 0xFE) == 0xF8) return (int64_t)i;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// FLAC MD5 variant: standard MD5 rounds, block data words loaded BIG-endian
// (md5.c:23-33), 64-bit length trailer appended as two host-LE words, digest
// serialized little-endian.
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

static void md5_transform(uint32_t state[4], const uint32_t in[16]) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    // fully unrolled RFC 1321 rounds (the loop-form version branched on the
    // round per step and ran ~174 MB/s; unrolling lifts the MD5 stage —
    // every decode's verdict and every encode's STREAMINFO hash — to the
    // memory-bound range). F uses the d^(b&(c^d)) form (one op fewer).
#define MD5_STEP(F, w, x, y, z, i, g, s) \
    w += F(x, y, z) + K[i] + in[g]; w = rotl32(w, s) + x;
#define MD5_F(x, y, z) ((z) ^ ((x) & ((y) ^ (z))))
#define MD5_G(x, y, z) ((y) ^ ((z) & ((x) ^ (y))))
#define MD5_H(x, y, z) ((x) ^ (y) ^ (z))
#define MD5_I(x, y, z) ((y) ^ ((x) | ~(z)))
    MD5_STEP(MD5_F, a, b, c, d,  0,  0,  7) MD5_STEP(MD5_F, d, a, b, c,  1,  1, 12)
    MD5_STEP(MD5_F, c, d, a, b,  2,  2, 17) MD5_STEP(MD5_F, b, c, d, a,  3,  3, 22)
    MD5_STEP(MD5_F, a, b, c, d,  4,  4,  7) MD5_STEP(MD5_F, d, a, b, c,  5,  5, 12)
    MD5_STEP(MD5_F, c, d, a, b,  6,  6, 17) MD5_STEP(MD5_F, b, c, d, a,  7,  7, 22)
    MD5_STEP(MD5_F, a, b, c, d,  8,  8,  7) MD5_STEP(MD5_F, d, a, b, c,  9,  9, 12)
    MD5_STEP(MD5_F, c, d, a, b, 10, 10, 17) MD5_STEP(MD5_F, b, c, d, a, 11, 11, 22)
    MD5_STEP(MD5_F, a, b, c, d, 12, 12,  7) MD5_STEP(MD5_F, d, a, b, c, 13, 13, 12)
    MD5_STEP(MD5_F, c, d, a, b, 14, 14, 17) MD5_STEP(MD5_F, b, c, d, a, 15, 15, 22)
    MD5_STEP(MD5_G, a, b, c, d, 16,  1,  5) MD5_STEP(MD5_G, d, a, b, c, 17,  6,  9)
    MD5_STEP(MD5_G, c, d, a, b, 18, 11, 14) MD5_STEP(MD5_G, b, c, d, a, 19,  0, 20)
    MD5_STEP(MD5_G, a, b, c, d, 20,  5,  5) MD5_STEP(MD5_G, d, a, b, c, 21, 10,  9)
    MD5_STEP(MD5_G, c, d, a, b, 22, 15, 14) MD5_STEP(MD5_G, b, c, d, a, 23,  4, 20)
    MD5_STEP(MD5_G, a, b, c, d, 24,  9,  5) MD5_STEP(MD5_G, d, a, b, c, 25, 14,  9)
    MD5_STEP(MD5_G, c, d, a, b, 26,  3, 14) MD5_STEP(MD5_G, b, c, d, a, 27,  8, 20)
    MD5_STEP(MD5_G, a, b, c, d, 28, 13,  5) MD5_STEP(MD5_G, d, a, b, c, 29,  2,  9)
    MD5_STEP(MD5_G, c, d, a, b, 30,  7, 14) MD5_STEP(MD5_G, b, c, d, a, 31, 12, 20)
    MD5_STEP(MD5_H, a, b, c, d, 32,  5,  4) MD5_STEP(MD5_H, d, a, b, c, 33,  8, 11)
    MD5_STEP(MD5_H, c, d, a, b, 34, 11, 16) MD5_STEP(MD5_H, b, c, d, a, 35, 14, 23)
    MD5_STEP(MD5_H, a, b, c, d, 36,  1,  4) MD5_STEP(MD5_H, d, a, b, c, 37,  4, 11)
    MD5_STEP(MD5_H, c, d, a, b, 38,  7, 16) MD5_STEP(MD5_H, b, c, d, a, 39, 10, 23)
    MD5_STEP(MD5_H, a, b, c, d, 40, 13,  4) MD5_STEP(MD5_H, d, a, b, c, 41,  0, 11)
    MD5_STEP(MD5_H, c, d, a, b, 42,  3, 16) MD5_STEP(MD5_H, b, c, d, a, 43,  6, 23)
    MD5_STEP(MD5_H, a, b, c, d, 44,  9,  4) MD5_STEP(MD5_H, d, a, b, c, 45, 12, 11)
    MD5_STEP(MD5_H, c, d, a, b, 46, 15, 16) MD5_STEP(MD5_H, b, c, d, a, 47,  2, 23)
    MD5_STEP(MD5_I, a, b, c, d, 48,  0,  6) MD5_STEP(MD5_I, d, a, b, c, 49,  7, 10)
    MD5_STEP(MD5_I, c, d, a, b, 50, 14, 15) MD5_STEP(MD5_I, b, c, d, a, 51,  5, 21)
    MD5_STEP(MD5_I, a, b, c, d, 52, 12,  6) MD5_STEP(MD5_I, d, a, b, c, 53,  3, 10)
    MD5_STEP(MD5_I, c, d, a, b, 54, 10, 15) MD5_STEP(MD5_I, b, c, d, a, 55,  1, 21)
    MD5_STEP(MD5_I, a, b, c, d, 56,  8,  6) MD5_STEP(MD5_I, d, a, b, c, 57, 15, 10)
    MD5_STEP(MD5_I, c, d, a, b, 58,  6, 15) MD5_STEP(MD5_I, b, c, d, a, 59, 13, 21)
    MD5_STEP(MD5_I, a, b, c, d, 60,  4,  6) MD5_STEP(MD5_I, d, a, b, c, 61, 11, 10)
    MD5_STEP(MD5_I, c, d, a, b, 62,  2, 15) MD5_STEP(MD5_I, b, c, d, a, 63,  9, 21)
#undef MD5_STEP
#undef MD5_F
#undef MD5_G
#undef MD5_H
#undef MD5_I
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
}

struct FlacMD5 {
    uint32_t state[4];
    uint64_t length;
    uint8_t buffer[64];
    size_t buffered;
};

void flacn_md5_init(FlacMD5* ctx) {
    ctx->state[0] = 0x67452301; ctx->state[1] = 0xefcdab89;
    ctx->state[2] = 0x98badcfe; ctx->state[3] = 0x10325476;
    ctx->length = 0;
    ctx->buffered = 0;
}

static void md5_block_be(FlacMD5* ctx, const uint8_t* p) {
    uint32_t w[16];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16)
             | ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
    md5_transform(ctx->state, w);
}

void flacn_md5_update(FlacMD5* ctx, const uint8_t* data, size_t n) {
    ctx->length += n;
    if (ctx->buffered) {
        size_t take = 64 - ctx->buffered;
        if (take > n) take = n;
        memcpy(ctx->buffer + ctx->buffered, data, take);
        ctx->buffered += take;
        data += take; n -= take;
        if (ctx->buffered == 64) { md5_block_be(ctx, ctx->buffer); ctx->buffered = 0; }
    }
    while (n >= 64) { md5_block_be(ctx, data); data += 64; n -= 64; }
    if (n) { memcpy(ctx->buffer, data, n); ctx->buffered = n; }
}

void flacn_md5_final(FlacMD5* ctx, uint8_t out[16]) {
    uint8_t tail[64];
    size_t used = ctx->buffered;
    memcpy(tail, ctx->buffer, used);
    tail[used++] = 0x80;
    if (used > 56) {
        memset(tail + used, 0, 64 - used);
        md5_block_be(ctx, tail);
        used = 0;
    }
    memset(tail + used, 0, 56 - used);
    uint32_t w[16];
    for (int i = 0; i < 14; i++)
        w[i] = ((uint32_t)tail[4 * i] << 24) | ((uint32_t)tail[4 * i + 1] << 16)
             | ((uint32_t)tail[4 * i + 2] << 8) | (uint32_t)tail[4 * i + 3];
    uint64_t bits = ctx->length << 3;
    w[14] = (uint32_t)(bits & 0xFFFFFFFFu);
    w[15] = (uint32_t)(bits >> 32);
    md5_transform(ctx->state, w);
    for (int i = 0; i < 4; i++) {
        out[4 * i] = (uint8_t)(ctx->state[i]);
        out[4 * i + 1] = (uint8_t)(ctx->state[i] >> 8);
        out[4 * i + 2] = (uint8_t)(ctx->state[i] >> 16);
        out[4 * i + 3] = (uint8_t)(ctx->state[i] >> 24);
    }
}

size_t flacn_md5_sizeof() { return sizeof(FlacMD5); }

void flacn_md5_digest(const uint8_t* data, size_t n, uint8_t out[16]) {
    FlacMD5 ctx;
    flacn_md5_init(&ctx);
    flacn_md5_update(&ctx, data, n);
    flacn_md5_final(&ctx, out);
}

// ---------------------------------------------------------------------------
// ReplayGain synthesis: gain + limiter + dither with noise shaping
// (replaygain_synthesis.c:216 dither_output_, :300-462 apply_gain;
// the error-feedback loop is sample-sequential, hence host-native)
// ---------------------------------------------------------------------------

#define RG_MAX_CH 8

struct RgDitherCtx {
    uint32_t r1, r2;                   // two-polycounter RNG state
    int32_t last_random[RG_MAX_CH];    // shaping-0 high-passed dither memory
    float dither_hist[RG_MAX_CH][16];
    float error_hist[RG_MAX_CH][16];
    uint32_t last_history_index;
};

// 16-tap psychoacoustic shaping filters at 44.1 kHz (the published WaveGain
// coefficient sets the reference embeds, replaygain_synthesis.c:131-196;
// shaping 0 uses no filter)
static const float RG_F44[3][16] = {
    { 0.85018292704024355931f,  0.29089597350995344721f, -0.05021866022121039450f,
     -0.23545456294599161833f, -0.58362726442227032096f, -0.67038978965193036429f,
     -0.38566861572833459221f, -0.15218663390367969967f, -0.02577543084864530676f,
      0.14119295297688728127f,  0.22398848581628781612f,  0.15401727203382084116f,
      0.05216161232906000929f, -0.00282237820999675451f, -0.03042794608323867363f,
     -0.03109780942998826024f},
    { 1.78827593892108555290f,  0.95508210637394326553f, -0.18447626783899924429f,
     -0.44198126506275016437f, -0.88404052492547413497f, -1.42218907262407452967f,
     -1.02037566838362314995f, -0.34861755756425577264f, -0.11490230170431934434f,
      0.12498899339968611803f,  0.38065885268563131927f,  0.31883491321310506562f,
      0.10486838686563442765f, -0.03105361685110374845f, -0.06450524884075370758f,
     -0.02939198261121969816f},
    { 2.89072132015058161445f,  2.68932810943698754106f,  0.21083359339410251227f,
     -0.98385073324997617515f, -1.11047823227097316719f, -2.18954076314139673147f,
     -2.36498032881953056225f, -0.95484132880101140785f, -0.23924057925542965158f,
     -0.13865235703915925642f,  0.43587843191057992846f,  0.65903257226026665927f,
      0.24361815372443152787f, -0.00235974960154720097f,  0.01844166574603346289f,
      0.01722945988740875099f},
};

size_t flacn_rg_ctx_sizeof() { return sizeof(RgDitherCtx); }

void flacn_rg_ctx_init(void* vctx) {
    RgDitherCtx* c = (RgDitherCtx*)vctx;
    memset(c, 0, sizeof(*c));
    c->r1 = c->r2 = 1;  // the reference RNG's static initial state
}

// opposite-rotation polycounter pair, periods coprime
// (replaygain_synthesis.c:92-117); parity via the builtin, not a table
static inline uint32_t rg_rand(RgDitherCtx* c) {
    uint32_t t1 = c->r1, t2 = c->r2;
    uint32_t p1 = (uint32_t)__builtin_parity(t1 & 0xF5u);
    uint32_t p2 = (uint32_t)__builtin_parity((t2 >> 25) & 0x63u);
    c->r1 = (t1 >> 1) | (p1 << 31);
    c->r2 = (t2 + t2) | p2;
    return c->r1 ^ c->r2;
}

// the reference's magic-number double->int64 round-to-even
// (dither_output_'s ROUND64, replaygain_synthesis.c:247)
static inline int64_t rg_round64(double x, double add) {
    union { double d; int64_t i; } u;
    u.d = x + add + (double)0x001FFFFD80000000LL;
    return u.i - 0x433FFFFD80000000LL;
}

// in/out are interleaved [wide_samples, channels] int32; `scale` already
// includes preamp and peak-limiting (grabbag__replaygain_compute_scale_factor)
void flacn_rg_apply(void* vctx, const int32_t* in, size_t wide_samples,
                    uint32_t channels, uint32_t source_bps, uint32_t target_bps,
                    double scale, int hard_limit, int do_dither, int shaping,
                    int32_t* out) {
    RgDitherCtx* c = (RgDitherCtx*)vctx;
    if (shaping < 0) shaping = 0;
    if (shaping > 3) shaping = 3;
    static const uint8_t default_dither[10] = {92, 92, 88, 84, 81, 78, 74, 67, 0, 0};
    // The reference splits the widths: DitherContext is initialized with the
    // STREAM bps (decode.c:1353 passes decoder_session->bps), so Add/Mask/
    // Dither quantize at the SOURCE width, while conv/hard_clip come from
    // the apply call's target_bps (replaygain_synthesis.c:226-228,372-373).
    // For bps%8 streams (source 20 -> target 24) the dithered output is
    // therefore a source-width value scaled to the padded byte width.
    int di = (int)source_bps - 11 - shaping;
    if (di < 0) di = 0;
    if (di > 9) di = 9;
    const double dither_mult =
        (double)(0.01f * default_dither[di]) / (double)((int64_t)1 << source_bps);
    const double add = 0.5 * (double)(((int64_t)1 << (32 - source_bps)) - 1);
    const uint64_t mask = ~(uint64_t)0 << (32 - source_bps);
    const int64_t conv = (int64_t)1 << (32 - target_bps);
    const int64_t hard_clip = -((int64_t)1 << (target_bps - 1));
    const double multi_scale = scale / (double)(1u << (source_bps - 1));
    const float* coeff = shaping > 0 ? RG_F44[shaping - 1] : RG_F44[0];
    const uint32_t last = c->last_history_index;

    for (uint32_t k = 0; k < channels; k++) {
        for (size_t i = 0; i < wide_samples; i++) {
            double sample = (double)in[i * channels + k] * multi_scale;
            if (hard_limit) {  // soft-knee 6 dB tanh limiter above half scale
                if (sample < -0.5)
                    sample = tanh((sample + 0.5) / 0.5) * 0.5 - 0.5;
                else if (sample > 0.5)
                    sample = tanh((sample - 0.5) / 0.5) * 0.5 + 0.5;
            }
            // the reference writes `sample *= 2147483647.f` — a FLOAT
            // literal, which rounds to 2^31 exactly (replaygain_synthesis.c:415)
            sample *= 2147483648.0;

            int64_t val64;
            uint32_t ridx = (uint32_t)((i + last) % 32) & 15;
            if (!do_dither) {
                val64 = rg_round64(sample, add);
            } else if (shaping == 0) {
                // high-passed rectangular dither
                double tmp = dither_mult * (double)(int32_t)rg_rand(c);
                double sum2 = tmp - c->last_random[k];
                c->last_random[k] = (int32_t)tmp;
                val64 = (int64_t)(rg_round64(sample + sum2, add) & mask);
            } else {
                // triangular dither shaped by the 16-tap filter with error
                // feedback; histories are circular, the filter rotates with i
                float* dh = c->dither_hist[k];
                float* eh = c->error_hist[k];
                double tri = dither_mult * ((double)(int32_t)rg_rand(c)
                                            + (double)(int32_t)rg_rand(c));
                // the reference's scalar16_ evaluates entirely in float
                // (float*float products and float sums) before widening
                float dsumf = 0.0f, esumf = 0.0f;
                for (int j = 0; j < 16; j++) {
                    dsumf += dh[j] * coeff[(ridx + j) & 15];
                    esumf += eh[j] * coeff[(ridx + j) & 15];
                }
                double dsum = (double)dsumf, esum = (double)esumf;
                double sum2 = tri - dsum;
                float stored = (float)sum2;
                dh[(-1 - (int)ridx) & 15] = stored;
                double sum = sample + (double)stored;  // the float-cast value
                                                       // feeds the sum, as in
                                                       // the reference
                val64 = (int64_t)(rg_round64(sum + esum, add) & mask);
                eh[(-1 - (int)ridx) & 15] = (float)(sum - (double)val64);
            }
            val64 /= conv;
            int32_t v;
            if (val64 >= -hard_clip)
                v = (int32_t)(-(hard_clip + 1));
            else if (val64 < hard_clip)
                v = (int32_t)hard_clip;
            else
                v = (int32_t)val64;
            out[i * channels + k] = v;
        }
    }
    c->last_history_index = (uint32_t)((last + wide_samples) % 32);
}

}  // extern "C"
