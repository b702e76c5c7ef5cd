/* Host runtime routines of the PyTorch port (decode side).
 *
 * The entropy decode runs on the GPU (csrc/literals.cu, sequences.cu,
 * compact.cu); these C routines cover the host work around it:
 *
 *   - zt_xxh64: frame content checksums, from the public XXH64 spec.
 *   - zt_execute_sequences: LZ77 sequence execution with memcpy-chunked,
 *     overlap-correct copies (the engine's host assembly stage).
 *   - zt_resolve_offsets: the repeat-offset scan of the device LZ77 route
 *     (kernels/lz77_device.py).
 *   - zt_fse_parse_build / zt_fse_weights: FSE table parse + build and
 *     FSE-compressed Huffman weights (the host prepass's hot calls).
 *
 * Built with plain gcc -O2 -shared at first use and loaded via ctypes
 * (zstd_tpu_torch/native/__init__.py).  Return codes mirror the Python
 * error taxonomy.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ------------------------------ XXH64 ---------------------------------- */

#define P1 0x9E3779B185EBCA87ULL
#define P2 0xC2B2AE3D27D4EB4FULL
#define P3 0x165667B19E3779F9ULL
#define P4 0x85EBCA77C2B2AE63ULL
#define P5 0x27D4EB2F165667C5ULL

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v; /* little-endian hosts only (x86/ARM LE) */
}

static inline uint32_t read32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl64(acc, 31);
    return acc * P1;
}

static inline uint64_t xxh_merge(uint64_t h, uint64_t v) {
    h ^= xxh_round(0, v);
    return h * P1 + P4;
}

EXPORT uint64_t zt_xxh64(const uint8_t *data, size_t n, uint64_t seed) {
    const uint8_t *p = data;
    const uint8_t *end = data + n;
    uint64_t h;

    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t *limit = end - 32;
        do {
            v1 = xxh_round(v1, read64(p));
            v2 = xxh_round(v2, read64(p + 8));
            v3 = xxh_round(v3, read64(p + 16));
            v4 = xxh_round(v4, read64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    while (p + 8 <= end) {
        h ^= xxh_round(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ------------------------ LZ77 sequence execution ----------------------- */

/* Overlap-correct append of `length` bytes from `offset` back.
 * Precondition: offset <= out_len, capacity checked by caller. */
static inline void copy_match(uint8_t *out, size_t out_len, size_t offset,
                              size_t length) {
    const uint8_t *src = out + out_len - offset;
    uint8_t *dst = out + out_len;
    if (offset >= length) {
        memcpy(dst, src, length);
    } else if (offset == 1) {
        memset(dst, src[0], length);
    } else {
        /* Period replication: double the materialized span each memcpy. */
        size_t filled = offset;
        memcpy(dst, src, offset);
        while (filled < length) {
            size_t take = filled < length - filled ? filled : length - filled;
            memcpy(dst + filled, dst, take);
            filled += take;
        }
    }
}

/* Status codes (keep in sync with zstd_tpu_torch/native/__init__.py). */
enum {
    ZT_OK = 0,
    ZT_ERR_NULL_OFFSET = 1,
    ZT_ERR_LITERALS_OVERRUN = 2,
    ZT_ERR_OFFSET_TOO_FAR = 3,
    ZT_ERR_OUTPUT_OVERFLOW = 4,
};

/* Execute `n` sequences (ll[i], offset_value[i], ml[i]) into `out`
 * (which already holds `out_len` bytes of earlier frame output),
 * consuming `literals` and maintaining the 3-slot repeat history `rep`
 * (RFC 8878 §3.1.1.5; decoding_context.rs:50-107).  Trailing literals
 * are appended.  Returns ZT_OK or an error code; *out_len_io is updated
 * to the new output length on success. */
EXPORT int zt_execute_sequences(
    uint8_t *out, size_t cap, size_t *out_len_io,
    const uint8_t *literals, size_t lit_len,
    const int32_t *ll_arr, const uint32_t *ofv_arr, const int32_t *ml_arr,
    size_t n, uint64_t *rep /* [3] */) {
    size_t out_len = *out_len_io;
    size_t lit_pos = 0;

    for (size_t i = 0; i < n; i++) {
        size_t ll = (size_t)ll_arr[i];
        size_t ml = (size_t)ml_arr[i];
        uint64_t ofv = ofv_arr[i];
        uint64_t offset;

        if (ofv == 0) return ZT_ERR_NULL_OFFSET;
        if (ofv > 3) {
            offset = ofv - 3;
            rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset;
        } else {
            uint64_t idx = (ll != 0) ? ofv - 1 : ofv;
            if (idx == 0) {
                offset = rep[0];
            } else if (idx == 1) {
                offset = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else if (idx == 2) {
                offset = rep[2];
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else { /* idx == 3: ll == 0 && ofv == 3 -> rep0 - 1 */
                offset = rep[0] - 1;
                if (offset == 0) return ZT_ERR_NULL_OFFSET;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            }
        }

        if (ll > lit_len - lit_pos) return ZT_ERR_LITERALS_OVERRUN;
        if (out_len + ll + ml > cap) return ZT_ERR_OUTPUT_OVERFLOW;
        memcpy(out + out_len, literals + lit_pos, ll);
        out_len += ll;
        lit_pos += ll;
        if (offset > out_len) return ZT_ERR_OFFSET_TOO_FAR;
        copy_match(out, out_len, (size_t)offset, ml);
        out_len += ml;
    }

    size_t tail = lit_len - lit_pos;
    if (out_len + tail > cap) return ZT_ERR_OUTPUT_OVERFLOW;
    memcpy(out + out_len, literals + lit_pos, tail);
    out_len += tail;

    *out_len_io = out_len;
    return ZT_OK;
}

/* ---------------------- repeat-offset resolution ------------------------ */

/* Resolve n (ll, offset_value) pairs to actual offsets, maintaining the
 * 3-slot history (decoding_context.rs:50-75) — the cheap intrinsically-
 * serial pass of device-side sequence execution, hoisted out of Python
 * (kernels/lz77_device.py builds per-byte source maps from these).
 * Returns 0, or 1 on a null offset. */
EXPORT int zt_resolve_offsets(
    const int32_t *ll_arr, const uint32_t *ofv_arr, size_t n,
    uint64_t *rep /* [3] */, int64_t *off_out) {
    for (size_t i = 0; i < n; i++) {
        uint64_t ofv = ofv_arr[i];
        uint64_t offset;
        if (ofv == 0) return 1;
        if (ofv > 3) {
            offset = ofv - 3;
            rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset;
        } else {
            uint64_t idx = (ll_arr[i] != 0) ? ofv - 1 : ofv;
            if (idx == 0) {
                offset = rep[0];
            } else if (idx == 1) {
                offset = rep[1]; rep[1] = rep[0]; rep[0] = offset;
            } else if (idx == 2) {
                offset = rep[2];
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset;
            } else {
                offset = rep[0] - 1;
                if (offset == 0) return 1;
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset;
            }
        }
        off_out[i] = (int64_t)offset;
    }
    return 0;
}

/* ---- FSE table parse + build (host prepass, RFC 8878 section 4.1.1) ----
 *
 * C form of ops/fse.py:parse_fse_distribution/build_fse_table
 * and ops/huffman.py:decode_fse_weights.  Returns -1 on any corruption;
 * the Python caller then re-runs its own path to raise the precise
 * typed error, so the taxonomy is unchanged.
 */

typedef struct {
    const uint8_t *p;
    size_t len;   /* bytes */
    size_t pos;   /* bits consumed (LSB-first within each byte) */
} zt_fbits;

static inline uint64_t zt_fb_peek(const zt_fbits *b, int n) {
    /* n <= 24; zero-padded past the end */
    uint64_t v = 0;
    size_t byte = b->pos >> 3;
    int sh = (int)(b->pos & 7);
    for (int i = 0; i < 5; i++) {
        if (byte + i < b->len) v |= (uint64_t)b->p[byte + i] << (8 * i);
    }
    return (v >> sh) & ((1ull << n) - 1);
}

static inline int zt_floor_log2_u32(uint32_t v) {
    return 31 - __builtin_clz(v);
}

/* Parse an FSE table description and build the decode table.
 * out_symbol/out_baseline: uint16[512]; out_nbits: uint8[512].
 * Returns accuracy_log >= 0, or -1 on corruption.  *out_bits gets the
 * bits consumed by the header. */
int zt_fse_parse_build(const uint8_t *data, size_t len, int max_al,
                       uint16_t *out_symbol, uint16_t *out_baseline,
                       uint8_t *out_nbits, size_t *out_bits) {
    zt_fbits b = {data, len, 0};
    size_t ext = 4; /* peek extent: Python's cursor raises when a PEEK
                       crosses the end, even if fewer bits are consumed */
    int al = (int)zt_fb_peek(&b, 4) + 5;
    b.pos += 4;
    if (al > max_al) return -1;
    int size = 1 << al;

    int16_t dist[256];
    int n_dist = 0;
    int remaining = size;
    while (remaining > 0 && n_dist < 256) {
        int bits = zt_floor_log2_u32((uint32_t)remaining + 1) + 1;
        if (b.pos + bits > ext) ext = b.pos + bits;
        uint32_t peeked = (uint32_t)zt_fb_peek(&b, bits);
        uint32_t lower_mask = (1u << (bits - 1)) - 1;
        uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
        int value;
        if ((peeked & lower_mask) < threshold) {
            value = (int)(peeked & lower_mask);
            b.pos += bits - 1;
        } else {
            value = (int)peeked;
            b.pos += bits;
            if ((uint32_t)value > lower_mask) value -= (int)threshold;
        }
        int proba = value - 1;
        remaining -= proba < 0 ? -proba : proba;
        dist[n_dist++] = (int16_t)proba;
        if (proba == 0) {
            for (;;) {
                if (b.pos + 2 > ext) ext = b.pos + 2;
                int zeros = (int)zt_fb_peek(&b, 2);
                b.pos += 2;
                if (n_dist + zeros > 256) return -1;
                for (int i = 0; i < zeros; i++) dist[n_dist++] = 0;
                if (zeros != 3) break;
            }
        }
    }
    if (remaining != 0 || n_dist >= 256) return -1;
    if (ext > 8 * len) return -1;
    *out_bits = b.pos;

    /* ---- build (counter formulation) ---- */
    int pos_total = 0, n_m1 = 0;
    for (int s = 0; s < n_dist; s++) {
        if (dist[s] > 0) pos_total += dist[s];
        else if (dist[s] == -1) n_m1++;
        else if (dist[s] < -1) return -1;
    }
    if (pos_total + n_m1 != size) return -1;
    int high_threshold = size - n_m1;

    /* less-than-one symbols at the tail, increasing symbol order from
     * the last index downward */
    {
        int idx = size - 1;
        for (int s = 0; s < n_dist; s++)
            if (dist[s] == -1) out_symbol[idx--] = (uint16_t)s;
    }
    /* spread positive-prob symbols, skipping the reserved tail */
    {
        int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
        for (int s = 0; s < n_dist; s++) {
            for (int k = 0; k < dist[s]; k++) {
                out_symbol[pos] = (uint16_t)s;
                do { pos = (pos + step) & mask; } while (pos >= high_threshold);
            }
        }
        if (pos != 0) return -1;
    }
    /* counters -> baseline/nbits (Python ops/fse.py:149-162) */
    {
        uint32_t counter[256];
        for (int s = 0; s < n_dist; s++)
            counter[s] = dist[s] > 0 ? (uint32_t)dist[s] : 1u;
        for (int st = 0; st < size; st++) {
            uint32_t c = counter[out_symbol[st]]++;
            int nb = al - zt_floor_log2_u32(c);
            out_baseline[st] = (uint16_t)(((uint32_t)c << nb) - (uint32_t)size);
            out_nbits[st] = (uint8_t)nb;
        }
    }
    return al;
}

/* Backward bit reader (sentinel-stripped): pos counts bits remaining. */
typedef struct {
    const uint8_t *p;
    long pos; /* bit index just above the next bit to read */
} zt_bbits;

static inline uint32_t zt_bb_take(zt_bbits *b, int n) {
    /* reads the n bits below pos (MSB-first order), zero-padded below 0 */
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        long bit = b->pos - 1 - i;
        uint32_t x = 0;
        if (bit >= 0) x = (b->p[bit >> 3] >> (bit & 7)) & 1;
        v = (v << 1) | x;
    }
    b->pos -= n;
    return v;
}

/* Decode FSE-compressed Huffman weights (2 interleaved tANS states).
 * Returns the number of weights written to out_w (<= 255), or -1. */
int zt_fse_weights(const uint8_t *payload, size_t len, uint8_t *out_w) {
    uint16_t symbol[512], baseline[512];
    uint8_t nbits[512];
    size_t hdr_bits = 0;
    int al = zt_fse_parse_build(payload, len, 9, symbol, baseline, nbits,
                                &hdr_bits);
    if (al < 0) return -1;
    size_t hdr_bytes = (hdr_bits + 7) >> 3;
    if (hdr_bytes >= len) return -1;
    const uint8_t *bs = payload + hdr_bytes;
    size_t bn = len - hdr_bytes;
    if (bs[bn - 1] == 0) return -1; /* missing sentinel */
    long pos = 8 * (long)(bn - 1) + zt_floor_log2_u32(bs[bn - 1]);
    zt_bbits b = {bs, pos};

    if (b.pos < 2 * al) return -1;
    uint32_t states[2];
    states[0] = zt_bb_take(&b, al);
    states[1] = zt_bb_take(&b, al);
    int n = 0, turn = 0;
    while ((long)nbits[states[turn]] <= b.pos) {
        if (n >= 253) return -1;
        uint32_t s = states[turn];
        out_w[n++] = (uint8_t)symbol[s];
        states[turn] = baseline[s] + zt_bb_take(&b, nbits[s]);
        turn ^= 1;
    }
    out_w[n++] = (uint8_t)symbol[states[turn]];
    out_w[n++] = (uint8_t)symbol[states[turn ^ 1]];
    return n;
}
