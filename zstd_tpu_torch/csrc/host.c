/* Host runtime routines of the PyTorch port.
 *
 * The entropy decode runs on the GPU (csrc/literals.cu, sequences.cu,
 * compact.cu); these C routines cover the host work around it and the
 * encoder's match finders:
 *
 *   - zt_xxh64: frame content checksums, from the public XXH64 spec.
 *   - zt_unpack_sequences: the sequences kernel's fetched word stream
 *     split into (ll, offset value, ml) arrays (the engine's finish).
 *   - zt_assemble_group: a frame group's frames assembled from their
 *     lanes' literals and sequences, one call a group (the engine's host
 *     assembly); zt_execute_sequences: its sequence executor on one
 *     block.
 *   - zt_resolve_offsets: the repeat-offset scan of the device LZ77 route
 *     (kernels/lz77_device.py).
 *   - zt_fse_parse_build / zt_fse_weights: FSE table parse + build and
 *     FSE-compressed Huffman weights (the host prepass's hot calls).
 *   - zt_huffman_canonical / zt_fse_pack: the batch plan's entropy
 *     tables packed for the kernels' banks, one call a table.
 *   - zt_lz77_lazy / zt_lz77_optimal: the encoder's hash-chain lazy
 *     matcher and price-driven optimal parse (encode.py).
 *
 * Built with plain gcc -O2 -shared at first use and loaded via ctypes
 * (zstd_tpu_torch/native/__init__.py).  Return codes mirror the Python
 * error taxonomy.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
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

/* Bytes past its end that a strided copy may write, and read from its
 * source: the slack an output or a literal buffer needs for the fast
 * path to run up to its last byte (libzstd's WILDCOPY_OVERLENGTH). */
#define ZT_WILD 32

static inline void copy8(uint8_t *d, const uint8_t *s) { memcpy(d, s, 8); }
static inline void copy16(uint8_t *d, const uint8_t *s) { memcpy(d, s, 16); }

/* Copy `len` bytes in 16-byte steps, the first alone and then two a
 * loop, each step's load before its store and each store before the next
 * load: right for disjoint buffers and for a source 16 or more bytes
 * before its destination.  Reads and writes up to ZT_WILD - 1 bytes past
 * `len`. */
static inline void wildcopy(uint8_t *d, const uint8_t *s, size_t len) {
    uint8_t *const end = d + len;
    copy16(d, s);
    if (len <= 16) return;
    d += 16;
    s += 16;
    do {
        copy16(d, s);
        d += 16;
        s += 16;
        copy16(d, s);
        d += 16;
        s += 16;
    } while (d < end);
}

/* A match of `len` bytes from `offset` (1 to 15) back: libzstd's
 * ZSTD_overlapCopy8 spreads the first 8 bytes so that the source then
 * lies 8 or more bytes behind (a multiple of the period), then 8-byte
 * steps.  Writes up to 8 bytes past `len`. */
static inline void overlap_match(uint8_t *d, size_t offset, size_t len) {
    static const uint32_t inc[8] = {0, 1, 2, 1, 4, 4, 4, 4}; /* dec32table */
    static const uint32_t dec[8] = {8, 8, 8, 7, 8, 9, 10, 11}; /* dec64table */
    const uint8_t *s = d - offset;
    uint8_t *const end = d + len;
    if (offset < 8) {
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
        d[3] = s[3];
        s += inc[offset];
        memcpy(d + 4, s, 4);
        s -= dec[offset];
    } else {
        copy8(d, s);
    }
    s += 8;
    d += 8;
    while (d < end) {
        copy8(d, s);
        d += 8;
        s += 8;
    }
}

/* Overlap-correct append of `length` bytes from `offset` back, touching
 * no byte past its end (the bounds-exact path).
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
    ZT_ERR_WORDS_RANGE = 5,
    ZT_ERR_FIELD_WIDTHS = 6,
    /* A frame's status in zt_assemble_group: */
    ZT_ERR_LITERALS_SIZE = 7, /* a block's streams do not add up to its regenerated size */
    ZT_ERR_CHECKSUM = 8,
    ZT_ERR_CONTENT_SIZE = 9,
    ZT_FRAME_SKIPPED = 10, /* flagged by the caller: not run */
    ZT_FRAME_LANES = 11,   /* one of its lanes is not ok: not run */
    ZT_NEED_ROOM = 12,     /* does not fit: the call stopped before it */
    ZT_ERR_TABLE = 13,     /* a table entry out of range: nothing trusted */
};

/* Unpack the sequences kernel's compacted word stream, as fetched to the
 * host, into flat ll / offset value / ml arrays.  Lane j's nseq[j]
 * sequences take g = 1 + (w > 32) words each from words[cumw[j]] on, with
 * w = w_ll + w_ml + w_of; a sequence's value is its word, or its word and
 * the next one as the high half when g = 2, masked to w bits and packed
 * ll | ml << w_ll | ofv << (w_ll + w_ml).  Lane j's sequences go out after
 * the sequences of the lanes before it.  Returns ZT_ERR_FIELD_WIDTHS for
 * a width below 0 or widths summing past 63, ZT_ERR_WORDS_RANGE for a
 * lane whose words do not lie inside words[0, n_words), before anything
 * is read of that lane; ZT_OK otherwise. */
EXPORT int zt_unpack_sequences(
    const uint32_t *words, size_t n_words, const int32_t *cumw, const int32_t *nseq,
    const int32_t *w_ll, const int32_t *w_ml, const int32_t *w_of, size_t n_lanes,
    int32_t *ll_out, uint32_t *ofv_out, int32_t *ml_out) {
    for (size_t j = 0; j < n_lanes; j++) {
        int a = w_ll[j], b = w_ml[j], c = w_of[j];
        if (a < 0 || b < 0 || c < 0 || a + b + c > 63) return ZT_ERR_FIELD_WIDTHS;
        size_t g = a + b + c > 32 ? 2 : 1;
        if (cumw[j] < 0 || nseq[j] < 0 || (size_t)cumw[j] > n_words
            || (size_t)nseq[j] > (n_words - (size_t)cumw[j]) / g)
            return ZT_ERR_WORDS_RANGE;
        const uint32_t *p = words + cumw[j];
        size_t n = (size_t)nseq[j];
        uint64_t mask = (1ULL << (a + b + c)) - 1;
        uint64_t m_ll = (1ULL << a) - 1, m_ml = (1ULL << b) - 1;
        for (size_t i = 0; i < n; i++, p += g) {
            uint64_t v = p[0];
            if (g == 2) v |= (uint64_t)p[1] << 32;
            v &= mask;
            ll_out[i] = (int32_t)(uint32_t)(v & m_ll);
            ml_out[i] = (int32_t)(uint32_t)((v >> a) & m_ml);
            ofv_out[i] = (uint32_t)(v >> (a + b));
        }
        ll_out += n;
        ml_out += n;
        ofv_out += n;
    }
    return ZT_OK;
}

/* Execute `n` sequences (ll[i], offset_value[i], ml[i]) into `out`
 * (which already holds `out_len` bytes of earlier frame output),
 * consuming `literals` and maintaining the 3-slot repeat history `rep`
 * (RFC 8878 §3.1.1.5; decoding_context.rs:50-107).  Trailing literals
 * are appended.  Returns ZT_OK or an error code; *out_len_io is updated
 * to the new output length on success.  `cap` bounds the output
 * (ZT_ERR_OUTPUT_OVERFLOW past it); `wend` >= cap is the end of the bytes
 * the call may write, and `lit_end` >= lit_len the end of the literal
 * bytes it may read.  A sequence whose literals end ZT_WILD or more bytes
 * before `lit_end` and whose output ends ZT_WILD or more bytes before
 * `wend` copies in 16- and 32-byte strides (wildcopy, overlap_match), its
 * copies overrunning into bytes that later sequences write; any other
 * takes the bounds-exact path and is counted in *exact_io.  When `far_io`
 * is not NULL, the bytes of every match whose source starts before the
 * call's first output byte (in an earlier block of the frame) are added
 * to it on success.  The repeat history lives in locals and goes back to
 * `rep` on return, as it stood after the last sequence resolved (the
 * failing one's resolution included when it failed past it). */
static int execute_block(
    uint8_t *out, size_t cap, size_t wend, size_t *out_len_io,
    const uint8_t *literals, size_t lit_len, size_t lit_end,
    const int32_t *ll_arr, const uint32_t *ofv_arr, const int32_t *ml_arr,
    size_t n, uint64_t *rep, size_t *far_io, size_t *exact_io) {
    uint64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
    const size_t start = *out_len_io;
    size_t out_len = start;
    size_t lit_pos = 0, exact = 0, far = 0;
    int status = ZT_OK;

    for (size_t i = 0; i < n; i++) {
        size_t ll = (uint32_t)ll_arr[i];
        size_t ml = (uint32_t)ml_arr[i];
        uint64_t ofv = ofv_arr[i];
        uint64_t offset;

        /* RFC 8878 repeat offsets: a value above 3 is a new offset; 1-3 name
         * rep[ofv - 1], shifted by one when ll == 0, where the fourth is
         * rep[0] - 1.  A repeat moves to the front; the new offset and the
         * repeats past rep[1] push the history down. */
        uint64_t idx = ofv - (ll != 0);
        int is_new = ofv > 3;
        uint64_t pick = idx == 0 ? r0 : idx == 1 ? r1 : idx == 2 ? r2 : r0 - 1;
        offset = is_new ? ofv - 3 : pick;
        if (__builtin_expect(ofv == 0 || offset == 0, 0)) { status = ZT_ERR_NULL_OFFSET; goto done; }
        {
            uint64_t n2 = (is_new | (idx >= 2)) ? r1 : r2;
            uint64_t n1 = (is_new | (idx != 0)) ? r0 : r1;
            r0 = offset;
            r1 = n1;
            r2 = n2;
        }

        if (ll > lit_len - lit_pos) { status = ZT_ERR_LITERALS_OVERRUN; goto done; }
        if (out_len + ll + ml > cap) { status = ZT_ERR_OUTPUT_OVERFLOW; goto done; }
        if (offset > out_len + ll) { status = ZT_ERR_OFFSET_TOO_FAR; goto done; }
        uint8_t *op = out + out_len;
        const uint8_t *lp = literals + lit_pos;
        far += offset > out_len + ll - start ? ml : 0;
        out_len += ll + ml;
        lit_pos += ll;
        if (lit_pos + ZT_WILD <= lit_end && out_len + ZT_WILD <= wend) {
            wildcopy(op, lp, ll);
            op += ll;
            if (offset >= 16)
                wildcopy(op, op - offset, ml);
            else
                overlap_match(op, (size_t)offset, ml);
        } else {
            if (ll) memcpy(op, lp, ll);
            copy_match(out, out_len - ml, (size_t)offset, ml);
            exact++;
        }
    }

    {
        size_t tail = lit_len - lit_pos;
        if (out_len + tail > cap) { status = ZT_ERR_OUTPUT_OVERFLOW; goto done; }
        if (tail) memcpy(out + out_len, literals + lit_pos, tail);
        out_len += tail;
    }
    if (far_io) *far_io += far;
    *exact_io += exact;
    *out_len_io = out_len;
done:
    rep[0] = r0;
    rep[1] = r1;
    rep[2] = r2;
    return status;
}

/* execute_block over an output of exactly `cap` bytes and literals of
 * exactly `lit_len`: the one-block entry (native.execute_sequences). */
EXPORT int zt_execute_sequences(
    uint8_t *out, size_t cap, size_t *out_len_io,
    const uint8_t *literals, size_t lit_len,
    const int32_t *ll_arr, const uint32_t *ofv_arr, const int32_t *ml_arr,
    size_t n, uint64_t *rep /* [3] */, size_t *far_io) {
    size_t exact = 0;
    return execute_block(out, cap, cap, out_len_io, literals, lit_len, lit_len,
                         ll_arr, ofv_arr, ml_arr, n, rep, far_io, &exact);
}

/* ------------------------- frame group assembly ------------------------ */

/* zt_assemble_group's tables, int64 rows (keep in sync with
 * zstd_tpu_torch/native/__init__.py).  A frame: its first block row, its
 * block count, flags, the header's content size (-1: none), the stored
 * checksum, and the caller's estimate of its size.  A block: its kind
 * (BlockType), a payload address (a raw block's bytes, raw literals),
 * that payload's length (a raw block's size, an RLE block's repeat, raw
 * literals' size, else the regenerated literals' size), the RLE byte
 * (block or literals), the literals' kind (LiteralsType), 4 literal
 * lanes (-1: none) and the sequence lane (-1: none).  A result: status,
 * start in the buffer, length, far-match bytes, computed checksum. */
enum { F_BLOCK0, F_NBLOCKS, F_FLAGS, F_CSIZE, F_CHECKSUM, F_EST, F_COLS };
enum { B_KIND, B_PTR, B_LEN, B_BYTE, B_LITKIND, B_LANES, B_SEQ = B_LANES + 4, B_COLS };
enum { R_STATUS, R_START, R_LEN, R_FAR, R_CHECKSUM, R_COLS };
enum { FLAG_SKIP = 1, FLAG_CHECKSUM = 2 };
enum { BLOCK_RAW = 0, BLOCK_RLE = 1, LIT_RAW = 0, LIT_RLE = 1 };

typedef struct {
    const int64_t *lit_ptr, *lit_len, *seq_ptr, *seq_n;
    const uint8_t *lit_ok, *seq_ok;
    size_t n_lit, n_seq;
    uint8_t *scratch; /* joined or RLE literals, with ZT_WILD bytes of slack */
    size_t scratch_cap;
} lanes_t;

/* Whether every lane the frame's blocks name exists and is ok. */
static int frame_lanes_ok(const int64_t *blk, size_t nb, const lanes_t *L) {
    for (size_t b = 0; b < nb; b++, blk += B_COLS) {
        for (int k = 0; k < 4; k++) {
            int64_t lane = blk[B_LANES + k];
            if (lane >= 0 && ((size_t)lane >= L->n_lit || !L->lit_ok[lane])) return 0;
        }
        int64_t seq = blk[B_SEQ];
        if (seq >= 0 && ((size_t)seq >= L->n_seq || !L->seq_ok[seq])) return 0;
    }
    return 1;
}

/* The bytes a frame writes when it runs without error. */
static size_t frame_need(const int64_t *blk, size_t nb, const lanes_t *L) {
    size_t need = 0;
    for (size_t b = 0; b < nb; b++, blk += B_COLS) {
        need += (size_t)blk[B_LEN];
        int64_t seq = blk[B_SEQ];
        if (blk[B_KIND] > BLOCK_RLE && seq >= 0) {
            const int32_t *ml = (const int32_t *)(uintptr_t)L->seq_ptr[3 * seq + 2];
            for (int64_t i = 0; i < L->seq_n[seq]; i++) need += (uint32_t)ml[i];
        }
    }
    return need;
}

/* A scratch buffer of at least n + ZT_WILD bytes, or NULL. */
static uint8_t *scratch(lanes_t *L, size_t n) {
    if (L->scratch_cap < n + ZT_WILD) {
        size_t want = n + ZT_WILD > (128u << 10) + ZT_WILD ? n + ZT_WILD : (128u << 10) + ZT_WILD;
        uint8_t *p = realloc(L->scratch, want);
        if (!p) return NULL;
        L->scratch = p;
        L->scratch_cap = want;
    }
    return L->scratch;
}

/* Run one frame's `nb` blocks into out[0, cap), writing no byte at or
 * past `wend`: raw and RLE blocks, then each compressed block's literals
 * (raw or a single stream read in place; RLE or the streams joined into
 * scratch) and its sequences through execute_block, the repeat history
 * carried from block to block. */
static int run_frame(uint8_t *out, size_t cap, size_t wend, const int64_t *blk, size_t nb,
                     lanes_t *L, size_t *len_out, size_t *far_out, size_t *exact_io) {
    uint64_t rep[3] = {1, 4, 8}; /* the initial repeat offsets (RFC 8878) */
    size_t len = 0;
    for (size_t b = 0; b < nb; b++, blk += B_COLS) {
        size_t n = (size_t)blk[B_LEN];
        const uint8_t *src = (const uint8_t *)(uintptr_t)blk[B_PTR];
        if (blk[B_KIND] == BLOCK_RAW || blk[B_KIND] == BLOCK_RLE) {
            if (n > cap - len) return ZT_ERR_OUTPUT_OVERFLOW;
            if (blk[B_KIND] == BLOCK_RAW) {
                if (n) memcpy(out + len, src, n);
            } else {
                memset(out + len, (int)blk[B_BYTE], n);
            }
            len += n;
            continue;
        }
        const uint8_t *lit = src;
        size_t lit_end = n;
        if (blk[B_LITKIND] == LIT_RLE) {
            uint8_t *s = scratch(L, n);
            if (!s) return ZT_ERR_OUTPUT_OVERFLOW;
            memset(s, (int)blk[B_BYTE], n);
            lit = s;
            lit_end = L->scratch_cap;
        } else if (blk[B_LITKIND] != LIT_RAW) {
            size_t total = 0, parts = 0;
            for (int k = 0; k < 4; k++) {
                int64_t lane = blk[B_LANES + k];
                if (lane >= 0 && L->lit_len[lane] > 0) {
                    total += (size_t)L->lit_len[lane];
                    parts++;
                    lit = (const uint8_t *)(uintptr_t)L->lit_ptr[lane];
                }
            }
            if (total != n) return ZT_ERR_LITERALS_SIZE;
            if (parts > 1) {
                uint8_t *s = scratch(L, n);
                if (!s) return ZT_ERR_OUTPUT_OVERFLOW;
                size_t at = 0;
                for (int k = 0; k < 4; k++) {
                    int64_t lane = blk[B_LANES + k];
                    if (lane >= 0 && L->lit_len[lane] > 0) {
                        memcpy(s + at, (const uint8_t *)(uintptr_t)L->lit_ptr[lane], (size_t)L->lit_len[lane]);
                        at += (size_t)L->lit_len[lane];
                    }
                }
                lit = s;
                lit_end = L->scratch_cap;
            }
        }
        int64_t seq = blk[B_SEQ];
        if (seq < 0) {
            if (n > cap - len) return ZT_ERR_OUTPUT_OVERFLOW;
            if (n) memcpy(out + len, lit, n);
            len += n;
            continue;
        }
        const int64_t *p = L->seq_ptr + 3 * seq;
        int status = execute_block(
            out, cap, wend, &len, lit, n, lit_end, (const int32_t *)(uintptr_t)p[0],
            (const uint32_t *)(uintptr_t)p[1], (const int32_t *)(uintptr_t)p[2],
            (size_t)L->seq_n[seq], rep, far_out, exact_io);
        if (status != ZT_OK) return status;
    }
    *len_out = len;
    return ZT_OK;
}

/* Assemble frames [first, n_frames) of a frame group into buf, one after
 * another from *pos_io: each frame not flagged FLAG_SKIP whose lanes are
 * all ok runs its blocks (run_frame), then, with FLAG_CHECKSUM, its XXH64
 * is checked against the stored checksum, then its length against the
 * content size.  A frame that fails leaves nothing: the next starts where
 * it did.  Writes stay below `wend` (at least cap + ZT_WILD for the
 * strided path to reach the last frame's end).  A frame that needs more
 * than cap - its start stops the call with ZT_NEED_ROOM, its result's
 * length the bytes it needs; frames after it are not run.  Returns ZT_OK,
 * ZT_NEED_ROOM or ZT_ERR_TABLE (a block or lane index out of range, found
 * before anything runs); *pos_io is the end of the last frame written,
 * and the sequences that took the bounds-exact path in frames that ran to
 * a status are added to *exact_io (a frame stopped for room counts when
 * it runs again). */
EXPORT int zt_assemble_group(
    uint8_t *buf, size_t cap, size_t wend, size_t *pos_io,
    const int64_t *frames, size_t first, size_t n_frames,
    const int64_t *blocks, size_t n_blocks,
    const int64_t *lit_ptr, const int64_t *lit_len, const uint8_t *lit_ok, size_t n_lit,
    const int64_t *seq_ptr, const int64_t *seq_n, const uint8_t *seq_ok, size_t n_seq,
    int64_t *res, size_t *exact_io) {
    lanes_t L = {lit_ptr, lit_len, seq_ptr, seq_n, lit_ok, seq_ok, n_lit, n_seq, NULL, 0};
    for (size_t f = first; f < n_frames; f++) {
        const int64_t *fr = frames + f * F_COLS;
        if (fr[F_BLOCK0] < 0 || fr[F_NBLOCKS] < 0 || (size_t)(fr[F_BLOCK0] + fr[F_NBLOCKS]) > n_blocks)
            return ZT_ERR_TABLE;
        const int64_t *blk = blocks + fr[F_BLOCK0] * B_COLS;
        for (int64_t b = 0; b < fr[F_NBLOCKS]; b++) {
            int64_t seq = blk[b * B_COLS + B_SEQ];
            if (seq >= 0 && (size_t)seq >= n_seq) return ZT_ERR_TABLE;
            for (int k = 0; k < 4; k++)
                if (blk[b * B_COLS + B_LANES + k] >= (int64_t)n_lit) return ZT_ERR_TABLE;
        }
    }
    size_t pos = *pos_io;
    int ret = ZT_OK;
    for (size_t f = first; f < n_frames; f++) {
        const int64_t *fr = frames + f * F_COLS;
        int64_t *r = res + f * R_COLS;
        const int64_t *blk = blocks + fr[F_BLOCK0] * B_COLS;
        size_t nb = (size_t)fr[F_NBLOCKS];
        size_t len = 0, far = 0, exact = 0;
        r[R_START] = (int64_t)pos;
        r[R_LEN] = r[R_FAR] = r[R_CHECKSUM] = 0;
        if (fr[F_FLAGS] & FLAG_SKIP) {
            r[R_STATUS] = ZT_FRAME_SKIPPED;
            continue;
        }
        if (!frame_lanes_ok(blk, nb, &L)) {
            r[R_STATUS] = ZT_FRAME_LANES;
            continue;
        }
        int status = run_frame(buf + pos, cap - pos, wend - pos, blk, nb, &L, &len, &far, &exact);
        if (status == ZT_ERR_OUTPUT_OVERFLOW) {
            size_t need = frame_need(blk, nb, &L);
            if (need > cap - pos) { /* runs again, and is counted, once it fits */
                r[R_STATUS] = ZT_NEED_ROOM;
                r[R_LEN] = (int64_t)need;
                ret = ZT_NEED_ROOM;
                break;
            }
        }
        *exact_io += exact;
        if (status == ZT_OK && (fr[F_FLAGS] & FLAG_CHECKSUM)) {
            uint64_t h = zt_xxh64(buf + pos, len, 0) & 0xFFFFFFFFu;
            r[R_CHECKSUM] = (int64_t)h;
            if (h != (uint64_t)fr[F_CHECKSUM]) status = ZT_ERR_CHECKSUM;
        }
        if (status == ZT_OK && fr[F_CSIZE] >= 0 && len != (size_t)fr[F_CSIZE]) status = ZT_ERR_CONTENT_SIZE;
        r[R_STATUS] = status;
        r[R_LEN] = (int64_t)len;
        if (status == ZT_OK) {
            r[R_FAR] = (int64_t)far;
            pos += len;
        }
    }
    free(L.scratch);
    *pos_io = pos;
    return ret;
}

/* ---------------------------- LZ77 hashing ----------------------------- */

#define ZT_HASH_LOG 16
#define ZT_MIN_MATCH 4

static inline uint32_t zt_hash4(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - ZT_HASH_LOG);
}

/* ---------------- LZ77 hash-chain lazy matcher (encoder) ----------------
 * zstd-style search replacing the single-probe greedy above for
 * level >= 2: a 2^ZT_HASH_LOG head table plus a chain table over the
 * last `chain_mask + 1` positions gives `attempts` candidates per
 * position; the three repeat offsets are probed first with a virtual
 * +1 length bonus (they encode in <= 5 bits, decoding_context.rs:50-75
 * is the decoder mirror); `lazy` enables one-step-deferred match
 * selection (emit a literal instead when position i+1 holds a strictly
 * longer match).  Matches may reach into earlier blocks of the frame
 * (bounded by `window`); head/chain persist across per-block calls.
 * The rep history update mirrors encode.offsets_to_values exactly so
 * search preferences track what the bitstream will actually encode.
 */

static inline size_t zt_match_len(
    const uint8_t *src, size_t a, size_t b, size_t limit) {
    size_t len = 0;
    while (b + len + 8 <= limit) {
        uint64_t x, y;
        memcpy(&x, src + a + len, 8);
        memcpy(&y, src + b + len, 8);
        uint64_t diff = x ^ y;
        if (diff) return len + ((size_t)__builtin_ctzll(diff) >> 3);
        len += 8;
    }
    while (b + len < limit && src[a + len] == src[b + len]) len++;
    return len;
}

static inline void zt_rep_update(int32_t reps[3], int32_t o, int32_t ll) {
    int v;
    if (ll != 0) {
        if (o == reps[0]) v = 1;
        else if (o == reps[1]) v = 2;
        else if (o == reps[2]) v = 3;
        else v = 0;
        if (v == 0) { reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = o; }
        else if (v == 2) { int32_t t = reps[0]; reps[0] = reps[1]; reps[1] = t; }
        else if (v == 3) {
            int32_t t = reps[2];
            reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = t;
        }
    } else {
        if (o == reps[1]) {
            int32_t t = reps[0]; reps[0] = reps[1]; reps[1] = t;
        } else if (o == reps[2]) {
            int32_t t = reps[2];
            reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = t;
        } else if (o == reps[0] - 1 && o > 0) {
            reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = o;
        } else if (o != reps[0]) {
            reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = o;
        }
    }
}

/* Best match at position i.  Returns length (0 if < ZT_MIN_MATCH);
 * *off_out gets the offset.  `cur_ll` is the pending literal-run
 * length (rep candidate rules differ at ll == 0). */
static inline int zt_log2_u32(uint32_t v) {
    return v <= 1 ? 0 : 31 - __builtin_clz(v);
}

/* Cost-aware match score in quarter-length units (the zstd lazy
 * heuristic): 4*len - log2(offset), with repeat offsets scored as if
 * offset == 1 plus a +4 continuity bonus — a rep code costs <= 5 bits
 * where a fresh offset costs log2(off) extra bits AND evicts the
 * rep history the following sequences would have reused. */
static size_t zt_find_best(
    const uint8_t *src, size_t i, size_t lo, size_t limit,
    const int32_t *head, const int32_t *chain, size_t chain_mask,
    int attempts, const int32_t reps[3], int32_t cur_ll,
    int32_t *off_out, long *score_out) {
    size_t best_len = 0;
    int32_t best_off = 0;
    long best_score = 4 * (long)(ZT_MIN_MATCH - 1); /* must beat this */

    /* Encodable rep-candidate set depends on whether literals precede
     * the sequence (offsets_to_values / decoding_context.rs:50-75).
     * Rep matches may be as short as 3 bytes. */
    int32_t rep_cands[3];
    if (cur_ll != 0) {
        rep_cands[0] = reps[0]; rep_cands[1] = reps[1]; rep_cands[2] = reps[2];
    } else {
        rep_cands[0] = reps[1]; rep_cands[1] = reps[2]; rep_cands[2] = reps[0] - 1;
    }
    for (int k = 0; k < 3; k++) {
        int32_t o = rep_cands[k];
        if (o <= 0 || (size_t)o > i || i - (size_t)o < lo) continue;
        size_t len = zt_match_len(src, i - (size_t)o, i, limit);
        long score = 4 * (long)len + 4;
        if (len >= 3 && score > best_score) {
            best_score = score;
            best_len = len;
            best_off = o;
        }
    }

    uint32_t h = zt_hash4(src + i);
    int64_t cand = head[h];
    for (int t = 0; t < attempts && cand >= (int64_t)lo; t++) {
        if (i + best_len >= limit) break; /* cannot improve further */
        if (cand >= (int64_t)i) { /* self/future entries (stale aliases) */
            int64_t prev = chain[(size_t)cand & chain_mask];
            if (prev >= cand) break;
            cand = prev;
            continue;
        }
        /* Quick reject: the byte that would extend the current best. */
        if (src[(size_t)cand + best_len] == src[i + best_len] &&
            memcmp(src + cand, src + i, ZT_MIN_MATCH) == 0) {
            size_t len = zt_match_len(
                src, (size_t)cand + ZT_MIN_MATCH, i + ZT_MIN_MATCH, limit)
                + ZT_MIN_MATCH;
            uint32_t off = (uint32_t)(i - (size_t)cand);
            long score = 4 * (long)len - zt_log2_u32(off);
            if (score > best_score) {
                best_score = score;
                best_len = len;
                best_off = (int32_t)off;
            }
        }
        int64_t prev = chain[(size_t)cand & chain_mask];
        if (prev >= cand) break; /* stale entry from an older window */
        cand = prev;
    }
    *off_out = best_off;
    *score_out = best_score;
    return best_off ? best_len : 0;
}

EXPORT size_t zt_lz77_lazy(
    const uint8_t *src, size_t block_start, size_t block_end, size_t window,
    int32_t *head /* [1<<ZT_HASH_LOG] */,
    int32_t *chain /* [chain_mask + 1] */, size_t chain_mask,
    int attempts, int lazy,
    int32_t *reps_io /* [3] */,
    int32_t *ll_out, int32_t *off_out, int32_t *ml_out, size_t max_seqs,
    uint8_t *lit_out, size_t *lit_len_io) {
    size_t n_seq = 0;
    size_t lit_len = 0;
    size_t anchor = block_start;
    size_t i = block_start;
    size_t match_limit = block_end >= 8 ? block_end - 8 : 0;
    int32_t reps[3] = { reps_io[0], reps_io[1], reps_io[2] };

#define ZT_INSERT(p) do { \
        uint32_t _h = zt_hash4(src + (p)); \
        chain[(p) & chain_mask] = head[_h]; \
        head[_h] = (int32_t)(p); \
    } while (0)

    size_t inserted_to = block_start; /* positions < inserted_to are in */

    while (i < match_limit && n_seq < max_seqs) {
        size_t lo = i > window ? i - window : 0;
        int32_t off0;
        long score0;
        size_t len0 = zt_find_best(src, i, lo, block_end, head, chain,
                                   chain_mask, attempts, reps,
                                   (int32_t)(i - anchor), &off0, &score0);
        if (inserted_to <= i) { ZT_INSERT(i); inserted_to = i + 1; }
        if (len0 == 0) { i++; continue; }
        /* One-step lazy: defer when i+1 holds a clearly better match
         * (score gain > 3 quarter-lengths covers the literal spent). */
        while (lazy && i + 1 < match_limit) {
            int32_t off1;
            long score1;
            size_t lo1 = i + 1 > window ? i + 1 - window : 0;
            size_t len1 = zt_find_best(src, i + 1, lo1, block_end, head,
                                       chain, chain_mask, attempts, reps,
                                       (int32_t)(i + 1 - anchor), &off1,
                                       &score1);
            if (inserted_to <= i + 1) { ZT_INSERT(i + 1); inserted_to = i + 2; }
            if (len1 && score1 > score0 + 3) {
                i++; len0 = len1; off0 = off1; score0 = score1;
            } else break;
        }
        size_t ll = i - anchor;
        memcpy(lit_out + lit_len, src + anchor, ll);
        lit_len += ll;
        ll_out[n_seq] = (int32_t)ll;
        off_out[n_seq] = off0;
        ml_out[n_seq] = (int32_t)len0;
        n_seq++;
        zt_rep_update(reps, off0, (int32_t)ll);
        /* Insert every position inside the match (quality > speed;
         * the matcher is not the encode bottleneck). */
        {
            size_t stop = i + len0 < match_limit ? i + len0 : match_limit;
            for (size_t j = inserted_to; j < stop; j++) ZT_INSERT(j);
            if (stop > inserted_to) inserted_to = stop;
        }
        i += len0;
        anchor = i;
    }
#undef ZT_INSERT
    memcpy(lit_out + lit_len, src + anchor, block_end - anchor);
    lit_len += block_end - anchor;
    *lit_len_io = lit_len;
    reps_io[0] = reps[0]; reps_io[1] = reps[1]; reps_io[2] = reps[2];
    return n_seq;
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

/* -------------------- LZ77 optimal parse (encoder) ----------------------
 * Price-driven dynamic program over every block position (zstd btopt
 * style, from scratch): opt[p] holds the cheapest way to materialize
 * src[block_start .. block_start+p) as sequences + literals, with the
 * repeat-offset history and pending literal-run length carried per
 * entry so both pricing and candidate legality track RFC 8878
 * semantics (decoding_context.rs:50-75 is the decoder mirror).
 *
 * Prices are in 1/8-bit units.  Literal prices come from the caller
 * (block-histogram entropy); sequence prices use the normative LL/ML
 * code tables (sequence.rs:98-191) with a flat tANS-state estimate
 * plus exact extra bits, and offsets priced as log2(offset) extra bits
 * vs a cheap repeat code.  This is the parse that greedy/lazy cannot
 * reproduce: matches whose total price exceeds the literal path (e.g.
 * the incrementing-counter synthetic's skewed leading digits) are
 * left as literals.
 */

static const uint32_t ZT_LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
    4096, 8192, 16384, 32768, 65536,
};
static const uint8_t ZT_LL_XB[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
};
static const uint32_t ZT_ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539,
};
static const uint8_t ZT_ML_XB[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16,
};

/* Per-code prices (1/8-bit units) come from the caller: flat tANS
 * estimates on the first pass, then re-derived from the emitted code
 * histograms on later passes (the adaptive-pricing loop that makes the
 * DP reproduce structure-preserving parses — libzstd-1 reaches 0.35
 * bit/seq on locked-rep streams precisely because its stream stats
 * feed back into its prices). */

static inline int zt_ll_code(uint32_t litlen) {
    if (litlen < 16) return (int)litlen;
    int code = 35;
    while (ZT_LL_BASE[code] > litlen) code--;
    return code;
}

static inline int zt_ml_code(uint32_t mlen) {
    if (mlen < 35) return (int)mlen - 3;
    int code = 52;
    while (ZT_ML_BASE[code] > mlen) code--;
    return code;
}

static inline uint32_t zt_price_ll(const uint32_t *ll_price, uint32_t litlen) {
    int code = zt_ll_code(litlen);
    return ll_price[code] + 8u * ZT_LL_XB[code];
}

static inline uint32_t zt_price_ml(const uint32_t *ml_price, uint32_t mlen) {
    int code = zt_ml_code(mlen);
    return ml_price[code] + 8u * ZT_ML_XB[code];
}

/* The offset value this (off, rep-history, litlen) combination would
 * encode as — mirror of encode.offsets_to_values. */
static inline uint32_t zt_ofv_of(
    int32_t off, const int32_t rep[3], uint32_t litlen) {
    if (litlen != 0) {
        if (off == rep[0]) return 1;
        if (off == rep[1]) return 2;
        if (off == rep[2]) return 3;
    } else {
        if (off == rep[1]) return 1;
        if (off == rep[2]) return 2;
        if (off == rep[0] - 1) return 3;
    }
    return (uint32_t)off + 3;
}

static inline uint32_t zt_price_of(
    const uint32_t *of_price, int32_t off, const int32_t rep[3],
    uint32_t litlen) {
    uint32_t code = (uint32_t)zt_log2_u32(zt_ofv_of(off, rep, litlen));
    return of_price[code] + 8u * code;
}

typedef struct {
    uint32_t cost;   /* 1/8-bit units */
    uint32_t from;   /* source position (relative) of the setting step */
    int32_t mlen;    /* 0 = literal step */
    int32_t moff;
    int32_t rep[3];
    uint32_t litlen; /* pending literal-run length ending here */
} zt_opt_t;

#include <stdlib.h>

EXPORT size_t zt_lz77_optimal(
    const uint8_t *src, size_t block_start, size_t block_end, size_t window,
    int32_t *head, int32_t *chain, size_t chain_mask, int attempts,
    int32_t *reps_io /* [3] */,
    const uint32_t *lit_price /* [256], 1/8-bit units */,
    const uint32_t *ll_price /* [36] */,
    const uint32_t *ml_price /* [53] */,
    const uint32_t *of_price /* [32] */,
    int32_t *ll_out, int32_t *off_out, int32_t *ml_out, size_t max_seqs,
    uint8_t *lit_out, size_t *lit_len_io) {
    size_t n = block_end - block_start;
    size_t match_limit = block_end >= 8 ? block_end - 8 : 0;
    zt_opt_t *opt = (zt_opt_t *)malloc((n + 1) * sizeof(zt_opt_t));
    if (!opt) { *lit_len_io = 0; return 0; }
    for (size_t p = 0; p <= n; p++) opt[p].cost = UINT32_MAX;
    opt[0].cost = 0;
    opt[0].from = 0;
    opt[0].mlen = 0;
    opt[0].moff = 0;
    opt[0].rep[0] = reps_io[0];
    opt[0].rep[1] = reps_io[1];
    opt[0].rep[2] = reps_io[2];
    opt[0].litlen = 0;

#define ZT_RELAX_LIT(p) do { \
        uint32_t _c = opt[p].cost + lit_price[src[block_start + (p)]]; \
        if (_c < opt[(p) + 1].cost) { \
            opt[(p) + 1].cost = _c; \
            opt[(p) + 1].from = (uint32_t)(p); \
            opt[(p) + 1].mlen = 0; \
            opt[(p) + 1].moff = 0; \
            opt[(p) + 1].rep[0] = opt[p].rep[0]; \
            opt[(p) + 1].rep[1] = opt[p].rep[1]; \
            opt[(p) + 1].rep[2] = opt[p].rep[2]; \
            opt[(p) + 1].litlen = opt[p].litlen + 1; \
        } \
    } while (0)

    /* Candidate set per position: the 3 legal repeat offsets plus
     * length-improving hash-chain matches. */
    for (size_t p = 0; p < n; p++) {
        size_t i = block_start + p;
        ZT_RELAX_LIT(p);
        if (i >= match_limit) continue;

        const zt_opt_t *cur = &opt[p];
        size_t lo = i > window ? i - window : 0;
        struct { int32_t off; size_t len; } cands[8];
        int ncand = 0;

        int32_t rep_cands[3];
        if (cur->litlen != 0) {
            rep_cands[0] = cur->rep[0];
            rep_cands[1] = cur->rep[1];
            rep_cands[2] = cur->rep[2];
        } else {
            rep_cands[0] = cur->rep[1];
            rep_cands[1] = cur->rep[2];
            rep_cands[2] = cur->rep[0] - 1;
        }
        size_t best_rep = 0;
        for (int k = 0; k < 3; k++) {
            int32_t o = rep_cands[k];
            if (o <= 0 || (size_t)o > i || i - (size_t)o < lo) continue;
            size_t len = zt_match_len(src, i - (size_t)o, i, block_end);
            if (len >= 3 && len > best_rep) {
                cands[ncand].off = o;
                cands[ncand].len = len;
                ncand++;
                best_rep = len;
                if (ncand == 8) break;
            }
        }

        uint32_t h = zt_hash4(src + i);
        int64_t cand = head[h];
        size_t best_len = best_rep > ZT_MIN_MATCH ? best_rep : ZT_MIN_MATCH - 1;
        for (int t = 0; t < attempts && cand >= (int64_t)lo && ncand < 8; t++) {
            if ((size_t)cand >= i) {
                int64_t prev = chain[(size_t)cand & chain_mask];
                if (prev >= cand) break;
                cand = prev;
                continue;
            }
            if (i + best_len < block_end &&
                src[(size_t)cand + best_len] == src[i + best_len] &&
                memcmp(src + cand, src + i, ZT_MIN_MATCH) == 0) {
                size_t len = zt_match_len(
                    src, (size_t)cand + ZT_MIN_MATCH, i + ZT_MIN_MATCH,
                    block_end) + ZT_MIN_MATCH;
                if (len > best_len) {
                    cands[ncand].off = (int32_t)(i - (size_t)cand);
                    cands[ncand].len = len;
                    ncand++;
                    best_len = len;
                }
            }
            int64_t prev = chain[(size_t)cand & chain_mask];
            if (prev >= cand) break;
            cand = prev;
        }
        /* Insert after the search so p never matches itself. */
        chain[i & chain_mask] = head[h];
        head[h] = (int32_t)i;

        for (int c = 0; c < ncand; c++) {
            int32_t off = cands[c].off;
            size_t len = cands[c].len;
            if (p + len > n) len = n - p;
            uint32_t ofp = zt_price_of(of_price, off, cur->rep, cur->litlen);
            uint32_t base = cur->cost + zt_price_ll(ll_price, cur->litlen) + ofp;
            size_t lmin = (off == rep_cands[0] || off == rep_cands[1] ||
                           off == rep_cands[2]) ? 3 : ZT_MIN_MATCH;
            /* Relax every length up to a cap, then the full length —
             * bounding per-position work on repetitive data. */
            size_t lcap = len < 96 ? len : 96;
            for (size_t l = lmin; l <= lcap || l == len; l = (l < lcap ? l + 1 : len)) {
                uint32_t price = base + zt_price_ml(ml_price, (uint32_t)l);
                zt_opt_t *dst = &opt[p + l];
                if (price < dst->cost) {
                    dst->cost = price;
                    dst->from = (uint32_t)p;
                    dst->mlen = (int32_t)l;
                    dst->moff = off;
                    dst->rep[0] = cur->rep[0];
                    dst->rep[1] = cur->rep[1];
                    dst->rep[2] = cur->rep[2];
                    zt_rep_update(dst->rep, off, (int32_t)cur->litlen);
                    dst->litlen = 0;
                }
                if (l == len) break;
            }
        }
    }
#undef ZT_RELAX_LIT

    /* Backtrack: trailing literals, then (litlen, off, mlen) per hop. */
    size_t n_seq = 0;
    {
        size_t p = n - (size_t)opt[n].litlen;
        /* Collect sequences in reverse. */
        size_t stack_cap = max_seqs;
        while (p > 0 && n_seq < stack_cap) {
            zt_opt_t *e = &opt[p];
            uint32_t ll = opt[e->from].litlen;
            ll_out[n_seq] = (int32_t)ll;
            off_out[n_seq] = e->moff;
            ml_out[n_seq] = e->mlen;
            n_seq++;
            p = (size_t)e->from - ll;
        }
        /* Reverse into forward order. */
        for (size_t a = 0, b = n_seq - 1; n_seq && a < b; a++, b--) {
            int32_t t;
            t = ll_out[a]; ll_out[a] = ll_out[b]; ll_out[b] = t;
            t = off_out[a]; off_out[a] = off_out[b]; off_out[b] = t;
            t = ml_out[a]; ml_out[a] = ml_out[b]; ml_out[b] = t;
        }
    }
    /* Literals and final rep state, forward order. */
    {
        size_t anchor = block_start;
        size_t lit_len = 0;
        int32_t reps[3] = { reps_io[0], reps_io[1], reps_io[2] };
        for (size_t s = 0; s < n_seq; s++) {
            size_t ll = (size_t)ll_out[s];
            memcpy(lit_out + lit_len, src + anchor, ll);
            lit_len += ll;
            zt_rep_update(reps, off_out[s], (int32_t)ll);
            anchor += ll + (size_t)ml_out[s];
        }
        memcpy(lit_out + lit_len, src + anchor, block_end - anchor);
        lit_len += block_end - anchor;
        *lit_len_io = lit_len;
        reps_io[0] = reps[0]; reps_io[1] = reps[1]; reps_io[2] = reps[2];
    }
    free(opt);
    return n_seq;
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

/* ------------------------- Plan entropy tables ------------------------- */

/* Canonical Huffman classes for the literals kernel, taken from a block's
 * Huffman table payload (header byte + weights, either form) without the
 * flat 2^max_bits decode table.  canon is int32[ZT_CANON_WORDS]: limits[12],
 * prevs[12], lengths[12], rankb[12], ranked[256], in that order, exactly as
 * format/block_table.py's Python pack lays them out.  weights gets the
 * completed weights (the implied last one included), the plan's dedup key.
 * Returns the number of completed weights, or -1 on a truncated payload or
 * corrupt weights: the caller then runs the Python path, which raises the
 * typed error. */
#define ZT_HUF_MAX_BITS 11
#define ZT_CANON_CLASSES 12
#define ZT_CANON_WORDS (4 * ZT_CANON_CLASSES + 256)

EXPORT int zt_huffman_canonical(const uint8_t *payload, size_t len,
                                int32_t *canon, uint8_t *weights) {
    if (len < 1) return -1;
    int header = payload[0], n;
    if (header < 128) {
        if (len < 1 + (size_t)header) return -1;
        n = zt_fse_weights(payload + 1, (size_t)header, weights);
        if (n < 0) return -1;
    } else {
        n = header - 127;
        if (len < 1 + (size_t)((n + 1) >> 1)) return -1;
        for (int i = 0; i < n; i++) {
            uint8_t b = payload[1 + (i >> 1)];
            weights[i] = (i & 1) ? (b & 0x0F) : (b >> 4);
        }
    }
    /* Complete and check as ops/huffman.py's complete_huffman_weights.  A
     * weight above 11 alone makes the sum reach 2^11, so max_bits > 11. */
    uint32_t wsum = 0;
    for (int i = 0; i < n; i++) {
        if (weights[i] > ZT_HUF_MAX_BITS) return -1;
        if (weights[i]) wsum += 1u << (weights[i] - 1);
    }
    if (wsum == 0) return -1;
    int max_bits = zt_floor_log2_u32(wsum) + 1;
    uint32_t rest = (1u << max_bits) - wsum;
    if (rest & (rest - 1)) return -1; /* rest > 0: max_bits is strictly above */
    if (max_bits > ZT_HUF_MAX_BITS) return -1;
    weights[n++] = (uint8_t)(zt_floor_log2_u32(rest) + 1);

    int32_t *limits = canon, *prevs = canon + ZT_CANON_CLASSES;
    int32_t *lengths = canon + 2 * ZT_CANON_CLASSES;
    int32_t *rankb = canon + 3 * ZT_CANON_CLASSES;
    int32_t *ranked = canon + 4 * ZT_CANON_CLASSES;
    int count[ZT_HUF_MAX_BITS + 1] = {0}, next[ZT_HUF_MAX_BITS + 1];
    for (int s = 0; s < n; s++) count[weights[s]]++;
    for (int k = 0; k < ZT_CANON_CLASSES; k++) {
        limits[k] = 1 << 12; /* unreachable pad */
        prevs[k] = 0;
        lengths[k] = 1;
        rankb[k] = 0;
    }
    memset(ranked, 0, 256 * sizeof(int32_t));
    /* Longest codes (smallest weights) first, in 2^max_bits window units
     * scaled up to the kernel's 11-bit window. */
    int scale = ZT_HUF_MAX_BITS - max_bits, cls = 0, rank = 0;
    uint32_t cum = 0;
    for (int w = 1; w <= max_bits; w++) {
        next[w] = rank;
        if (count[w] == 0) continue;
        uint32_t span = (uint32_t)count[w] << (w - 1);
        prevs[cls] = (int32_t)(cum << scale);
        limits[cls] = (int32_t)((cum + span) << scale);
        lengths[cls] = max_bits + 1 - w;
        rankb[cls] = rank;
        rank += count[w];
        cum += span;
        cls++;
    }
    for (int s = 0; s < n; s++)
        if (weights[s]) ranked[next[weights[s]]++] = s;
    return n;
}

/* Pack a sequence-code FSE table (an RLE symbol is a one-state table with
 * baseline 0 and 0 bits) into the sequences kernel's dual planes:
 * p0 = baseline << 16 | nbits; p1 = value base << 5 | extra bits for
 * kind 0 (LL) and 2 (ML), the code itself for kind 1 (OF).  Returns the
 * bits bounding any decoded value (the bank's wbits, at least 1), or -1
 * for a code out of its kind's range. */
EXPORT int zt_fse_pack(const uint16_t *symbol, const uint16_t *baseline,
                       const uint8_t *nbits, size_t size, int kind,
                       int32_t *p0, int32_t *p1) {
    /* The code tables are the encoder's (ZT_LL_BASE above); tests hold
     * them to ops/sequence_codes.py code by code. */
    const uint32_t *base = kind == 0 ? ZT_LL_BASE : ZT_ML_BASE;
    const uint8_t *extra = kind == 0 ? ZT_LL_XB : ZT_ML_XB;
    uint32_t max_code = kind == 0 ? 35 : kind == 1 ? 31 : 52, top = 0;
    for (size_t i = 0; i < size; i++) {
        uint32_t s = symbol[i];
        if (s > max_code) return -1;
        p0[i] = (int32_t)((uint32_t)baseline[i] << 16 | nbits[i]);
        if (kind == 1) {
            p1[i] = (int32_t)s;
            if (s + 1 > top) top = s + 1; /* value < 2^(code + 1) */
        } else {
            p1[i] = (int32_t)(base[s] << 5 | extra[s]);
            uint32_t v = base[s] + (1u << extra[s]) - 1;
            if (v > top) top = v;
        }
    }
    if (kind != 1) top = top ? (uint32_t)zt_floor_log2_u32(top) + 1 : 0;
    return top > 1 ? (int)top : 1;
}
