// Huffman literals decode, one warp per literal stream (lane).
//
// Replaces zstd_tpu/kernels/pallas_lit.py:63 (_kernel, reached through
// decode_literals_dense_pl).  Per symbol: an 11-bit peek below the lane's
// bit position, the code-length class as the number of class limits <= the
// peek, a rank from the class's first rank and the peek's offset in the
// class, and the symbol from the 256-entry rank table (the arithmetic
// canonical Huffman of format/block_table.pack_huffman_canonical); the
// class past the table selects length 0 and rank 0.  The bytes past regen
// hold the symbol at the frozen final position, as the plain form's
// inactive slots do; a lane is ok when it ends at its end bit.
//
// Bound on the H100: each symbol's position depends on the previous
// symbol's code length, so a lane is a serial chain and a launch takes its
// longest lane's chain; the bytes moved (stream words in, symbols out)
// would take microseconds.  The design spreads the lanes and shortens the
// chain:
//
// * Launch: one block of one warp per lane (blocks = lanes, 32 threads,
//   6.3 KB of static shared memory), so a frame group's 256 lanes spread
//   over the card's 132 SMs.
// * Table: the warp first builds direct 2 048-entry tables of the code
//   length and the symbol for every 11-bit peek in shared memory, each
//   entry by the formula above from the lane's slot (class arrays and rank
//   table staged in shared memory first), so they are exact by
//   construction; a symbol is then one shared load, where the plain
//   form's 12 compares and rank gather were.
// * Bits: the stream's words sit in the warp's shared ring (common.cuh
//   Ring), checked once every 8 output words.  A symbol's peek is a shift
//   and a mask of a 64-bit window held in registers, which was loaded with
//   one 8-byte shared load at the position before the previous symbol, so
//   the load is off the chain.  Per symbol the chain is the length's table
//   load, one subtraction, the peek's shift and mask.
// * Outputs: four symbols make one u32 word; thread t keeps word t of
//   every 32 and the warp stores 128 symbols with one coalesced store at
//   word cum[j] of the dense output.
//
// What holds it (measured on an H100, PERF.md): a symbol takes ~27 ns,
// ~54 cycles of the 1.98 GHz SM clock, and its chain is one dependent
// shared load and three integer operations, so the kernel is bound by its
// lane's chain latency.
//
// All 32 threads run the decode in step on the same values (shared loads
// broadcast), so the warp's control flow is uniform.  Code lengths are
// 0..11 (pack_huffman_canonical), so the shift of the rank formula is in
// range and a length fits its byte.

#include "common.cuh"

namespace {

constexpr int kClasses = 12;
constexpr int kLaneCols = 5;  // base, p0, pend, regen, slot
constexpr int kPeeks = 2048;  // 11-bit peeks
constexpr int kThreads = 32;  // one warp per lane

__global__ void __launch_bounds__(kThreads)
literals_kernel(const uint32_t* __restrict__ words, long long n_words,
                const int32_t* __restrict__ lane_mat, const int32_t* __restrict__ cum,
                const int32_t* __restrict__ limits, const int32_t* __restrict__ prevs,
                const int32_t* __restrict__ lengths, const int32_t* __restrict__ rankb,
                const int32_t* __restrict__ ranked, uint8_t* __restrict__ dense,
                int32_t* __restrict__ ok) {
    __shared__ uint8_t lut_len[kPeeks], lut_sym[kPeeks];  // code length, symbol
    __shared__ int32_t cls[3][kClasses];  // prevs, lengths, rankb of the slot
    __shared__ int32_t rank_sym[256];
    __shared__ uint2 ring_pairs[zt::Ring::kEntries];
    const int j = blockIdx.x;
    const int lane = threadIdx.x;
    const int32_t* col = lane_mat + static_cast<long long>(kLaneCols) * j;
    const int p0 = col[1], pend = col[2], regen = col[3], slot = col[4];

    // The slot's class arrays and rank table, staged in shared memory with
    // coalesced loads, then one table entry per peek, 64 a thread.
    const long long row = static_cast<long long>(slot) * kClasses;
    if (lane < kClasses) {
        cls[0][lane] = prevs[row + lane];
        cls[1][lane] = lengths[row + lane];
        cls[2][lane] = rankb[row + lane];
    }
#pragma unroll
    for (int r = lane; r < 256; r += kThreads) rank_sym[r] = ranked[static_cast<long long>(slot) * 256 + r];
    int lim[kClasses];
#pragma unroll
    for (int k = 0; k < kClasses; k++) lim[k] = __ldg(limits + row + k);
    __syncwarp();
#pragma unroll 4
    for (int v = lane; v < kPeeks; v += kThreads) {
        int c = 0;
#pragma unroll
        for (int k = 0; k < kClasses; k++) c += (v >= lim[k]);
        int prev = 0, length = 0, rb = 0;
        if (c < kClasses) {
            prev = cls[0][c];
            length = cls[1][c];
            rb = cls[2][c];
        }
        const int rank = rb + ((v - prev) >> (11 - length));
        lut_len[v] = static_cast<uint8_t>(length);
        lut_sym[v] = static_cast<uint8_t>((rank >= 0 && rank < 256) ? rank_sym[rank] : 0);
    }
    __syncwarp();

    zt::Ring ring;
    ring.init(ring_pairs, words, n_words, col[0], p0, lane);
    uint32_t* out = reinterpret_cast<uint32_t*>(dense) + cum[j];
    const int n_out = max((regen + 3) >> 2, 0);  // whole words of four symbols
    const int n_full = max(regen >> 2, 0);       // words of four live symbols
    // A symbol's peek comes from the 64-bit window loaded at the position
    // before the symbol ahead of it: the 64 bits below word
    // (pos - 1) >> 5 hold the 33 bits below pos, so every peek of the next
    // symbol, which starts at most 11 bits lower.  The load and the peek's
    // shift less the next code length are off the chain; per symbol the
    // chain is the length's table load, one subtraction, the peek's shift
    // and mask.
    int pos = p0;
    uint2 win = ring.below((pos - 1) >> 5);
    int sh = pos - (32 * ((pos - 1) >> 5) - 21);  // the peek's shift in `win`
    // Four symbols, packed into one word; `live` of them move the position
    // (past regen it freezes, only in the last word).  The ring holds the
    // words of the next 8 words' symbols (8 x 44 bits and the window).
    auto decode_word = [&](int live) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; b++) {
            const uint64_t bits = (static_cast<uint64_t>(win.y) << 32) | win.x;
            const int v = static_cast<int>(bits >> sh) & 0x7FF;
            const int t = (pos - 1) >> 5;
            win = ring.below(t);
            sh = pos - (32 * t - 21);
            word |= static_cast<uint32_t>(lut_sym[v]) << (8 * b);
            if (b < live) {
                const int len = lut_len[v];
                pos -= len;
                sh -= len;
            }
        }
        return word;
    };
    // Thread w % 32 keeps word w until the warp stores the 32 words with
    // one coalesced store.
    uint32_t keep = 0;
    auto store_words = [&](int to) {  // the held words below `to`
        const int from = (to - 1) & ~31;
        if (from + lane < to) out[from + lane] = keep;
    };
    int w = 0;
    while (w < n_full) {
        ring.ensure(pos, 8 * 44 + 64);
#pragma unroll
        for (int i = 0; i < 8; i++) {
            if (w == n_full) break;
            const uint32_t word = decode_word(4);
            if ((w & 31) == lane) keep = word;
            w++;
        }
        if ((w & 31) == 0) store_words(w);
    }
    if (w < n_out) {
        ring.ensure(pos, 64);
        const uint32_t word = decode_word(regen & 3);
        if ((w & 31) == lane) keep = word;
        w++;
    }
    if (n_out & 31 || n_out > n_full) store_words(n_out);  // the last chunk, unless stored
    if (lane == 0) ok[j] = (pos == pend) ? 1 : 0;
}

}  // namespace

ZT_EXPORT int zt_literals(const void* words, long long n_words, const void* lane_mat,
                          const void* cum, const void* limits, const void* prevs,
                          const void* lengths, const void* rankb, const void* ranked,
                          void* dense, void* ok, int n_lanes, void* stream) {
    if (n_lanes > 0) {
        literals_kernel<<<n_lanes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), n_words,
            static_cast<const int32_t*>(lane_mat), static_cast<const int32_t*>(cum),
            static_cast<const int32_t*>(limits), static_cast<const int32_t*>(prevs),
            static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(rankb),
            static_cast<const int32_t*>(ranked), static_cast<uint8_t*>(dense),
            static_cast<int32_t*>(ok));
    }
    return static_cast<int>(cudaGetLastError());
}

// Launch geometry for n_lanes lanes (common.cuh zt::launch_info); `wide` is
// taken for the sequences kernel's signature and unused.
ZT_EXPORT int zt_launch_info(int n_lanes, int /*wide*/, int* out) {
    return zt::launch_info(literals_kernel, n_lanes, kThreads, 0, out);
}
