// Huffman literals decode, one thread per literal stream (lane).
//
// Replaces zstd_tpu/kernels/pallas_lit.py:63 (_kernel, reached through
// decode_literals_dense_pl).  Per symbol: an 11-bit peek below the lane's
// bit position, the code-length class as the number of class limits <= the
// peek, a rank from the class's first rank and the peek's offset in the
// class, and the symbol from the 256-entry rank table (the arithmetic
// canonical Huffman of format/block_table.pack_huffman_canonical).
//
// Where the TPU kernel one-hot selected each lane's words out of a (W, 128)
// VMEM window (Mosaic has no per-lane gather), a thread here loads its own
// words from the device copy of the input: no window, no MAX_W cap.  The
// thread writes its symbols straight to the dense output at byte 4*cum[j],
// so no compaction pass follows.  It loops to its own lane's regen rounded
// up to a whole word; the bytes past regen hold the symbol at the frozen
// final position, as the plain form's inactive slots do.
//
// Bound on the H100: each symbol depends on the previous one's code length,
// so a lane is a serial chain of dependent loads and a few hundred lanes
// fill a small fraction of the card; the bytes moved (stream words in,
// symbols out) are far below what 3.35 TB/s would need.  This first form is
// latency bound; shared-memory tables and more lanes per call are later
// work.

#include "common.cuh"

namespace {

constexpr int kClasses = 12;
constexpr int kLaneCols = 5;  // base, p0, pend, regen, slot

__global__ void literals_kernel(const uint32_t* __restrict__ words, long long n_words,
                                const int32_t* __restrict__ lane_mat,
                                const int32_t* __restrict__ cum,
                                const int32_t* __restrict__ limits,
                                const int32_t* __restrict__ prevs,
                                const int32_t* __restrict__ lengths,
                                const int32_t* __restrict__ rankb,
                                const int32_t* __restrict__ ranked, uint8_t* __restrict__ dense,
                                int32_t* __restrict__ ok, int n_lanes) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    const int32_t* col = lane_mat + static_cast<long long>(kLaneCols) * j;
    const long long base = col[0];
    const int p0 = col[1], pend = col[2], regen = col[3], slot = col[4];

    int lim[kClasses], prv[kClasses], len[kClasses], rkb[kClasses];
    const long long t = static_cast<long long>(slot) * kClasses;
    for (int k = 0; k < kClasses; k++) {
        lim[k] = limits[t + k];
        prv[k] = prevs[t + k];
        len[k] = lengths[t + k];
        rkb[k] = rankb[t + k];
    }
    const int32_t* rk = ranked + static_cast<long long>(slot) * 256;
    uint8_t* out = dense + 4LL * cum[j];

    int pos = p0;
    const int n_out = ((regen + 3) >> 2) << 2;
    for (int i = 0; i < n_out; i++) {
        const int v = static_cast<int>(zt::read_bits(words, n_words, base, pos, 11));
        int c = 0;
#pragma unroll
        for (int k = 0; k < kClasses; k++) c += (v >= lim[k]);
        int length = 0, prev = 0, rb = 0;
        if (c < kClasses) {
            length = len[c];
            prev = prv[c];
            rb = rkb[c];
        }
        // Code lengths are 1..11 (pack_huffman_canonical), so the shift is
        // in range; a class past the table selects length 0 and rank 0.
        const int rank = rb + ((v - prev) >> (11 - length));
        const int sym = (rank >= 0 && rank < 256) ? rk[rank] : 0;
        out[i] = static_cast<uint8_t>(sym & 0xFF);
        if (i < regen) pos -= length;
    }
    ok[j] = (pos == pend) ? 1 : 0;
}

}  // namespace

ZT_EXPORT int zt_literals(const void* words, long long n_words, const void* lane_mat,
                          const void* cum, const void* limits, const void* prevs,
                          const void* lengths, const void* rankb, const void* ranked,
                          void* dense, void* ok, int n_lanes, void* stream) {
    if (n_lanes > 0) {
        const int threads = 128;
        const int blocks = (n_lanes + threads - 1) / threads;
        literals_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), n_words,
            static_cast<const int32_t*>(lane_mat), static_cast<const int32_t*>(cum),
            static_cast<const int32_t*>(limits), static_cast<const int32_t*>(prevs),
            static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(rankb),
            static_cast<const int32_t*>(ranked), static_cast<uint8_t*>(dense),
            static_cast<int32_t*>(ok), n_lanes);
    }
    return static_cast<int>(cudaGetLastError());
}
