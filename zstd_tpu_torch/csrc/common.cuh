// Shared pieces of the port's CUDA kernels: the warp's backward-bitstream
// reader, the launch-geometry report of the lane kernels, and the
// error-string export every kernel library carries.
//
// A lane's entropy stream lives in place in the raw input's little-endian
// u32 words: `base` is its first word, bit positions count from bit 0 of
// that word, and a backward stream is read from its sentinel downward.
// Reads are random access — the n bits just below `pos` — which is what the
// JAX reference's buffered reader yields (zstd_tpu_torch/kernels/bitbuf.py
// states the equivalence).  Words below the base word read as zero (the
// phantom padding past the stream start); other word indices clamp into the
// buffer, as the reference's gathers clamp.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ZT_EXPORT extern "C" __attribute__((visibility("default")))

namespace zt {

// Word `wi` of a lane's stream: 0 below the base word, clamped past the end.
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              long long n_words, long long base,
                                              int wi) {
    if (wi < 0) return 0u;
    long long idx = base + wi;
    if (idx > n_words - 1) idx = n_words - 1;
    if (idx < 0) idx = 0;
    return __ldg(words + idx);
}

// One warp's reader over one backward stream, run by all 32 threads of the
// warp in step (every thread computes the same positions; shared loads of
// one address broadcast).
//
// The stream's words sit in a ring in shared memory as pairs: entry t % 128
// holds words t - 1 and t, for the 128 words t from `low` up, so the 64 bits
// below any word's top are one 8-byte load.  A read of the n <= 32 bits
// below position p takes the pair of word p >> 5, one funnel shift and one
// shift; reads whose positions are known can all be issued at once.
// ensure(p, bits) keeps the words down to bit p - bits in the ring: when
// they run out, the warp stores the 32 pairs below `low`, which it holds
// in registers (thread t holds the pair of word low - 32 + t), over the
// ring's top 32 entries, and loads the next 32 pairs with coalesced loads,
// 32 words ahead of their use.  Every word is load_word()'s, so a read
// gives exactly the bits of the random-access read above: phantom zeros
// below the base word, clamped indices past the end.
struct Ring {
    static constexpr int kEntries = 128;
    uint2* ring;
    const uint32_t* words;
    long long n_words, base;
    int lane, low;
    uint2 pre;  // the pair of word low - 32 + lane

    __device__ __forceinline__ uint2 pair(int t) const {
        return make_uint2(load_word(words, n_words, base, t - 1), load_word(words, n_words, base, t));
    }

    // Ring words for reads below bit `pos`: the top 32 entries hold word
    // pos >> 5, the highest such a read touches.
    __device__ __forceinline__ void init(uint2* smem, const uint32_t* w, long long nw, long long b,
                                         int pos, int ln) {
        ring = smem;
        words = w;
        n_words = nw;
        base = b;
        lane = ln;
        low = ((pos >> 5) & ~31) - (kEntries - 32);
        for (int c = 0; c < kEntries; c += 32) ring[(low + c + lane) & (kEntries - 1)] = pair(low + c + lane);
        pre = pair(low - 32 + lane);
        __syncwarp();
    }

    // Make the words down to bit p - bits (bits <= 992: one chunk of 32
    // words then suffices) readable.  Reads since the last call were at
    // most `bits` above p, so the top entries it overwrites are above every
    // word later reads touch; the first
    // __syncwarp() holds the stores until every thread's earlier reads are
    // done, the second holds the reads until every store is.
    __device__ __forceinline__ void ensure(int p, int bits) {
        if (((p - bits) >> 5) < low) {
            __syncwarp();
            ring[(low - 32 + lane) & (kEntries - 1)] = pre;
            low -= 32;
            pre = pair(low - 32 + lane);
            __syncwarp();
        }
    }

    // Words t - 1 (x) and t (y), t >= low: the 64 bits from bit 32t - 32.
    __device__ __forceinline__ uint2 below(int t) const { return ring[t & (kEntries - 1)]; }

    // The n (0..32) bits just below bit position p, MSB first: the 32 bits
    // below p, shifted down by 32 - n (to 0 for n = 0).
    __device__ __forceinline__ uint32_t read(int p, int n) const {
        const uint2 q = below(p >> 5);  // arithmetic shift: floor below bit 0
        return __funnelshift_rc(__funnelshift_r(q.x, q.y, p), 0u, 32 - n);
    }
};

// Launch geometry of `kernel` and its compiled resources, for the report of
// a lane kernel's zt_launch_info(): blocks, threads per block, dynamic shared
// bytes, static shared bytes, registers per thread, local (stack and spill)
// bytes per thread.
template <typename Kernel>
inline int launch_info(Kernel kernel, int blocks, int threads, int dynamic_smem, int* out) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    const int info[6] = {blocks, threads, dynamic_smem, static_cast<int>(a.sharedSizeBytes),
                         a.numRegs, static_cast<int>(a.localSizeBytes)};
    for (int i = 0; i < 6; i++) out[i] = e == cudaSuccess ? info[i] : 0;
    return static_cast<int>(e);
}

}  // namespace zt

ZT_EXPORT const char* zt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
