// Shared pieces of the port's CUDA kernels: the backward-bitstream reader
// and the error-string export every kernel library carries.
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

ZT_EXPORT const char* zt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace zt {

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              long long n_words, long long base,
                                              int wi) {
    if (wi < 0) return 0u;
    long long idx = base + wi;
    if (idx > n_words - 1) idx = n_words - 1;
    if (idx < 0) idx = 0;
    return __ldg(words + idx);
}

// The n (0..32) bits just below bit position `pos`, MSB first.
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ words,
                                              long long n_words, long long base,
                                              int pos, int n) {
    int lo_bit = pos - n;
    int wi = lo_bit >> 5;  // arithmetic shift: floor for negative positions
    int sh = lo_bit & 31;
    uint64_t v = static_cast<uint64_t>(load_word(words, n_words, base, wi)) |
                 (static_cast<uint64_t>(load_word(words, n_words, base, wi + 1)) << 32);
    uint64_t mask = (n >= 32) ? 0xFFFFFFFFull : ((1ull << n) - 1ull);
    return static_cast<uint32_t>((v >> sh) & mask);
}

}  // namespace zt
