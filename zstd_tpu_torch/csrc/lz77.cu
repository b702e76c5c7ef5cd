// LZ77 copy-program executor: runs batches of (src, dst, len) byte copies.
//
// Replaces tools/lz77_pallas_spike.py:46 (_kernel, reached through
// run_ops): run a program's ops in order over a byte buffer with
// forward-copy semantics — a byte an op reads inside its own destination
// range is one that op already wrote (offset < length replicates the
// period), the byte-serial semantics of decoding_context.rs:78-99.  Here it
// is the device LZ77 route of the engine (DeviceEngine(device_execute=True)):
// one program per frame, a frame group's programs laid end to end in one
// buffer, one launch per group.
//
// Design for the card, not block by block.  The TPU kernel kept one byte per
// int32 element in (R, 128) VMEM rows and moved bytes with two lane rolls
// and a select, because Mosaic has no byte gather and no per-lane
// addressing; its program sat in SMEM (a few thousand ops) and a repeat
// loop amortised relay latency.  Here the buffer is plain uint8 in device
// memory, updated in place, and one warp runs one program: the warp loads
// 32 ops at a time (one per lane, coalesced) and broadcasts each with
// __shfl_sync; an op is copied in chunks of up to 128 bytes, 4 per lane, of
// min(period, remaining) bytes, where the period starts at dst - src and
// grows to the largest multiple of it already copied (log doubling for
// self-overlapping matches).  A chunk never reads a byte it writes, so its
// loads all precede its stores; __syncwarp() after each chunk orders its
// stores before the next chunk's (or op's) loads.
//
// Bound on the H100: bytes over 3.35 TB/s (ops read once, every copied
// byte read once and written once).  The ops of a frame are a serial chain
// (a match may read the bytes of the op just before it), so the kernel runs
// at one dependent load-store round trip per chunk, on one warp per frame:
// a frame group of a few frames keeps a few SMs busy.  That latency, not
// bandwidth, is what it is bound by in practice; PERF.md keeps its times.
//
// The wrapper (zstd_tpu_torch/kernels/lz77.py) checks on the host, before
// the launch, what the kernel relies on: 0 <= src < dst and dst + len within
// the buffer for every op, and op ranges that cover the ops in order.

#include "common.cuh"

namespace {

constexpr int kBytesPerLane = 4;
constexpr long long kChunk = 32 * kBytesPerLane;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

// One warp per program.  `buf` is read and written by the same warp only
// (programs write disjoint bytes), so plain loads and stores, ordered by
// __syncwarp, are coherent: the buffer is deliberately not __restrict__ or
// const, which would allow the non-coherent read-only path.
__global__ void lz77_kernel(const long long* __restrict__ src, const long long* __restrict__ dst,
                            const long long* __restrict__ len, const long long* __restrict__ op_off,
                            int n_progs, uint8_t* buf) {
    const int prog = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (prog >= n_progs) return;  // warp-uniform
    const long long o0 = op_off[prog];
    const long long o1 = op_off[prog + 1];
    for (long long base = o0; base < o1; base += 32) {
        long long my_s = 0, my_d = 1, my_n = 0;
        if (base + lane < o1) {
            my_s = src[base + lane];
            my_d = dst[base + lane];
            my_n = len[base + lane];
        }
        const int count = static_cast<int>(lmin(32LL, o1 - base));
        for (int j = 0; j < count; ++j) {
            const long long s = __shfl_sync(kFull, my_s, j);
            const long long d = __shfl_sync(kFull, my_d, j);
            const long long n = __shfl_sync(kFull, my_n, j);
            const long long dist = d - s;
            long long copied = 0;
            long long period = dist;
            while (copied < n) {
                const long long c = lmin(lmin(period, n - copied), kChunk);
                const long long from = d + copied - period;
                uint8_t v[kBytesPerLane];
#pragma unroll
                for (int q = 0; q < kBytesPerLane; ++q) {
                    const int i = lane + 32 * q;
                    if (i < c) v[q] = buf[from + i];
                }
#pragma unroll
                for (int q = 0; q < kBytesPerLane; ++q) {
                    const int i = lane + 32 * q;
                    if (i < c) buf[d + copied + i] = v[q];
                }
                __syncwarp();
                copied += c;
                if (copied >= dist) period = copied - copied % dist;
            }
        }
    }
}

}  // namespace

// ops: int64 [3, n_ops] rows (src, dst, len); op_off: int64 [n_progs + 1];
// buf: uint8, updated in place.
ZT_EXPORT int zt_lz77_exec(const void* ops, long long n_ops, const void* op_off, int n_progs,
                           void* buf, void* stream) {
    if (n_progs > 0 && n_ops > 0) {
        const long long* o = static_cast<const long long*>(ops);
        lz77_kernel<<<n_progs, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            o, o + n_ops, o + 2 * n_ops, static_cast<const long long*>(op_off), n_progs,
            static_cast<uint8_t*>(buf));
    }
    return static_cast<int>(cudaGetLastError());
}
