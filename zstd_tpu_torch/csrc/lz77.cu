// LZ77 copy-program executor: a byte buffer after batches of (src, dst, len)
// copies, resolved in parallel over the whole frame group.
//
// Replaces tools/lz77_pallas_spike.py:46 (_kernel, reached through run_ops):
// run a program's ops in order over a byte buffer with forward-copy
// semantics — a byte an op reads inside its own destination range is one
// that op already wrote (offset < length replicates the period), the
// byte-serial semantics of decoding_context.rs:78-99.  Here it is the device
// LZ77 route of the engine (DeviceEngine(device_execute=True)): one program
// per frame, a frame group's programs laid end to end in one buffer, one
// wrapper call per group.
//
// Precondition.  (a) Within a program the ops' destination ranges ascend and
// do not overlap; (b) 0 <= src < dst and dst + len within the buffer for
// every op, and the buffer is below 2^31 bytes; (c) no op reads a byte that
// another program's ops write.  The wrapper (zstd_tpu_torch/kernels/lz77.py)
// checks (a) and (b) on the host before the launch; pack_programs gives (c)
// by construction (each frame's ops stay inside its own buffer), and it is
// not checked.
//
// Under it the serial result has a closed form.  Byte dst + k of an op takes
// the final value of byte src + (k mod (dst - src)): that byte lies below the
// op's destination, so only earlier ops of the program write it, and no later
// op does.  Folding by the period removes every chain inside an op (offset 1
// over a 128 KiB run is one step deep).  So every written byte has one source
// strictly below it, every byte no op writes (a pool byte, a prefilled raw or
// RLE byte) is a root that keeps its value, and the result is
// buf[i] = buf[root(i)].  Only matches of matches form chains.
//
// Design: one map entry per byte of the span [lo, hi) that the ops write
// (int32, in scratch the wrapper allocates), and 3 + R launches on the
// stream with no host synchronisation:
//   1. init: every entry kRoot (no op writes the byte), the round flags 0.
//   2. expand: one warp per 32 ops over the whole grid.  A lane writes its
//      own op's entries; the warp writes each op longer than kShortOp
//      together, 32 entries at a time.  An entry is its source position
//      (open), or ~source (resolved) when the source lies below its
//      program's first destination or below lo: no op writes such a byte,
//      by (a) and (c).  Every literal op's bytes are resolved here.
//   3. R jump rounds: every open entry follows its chain up to kHops steps
//      (an entry read may itself have moved on in this round: it only ever
//      moves towards the root, so a stale read slows convergence and never
//      gives a wrong byte) and stores how far it got.  A round that leaves
//      an entry open sets its flag; a round whose predecessor's flag is
//      clear returns at once.  Each round takes an open entry at least
//      kHops + 1 times as far along its chain, so the wrapper's R, the least
//      with (kHops + 1)^R >= hi - lo, resolves any chain.
//   4. gather: buf[i] = buf[~map[i]] for every written byte.  Roots are never
//      written, so the gather runs in place, in any order.
//
// Bound on the H100: bytes over 3.35 TB/s — the ops read once and every
// copied byte read and written once.  The design keeps to passes over the
// span that are coalesced and spread over every SM (the map adds about 4
// bytes a span byte a pass, mostly in the 50 MB L2), resolves every literal
// byte at expand time, and lets rounds past convergence return at once.
// What stays above the bound is the rounds' dependent random loads: every
// byte of a match walks its chain of matches of matches on its own.
// PERF.md keeps its times.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kShortOp = 32;  // longer ops are expanded by the whole warp
constexpr int kHops = 4;      // chain steps an open entry takes per round (kernels/lz77.py HOPS)
constexpr int kRoot = static_cast<int>(0x80000000u);  // ~p for no position p < 2^31 - 1

__device__ __forceinline__ long long thread_id() {
    return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long n_threads() {
    return static_cast<long long>(gridDim.x) * blockDim.x;
}

// map holds n_vec int4 vectors; flags n_flags ints.
__global__ void lz77_init(int* __restrict__ map, long long n_vec, int* __restrict__ flags, int n_flags) {
    const long long t = thread_id();
    if (t < n_flags) flags[t] = 0;
    for (long long q = t; q < n_vec; q += n_threads())
        reinterpret_cast<int4*>(map)[q] = make_int4(kRoot, kRoot, kRoot, kRoot);
}

// Entry of byte dst + k of an op whose source byte is v: resolved when v lies
// below the first destination of the op's program.
__device__ __forceinline__ int entry(int v, int first) { return v < first ? ~v : v; }

__global__ void lz77_expand(const long long* __restrict__ src, const long long* __restrict__ dst,
                            const long long* __restrict__ len, long long n_ops,
                            const long long* __restrict__ op_off, int n_progs, int lo,
                            int* __restrict__ map) {
    const int lane = threadIdx.x & 31;
    const long long warp_stride = n_threads();  // ops a grid-stride step covers
    for (long long base = thread_id() - lane; base < n_ops; base += warp_stride) {  // warp-uniform
        const long long o = base + lane;
        int s = 0, d = 1, n = 0, first = 0;
        if (o < n_ops) {
            s = static_cast<int>(src[o]);
            d = static_cast<int>(dst[o]);
            n = static_cast<int>(len[o]);
            int a = 0, b = n_progs;  // op_off[a] <= o < op_off[b]
            while (b - a > 1) {
                const int m = (a + b) >> 1;
                if (op_off[m] <= o) a = m; else b = m;
            }
            // No op writes a byte below lo either (a zero-length first op
            // may start lower).
            const long long f0 = dst[op_off[a]];
            first = static_cast<int>(f0 > lo ? f0 : lo);
        }
        if (n <= kShortOp) {
            const int period = d - s;
            int j = 0;  // k mod period
            for (int k = 0; k < n; ++k) {
                map[d - lo + k] = entry(s + j, first);
                if (++j == period) j = 0;
            }
        }
        unsigned longs = __ballot_sync(kFull, n > kShortOp);
        while (longs) {
            const int l = __ffs(longs) - 1;
            longs &= longs - 1;
            const int ls = __shfl_sync(kFull, s, l);
            const int ld = __shfl_sync(kFull, d, l);
            const int ln = __shfl_sync(kFull, n, l);
            const int lf = __shfl_sync(kFull, first, l);
            const int period = ld - ls;
            const int step = 32 % period;
            int j = lane % period;  // k mod period for k = lane, lane + 32, ...
            for (long long k = lane; k < ln; k += 32) {
                map[ld - lo + k] = entry(ls + j, lf);
                j += step;
                if (j >= period) j -= period;
            }
        }
    }
}

// One round: open entries (>= 0, a source position) step along their chains.
// A thread steps its four entries together, so their loads are in flight at
// once.
__global__ void lz77_jump(int* map, long long n_vec, int lo, int* flags, int round) {
    __shared__ int go;  // one load of the flag a block, not one a warp
    if (threadIdx.x == 0) go = round == 0 || flags[round - 1] != 0;
    __syncthreads();
    if (!go) return;  // grid-uniform: the previous round left nothing open
    bool open = false;
    for (long long q = thread_id(); q < n_vec; q += n_threads()) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(map) + q);
        int cur[4] = {v.x, v.y, v.z, v.w};  // resolved (< 0), or no op writes the byte (kRoot)
        if ((cur[0] & cur[1] & cur[2] & cur[3]) < 0) continue;  // no entry open
        for (int h = 0; h < kHops; ++h) {
            int f[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
                if (cur[t] >= 0) f[t] = __ldcg(map + (cur[t] - lo));
#pragma unroll
            for (int t = 0; t < 4; ++t)
                if (cur[t] >= 0) cur[t] = f[t] == kRoot ? ~cur[t] : f[t];  // kRoot: cur is a root
            if ((cur[0] & cur[1] & cur[2] & cur[3]) < 0) break;
        }
        open |= (cur[0] & cur[1] & cur[2] & cur[3]) >= 0;  // an entry still open
        reinterpret_cast<int4*>(map)[q] = make_int4(cur[0], cur[1], cur[2], cur[3]);
    }
    if (__syncthreads_or(open) && threadIdx.x == 0) flags[round] = 1;  // one store a block
}

// buf is both read (roots) and written (every other byte of the span).
__global__ void lz77_gather(const int* __restrict__ map, long long n_vec, int lo, uint8_t* buf) {
    for (long long q = thread_id(); q < n_vec; q += n_threads()) {
        const int4 v = reinterpret_cast<const int4*>(map)[q];
        const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
            if (e[t] < 0 && e[t] != kRoot) buf[lo + 4 * q + t] = buf[~e[t]];
    }
}

// Blocks for a grid-stride loop over `threads`: every SM of the launch's card
// full, and no more.
int grid_for(long long threads, int sms) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    const long long cap = 8LL * sms;  // 2 048 threads an SM: every SM full
    return static_cast<int>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

}  // namespace

// ops: int64 [3, n_ops] rows (src, dst, len); op_off: int64 [n_progs + 1];
// buf: uint8, updated in place; the ops write bytes in [lo, lo + n_map) only;
// map: int32 [n_map] scratch, n_map a multiple of 4 and the pointer 16-byte
// aligned; flags: int32 [rounds].  Launches init, expand, `rounds` jump
// rounds and gather on `stream`.
ZT_EXPORT int zt_lz77_exec(const void* ops, long long n_ops, const void* op_off, int n_progs,
                           void* buf, int lo, long long n_map, void* map, void* flags, int rounds,
                           void* stream) {
    if (n_progs <= 0 || n_ops <= 0 || n_map <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long* o = static_cast<const long long*>(ops);
    int* m = static_cast<int*>(map);
    int* f = static_cast<int*>(flags);
    const long long n_vec = n_map / 4;
    // The SM count of the current device, which the wrapper makes the
    // buffer's: asked on every call, so each card gets its own.
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
        cudaGetLastError();  // clear it: the error is returned here
        return static_cast<int>(e);
    }
    lz77_init<<<grid_for(n_vec > rounds ? n_vec : rounds, sms), kThreads, 0, s>>>(m, n_vec, f, rounds);
    lz77_expand<<<grid_for(n_ops, sms), kThreads, 0, s>>>(o, o + n_ops, o + 2 * n_ops, n_ops,
                                                     static_cast<const long long*>(op_off), n_progs,
                                                     lo, m);
    for (int r = 0; r < rounds; ++r) lz77_jump<<<grid_for(n_vec, sms), kThreads, 0, s>>>(m, n_vec, lo, f, r);
    lz77_gather<<<grid_for(n_vec, sms), kThreads, 0, s>>>(m, n_vec, lo, static_cast<uint8_t*>(buf));
    return static_cast<int>(cudaGetLastError());
}
