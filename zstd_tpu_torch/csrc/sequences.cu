// Interleaved tANS sequence decode, one thread per sequence stream (lane).
//
// Replaces zstd_tpu/kernels/pallas_seq.py:108 (_kernel, reached through
// decode_sequences_dense_pl), and carries the wide retry that the JAX
// package runs on its lax.scan form (entropy2.decode_sequences_v2 with
// wide=True).  Per sequence: FSE rows of the LL/OF/ML states from the flat
// table banks at bank_off[slot] + state; extra bits read OF, ML, LL; state
// updates LL, ML, OF, skipped on the lane's last sequence;
// ofv = (1 << of_code) + extra.  State init reads LL, OF, ML.
//
// Outputs are (rows, L) planes, row i = slot i (= sequence i, by the
// never-stall invariant): narrow mode writes valid << 31 | ofv and
// ll << 16 | ml, and flags a lane bad for of_code >= 31, a stall, or
// ll/ml > 0xFFFF; wide mode writes valid << 31 | ofv, ll and ml in full
// range.  A lane is ok when it emitted nseq sequences, ended exactly at
// its end bit and is not bad.  The reference's 192-bit buffer is tracked
// by its fill count alone (three refills per slot while the count is
// <= 160; a slot decodes with >= 90 bits), which keeps the stall rule
// exact.  Slots past a lane's last sequence carry the reference's
// inactive values (ofv of the frozen offset state, zero ll/ml).
//
// Where the TPU kernel kept a 128-word sliding cache selected one-hot out
// of a (W, 128) window and one-hot selected table rows over R = 2^al rows,
// a thread here loads its own stream words and table entries: no window,
// no MAX_W cap, no step ladder (each thread loops to its own nseq; plane
// heights follow the longest lane of the call).
//
// Bound on the H100: a lane is a serial chain (each state depends on the
// previous one's bits), so with a few dozen lanes per call the card is
// nearly idle and the kernel is latency bound; its bytes (stream words in,
// two planes out) are far below the memory rate.  Tables in shared memory
// and more parallelism are later work.

#include "common.cuh"

namespace {

constexpr int kLaneCols = 13;  // base, p0, pend, nseq, w_ll, w_ml, w_of,
                               // ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al
constexpr int kMaxBits = 90;   // of extra <= 31, ml/ll extra <= 16, 3 updates <= 9
constexpr int kBufBits = 192;  // reference buffer: refills fire at <= 160 bits

struct Reader {
    const uint32_t* words;
    long long n_words;
    long long base;
    int pos;
    int nb;
    __device__ __forceinline__ int take(int n) {
        const int v = static_cast<int>(zt::read_bits(words, n_words, base, pos, n));
        pos -= n;
        nb -= n;
        return v;
    }
};

__device__ __forceinline__ int fse(const int32_t* __restrict__ flat, long long n_flat,
                                   long long off, int state) {
    long long idx = off + state;
    if (idx > n_flat - 1) idx = n_flat - 1;
    if (idx < 0) idx = 0;
    return flat[idx];
}

__device__ __forceinline__ uint32_t pow2_u32(int code) {
    return (code >= 0 && code < 32) ? (1u << code) : 0u;
}

__global__ void sequences_kernel(const uint32_t* __restrict__ words, long long n_words,
                                 const int32_t* __restrict__ lane_mat,
                                 const int32_t* __restrict__ flat0,
                                 const int32_t* __restrict__ flat1, long long n_flat,
                                 const int32_t* __restrict__ bank_off, int rows, int n_lanes,
                                 int wide, uint32_t* __restrict__ out_a,
                                 int32_t* __restrict__ out_b, int32_t* __restrict__ out_c,
                                 int32_t* __restrict__ ok) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_lanes) return;
    const int32_t* col = lane_mat + static_cast<long long>(kLaneCols) * j;
    const int p0 = col[1], pend = col[2], nseq = col[3];
    const long long off_ll = bank_off[col[7]], off_of = bank_off[col[8]],
                    off_ml = bank_off[col[9]];
    const int ll_al = col[10], of_al = col[11], ml_al = col[12];

    Reader r{words, n_words, static_cast<long long>(col[0]), p0, (p0 & 31) + kBufBits - 32};
    int s_ll = r.take(ll_al);
    int s_of = r.take(of_al);
    int s_ml = r.take(ml_al);
    int emitted = 0;
    bool bad = false;

    for (int t = 0; t < rows; t++) {
        const long long o = static_cast<long long>(t) * n_lanes + j;
        if (emitted >= nseq) {
            // Done: the remaining slots are invalid and carry the frozen
            // offset state's 1 << of_code.
            const uint32_t fill = pow2_u32(fse(flat1, n_flat, off_of, s_of)) & 0x7FFFFFFFu;
            for (long long q = o; q < static_cast<long long>(rows) * n_lanes; q += n_lanes) {
                out_a[q] = fill;
                out_b[q] = 0;
                if (wide) out_c[q] = 0;
            }
            break;
        }
        for (int k = 0; k < 3; k++)
            if (r.nb <= kBufBits - 32) r.nb += 32;
        const bool can = r.nb >= kMaxBits;

        const int e0_ll = fse(flat0, n_flat, off_ll, s_ll);
        const int e1_ll = fse(flat1, n_flat, off_ll, s_ll);
        const int e0_of = fse(flat0, n_flat, off_of, s_of);
        const int of_code = fse(flat1, n_flat, off_of, s_of);
        const int e0_ml = fse(flat0, n_flat, off_ml, s_ml);
        const int e1_ml = fse(flat1, n_flat, off_ml, s_ml);

        const uint32_t ofv = pow2_u32(of_code) + static_cast<uint32_t>(r.take(can ? of_code : 0));
        const int ml = (e1_ml >> 5) + r.take(can ? (e1_ml & 31) : 0);
        const int ll = (e1_ll >> 5) + r.take(can ? (e1_ll & 31) : 0);

        if (can && emitted < nseq - 1) {
            s_ll = (e0_ll >> 16) + r.take(e0_ll & 0xFFFF);
            s_ml = (e0_ml >> 16) + r.take(e0_ml & 0xFFFF);
            s_of = (e0_of >> 16) + r.take(e0_of & 0xFFFF);
        }
        emitted += can ? 1 : 0;
        bad = bad || (can && of_code >= 31);
        out_a[o] = (can ? 0x80000000u : 0u) | (ofv & 0x7FFFFFFFu);
        if (wide) {
            out_b[o] = can ? ll : 0;
            out_c[o] = can ? ml : 0;
        } else {
            bad = bad || !can || ll > 0xFFFF || ml > 0xFFFF;
            const uint32_t packed = (static_cast<uint32_t>(ll) << 16) |
                                    (static_cast<uint32_t>(ml) & 0xFFFFu);
            out_b[o] = can ? static_cast<int32_t>(packed) : 0;
        }
    }
    ok[j] = (emitted == nseq && r.pos == pend && !bad) ? 1 : 0;
}

}  // namespace

// Narrow mode: out_c may be null.  Wide mode: out_b = ll, out_c = ml.
ZT_EXPORT int zt_sequences(const void* words, long long n_words, const void* lane_mat,
                           const void* flat0, const void* flat1, long long n_flat,
                           const void* bank_off, int rows, int n_lanes, int wide, void* out_a,
                           void* out_b, void* out_c, void* ok, void* stream) {
    if (n_lanes > 0) {
        const int threads = 64;
        const int blocks = (n_lanes + threads - 1) / threads;
        sequences_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), n_words,
            static_cast<const int32_t*>(lane_mat), static_cast<const int32_t*>(flat0),
            static_cast<const int32_t*>(flat1), n_flat, static_cast<const int32_t*>(bank_off),
            rows, n_lanes, wide, static_cast<uint32_t*>(out_a), static_cast<int32_t*>(out_b),
            static_cast<int32_t*>(out_c), static_cast<int32_t*>(ok));
    }
    return static_cast<int>(cudaGetLastError());
}
