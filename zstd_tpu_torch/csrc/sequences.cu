// Interleaved tANS sequence decode, one warp per sequence stream (lane).
//
// Replaces zstd_tpu/kernels/pallas_seq.py:108 (_kernel, reached through
// decode_sequences_dense_pl), and carries the wide retry that the JAX
// package runs on its lax.scan form (entropy2.decode_sequences_v2 with
// wide=True).  Per sequence: FSE rows of the LL/OF/ML states; extra bits
// read OF, ML, LL; state updates LL, ML, OF, skipped on the lane's last
// sequence; ofv = (1 << of_code) + extra.  State init reads LL, OF, ML.
//
// Outputs are (rows, L) planes, row i = slot i (= sequence i, by the
// never-stall invariant): narrow mode writes valid << 31 | ofv and
// ll << 16 | ml, and flags a lane bad for of_code >= 31, a stall, or
// ll/ml > 0xFFFF; wide mode writes valid << 31 | ofv, ll and ml in full
// range.  A lane is ok when it emitted nseq sequences, ended exactly at
// its end bit and is not bad.  The reference's 192-bit buffer is tracked
// by its fill count alone (`nb`: three refills per slot while the count is
// <= 160; a slot decodes with >= 90 bits), which keeps the stall rule
// exact.  Slots past a lane's last sequence carry the reference's
// inactive values (ofv of the frozen offset state, zero ll/ml).
//
// Bound on the H100: a lane is a serial chain — each state's table row
// depends on the bits the previous sequence consumed — so a launch takes
// its longest lane's chain; its bytes (stream words in, two planes out)
// would move in microseconds.  The design spreads the lanes and shortens
// the chain:
//
// * Launch: one block of one warp per lane (blocks = lanes, 32 threads,
//   25.6 KB of static shared memory), so a frame group's 64 lanes run on
//   64 SMs.  A launch of the main path fits the card's resident slots, so
//   blocks start in lane order; no longest-first ordering.
// * Tables: the warp stages its lane's three FSE tables into shared
//   memory, each row pre-digested into one 16-byte entry (value base or
//   1 << OF code, extra-bits width, state baseline, state-update width),
//   so a sequence's three lookups are three independent 16-byte loads and
//   no field is decoded on the chain.  Each table stages the 512 rows the
//   plain form gathers (kernels/entropy2.fse_bank_rows: bank_off[slot] + r
//   clamped into the bank) and a 513th, the zero entry, which a state
//   outside 0..511 selects as the plain form's _fse_entry does: the
//   staged lookup equals the plain form for every state.  States are kept
//   as their row indices.
// * Bits: the stream's words sit in the warp's shared ring (common.cuh
//   Ring), checked once every kSlotsPerCheck slots.  The three rows give
//   all six fields' widths, so the six reads (each one 8-byte ring load
//   and two shifts) go out together at the positions of a sequence that
//   decodes and updates its states; the reference
//   buffer's count (`can`, `upd`) selects afterwards which of them count,
//   off the chain.  The next slot's rows are loaded before this slot's
//   outputs are made, so the outputs fill the loads' latency.
// * Outputs: thread t keeps row t of every 32 and the warp stores the 32
//   rows at once; slots past the lane's end are filled 32 at a time.
//   Narrow and wide are two instantiations of one kernel.
//
// What holds it (measured on an H100, PERF.md): a sequence takes ~103 ns
// (wide ~95 ns), ~205 cycles of the 1.98 GHz SM clock.  Its chain is two
// dependent shared loads and a dozen integer operations, but one warp
// issues in order and a slot is ~100 instructions: the kernel is bound by
// one warp's instruction issue along its lane's chain.
//
// All 32 threads run the decode in step on the same values (shared loads
// broadcast), so the warp's control flow is uniform.  Reads are of 0-32
// bits: a table field above 32 bits or below 0 (none that a header
// yields: nbits <= 9, extra bits <= 31, OF codes 0..31) reads and moves 32
// bits or none.

#include "common.cuh"

namespace {

constexpr int kLaneCols = 13;  // base, p0, pend, nseq, w_ll, w_ml, w_of,
                               // ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al
constexpr int kMaxBits = 90;   // of extra <= 31, ml/ll extra <= 16, 3 updates <= 9
constexpr int kBufBits = 192;  // reference buffer: refills fire at <= 160 bits
constexpr int kRows = 512;     // FSE rows per table (entropy2.FSE_SLOT_SIZE)
constexpr int kThreads = 32;   // one warp per lane
constexpr int kSlotsPerCheck = 4;  // slots between checks of the ring's words
enum { kLL, kOF, kML };

// Reads take 0..32 bits (common.cuh Ring::read).
__device__ __forceinline__ int width(int n) { return min(max(n, 0), 32); }

__device__ __forceinline__ uint32_t pow2_u32(int code) {
    return (code >= 0 && code < 32) ? (1u << code) : 0u;
}

// A staged FSE row: x = value base (OF: 1 << code), y = extra-bits width
// (OF: the code), z = state baseline, w = state-update width.
__device__ __forceinline__ int4 staged_row(int kind, int e0, int e1) {
    const int x = kind == kOF ? static_cast<int>(pow2_u32(e1)) : e1 >> 5;
    const int y = kind == kOF ? width(e1) : e1 & 31;
    return make_int4(x, y, e0 >> 16, width(e0 & 0xFFFF));
}

// The row of a state update's new state: the state's row 0..511, or 512
// (the zero entry's row) outside them.  Clamping the read at 65 536 keeps
// the sum in range and changes no row: a read that large puts the state
// past 32 767 whatever its baseline (-32 768..32 767), outside either way.
__device__ __forceinline__ int next_row(int baseline, uint32_t bits) {
    return min(static_cast<unsigned>(baseline + static_cast<int>(min(bits, 65536u))), 512u);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
sequences_kernel(const uint32_t* __restrict__ words, long long n_words,
                 const int32_t* __restrict__ lane_mat, const int32_t* __restrict__ flat0,
                 const int32_t* __restrict__ flat1, long long n_flat,
                 const int32_t* __restrict__ bank_off, int rows, int n_lanes,
                 uint32_t* __restrict__ out_a, int32_t* __restrict__ out_b,
                 int32_t* __restrict__ out_c, int32_t* __restrict__ ok) {
    __shared__ int4 tabs[3][kRows + 1];  // LL, OF, ML staged rows
    __shared__ uint2 ring_pairs[zt::Ring::kEntries];
    const int j = blockIdx.x;
    const int lane = threadIdx.x;
    const int32_t* col = lane_mat + static_cast<long long>(kLaneCols) * j;
    const int p0 = col[1], pend = col[2], nseq = col[3];

    // Stage the three tables: each thread loads its 16 rows of a table
    // before it stores them, so the loads overlap.
    for (int kind = 0; kind < 3; kind++) {  // slots in lane_mat columns 7, 8, 9
        const long long off = bank_off[col[7 + kind]];
        int e0[kRows / kThreads], e1[kRows / kThreads];
#pragma unroll
        for (int i = 0; i < kRows / kThreads; i++) {
            long long idx = off + lane + i * kThreads;
            if (idx > n_flat - 1) idx = n_flat - 1;
            if (idx < 0) idx = 0;
            e0[i] = __ldg(flat0 + idx);
            e1[i] = __ldg(flat1 + idx);
        }
#pragma unroll
        for (int i = 0; i < kRows / kThreads; i++)
            tabs[kind][lane + i * kThreads] = staged_row(kind, e0[i], e1[i]);
        if (lane == 0) tabs[kind][kRows] = staged_row(kind, 0, 0);
    }
    zt::Ring ring;
    ring.init(ring_pairs, words, n_words, col[0], p0, lane);  // ends with __syncwarp()

    int pos = p0;
    int nb = (p0 & 31) + kBufBits - 32;  // the reference buffer's fill count
    int row[3];  // the states' rows: LL, OF, ML
    for (int kind = 0; kind < 3; kind++) {
        const int n = width(col[10 + kind]);
        row[kind] = next_row(0, ring.read(pos, n));
        pos -= n;
        nb -= n;
    }
    int r_ll = row[kLL], r_of = row[kOF], r_ml = row[kML];
    int emitted = 0;
    bool bad = false;

    // Thread t % 32 keeps row t until the warp stores the 32 rows.
    uint32_t keep_a = 0;
    int32_t keep_b = 0, keep_c = 0;
    const long long L = n_lanes;
    auto store_rows = [&](int to) {  // the held rows below `to`
        const int from = (to - 1) & ~31;
        if (from + lane < to) {
            const long long o = (from + lane) * L + j;
            out_a[o] = keep_a;
            out_b[o] = keep_b;
            if (kWide) out_c[o] = keep_c;
        }
    };
    int t = 0;
    bool live = t < rows && emitted < nseq;
    int4 rl = tabs[kLL][r_ll], ro = tabs[kOF][r_of], rm = tabs[kML][r_ml];
    while (live) {
        ring.ensure(pos, kSlotsPerCheck * 6 * 32);
#pragma unroll
        for (int i = 0; i < kSlotsPerCheck; i++) {
            if (!live) break;
            // The three rows give every field's width, so the six reads go
            // out together at the positions of a sequence that decodes and
            // updates its states; the reference buffer's count decides
            // afterwards which of them count.  Widths OF, ML, LL extra
            // bits, then LL, ML, OF state updates; positions summed as a
            // tree.
            const int w_ofml = ro.y + rm.y, w_llll = rl.y + rl.w, w_mlof = rm.w + ro.w;
            const int w_4 = w_ofml + w_llll;
            const int p1 = pos - ro.y, p2 = pos - w_ofml, p3 = p2 - rl.y;
            const int p4 = pos - w_4, p5 = p4 - rm.w, p6 = pos - (w_4 + w_mlof);
            const uint32_t x_of = ring.read(pos, ro.y);
            const uint32_t x_ml = ring.read(p1, rm.y);
            const uint32_t x_ll = ring.read(p2, rl.y);
            const int n_ll = next_row(rl.z, ring.read(p3, rl.w));
            const int n_ml = next_row(rm.z, ring.read(p4, rm.w));
            const int n_of = next_row(ro.z, ring.read(p5, ro.w));

            // Three refills of 32 bits while the count is <= 160, in closed
            // form; the slot decodes with >= 90 bits, which is a count of
            // >= -6 before the refills.
            const bool can = nb >= kMaxBits - 96;
            nb += 32 * min(3, max(0, ((kBufBits - 32 - nb) >> 5) + 1));
            const bool upd = can && emitted < nseq - 1;
            nb -= can ? ro.y + rm.y + rl.y + (upd ? rl.w + rm.w + ro.w : 0) : 0;
            pos = can ? (upd ? p6 : p3) : pos;
            if (upd) {
                r_ll = n_ll;
                r_ml = n_ml;
                r_of = n_of;
            }
            // The next slot's rows go out now; this slot's outputs are made
            // while they arrive.
            const int4 ol = rl, oo = ro, om = rm;
            rl = tabs[kLL][r_ll];
            ro = tabs[kOF][r_of];
            rm = tabs[kML][r_ml];
            emitted += can ? 1 : 0;
            bad = bad || (can && oo.y >= 31);

            // ll and ml in 32 bits (wrapping, as the plain form's int32
            // planes): their extra bits are < 2^31 (widths <= 31) and their
            // bases within +-2^26, so `ll > 0xFFFF` is the exact comparison
            // of the extra bits with 0xFFFF - base.
            const uint32_t ofv = static_cast<uint32_t>(oo.x) + (can ? x_of : 0u);
            const int ml = static_cast<int>(static_cast<uint32_t>(om.x) + x_ml);
            const int ll = static_cast<int>(static_cast<uint32_t>(ol.x) + x_ll);
            if ((t & 31) == lane) {
                keep_a = (can ? 0x80000000u : 0u) | (ofv & 0x7FFFFFFFu);
                if (kWide) {
                    keep_b = can ? ll : 0;
                    keep_c = can ? ml : 0;
                } else {
                    const uint32_t packed = (static_cast<uint32_t>(ll) << 16) |
                                            (static_cast<uint32_t>(ml) & 0xFFFFu);
                    keep_b = can ? static_cast<int32_t>(packed) : 0;
                }
            }
            if (!kWide)
                bad = bad || !can || static_cast<int>(x_ll) > 0xFFFF - ol.x ||
                      static_cast<int>(x_ml) > 0xFFFF - om.x;
            t++;
            live = t < rows && emitted < nseq;
        }
        if ((t & 31) == 0 || !live) store_rows(t);
    }
    // Done: the remaining slots are invalid and carry the frozen offset
    // state's 1 << of_code.
    const uint32_t fill = static_cast<uint32_t>(tabs[kOF][r_of].x) & 0x7FFFFFFFu;
    for (long long row = t + lane; row < rows; row += kThreads) {
        const long long o = row * L + j;
        out_a[o] = fill;
        out_b[o] = 0;
        if (kWide) out_c[o] = 0;
    }
    if (lane == 0) ok[j] = (emitted == nseq && pos == pend && !bad) ? 1 : 0;
}

}  // namespace

// Narrow mode: out_c may be null.  Wide mode: out_b = ll, out_c = ml.
ZT_EXPORT int zt_sequences(const void* words, long long n_words, const void* lane_mat,
                           const void* flat0, const void* flat1, long long n_flat,
                           const void* bank_off, int rows, int n_lanes, int wide, void* out_a,
                           void* out_b, void* out_c, void* ok, void* stream) {
    if (n_lanes > 0) {
        auto kernel = wide ? sequences_kernel<true> : sequences_kernel<false>;
        kernel<<<n_lanes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), n_words,
            static_cast<const int32_t*>(lane_mat), static_cast<const int32_t*>(flat0),
            static_cast<const int32_t*>(flat1), n_flat, static_cast<const int32_t*>(bank_off),
            rows, n_lanes, static_cast<uint32_t*>(out_a), static_cast<int32_t*>(out_b),
            static_cast<int32_t*>(out_c), static_cast<int32_t*>(ok));
    }
    return static_cast<int>(cudaGetLastError());
}

// Launch geometry for n_lanes lanes of the narrow or wide instance
// (common.cuh zt::launch_info).
ZT_EXPORT int zt_launch_info(int n_lanes, int wide, int* out) {
    return wide ? zt::launch_info(sequences_kernel<true>, n_lanes, kThreads, 0, out)
                : zt::launch_info(sequences_kernel<false>, n_lanes, kThreads, 0, out);
}
