// Ragged compaction of a lane-last plane into one dense array, as a tiled
// transpose.
//
// Replaces zstd_tpu/kernels/compact_dma.py:37 (_kernel, reached through
// compact_lanes_dma): lane j's first cum[j+1] - cum[j] words of a
// row-major (rows, L) u32 plane land at dense[cum[j] : cum[j+1]].  The TPU
// kernel ran one DMA per lane at 1024-word-aligned offsets (Mosaic HBM
// slices are (1024,)-tiled) over a transposed plane, with a fetch pad; here
// it writes exactly cum[L] words at any offset.  In the port it compacts
// every sequences call's packed word plane; the literals kernel writes its
// dense bytes itself.
//
// Bound on the H100: pure data movement, so bytes over 3.35 TB/s (the
// words each lane keeps, read once and written once).  A lane's words run
// down a column of the plane, so reading them one lane at a time fetches a
// 32-byte sector for every 4-byte word.  Instead a block takes a tile of
// kLanes lanes by kRows rows, so the grid covers the plane over every SM:
// its warps read the tile row by row, 32 neighbouring lanes a 128-byte
// line, into shared memory padded by one word a row (conflict-free both
// ways); then each warp writes whole lanes of the tile, a contiguous run of
// words at dense[cum[j] + r0 ...].  A block reads only the rows some lane
// of its tile keeps, and a tile past every count reads and writes nothing.
// As the plain gather clips, a lane counting more than `rows` words gets
// the plane's last word past the plane (written by the last row of tiles).

#include "common.cuh"

namespace {

constexpr int kLanes = 32;  // lanes a tile covers: one 128-byte line of a row
constexpr int kRows = 128;  // rows a tile covers
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
compact_kernel(const int32_t* __restrict__ plane, int rows, int n_lanes,
               const int32_t* __restrict__ cum, int32_t* __restrict__ dense) {
    __shared__ int32_t tile[kLanes][kRows + 1];
    __shared__ int start_s[kLanes], count_s[kLanes];
    __shared__ int need_s;
    const int j0 = blockIdx.x * kLanes;
    const int r0 = blockIdx.y * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lanes = min(kLanes, n_lanes - j0);
    if (warp == 0) {
        int start = 0, count = 0;
        if (lane < lanes) {
            start = cum[j0 + lane];
            count = cum[j0 + lane + 1] - start;
        }
        start_s[lane] = start;
        count_s[lane] = count;
        int most = count;
        for (int o = 16; o; o >>= 1) most = max(most, __shfl_xor_sync(kFull, most, o));
        if (lane == 0) need_s = min(min(most, rows) - r0, kRows);  // rows some lane keeps
    }
    __syncthreads();
    const int need = need_s;
    if (lane < lanes)
        for (int r = warp; r < need; r += kWarps)
            tile[lane][r] = plane[static_cast<long long>(r0 + r) * n_lanes + j0 + lane];
    __syncthreads();
    for (int jj = warp; jj < lanes; jj += kWarps) {
        const int n = min(min(count_s[jj], rows) - r0, kRows);
        int32_t* out = dense + start_s[jj] + r0;
        for (int r = lane; r < n; r += 32) out[r] = tile[jj][r];
    }
    if (blockIdx.y == gridDim.y - 1) {  // the clipped words past the plane
        const int32_t last = plane[static_cast<long long>(rows) * n_lanes - 1];
        for (int jj = warp; jj < lanes; jj += kWarps)
            for (int r = rows + lane; r < count_s[jj]; r += 32) dense[start_s[jj] + r] = last;
    }
}

}  // namespace

ZT_EXPORT int zt_compact(const void* plane, int rows, int n_lanes, const void* cum, void* dense,
                         void* stream) {
    if (n_lanes > 0 && rows > 0) {
        const dim3 grid((n_lanes + kLanes - 1) / kLanes, (rows + kRows - 1) / kRows);
        compact_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(plane), rows, n_lanes, static_cast<const int32_t*>(cum),
            static_cast<int32_t*>(dense));
    }
    return static_cast<int>(cudaGetLastError());
}
