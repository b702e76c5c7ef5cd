// Ragged compaction of a lane-last plane into one dense array.
//
// Replaces zstd_tpu/kernels/compact_dma.py:37 (_kernel, reached through
// compact_lanes_dma): lane j's first cum[j+1] - cum[j] words of a
// row-major (rows, L) u32 plane land at dense[cum[j] : cum[j+1]].  The TPU
// kernel ran one DMA per lane at 1024-word-aligned offsets (Mosaic HBM
// slices are (1024,)-tiled) over a transposed plane, with a fetch pad; here
// one block per lane strides its threads over the lane's words, at any
// offset, and writes exactly cum[L] words.  In the port it compacts every
// sequences call's packed word plane; the literals kernel writes its dense
// bytes itself.
//
// Bound on the H100: pure data movement, so bytes over 3.35 TB/s; the
// column reads are strided by L words (one 4-byte word per 32-byte sector),
// which wastes most of each sector — a transposed plane or fusing the pack
// into the sequences kernel is later work.

#include "common.cuh"

namespace {

__global__ void compact_kernel(const int32_t* __restrict__ plane, int rows, int n_lanes,
                               const int32_t* __restrict__ cum, int32_t* __restrict__ dense) {
    const int j = blockIdx.x;
    const long long start = cum[j];
    const int count = cum[j + 1] - cum[j];
    const long long last = static_cast<long long>(rows) * n_lanes - 1;
    for (int r = threadIdx.x; r < count; r += blockDim.x) {
        long long idx = static_cast<long long>(r) * n_lanes + j;
        if (idx > last) idx = last;  // clipped, as the plain gather clips
        dense[start + r] = plane[idx];
    }
}

}  // namespace

ZT_EXPORT int zt_compact(const void* plane, int rows, int n_lanes, const void* cum, void* dense,
                         void* stream) {
    if (n_lanes > 0 && rows > 0) {
        compact_kernel<<<n_lanes, 256, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(plane), rows, n_lanes, static_cast<const int32_t*>(cum),
            static_cast<int32_t*>(dense));
    }
    return static_cast<int>(cudaGetLastError());
}
