// One-rect COAX range scan (paper §6) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/range_scan.py:_range_scan_kernel
// (launched by range_scan).  For every row p:
//
//   mask[p]   = lo[j] <= rows[j,p] < hi[j]  for every j
//               && win[0] <= p < win[1]      (p the int32 row id)
//   counts[t] = sum of mask[p] over the rows p of tile t
//
// What bounds it.  Bytes: the D columns of every row inside the window are
// read once and the N-row int32 mask is written whole; about 14 compares a
// row is far below the card's rate.  Rows outside the window cannot match,
// so the kernel does not read them (the TPU kernel streamed every tile).
//
// What the design does about it.  With one rect there is nothing to reuse
// a tile for, so rows are not staged in shared memory: each thread reads
// its own rows straight from device memory, column by column, and a warp's
// loads and mask stores are each 128 contiguous bytes.  A row inside the
// window is read whole (all D columns), so the bytes moved do not depend on
// the order of the compares.  One block per tile; the tile's count is a
// warp __reduce_add_sync and a sum over the block's warps.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
range_scan_kernel(const float* __restrict__ rows_t,   // (d, n)
                  const float* __restrict__ lo,       // (d,)
                  const float* __restrict__ hi,       // (d,)
                  const int* __restrict__ window,     // (2,)
                  int* __restrict__ mask,             // (n,)
                  int* __restrict__ counts,           // (n / tile,)
                  int d, int n, int tile) {
  __shared__ int warp_sum[THREADS / 32];
  const int t = blockIdx.x;
  const int base = t * tile;
  const int w_lo = window[0], w_hi = window[1];
  int mine = 0;
  for (int r0 = 0; r0 < tile; r0 += blockDim.x) {
    const int i = r0 + threadIdx.x;
    if (i >= tile) break;
    const int gid = base + i;
    bool hit = gid >= w_lo && gid < w_hi;
    if (hit) {
      bool inside = true;
      for (int j = 0; j < d; ++j) {
        const float v = rows_t[static_cast<size_t>(j) * n + gid];
        inside &= v >= lo[j] && v < hi[j];
      }
      hit = inside;
    }
    mask[gid] = hit;
    mine += hit;
  }
  mine = __reduce_add_sync(FULL, mine);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sum[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
    counts[t] = total;
  }
}

}  // namespace

extern "C" {

// Enqueue the scan on `stream`; returns the CUDA error code (0 ok).  N is a
// multiple of `tile`; the caller keeps every buffer alive until the stream
// has run the kernel.
int coax_range_scan(const float* rows_t, const float* lo, const float* hi,
                    const int* window, int* mask, int* counts, int d, int n,
                    int tile, void* stream) {
  if (d < 0 || tile < 1 || n < tile || n % tile) return cudaErrorInvalidValue;
  range_scan_kernel<<<n / tile, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows_t, lo, hi, window, mask, counts, d, n, tile);
  return cudaGetLastError();
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
