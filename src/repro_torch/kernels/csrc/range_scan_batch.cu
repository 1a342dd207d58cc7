// Batched COAX range scan (paper §6) for Hopper (sm_90a): B translated
// rects, each with its own [lo, hi) row window, over one record array.
//
// Replaces the TPU kernel repro/kernels/range_scan_batch.py:
// _range_scan_batch_kernel (launched by range_scan_batch).  For every query
// b and row p:
//
//   mask[b,p]   = lo[j,b] <= rows[j,p] < hi[j,b]  for every j
//                 && win[b,0] <= p < win[b,1]        (p the int32 row id)
//   counts[b,t] = sum of mask[b,p] over the rows p of tile t
//
// What bounds it.  The mask is B x N int32 and has to be written whole:
// for the airline primary image (D = 8, N = 18,432,000) and a 64-query
// wave that is 4.7 GB of stores against 0.59 GB of rows read, so the
// kernel is bound by the bytes it writes (about 1.6 ms at 3.35 TB/s).
//
// What the design does about it.  One block per row tile loads the
// (D, tile) slab into shared memory once and then runs every query against
// it, so the rows stream from device memory once per call (the TPU grid
// kept the tile resident across its inner query axis to the same end).
// The queries' bounds and windows are staged in shared memory QC at a
// time.  Each thread tests its own rows, so a warp's mask stores are 128
// contiguous bytes.  A tile's count is a warp __reduce_add_sync plus one
// shared atomicAdd per warp; integer sums, so the order does not matter.
// The compares are plain IEEE compares (the build passes -ftz=false).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int QC = 64;              // queries staged in shared memory at once
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
range_scan_batch_kernel(const float* __restrict__ rows_t,   // (d, n)
                        const float* __restrict__ lo_t,     // (d, b)
                        const float* __restrict__ hi_t,     // (d, b)
                        const int* __restrict__ windows,    // (b, 2)
                        int* __restrict__ mask,             // (b, n)
                        int* __restrict__ counts,           // (b, n / tile)
                        int d, int n, int b, int tile) {
  extern __shared__ unsigned smem[];
  float* slab = reinterpret_cast<float*>(smem);            // (d, tile)
  float* qlo = slab + static_cast<size_t>(d) * tile;       // (QC, d)
  float* qhi = qlo + QC * d;                               // (QC, d)
  int* qwin = reinterpret_cast<int*>(qhi + QC * d);        // (QC, 2)
  int* qcount = qwin + 2 * QC;                             // (QC,)

  const int t = blockIdx.x;
  const int base = t * tile;
  const int num_tiles = n / tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    for (int j = 0; j < d; ++j)
      slab[j * tile + i] = rows_t[static_cast<size_t>(j) * n + base + i];

  for (int q0 = 0; q0 < b; q0 += QC) {
    const int qn = min(QC, b - q0);
    __syncthreads();                    // the previous chunk's slots are read
    for (int e = threadIdx.x; e < qn * d; e += blockDim.x) {
      const int qi = e / d, j = e % d;
      qlo[e] = lo_t[static_cast<size_t>(j) * b + q0 + qi];
      qhi[e] = hi_t[static_cast<size_t>(j) * b + q0 + qi];
    }
    for (int e = threadIdx.x; e < qn; e += blockDim.x) {
      qwin[2 * e] = windows[2 * (q0 + e)];
      qwin[2 * e + 1] = windows[2 * (q0 + e) + 1];
      qcount[e] = 0;
    }
    __syncthreads();                    // slab (first chunk) and slots ready

    for (int qi = 0; qi < qn; ++qi) {
      const int w_lo = qwin[2 * qi], w_hi = qwin[2 * qi + 1];
      const float* lo = qlo + qi * d;
      const float* hi = qhi + qi * d;
      int* out = mask + static_cast<size_t>(q0 + qi) * n + base;
      int mine = 0;
      for (int r0 = 0; r0 < tile; r0 += blockDim.x) {   // same trip count
        const int i = r0 + threadIdx.x;                 // for every thread
        bool hit = false;
        if (i < tile) {
          const int gid = base + i;
          hit = gid >= w_lo && gid < w_hi;
          for (int j = 0; j < d && hit; ++j) {
            const float v = slab[j * tile + i];
            hit = v >= lo[j] && v < hi[j];
          }
          out[i] = hit;
        }
        mine += hit;
      }
      mine = __reduce_add_sync(FULL, mine);
      if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&qcount[qi], mine);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qn; e += blockDim.x)
      counts[static_cast<size_t>(q0 + e) * num_tiles + t] = qcount[e];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes; the wrapper checks it
// against the card's limit before launching.
size_t coax_range_scan_batch_smem(int d, int tile) {
  return (static_cast<size_t>(d) * tile + 2 * QC * d + 3 * QC) * 4;
}

// Enqueue the scan on `stream`; returns the CUDA error code (0 ok).  N is a
// multiple of `tile`; the caller keeps every buffer alive until the stream
// has run the kernel.
int coax_range_scan_batch(const float* rows_t, const float* lo_t,
                          const float* hi_t, const int* windows, int* mask,
                          int* counts, int d, int n, int b, int tile,
                          void* stream) {
  if (d < 0 || b < 1 || tile < 1 || n < tile || n % tile)
    return cudaErrorInvalidValue;
  const size_t smem = coax_range_scan_batch_smem(d, tile);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(range_scan_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  range_scan_batch_kernel<<<n / tile, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      rows_t, lo_t, hi_t, windows, mask, counts, d, n, b, tile);
  return cudaGetLastError();
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
