// Algorithm 1's split (paper §5) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/margin_split.py:_margin_split_kernel
// (launched by margin_split).  With params = [m, b, eps_lb, eps_ub,
// n_valid, ...] (float32, on the device), for every row p:
//
//   disp[p]   = d[p] - (m * x[p] + b)          (float32, rounded 3 times)
//   mask[p]   = -eps_lb <= disp[p] <= eps_ub  &&  float32(p) < n_valid
//   counts[t] = sum of mask[p] over the rows p of tile t
//
// Rounding.  The reference rounds the product and the sum apart.  nvcc's
// default -fmad=true would contract m * x + b into one FMA, which rounds
// once, and rows on the margin would flip; the _rn intrinsics are never
// contracted, so the kernel rounds as the reference does.  The row-id test
// is float32, as in the reference: above 2^24 rows a real row can round to
// n_valid and is dropped (the reference's contract).
//
// What bounds it.  Bytes: two float32 columns read, disp and mask written,
// 16 B a row; a handful of operations a row is far below the card's rate.
//
// What the design does about it.  One thread per row: a warp's loads and
// stores are each 128 contiguous bytes, and nothing is staged.  One block
// per tile; the tile's count is a warp __reduce_add_sync and a sum over the
// block's warps.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
margin_split_kernel(const float* __restrict__ x, const float* __restrict__ dv,
                    const float* __restrict__ params,
                    float* __restrict__ disp, int* __restrict__ mask,
                    int* __restrict__ counts, int tile) {
  __shared__ int warp_sum[THREADS / 32];
  const float m = params[0], b = params[1];
  const float neg_lb = -params[2], eps_ub = params[3];
  const float n_valid = params[4];
  const int t = blockIdx.x;
  const int base = t * tile;
  int mine = 0;
  for (int r0 = 0; r0 < tile; r0 += blockDim.x) {
    const int i = r0 + threadIdx.x;
    if (i >= tile) break;
    const int p = base + i;
    const float r = __fsub_rn(dv[p], __fadd_rn(__fmul_rn(m, x[p]), b));
    const bool in = r >= neg_lb && r <= eps_ub && __int2float_rn(p) < n_valid;
    disp[p] = r;
    mask[p] = in;
    mine += in;
  }
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
    counts[t] = total;
  }
}

}  // namespace

extern "C" {

// Enqueue the split on `stream`; returns the CUDA error code (0 ok).  N is
// a multiple of `tile`; the caller keeps every buffer alive until the
// stream has run the kernel.
int coax_margin_split(const float* x, const float* dv, const float* params,
                      float* disp, int* mask, int* counts, int n, int tile,
                      void* stream) {
  if (tile < 1 || n < tile || n % tile) return cudaErrorInvalidValue;
  margin_split_kernel<<<n / tile, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, dv, params, disp, mask, counts, tile);
  return cudaGetLastError();
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
