// Algorithm 1's grid bucketing (paper §5, Fig. 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/grid_histogram.py:
// _grid_histogram_kernel (launched by grid_histogram).  With params =
// [x_lo, inv_wx, d_lo, inv_wd, n_valid, ...] (float32, on the device):
//
//   ix = int(clip((x[p] - x_lo) * inv_wx, 0, B - 1))     (float32, twice
//   jd = int(clip((d[p] - d_lo) * inv_wd, 0, B - 1))      rounded, truncated)
//   hist[ix, jd] += 1   for every row p with float32(p) < n_valid
//
// The row-id test is float32, as in the reference: above 2^24 rows a real
// row can round to n_valid and is dropped (the reference's contract).
//
// What bounds it.  Bytes: two float32 columns read once (8 B a row); the
// B x B output is at most 64 KiB.  About ten operations a row is far below
// the card's rate.
//
// What the design does about it.  The TPU built one-hot matrices and
// multiplied them on its matrix unit, since it has no scatter; the card
// has fast shared-memory atomics, so that is not carried over.  A few
// blocks per SM (as many as fit at once) each keep a private B x B uint32
// histogram in shared memory and walk the rows in a grid-stride loop.  The
// data is skewed (correlated pairs fill few buckets), so lanes of a warp
// that hit the same bucket are merged with __match_any_sync and add once.
// Each block then adds its nonzero bins into a global uint32 histogram,
// and a last kernel converts it to float32: counts are exact integers,
// rounded to float32 once (exact below 2^24 a bucket).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const float* __restrict__ x, const float* __restrict__ dv,
                 const float* __restrict__ params, unsigned* __restrict__ hist,
                 int n, int buckets) {
  extern __shared__ unsigned local[];
  const int bins = buckets * buckets;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) local[i] = 0;
  __syncthreads();

  const float x_lo = params[0], inv_wx = params[1];
  const float d_lo = params[2], inv_wd = params[3];
  const float n_valid = params[4];
  const float top = static_cast<float>(buckets - 1);
  const int lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  // r0 is the same for every thread of a block, so all lanes of a warp
  // take part in every __match_any_sync.
  for (size_t r0 = static_cast<size_t>(blockIdx.x) * blockDim.x;
       r0 < static_cast<size_t>(n); r0 += stride) {
    const size_t p = r0 + threadIdx.x;
    int key = -1;
    if (p < static_cast<size_t>(n) &&
        __int2float_rn(static_cast<int>(p)) < n_valid) {
      const float fx = __fmul_rn(__fsub_rn(x[p], x_lo), inv_wx);
      const float fd = __fmul_rn(__fsub_rn(dv[p], d_lo), inv_wd);
      const int ix = static_cast<int>(fminf(fmaxf(fx, 0.0f), top));
      const int jd = static_cast<int>(fminf(fmaxf(fd, 0.0f), top));
      key = ix * buckets + jd;
    }
    const unsigned peers = __match_any_sync(FULL, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&local[key], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x)
    if (local[i]) atomicAdd(&hist[i], local[i]);
}

__global__ void to_float_kernel(const unsigned* __restrict__ hist,
                                float* __restrict__ out, int bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < bins) out[i] = __uint2float_rn(hist[i]);
}

}  // namespace

extern "C" {

// Enqueue the histogram on `stream`: zero `scratch` (B*B uint32), count,
// convert into `out` (B*B float32).  Returns the CUDA error code (0 ok).
// The caller keeps every buffer alive until the stream has run the work.
int coax_grid_histogram(const float* x, const float* dv, const float* params,
                        unsigned* scratch, float* out, int n, int buckets,
                        void* stream) {
  if (n < 1 || buckets < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bins = buckets * buckets;
  // one uint32 histogram: a block's shared memory, and the global scratch
  const size_t smem = static_cast<size_t>(bins) * sizeof(unsigned);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(histogram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (static_cast<long long>(n) + THREADS - 1) / THREADS;
  const long long fit = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(want < fit ? want : fit);
  if ((err = cudaMemsetAsync(scratch, 0, smem, st)) != cudaSuccess) return err;
  histogram_kernel<<<blocks, THREADS, smem, st>>>(x, dv, params, scratch, n,
                                                  buckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  to_float_kernel<<<(bins + 255) / 256, 256, 0, st>>>(scratch, out, bins);
  return cudaGetLastError();
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
