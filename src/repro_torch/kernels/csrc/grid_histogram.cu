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
// Rounding int -> float32 is monotone, so the rows kept form a prefix
// [0, P): each block finds P once by a binary search over that same test
// (kept_prefix), and a row is then kept by an integer compare p < P.
//
// What bounds it.  Bytes: two float32 columns read once (8 B a row); the
// B x B output is at most 64 KiB.  About ten operations a row is far below
// the card's rate.
//
// What the design does about it.  The TPU built one-hot matrices and
// multiplied them on its matrix unit, since it has no scatter; the card
// has fast shared-memory atomics, so that is not carried over.
//  * Bytes in flight: a thread loads UNROLL float4 pairs (4 rows of x and
//    of d each, 16-byte loads of whole vectors only) before it bins any of
//    them.
//  * Binning: every block keeps one private B x B uint32 histogram in
//    shared memory.  Runs of equal keys among a thread's own 8 rows merge
//    into one shared atomic (on the card this measured as fast as or
//    faster than merging the lanes of a warp with __match_any_sync, and
//    than two striped histograms a block, on a correlated pair, on every
//    row in one bucket and on uniform data).
//  * Any N: the n % 4 rows after the last whole vector are loaded as
//    scalars by the first threads of block 0.
//  * One launch, no memset: each block adds its nonzero bins into a global
//    uint32 histogram, then takes a ticket; the last block converts the
//    counts to float32 (exact integers, rounded once) and zeroes the
//    histogram and the ticket for the next call on the stream.
//  * No per-call device queries: coax_grid_histogram_blocks sizes the grid
//    once and the wrapper caches it per device and bucket count.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 2;            // float4 pairs in flight per thread
constexpr int ROWS = 4 * UNROLL;     // rows a thread bins per step

// Rows kept are p < P with P the least p in [0, n] for which p == n or
// float32(p) < n_valid fails (a NaN n_valid keeps none).
__device__ int kept_prefix(float n_valid, int n) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__int2float_rn(mid) < n_valid) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ int key_of(float x, float d, float x_lo,
                                      float inv_wx, float d_lo, float inv_wd,
                                      float top, int buckets) {
  const float fx = __fmul_rn(__fsub_rn(x, x_lo), inv_wx);
  const float fd = __fmul_rn(__fsub_rn(d, d_lo), inv_wd);
  const int ix = static_cast<int>(fminf(fmaxf(fx, 0.0f), top));
  const int jd = static_cast<int>(fminf(fmaxf(fd, 0.0f), top));
  return ix * buckets + jd;
}

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const float* __restrict__ x, const float* __restrict__ d,
                 const float* __restrict__ params, unsigned* __restrict__ hist,
                 float* __restrict__ out, int n, int buckets) {
  extern __shared__ unsigned local[];          // bins
  __shared__ int s_prefix;
  __shared__ bool s_last;
  const int bins = buckets * buckets;
  for (int i = threadIdx.x; i < bins; i += THREADS) local[i] = 0;
  if (threadIdx.x == 0) s_prefix = kept_prefix(params[4], n);
  __syncthreads();

  const int prefix = s_prefix;
  const int whole = n / 4;                     // vectors inside [0, n)
  const int want = (prefix + 3) / 4;           // vectors holding a kept row
  const int vecs = want < whole ? want : whole;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  const float x_lo = params[0], inv_wx = params[1];
  const float d_lo = params[2], inv_wd = params[3];
  const float top = static_cast<float>(buckets - 1);
  const int step = gridDim.x * THREADS * UNROLL;
  for (int v0 = blockIdx.x * THREADS * UNROLL; v0 < vecs; v0 += step) {
    float4 xs[UNROLL], ds[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + threadIdx.x;
      if (v < vecs) {
        xs[u] = x4[v];
        ds[u] = d4[v];
      }
    }
    int keys[ROWS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + threadIdx.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        keys[4 * u + c] =
            v < vecs && 4 * v + c < prefix
                ? key_of(lane_of(xs[u], c), lane_of(ds[u], c), x_lo, inv_wx,
                         d_lo, inv_wd, top, buckets)
                : -1;
      }
    }
    unsigned run = 1;                  // merge runs of equal keys
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (j + 1 < ROWS && keys[j + 1] == keys[j]) {
        ++run;
      } else {
        if (keys[j] >= 0) atomicAdd(&local[keys[j]], run);
        run = 1;
      }
    }
  }
  if (blockIdx.x == 0) {               // the rows after the last vector
    const int p = 4 * whole + threadIdx.x;
    if (p < n && p < prefix)
      atomicAdd(&local[key_of(x[p], d[p], x_lo, inv_wx, d_lo, inv_wd, top,
                              buckets)], 1u);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < bins; i += THREADS) {
    const unsigned c = local[i];
    if (c) atomicAdd(&hist[i], c);
  }
  __threadfence();                   // this block's adds before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&hist[bins], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();                   // every other block's adds are in
  for (int i = threadIdx.x; i < bins; i += THREADS)
    out[i] = __uint2float_rn(atomicExch(&hist[i], 0u));
  if (threadIdx.x == 0) hist[bins] = 0;
}

size_t smem_bytes(int buckets) {
  return static_cast<size_t>(buckets) * buckets * sizeof(unsigned);
}

}  // namespace

extern "C" {

// Size the grid at `buckets` on the current device: as many blocks as fit
// at once (raising the shared-memory limit when a block needs more than
// 48 KiB).  Writes the count to *blocks; returns the CUDA error code (0
// ok).  Run once per device and bucket count.
int coax_grid_histogram_blocks(int buckets, int* blocks) {
  if (buckets < 1 || blocks == nullptr) return cudaErrorInvalidValue;
  const auto k = histogram_kernel;
  const size_t smem = smem_bytes(buckets);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Enqueue the histogram on `stream`, one launch: count into `scratch`
// (B*B uint32 bins, then the ticket; all zero on entry, left zero on exit)
// and write `out` (B*B float32).  `x`, `dv` are 16-byte aligned; `blocks`
// comes from coax_grid_histogram_blocks.  Returns
// the CUDA error code (0 ok).  The caller keeps every buffer alive until
// the stream has run the work, and gives each stream its own scratch.
int coax_grid_histogram(const float* x, const float* dv, const float* params,
                        unsigned* scratch, float* out, int n, int buckets,
                        int blocks, void* stream) {
  if (n < 1 || buckets < 1 || blocks < 1) return cudaErrorInvalidValue;
  const long long want =
      (static_cast<long long>(n / 4) + THREADS * UNROLL - 1) /
      (THREADS * UNROLL);
  const int grid = static_cast<int>(want < 1 ? 1 : want < blocks ? want
                                                                 : blocks);
  histogram_kernel<<<grid, THREADS, smem_bytes(buckets),
                     static_cast<cudaStream_t>(stream)>>>(
      x, dv, params, scratch, out, n, buckets);
  return cudaGetLastError();
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
