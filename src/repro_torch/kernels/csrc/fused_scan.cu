// Fused probe + sort-band + filter + hit compaction over one segment, for
// Hopper (sm_90a).
//
// Replaces the TPU megakernel repro/kernels/fused_scan.py:_make_kernel
// (launched by fused_scan_call).  For every query b and row p of the
// segment:
//
//   cand[b,p] = alive[p] > 0
//               && first[b,j] <= coords[j,p] <= last[b,j]  for every j  (probe)
//               && tband[b,0] <= sv[p] < tband[b,1]                     (sort)
//   hit[b,p]  = cand[b,p] && flo[j,b] <= rows[j,p] < fhi[j,b]  for every j
//
// Outputs: counts[b] = sum_p hit, scanned[b] = sum_p cand, and
// hits[b, :min(count, hit_cap)] = the hit row positions in ascending order
// (slots past that stay at the -1 the wrapper filled in).
//
// What bounds it.  Every row of the segment is read once: rows (D f32),
// coords (k i32), sv (f32) and alive (i32), 52 B a row for the airline
// primary segment (D = 8, k = 3).  At N_pad = 2^25 that is about 1.75 GB,
// so at least 0.52 ms at the card's 3.35 TB/s: the kernel is bound by
// bytes.  The TPU grid streamed the segment once PER QUERY (tiles were the
// inner grid axis, so each query's output block stayed resident); on this
// card that would read 64x the bytes for a 64-query wave.
//
// What the design does about it.  The grid is tile-major: one block loads
// one row tile into shared memory once and evaluates every query of the
// wave against it, so the segment streams from device memory once per
// wave.  Blocks run in no order, so ascending hit order, which the TPU got
// from its sequential tile axis, comes from three launches instead:
//   (i)   count pass: per (query, tile) hit and candidate counts into a
//         (Bp, num_tiles) scratch.  A block skips a query outright when the
//         tile's cell-coordinate box (over live rows; rows are stored
//         cell-major, so a tile spans few cells) misses the query's probe
//         box -- exact, since no live row of the tile can then be a
//         candidate.
//   (ii)  scan pass: one block per query runs an exclusive scan over its
//         tile counts, giving each tile's hit offset, plus counts/scanned.
//   (iii) write pass: only (tile, query) pairs with hits and an offset below
//         hit_cap reload the tile and rank their hits with __ballot_sync /
//         __popc and a warp prefix across the block, in row order.
// No atomics place hits, so the output is deterministic.  The compares are
// plain IEEE float compares; the build passes -ftz=false so subnormal rows
// compare exactly as the host's f64 compare does.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int QC = 32;        // queries per reduction chunk of the count pass
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* rows_t;   // (d, n_pad)
  const float* flo_t;    // (d, bp)
  const float* fhi_t;    // (d, bp)
  const int* alive;      // (n_pad,)
  const int* coords;     // (k, n_pad)       probe only
  const int* first;      // (bp, k)          probe only
  const int* last;       // (bp, k)          probe only
  const float* sv;       // (n_pad,)         sort only
  const float* tband;    // (bp, 2)          sort only
  int* counts;           // (bp,)
  int* hits;             // (bp, hits_width)
  int* scanned;          // (bp,)
  int* tile_hits;        // (bp, num_tiles) scratch
  int* tile_cand;        // (bp, num_tiles) scratch
  int* tile_off;         // (bp, num_tiles) scratch
  int d, n_pad, bp, k, tile, hit_cap, hits_width, num_tiles;
};

// Shared-memory layout, in 4-byte words: the row tile, then QC query slots.
struct Layout {
  int rows, coords, sv, alive;            // tile image
  int qlo, qhi, qfirst, qlast, qband;     // query slots
  int red_h, red_c, box;                  // count-pass reductions
  int words;
  __host__ __device__ Layout(const Args& a, bool probe, bool sort, int nw) {
    int w = 0;
    rows = w;   w += a.d * a.tile;
    coords = w; if (probe) w += a.k * a.tile;
    sv = w;     if (sort) w += a.tile;
    alive = w;  w += a.tile;
    qlo = w;    w += QC * a.d;
    qhi = w;    w += QC * a.d;
    qfirst = w; w += QC * a.k;
    qlast = w;  w += QC * a.k;
    qband = w;  w += QC * 2;
    red_h = w;  w += nw * QC;
    red_c = w;  w += nw * QC;
    box = w;    w += 2 * a.k;
    words = w;
  }
};

struct Smem {
  float* rows; int* coords; float* sv; int* alive;
  float* qlo; float* qhi; int* qfirst; int* qlast; float* qband;
  int* red_h; int* red_c; int* box;
  __device__ Smem(unsigned* base, const Layout& L)
      : rows(reinterpret_cast<float*>(base + L.rows)),
        coords(reinterpret_cast<int*>(base + L.coords)),
        sv(reinterpret_cast<float*>(base + L.sv)),
        alive(reinterpret_cast<int*>(base + L.alive)),
        qlo(reinterpret_cast<float*>(base + L.qlo)),
        qhi(reinterpret_cast<float*>(base + L.qhi)),
        qfirst(reinterpret_cast<int*>(base + L.qfirst)),
        qlast(reinterpret_cast<int*>(base + L.qlast)),
        qband(reinterpret_cast<float*>(base + L.qband)),
        red_h(reinterpret_cast<int*>(base + L.red_h)),
        red_c(reinterpret_cast<int*>(base + L.red_c)),
        box(reinterpret_cast<int*>(base + L.box)) {}
};

template <bool PROBE, bool SORT>
__device__ void load_tile(const Args& a, const Smem& s, int tile_idx) {
  const size_t base = static_cast<size_t>(tile_idx) * a.tile;
  for (int i = threadIdx.x; i < a.tile; i += blockDim.x) {
    for (int j = 0; j < a.d; ++j)
      s.rows[j * a.tile + i] = a.rows_t[static_cast<size_t>(j) * a.n_pad + base + i];
    if (PROBE)
      for (int j = 0; j < a.k; ++j)
        s.coords[j * a.tile + i] = a.coords[static_cast<size_t>(j) * a.n_pad + base + i];
    if (SORT) s.sv[i] = a.sv[base + i];
    s.alive[i] = a.alive[base + i];
  }
}

// Copy the parameters of queries [q0, q0 + qn) into slots [0, qn).
template <bool PROBE, bool SORT>
__device__ void stage_queries(const Args& a, const Smem& s, int q0, int qn) {
  for (int e = threadIdx.x; e < qn * a.d; e += blockDim.x) {
    const int qi = e / a.d, j = e % a.d;
    s.qlo[e] = a.flo_t[static_cast<size_t>(j) * a.bp + q0 + qi];
    s.qhi[e] = a.fhi_t[static_cast<size_t>(j) * a.bp + q0 + qi];
  }
  if (PROBE)
    for (int e = threadIdx.x; e < qn * a.k; e += blockDim.x) {
      s.qfirst[e] = a.first[static_cast<size_t>(q0) * a.k + e];
      s.qlast[e] = a.last[static_cast<size_t>(q0) * a.k + e];
    }
  if (SORT)
    for (int e = threadIdx.x; e < qn * 2; e += blockDim.x)
      s.qband[e] = a.tband[static_cast<size_t>(q0) * 2 + e];
}

template <bool PROBE, bool SORT>
__device__ __forceinline__ bool is_cand(const Args& a, const Smem& s, int i,
                                        int slot) {
  if (s.alive[i] <= 0) return false;
  if (PROBE) {
    for (int j = 0; j < a.k; ++j) {
      const int c = s.coords[j * a.tile + i];
      if (c < s.qfirst[slot * a.k + j] || c > s.qlast[slot * a.k + j])
        return false;
    }
  }
  if (SORT) {
    const float v = s.sv[i];
    if (!(v >= s.qband[2 * slot] && v < s.qband[2 * slot + 1])) return false;
  }
  return true;
}

__device__ __forceinline__ bool is_inside(const Args& a, const Smem& s, int i,
                                          int slot) {
  for (int j = 0; j < a.d; ++j) {
    const float x = s.rows[j * a.tile + i];
    if (!(x >= s.qlo[slot * a.d + j] && x < s.qhi[slot * a.d + j]))
      return false;
  }
  return true;
}

// (i) Per (query, tile) hit and candidate counts.  One block per tile.
template <bool PROBE, bool SORT>
__global__ void __launch_bounds__(256) count_pass(Args a) {
  extern __shared__ unsigned smem_words[];
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Layout L(a, PROBE, SORT, nw);
  const Smem s(smem_words, L);
  const int rpt = a.tile / blockDim.x;      // rows per thread

  if (PROBE)
    for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
      s.box[j] = INT_MAX;
      s.box[a.k + j] = INT_MIN;
    }
  load_tile<PROBE, SORT>(a, s, blockIdx.x);
  __syncthreads();

  // the tile's cell-coordinate box over live rows
  bool mine_alive = false;
  for (int r = 0; r < rpt; ++r)
    mine_alive |= s.alive[r * blockDim.x + threadIdx.x] > 0;
  if (PROBE)
    for (int j = 0; j < a.k; ++j) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int r = 0; r < rpt; ++r) {
        const int i = r * blockDim.x + threadIdx.x;
        if (s.alive[i] > 0) {
          lo = min(lo, s.coords[j * a.tile + i]);
          hi = max(hi, s.coords[j * a.tile + i]);
        }
      }
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      if (lane == 0) {
        atomicMin(&s.box[j], lo);
        atomicMax(&s.box[a.k + j], hi);
      }
    }
  const bool any_alive = __syncthreads_or(mine_alive);   // also a barrier

  for (int q0 = 0; q0 < a.bp; q0 += QC) {
    const int qn = min(QC, a.bp - q0);
    stage_queries<PROBE, SORT>(a, s, q0, qn);
    __syncthreads();
    for (int qi = 0; qi < qn; ++qi) {
      bool skip = !any_alive;               // uniform across the block
      if (PROBE && !skip)
        for (int j = 0; j < a.k; ++j)
          if (s.box[a.k + j] < s.qfirst[qi * a.k + j] ||
              s.box[j] > s.qlast[qi * a.k + j])
            skip = true;
      int h = 0, c = 0;
      if (!skip) {
        for (int r = 0; r < rpt; ++r) {
          const int i = r * blockDim.x + threadIdx.x;
          if (is_cand<PROBE, SORT>(a, s, i, qi)) {
            ++c;
            h += is_inside(a, s, i, qi);
          }
        }
        h = __reduce_add_sync(FULL, h);
        c = __reduce_add_sync(FULL, c);
      }
      if (lane == 0) {
        s.red_h[warp * QC + qi] = h;
        s.red_c[warp * QC + qi] = c;
      }
    }
    __syncthreads();
    if (threadIdx.x < qn) {
      int hs = 0, cs = 0;
      for (int w = 0; w < nw; ++w) {
        hs += s.red_h[w * QC + threadIdx.x];
        cs += s.red_c[w * QC + threadIdx.x];
      }
      const size_t o = static_cast<size_t>(q0 + threadIdx.x) * a.num_tiles + blockIdx.x;
      a.tile_hits[o] = hs;
      a.tile_cand[o] = cs;
    }
    __syncthreads();                        // slots and reductions reused
  }
}

// Exclusive scan of v across the block; *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = (blockDim.x + 31) / 32;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();                          // warp_sums reusable afterwards
  return before + x - v;
}

// (ii) Per query: tile offsets, counts and scanned.  One block per query.
__global__ void __launch_bounds__(1024) scan_pass(Args a) {
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * a.num_tiles;
  const int per = (a.num_tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, a.num_tiles);
  const int t1 = min(t0 + per, a.num_tiles);
  int hsum = 0, csum = 0;
  for (int t = t0; t < t1; ++t) {
    hsum += a.tile_hits[row + t];
    csum += a.tile_cand[row + t];
  }
  int htotal, ctotal;
  int run = block_exclusive_scan(hsum, &htotal);
  block_exclusive_scan(csum, &ctotal);
  for (int t = t0; t < t1; ++t) {
    a.tile_off[row + t] = run;
    run += a.tile_hits[row + t];
  }
  if (threadIdx.x == 0) {
    a.counts[b] = htotal;
    a.scanned[b] = ctotal;
  }
}

// (iii) Place hits of (tile, query) pairs that have any below hit_cap.
template <bool PROBE, bool SORT>
__global__ void __launch_bounds__(256) write_pass(Args a) {
  extern __shared__ unsigned smem_words[];
  __shared__ int warp_hits[32];
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Layout L(a, PROBE, SORT, nw);
  const Smem s(smem_words, L);
  const int rpt = a.tile / blockDim.x;
  const unsigned below = (1u << lane) - 1u;
  bool loaded = false;
  for (int b = 0; b < a.bp; ++b) {
    const size_t o = static_cast<size_t>(b) * a.num_tiles + blockIdx.x;
    const int cnt = a.tile_hits[o];
    int run = a.tile_off[o];
    if (cnt == 0 || run >= a.hit_cap) continue;      // uniform
    if (!loaded) {
      load_tile<PROBE, SORT>(a, s, blockIdx.x);
      loaded = true;
    }
    stage_queries<PROBE, SORT>(a, s, b, 1);
    __syncthreads();
    for (int r = 0; r < rpt && run < a.hit_cap; ++r) {
      const int i = r * blockDim.x + threadIdx.x;    // rows in order
      const bool hit = is_cand<PROBE, SORT>(a, s, i, 0) && is_inside(a, s, i, 0);
      const unsigned bal = __ballot_sync(FULL, hit);
      if (lane == 0) warp_hits[warp] = __popc(bal);
      __syncthreads();
      int pre = 0, tot = 0;
      for (int w = 0; w < nw; ++w) {
        const int n = warp_hits[w];
        pre += w < warp ? n : 0;
        tot += n;
      }
      const int pos = run + pre + __popc(bal & below);
      if (hit && pos < a.hit_cap)
        a.hits[static_cast<size_t>(b) * a.hits_width + pos] =
            blockIdx.x * a.tile + i;
      run += tot;
      __syncthreads();                      // warp_hits and the slot reused
    }
  }
}

int threads_for(int tile) {
  for (int t = 256; t >= 32; t >>= 1)
    if (tile % t == 0) return t;
  return 0;
}

template <bool PROBE, bool SORT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nt = threads_for(a.tile);
  if (nt == 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(Layout(a, PROBE, SORT, nt / 32).words) * 4;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(count_pass<PROBE, SORT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(write_pass<PROBE, SORT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  count_pass<PROBE, SORT><<<a.num_tiles, nt, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_pass<<<a.bp, 1024, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  write_pass<PROBE, SORT><<<a.num_tiles, nt, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue the three passes on `stream`; returns the CUDA error code (0 ok).
// The caller fills `hits` with -1 and keeps every buffer alive until the
// stream has run the passes.
int coax_fused_scan(const float* rows_t, const float* flo_t, const float* fhi_t,
                    const int* alive, const int* coords, const int* first,
                    const int* last, const float* sv, const float* tband,
                    int* counts, int* hits, int* scanned, int* scratch,
                    int d, int n_pad, int bp, int k, int tile, int hit_cap,
                    int probe, int has_sort, void* stream) {
  Args a;
  a.rows_t = rows_t; a.flo_t = flo_t; a.fhi_t = fhi_t; a.alive = alive;
  a.coords = coords; a.first = first; a.last = last; a.sv = sv; a.tband = tband;
  a.counts = counts; a.hits = hits; a.scanned = scanned;
  a.d = d; a.n_pad = n_pad; a.bp = bp; a.k = probe ? k : 0; a.tile = tile;
  a.hit_cap = hit_cap; a.hits_width = hit_cap + tile;
  a.num_tiles = n_pad / tile;
  const size_t plane = static_cast<size_t>(bp) * a.num_tiles;
  a.tile_hits = scratch;
  a.tile_cand = scratch + plane;
  a.tile_off = scratch + 2 * plane;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (probe && has_sort) return launch<true, true>(a, st);
  if (probe) return launch<true, false>(a, st);
  if (has_sort) return launch<false, true>(a, st);
  return launch<false, false>(a, st);
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
