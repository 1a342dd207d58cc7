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
// primary segment (D = 8, k = 3), about 0.97 GB at 18.4M rows, so at least
// 0.29 ms at the card's 3.35 TB/s: the kernel is bound by bytes.  The TPU
// grid streamed the segment once PER QUERY (tiles were its inner grid
// axis); on this card that would read 64x the bytes for a 64-query wave.
//
// What the design does about it.  Three passes; blocks run in no order, so
// ascending hit order, which the TPU got from its sequential tile axis,
// comes from a scan between a pass that finds hits and one that places
// them.  The kernel's row tile (at most 512 rows, dividing the caller's
// tile) and its ring depth come from the launch plan.
//   (i)   count pass: persistent blocks (as many as fit on the card) take
//         row tiles in order from a ticket counter; a segment with fewer
//         tiles than blocks splits each tile's queries into groups, one
//         work item each, so that every block has work.  Each tile comes
//         into a ring of shared-memory stages by 1-D bulk copies
//         (cp.async.bulk, one per row plane, completion on an mbarrier),
//         started as soon as a stage is free, so the loads of the next tiles
//         overlap the compares of this one.  The wave's query bounds are
//         staged once per block.  Each warp owns 64 rows of the tile (32
//         at tiles under 512) and evaluates only the queries ACTIVE on them:
//         its rows hold a live row, their cell-coordinate box over live
//         rows (rows are stored cell-major, so a tile spans few cells)
//         meets the query's probe box, and the query's probe range and
//         sort band are not empty -- exact skips, since no such row can
//         then be a candidate.  Per 32 rows a __ballot_sync gives the hit
//         word, stored into a (Bp, N_pad / 32) bitmap when not zero;
//         popcounts give hit and candidate counts, summed per tile in
//         shared memory.  One barrier per tile.  Tile hit counts go to a
//         (num_tiles, Bp) scratch, 64-tile chunk sums are added with
//         integer atomics (order-free sums), and each (tile, query) pair
//         with hits is appended to a list with the mask of its nonzero
//         words (list order does not matter: offsets come from the scan).
//   (ii)  scan pass: one block per query scans its chunk sums into chunk
//         offsets, and writes counts and scanned.
//   (iii) expand pass: one warp per listed pair adds the hits of its
//         chunk's earlier tiles to the chunk offset; below hit_cap it reads
//         the pair's nonzero words, scans their popcounts across the warp
//         and writes the row ids of the set bits in bit order, dropping any
//         at or past hit_cap.  It reads no row data and has no barrier.
// No atomics place hits, so the output is deterministic.  The compares are
// plain IEEE float compares; the build passes -ftz=false so subnormal rows
// compare exactly as the host's f64 compare does.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CH = 64;               // tiles per scan chunk
constexpr int MIN_QPER = 4;          // least queries in a count work item
constexpr int SCAN_THREADS = 256;
constexpr int EXPAND_THREADS = 256;
constexpr int EXPAND_BLOCKS_PER_SM = 8;

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
  int* chunk_sum;        // (chunks, bp, 2) scratch, zeroed: hit, cand sums
  int* ticket;           // this launch's ticket counter, zeroed
  int* chunk_off;        // (chunks, bp) scratch
  int* tile_hits;        // (num_tiles, bp) scratch
  int* pairs;            // (num_tiles * bp, 4) scratch: tile, query, word mask
  int* pair_count;       // pairs listed, zeroed
  unsigned* bitmap;      // (bp, n_pad / 32) scratch, written where active
  int d, n_pad, bp, k, tile, hit_cap, hits_width, num_tiles, chunks, words;
  int stages, qchunk;    // ring depth; queries staged per count launch
  int q0, qn;            // this count launch's queries
  int qsplit, qper;      // query groups per tile (work item), their size
  int items;             // num_tiles * qsplit
};

// Count-pass shared memory, in bytes: the stage ring first (each plane is
// tile * 4 bytes, a multiple of 128), then the mbarriers, the wave's query
// bounds, the warps' boxes and the per-tile count slots.
// kernels/fused_scan.py:launch_plan mirrors it.
struct Layout {
  size_t stage, bars, item_of, qlo, qhi, qfirst, qlast, qband, qok, wbox,
      slots, bytes;
  __host__ __device__ Layout(const Args& a, bool sort, int nw) {
    const size_t q = a.qchunk;
    stage = static_cast<size_t>(a.d + a.k + (sort ? 1 : 0) + 1) * a.tile * 4;
    size_t o = a.stages * stage;
    bars = o;    o += a.stages * 8;
    item_of = o; o += a.stages * 4;
    qlo = o;     o += q * a.d * 4;
    qhi = o;     o += q * a.d * 4;
    qfirst = o;  o += q * a.k * 4;
    qlast = o;   o += q * a.k * 4;
    qband = o;   o += q * 2 * 4;
    qok = o;     o += q * 4;
    wbox = o;    o += static_cast<size_t>(nw) * 2 * a.k * 4;
    slots = o;   o += 3 * 3 * q * 4;      // 3 buffers: hits, cands, word masks
    bytes = o;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `bar` with `parity` to complete.  A copy that never
// lands would spin forever; past 2^24 polls the kernel traps instead, so the
// launch fails with an error rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0, polls = 0;
  while (!done) {
    if (++polls > (1u << 24)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// 1-D bulk copy global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Fill stage `s` with the tile of work item `item` (one bulk copy per
// plane), or, past the last item, complete the stage's phase empty.
// Thread 0 only.
template <bool PROBE, bool SORT>
__device__ void fill_stage(const Args& a, float* ring, uint64_t* bars,
                           int* item_of, size_t stage_bytes, int s, int item) {
  item_of[s] = item;
  if (item >= a.items) {
    mbar_arrive(&bars[s]);
    return;
  }
  const int t = item / a.qsplit;
  mbar_expect_tx(&bars[s], static_cast<unsigned>(stage_bytes));
  const unsigned plane = a.tile * 4;
  const size_t base = static_cast<size_t>(t) * a.tile;
  float* dst = ring + s * (stage_bytes / 4);
  for (int j = 0; j < a.d; ++j, dst += a.tile)
    bulk_load(dst, a.rows_t + static_cast<size_t>(j) * a.n_pad + base, plane,
              &bars[s]);
  if (PROBE)
    for (int j = 0; j < a.k; ++j, dst += a.tile)
      bulk_load(dst, a.coords + static_cast<size_t>(j) * a.n_pad + base, plane,
                &bars[s]);
  if (SORT) {
    bulk_load(dst, a.sv + base, plane, &bars[s]);
    dst += a.tile;
  }
  bulk_load(dst, a.alive + base, plane, &bars[s]);
}

// (i) Per (tile, query): hit bitmap words, hit and candidate counts, the
// list of pairs with hits, chunk sums.
template <bool PROBE, bool SORT>
__global__ void __launch_bounds__(256) count_pass(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Layout L(a, SORT, nt / 32);
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* item_of = reinterpret_cast<int*>(smem + L.item_of);
  float* qlo = reinterpret_cast<float*>(smem + L.qlo);
  float* qhi = reinterpret_cast<float*>(smem + L.qhi);
  int* qfirst = reinterpret_cast<int*>(smem + L.qfirst);
  int* qlast = reinterpret_cast<int*>(smem + L.qlast);
  float* qband = reinterpret_cast<float*>(smem + L.qband);
  int* qok = reinterpret_cast<int*>(smem + L.qok);
  int* wbox = reinterpret_cast<int*>(smem + L.wbox);
  int* slots = reinterpret_cast<int*>(smem + L.slots);
  const int T = a.tile, k = a.k, d = a.d, qn = a.qn, q0 = a.q0;
  const int wpw = T / nt;                   // 32-row words per warp
  const int per_buf = 3 * a.qchunk;         // hits, cands, word masks
  const size_t row_words = static_cast<size_t>(a.n_pad) / 32;
  const unsigned below = (1u << lane) - 1u;

  // the wave's query bounds, once per block
  for (int e = tid; e < qn * d; e += nt) {
    const int q = e / d, j = e % d;
    qlo[e] = a.flo_t[static_cast<size_t>(j) * a.bp + q0 + q];
    qhi[e] = a.fhi_t[static_cast<size_t>(j) * a.bp + q0 + q];
  }
  if (PROBE)
    for (int e = tid; e < qn * k; e += nt) {
      qfirst[e] = a.first[static_cast<size_t>(q0) * k + e];
      qlast[e] = a.last[static_cast<size_t>(q0) * k + e];
    }
  if (SORT)
    for (int e = tid; e < qn * 2; e += nt)
      qband[e] = a.tband[static_cast<size_t>(q0) * 2 + e];
  for (int e = tid; e < 3 * per_buf; e += nt) slots[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // a query with an empty probe range or sort band has no candidate at all
  for (int q = tid; q < qn; q += nt) {
    bool ok = true;
    if (PROBE)
      for (int j = 0; j < k; ++j) ok &= qfirst[q * k + j] <= qlast[q * k + j];
    if (SORT) ok &= qband[2 * q] < qband[2 * q + 1];
    qok[q] = ok;
  }

  int next = 0;                             // thread 0: the next ticket
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s)
      fill_stage<PROBE, SORT>(a, ring, bars, item_of, L.stage, s,
                         atomicAdd(a.ticket, 1));
    next = atomicAdd(a.ticket, 1);
  }
  __syncthreads();                          // qok is read below

  for (int it = 0;; ++it) {
    const int s = it % a.stages;
    mbar_wait(&bars[s], (it / a.stages) & 1);
    const int item = item_of[s];
    if (item >= a.items) break;             // tickets only grow: all done
    const int t = item / a.qsplit;          // this item's tile and queries
    const int ql0 = item % a.qsplit * a.qper, ql1 = min(qn, ql0 + a.qper);
    const float* rows = ring + s * (L.stage / 4);
    const int* coords = reinterpret_cast<const int*>(rows + d * T);
    const float* sv = rows + (d + k) * T;
    const int* alive = reinterpret_cast<const int*>(rows + (d + k + SORT) * T);
    // per-tile counts, in three rotating buffers: this tile's was zeroed a
    // tile ago; the next one's was last read two tiles ago, before the
    // barrier every thread has passed since
    int* cnt = slots + it % 3 * per_buf;
    int* nxt = slots + (it + 1) % 3 * per_buf;
    for (int e = tid; e < per_buf; e += nt) nxt[e] = 0;

    // this warp's rows: are any live, and their cell-coordinate box
    bool mine = false;
    for (int r = 0; r < wpw; ++r)
      mine |= alive[(warp * wpw + r) * 32 + lane] > 0;
    int* wb = wbox + warp * 2 * k;
    if (__any_sync(FULL, mine)) {
      if (PROBE) {
        for (int j = 0; j < k; ++j) {
          int lo = INT_MAX, hi = INT_MIN;
          for (int r = 0; r < wpw; ++r) {
            const int i = (warp * wpw + r) * 32 + lane;
            if (alive[i] > 0) {
              lo = min(lo, coords[j * T + i]);
              hi = max(hi, coords[j * T + i]);
            }
          }
          lo = __reduce_min_sync(FULL, lo);
          hi = __reduce_max_sync(FULL, hi);
          if (lane == 0) {
            wb[j] = lo;
            wb[k + j] = hi;
          }
        }
        __syncwarp();
      }
      // the queries whose probe box meets this warp's box, 32 at a time;
      // the warp evaluates each on its own rows
      for (int q32 = ql0 / 32 * 32; q32 < ql1; q32 += 32) {
        const int ql = q32 + lane;
        bool act = ql >= ql0 && ql < ql1 && qok[ql];
        if (PROBE)
          for (int j = 0; j < k && act; ++j)
            act = wb[k + j] >= qfirst[ql * k + j] && wb[j] <= qlast[ql * k + j];
        unsigned m = __ballot_sync(FULL, act);
        while (m) {
          const int q = q32 + __ffs(m) - 1;
          m &= m - 1;
          int h = 0, c = 0;
          unsigned wm = 0;
          for (int r = 0; r < wpw; ++r) {
            const int wi = warp * wpw + r, i = wi * 32 + lane;
            bool cand = alive[i] > 0;
            if (PROBE)
              for (int j = 0; j < k && cand; ++j) {
                const int cc = coords[j * T + i];
                cand = cc >= qfirst[q * k + j] && cc <= qlast[q * k + j];
              }
            if (SORT && cand) {
              const float v = sv[i];
              cand = v >= qband[2 * q] && v < qband[2 * q + 1];
            }
            bool hit = cand;
            for (int j = 0; j < d && hit; ++j) {
              const float x = rows[j * T + i];
              hit = x >= qlo[q * d + j] && x < qhi[q * d + j];
            }
            const unsigned hb = __ballot_sync(FULL, hit);
            c += __popc(__ballot_sync(FULL, cand));
            if (hb) {
              h += __popc(hb);
              wm |= 1u << wi;
              if (lane == 0)
                a.bitmap[static_cast<size_t>(q0 + q) * row_words +
                         static_cast<size_t>(t) * a.words + wi] = hb;
            }
          }
          if (lane == 0 && c) {
            atomicAdd(&cnt[q], h);
            atomicAdd(&cnt[a.qchunk + q], c);
            if (wm) atomicOr(&cnt[2 * a.qchunk + q], static_cast<int>(wm));
          }
        }
      }
    }
    __syncthreads();                        // the stage and counts are done

    if (tid == 0) {                         // refill the stage just freed
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill_stage<PROBE, SORT>(a, ring, bars, item_of, L.stage, s, next);
      next = atomicAdd(a.ticket, 1);
    }
    for (int base = ql0; base < ql1; base += nt) {
      const int q = base + tid;
      int h = 0;
      if (q < ql1) {
        h = cnt[q];
        const int c = cnt[a.qchunk + q];
        a.tile_hits[static_cast<size_t>(t) * a.bp + q0 + q] = h;
        if (c) {
          int* cs = a.chunk_sum +
                    (static_cast<size_t>(t / CH) * a.bp + q0 + q) * 2;
          atomicAdd(cs, h);
          atomicAdd(cs + 1, c);
        }
      }
      const unsigned with = __ballot_sync(FULL, h > 0);
      if (with) {                           // append the pairs with hits
        int at = 0;
        if (lane == 0) at = atomicAdd(a.pair_count, __popc(with));
        at = __shfl_sync(FULL, at, 0) + __popc(with & below);
        if (h > 0)
          reinterpret_cast<int4*>(a.pairs)[at] =
              make_int4(t, q0 + q, cnt[2 * a.qchunk + q], 0);
      }
    }
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

// (ii) Per query: chunk offsets, counts and scanned.  One block per query.
__global__ void __launch_bounds__(SCAN_THREADS) scan_pass(Args a) {
  const int q = blockIdx.x;
  const int per = (a.chunks + blockDim.x - 1) / blockDim.x;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, a.chunks);
  const int c1 = min(c0 + per, a.chunks);
  int hsum = 0, csum = 0;
  for (int c = c0; c < c1; ++c) {
    const int* cs = a.chunk_sum + (static_cast<size_t>(c) * a.bp + q) * 2;
    hsum += cs[0];
    csum += cs[1];
  }
  int htotal, ctotal;
  int run = block_exclusive_scan(hsum, &htotal);
  block_exclusive_scan(csum, &ctotal);
  for (int c = c0; c < c1; ++c) {
    a.chunk_off[static_cast<size_t>(c) * a.bp + q] = run;
    run += a.chunk_sum[(static_cast<size_t>(c) * a.bp + q) * 2];
  }
  if (threadIdx.x == 0) {
    a.counts[q] = htotal;
    a.scanned[q] = ctotal;
  }
}

// Row ids of the set bits of (query q, tile t)'s bitmap words, in bit
// order, at hits[q, off + rank] for ranks below hit_cap.  Words outside the
// mask `wm` hold no hit and were not written.  One warp; words <= 32.
__device__ void expand_pair(const Args& a, int q, int t, int off, unsigned wm) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const unsigned mine =
      (wm >> lane) & 1u
          ? a.bitmap[static_cast<size_t>(q) * (a.n_pad / 32) +
                     static_cast<size_t>(t) * a.words + lane]
          : 0u;
  const int n = __popc(mine);
  int incl = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int pre = incl - n;
  int* out = a.hits + static_cast<size_t>(q) * a.hits_width;
  for (unsigned m = wm; m; m &= m - 1) {
    const int w = __ffs(m) - 1;
    const unsigned bits = __shfl_sync(FULL, mine, w);
    const int base = off + __shfl_sync(FULL, pre, w);
    if (base >= a.hit_cap) break;           // uniform
    const int pos = base + __popc(bits & below);
    if (((bits >> lane) & 1u) && pos < a.hit_cap)
      out[pos] = t * a.tile + w * 32 + lane;
  }
}

// (iii) Place the hits.  One warp per listed (tile, query) pair: its offset
// is the query's chunk offset plus the hits of the chunk's earlier tiles.
__global__ void __launch_bounds__(EXPAND_THREADS) expand_pass(Args a) {
  const int lane = threadIdx.x % 32;
  const int np = *a.pair_count;
  const int warps = gridDim.x * (EXPAND_THREADS / 32);
  for (int i = blockIdx.x * (EXPAND_THREADS / 32) + threadIdx.x / 32; i < np;
       i += warps) {
    const int4 p = reinterpret_cast<const int4*>(a.pairs)[i];
    const int t = p.x, q = p.y, c = t / CH;
    int before = 0;
    for (int u = c * CH + lane; u < t; u += 32)
      before += a.tile_hits[static_cast<size_t>(u) * a.bp + q];
    const int off = a.chunk_off[static_cast<size_t>(c) * a.bp + q] +
                    __reduce_add_sync(FULL, before);
    if (off < a.hit_cap) expand_pair(a, q, t, off, static_cast<unsigned>(p.z));
  }
}

// Resident count-pass blocks per SM at `smem` bytes, and the SM count.  The
// kernel's dynamic shared-memory limit is raised to the card's opt-in
// maximum first, so it is never below what a plan asks for.
template <bool PROBE, bool SORT>
cudaError_t blocks_on_card(int nt, size_t smem, int* per_sm, int* sms) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(count_pass<PROBE, SORT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, count_pass<PROBE, SORT>, nt, smem);
  return err;
}

template <bool PROBE, bool SORT>
cudaError_t launch(Args a, size_t smem, cudaStream_t stream) {
  const int nt = min(a.tile, 256);
  if (a.stages < 1 || a.qchunk < 1) return cudaErrorInvalidValue;
  if (Layout(a, SORT, nt / 32).bytes != smem) return cudaErrorInvalidValue;
  int occ = 0, sms = 0;
  cudaError_t err = blocks_on_card<PROBE, SORT>(nt, smem, &occ, &sms);
  if (err != cudaSuccess) return err;
  if (occ < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * occ;
  const int nq = (a.bp + a.qchunk - 1) / a.qchunk;
  // chunk sums, the pair count and one ticket counter per count launch
  err = cudaMemsetAsync(a.chunk_sum, 0,
                        (static_cast<size_t>(a.chunks) * a.bp * 2 + 1 + nq) * 4,
                        stream);
  if (err != cudaSuccess) return err;
  int* tickets = a.pair_count + 1;
  for (int i = 0; i < nq; ++i) {
    a.q0 = i * a.qchunk;
    a.qn = min(a.qchunk, a.bp - a.q0);
    a.ticket = tickets + i;
    // fewer tiles than blocks: split each tile's queries into groups of at
    // least MIN_QPER, one work item each, so every block has work
    a.qsplit = 1;
    if (a.num_tiles < blocks)
      a.qsplit = max(1, min((a.qn + MIN_QPER - 1) / MIN_QPER,
                            blocks / a.num_tiles));
    a.qper = (a.qn + a.qsplit - 1) / a.qsplit;
    a.qsplit = (a.qn + a.qper - 1) / a.qper;
    a.items = a.num_tiles * a.qsplit;
    count_pass<PROBE, SORT><<<min(a.items, blocks), nt, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_pass<<<a.bp, SCAN_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  expand_pass<<<sms * EXPAND_BLOCKS_PER_SM, EXPAND_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue the passes on `stream`; returns the CUDA error code (0 ok).  The
// caller fills `hits` with -1, sizes `scratch` and `bitmap` and picks
// `tile_rows`, `stages`, `qchunk` and `smem_bytes` as
// kernels/fused_scan.py:launch_plan does, and keeps every buffer alive until
// the stream has run the passes.
int coax_fused_scan(const float* rows_t, const float* flo_t, const float* fhi_t,
                    const int* alive, const int* coords, const int* first,
                    const int* last, const float* sv, const float* tband,
                    int* counts, int* hits, int* scanned, int* scratch,
                    unsigned* bitmap, int d, int n_pad, int bp, int k, int tile,
                    int hit_cap, int probe, int has_sort, int tile_rows,
                    int stages, int qchunk, long long smem_bytes,
                    void* stream) {
  Args a;
  a.rows_t = rows_t; a.flo_t = flo_t; a.fhi_t = fhi_t; a.alive = alive;
  a.coords = coords; a.first = first; a.last = last; a.sv = sv; a.tband = tband;
  a.counts = counts; a.hits = hits; a.scanned = scanned; a.bitmap = bitmap;
  a.d = d; a.n_pad = n_pad; a.bp = bp; a.k = probe ? k : 0;
  a.tile = tile_rows;                      // the kernel's own row tile
  if (tile_rows < 32 || tile_rows > 512 || tile_rows % 32 || tile % tile_rows)
    return cudaErrorInvalidValue;
  a.hit_cap = hit_cap; a.hits_width = hit_cap + tile;
  a.num_tiles = n_pad / a.tile;
  a.chunks = (a.num_tiles + CH - 1) / CH;
  a.words = a.tile / 32;
  a.stages = stages; a.qchunk = qchunk; a.q0 = 0; a.qn = 0;
  // scratch, in int32 words: the pair list (16-byte entries, first so they
  // are aligned), then the zeroed chunk sums, pair count and tickets, then
  // the chunk offsets and the tile hit counts
  const size_t per_tile = static_cast<size_t>(a.num_tiles) * bp;
  const size_t per_chunk = static_cast<size_t>(a.chunks) * bp;
  const size_t nq = (bp + qchunk - 1) / qchunk;
  a.pairs = scratch;
  a.chunk_sum = a.pairs + 4 * per_tile;
  a.pair_count = a.chunk_sum + 2 * per_chunk;
  a.ticket = a.pair_count + 1;
  a.chunk_off = a.ticket + nq;
  a.tile_hits = a.chunk_off + per_chunk;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (probe && has_sort) return launch<true, true>(a, smem, st);
  if (probe) return launch<true, false>(a, smem, st);
  if (has_sort) return launch<false, true>(a, smem, st);
  return launch<false, false>(a, smem, st);
}

const char* coax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
