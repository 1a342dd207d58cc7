"""Fused probe + sort-band + filter + hit-compaction kernel (DESIGN.md §4).

One call evaluates, for every query b and row p of one segment, the whole
per-row serving predicate

  ``hit[b, p] = alive[p] ∧ candidate[b, p] ∧ inside[b, p]``

* ``candidate``: the row's precomputed cell coordinates lie in the query's
  host-probed ``[first, last]`` on every grid dim (segments with a probe)
  and its in-cell sorted attribute lies in ``[t_lo, t_hi)`` (segments with
  a sort dim).  Rows are stored cell-major and cell-sorted, so this selects
  exactly the rows of the numpy path's refined candidate blocks.
* ``inside``: the ceil-rounded f32 rect compare (``f32_ceil`` pairing makes
  it bit-equal to the f64 host compare).
* ``alive`` masks tombstoned snapshot rows and padding, so the delta
  segment (no probe, no sort) runs through the same kernel.

Outputs are compacted per query: the true hit count, the first
``min(count, hit_cap)`` hit positions ascending (later slots -1), and the
candidate count.  A query whose count exceeds ``hit_cap`` is re-answered
exactly on the host (the drain-time overflow contract).

On a CUDA tensor ``fused_scan`` launches the hand-written kernel in
``csrc/fused_scan.cu`` (built by ``kernels.build`` at first use) and counts
the launch in ``fused_scan.launches``; on a CPU tensor it runs the plain
version ``ref.fused_scan_ref``.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import ref
from ._abi import SMEM_LIMIT, VP, I, aligned, check, launch

DEFAULT_TILE = 512
DEFAULT_HIT_CAP = 1024

__all__ = ["fused_scan", "launch_plan", "LaunchPlan", "DEFAULT_TILE",
           "DEFAULT_HIT_CAP"]

QCHUNK = 128          # queries one count-pass launch stages in shared memory
SCAN_CHUNK = 64       # tiles per scan chunk (csrc/fused_scan.cu CH)
MAX_TILE_ROWS = 512   # the kernel's row tile: at most this, dividing `tile`
MAX_STAGES = 3        # depth of the count pass's ring of tile stages
BLOCKS_PER_SM = 6     # count-pass blocks an SM should hold, before depth
                      # (its registers hold 6 blocks of 256 threads)
SM_SMEM = 233_472     # shared memory of one Hopper SM
BLOCK_RESERVED = 1_024    # of it, what the card keeps back for each block


class LaunchPlan(NamedTuple):
    """How ``csrc/fused_scan.cu`` runs one call: its own row tile,
    count-pass threads per block, ring stages, queries per count launch
    (``launches`` of them), the count pass's dynamic shared memory in bytes
    (the kernel recomputes it and refuses a mismatch), row tiles, scan
    chunks, and the int32 words of the scratch and of the hit bitmap."""
    tile_rows: int
    threads: int
    stages: int
    qchunk: int
    launches: int
    smem: int
    num_tiles: int
    chunks: int
    scratch_words: int
    bitmap_words: int


def launch_plan(d: int, k: int, has_sort: bool, tile: int, n: int,
                bp: int) -> LaunchPlan:
    """The kernel's sizing for ``d`` row dims, ``k`` probe dims (0 without
    a probe), a sort plane or not, ``n`` rows in tiles of ``tile`` (a
    multiple of 32 dividing ``n``) and ``bp`` queries.  The row tile is
    the largest power of two up to ``MAX_TILE_ROWS`` dividing ``tile``.
    Blocks on an SM come first, ring depth second: the ring takes as many
    stages (at most ``MAX_STAGES``) as leave ``BLOCKS_PER_SM`` blocks on an
    SM, else as leave one block fewer, and so on; raises when one stage
    does not fit one block."""
    rows = next(t for t in (512, 256, 128, 64, 32)
                if t <= MAX_TILE_ROWS and tile % t == 0)
    threads = min(rows, 256)
    nw = threads // 32
    qchunk = min(bp, QCHUNK)
    stage = 4 * rows * (d + k + int(has_sort) + 1)
    # per stage: its planes, an mbarrier and its item id; then the query
    # bounds and non-empty flags, the warps' boxes, and three buffers of
    # per-query hit, candidate and word-mask slots
    fixed = 4 * (qchunk * (2 * d + 2 * k + 3) + nw * 2 * k + 9 * qchunk)

    def smem(s):
        return s * (stage + 12) + fixed

    stages = None
    for blocks in range(BLOCKS_PER_SM, 0, -1):
        share = min(SM_SMEM // blocks - BLOCK_RESERVED, SMEM_LIMIT)
        stages = next((s for s in range(MAX_STAGES, 0, -1)
                       if smem(s) <= share), None)
        if stages is not None:
            break
    if stages is None:
        raise ValueError(f"a tile of {rows} rows x {d + k + has_sort + 1} "
                         f"planes does not fit the kernel's shared memory")
    num_tiles = n // rows
    chunks = -(-num_tiles // SCAN_CHUNK)
    launches = -(-bp // qchunk)
    # the pair list (4 words a pair, as many as (tile, query) pairs); chunk
    # sums (hit, cand), the pair count and the tickets, zeroed; chunk
    # offsets; tile hit counts
    scratch = (4 * num_tiles * bp + 2 * chunks * bp + 1 + launches
               + chunks * bp + num_tiles * bp)
    return LaunchPlan(rows, threads, stages, qchunk, launches, smem(stages),
                      num_tiles, chunks, scratch, bp * (n // 32))


def fused_scan(rows_t, flo_t, fhi_t, alive, coords=None, first=None,
               last=None, sv=None, tband=None, gidx=None, *,
               tile: int = DEFAULT_TILE, hit_cap: int = DEFAULT_HIT_CAP):
    """Scan one segment for one wave of queries.

    rows_t (D, N_pad) f32, +inf pads; flo_t/fhi_t (D, Bp) f32 ceil-rounded
    bounds; alive (1, N_pad) i32; probe stage: coords (k, N_pad) i32 (pads
    -1), first/last (Bp, k) i32; sort stage: sv (1, N_pad) f32 (pads +inf),
    tband (Bp, 2) f32.  A stage is on when its operands are given.
    ``gidx`` (Bp, R) i32 candidate row lists restrict the CPU route to each
    query's candidate box (see ``ref.fused_scan_ref``); the kernel always
    scans the whole segment and refuses ``gidx``.

    Returns ``(counts (Bp, 1) i32, hits (Bp, hit_cap + tile) i32,
    scanned (Bp, 1) i32)``.
    """
    dev = rows_t.device
    if dev.type == "cpu":
        return ref.fused_scan_ref(rows_t, flo_t, fhi_t, alive, coords, first,
                                  last, sv, tband, gidx, tile=tile,
                                  hit_cap=hit_cap)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan runs on cuda or cpu tensors, not {dev}")
    if gidx is not None:
        raise ValueError("the CUDA kernel scans the whole segment; gidx is "
                         "the CPU route's")
    probe, has_sort = coords is not None, sv is not None
    if probe != (first is not None) or probe != (last is not None):
        raise ValueError("probe stage needs coords, first and last together")
    if has_sort != (tband is not None):
        raise ValueError("sort stage needs sv and tband together")
    if rows_t.dim() != 2 or flo_t.dim() != 2:
        raise ValueError("rows_t and flo_t must be 2-D")
    d, n = rows_t.shape
    bp = flo_t.shape[1]
    if tile < 32 or tile % 32 or n % tile:
        raise ValueError(f"tile={tile} must be a multiple of 32 dividing N={n}")
    if bp < 1 or n >= 2 ** 31 or hit_cap < 1:
        raise ValueError(f"unsupported sizes: Bp={bp}, N={n}, hit_cap={hit_cap}")
    f32, i32 = torch.float32, torch.int32
    check(rows_t, "rows_t", f32, (d, n), dev)
    check(flo_t, "flo_t", f32, (d, bp), dev)
    check(fhi_t, "fhi_t", f32, (d, bp), dev)
    check(alive, "alive", i32, (1, n), dev)
    k = 0
    if probe:
        k = coords.shape[0]
        check(coords, "coords", i32, (k, n), dev)
        check(first, "first", i32, (bp, k), dev)
        check(last, "last", i32, (bp, k), dev)
    if has_sort:
        check(sv, "sv", f32, (1, n), dev)
        check(tband, "tband", f32, (bp, 2), dev)

    plan = launch_plan(d, k, has_sort, tile, n, bp)
    rows_t, alive, coords, sv = (aligned(t) for t in (rows_t, alive, coords,
                                                       sv))
    counts, scanned = torch.empty((2, bp, 1), dtype=i32, device=dev)
    # the scratch (its pair list first, 16-byte aligned), then the bitmap
    scratch = torch.empty(plan.scratch_words + plan.bitmap_words, dtype=i32,
                          device=dev)
    bitmap = scratch[plan.scratch_words:]
    hits = torch.full((bp, hit_cap + tile), -1, dtype=i32, device=dev)
    launch("fused_scan", "coax_fused_scan",
           [VP] * 14 + [I] * 11 + [ctypes.c_longlong], dev,
           rows_t, flo_t, fhi_t, alive, coords, first, last, sv, tband,
           counts, hits, scanned, scratch, bitmap, d, n, bp, k, tile,
           hit_cap, int(probe), int(has_sort), plan.tile_rows, plan.stages,
           plan.qchunk, plan.smem)
    fused_scan.launches += 1
    return counts, hits, scanned


fused_scan.launches = 0      # kernel launch groups (one per call on CUDA)
