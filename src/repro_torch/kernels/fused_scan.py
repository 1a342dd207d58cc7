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

import torch

from . import ref

DEFAULT_TILE = 512
DEFAULT_HIT_CAP = 1024

__all__ = ["fused_scan", "DEFAULT_TILE", "DEFAULT_HIT_CAP"]

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    from .build import load
    lib = load("fused_scan")
    if lib.coax_fused_scan.argtypes is None:    # first use: declare the ABI
        lib.coax_fused_scan.argtypes = [_VP] * 13 + [_I] * 8 + [_VP]
        lib.coax_fused_scan.restype = _I
        lib.coax_error_string.argtypes = [_I]
        lib.coax_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rows_t on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check(rows_t, "rows_t", f32, (d, n), dev)
    _check(flo_t, "flo_t", f32, (d, bp), dev)
    _check(fhi_t, "fhi_t", f32, (d, bp), dev)
    _check(alive, "alive", i32, (1, n), dev)
    k = 0
    if probe:
        k = coords.shape[0]
        _check(coords, "coords", i32, (k, n), dev)
        _check(first, "first", i32, (bp, k), dev)
        _check(last, "last", i32, (bp, k), dev)
    if has_sort:
        _check(sv, "sv", f32, (1, n), dev)
        _check(tband, "tband", f32, (bp, 2), dev)

    lib = _lib()
    counts = torch.empty((bp, 1), dtype=i32, device=dev)
    scanned = torch.empty((bp, 1), dtype=i32, device=dev)
    hits = torch.full((bp, hit_cap + tile), -1, dtype=i32, device=dev)
    scratch = torch.empty((3, bp, n // tile), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coax_fused_scan(
            ptr(rows_t), ptr(flo_t), ptr(fhi_t), ptr(alive), ptr(coords),
            ptr(first), ptr(last), ptr(sv), ptr(tband), ptr(counts),
            ptr(hits), ptr(scanned), ptr(scratch), d, n, bp, k, tile,
            hit_cap, int(probe), int(has_sort), stream)
    if rc != 0:
        raise RuntimeError(f"fused_scan launch failed: CUDA error {rc} "
                           f"({lib.coax_error_string(rc).decode()})")
    fused_scan.launches += 1
    return counts, hits, scanned


fused_scan.launches = 0      # kernel launch groups (one per call on CUDA)
