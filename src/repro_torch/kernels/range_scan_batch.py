"""Batched range scan (paper §6): B rects, each with its own ``[lo, hi)``
row window, over one column-major record array in one launch.

On a CUDA tensor ``range_scan_batch`` launches the hand-written kernel in
``csrc/range_scan_batch.cu`` (built by ``kernels.build`` at first use) and
counts the launch in ``range_scan_batch.launches``; on a CPU tensor it runs
the plain version ``ref.range_scan_batch_ref``.  There is no fallback
between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._abi import SMEM_LIMIT, VP, I, check, entry, launch

DEFAULT_TILE = 512
ARGTYPES = [VP] * 6 + [I] * 4

__all__ = ["range_scan_batch", "DEFAULT_TILE"]


def range_scan_batch(rows_t, rect_lo_t, rect_hi_t, windows, *,
                     tile: int = DEFAULT_TILE):
    """Evaluate B translated rects over ``rows_t`` (D, N) f32, N a multiple
    of ``tile``: bounds ``rect_lo_t``/``rect_hi_t`` (D, B) f32, one column
    per query; ``windows`` (B, 2) i32 ``[lo, hi)`` in row ids.

    Returns ``(mask (B, N) i32, counts (B, N / tile) i32)``.
    """
    if rows_t.dim() != 2 or rect_lo_t.dim() != 2:
        raise ValueError("rows_t and rect_lo_t must be 2-D")
    d, n = rows_t.shape
    b = rect_lo_t.shape[1]
    if tile < 1 or n < 1 or n % tile:
        raise ValueError(f"N={n} must be a positive multiple of tile={tile}")
    dev = rows_t.device
    if dev.type == "cpu":
        return ref.range_scan_batch_ref(rows_t, rect_lo_t, rect_hi_t,
                                        windows, tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"range_scan_batch runs on cuda or cpu tensors, "
                         f"not {dev}")
    if b < 1 or n >= 2 ** 31:
        raise ValueError(f"unsupported sizes: B={b}, N={n}")
    f32, i32 = torch.float32, torch.int32
    check(rows_t, "rows_t", f32, (d, n), dev)
    check(rect_lo_t, "rect_lo_t", f32, (d, b), dev)
    check(rect_hi_t, "rect_hi_t", f32, (d, b), dev)
    check(windows, "windows", i32, (b, 2), dev)
    lib, _ = entry("range_scan_batch", "coax_range_scan_batch", ARGTYPES)
    smem_of = lib.coax_range_scan_batch_smem
    if smem_of.argtypes is None:
        smem_of.argtypes = [I, I]
        smem_of.restype = ctypes.c_size_t
    smem = smem_of(d, tile)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a (D={d}, tile={tile}) slab needs {smem} B of "
                         f"shared memory; a block has {SMEM_LIMIT}")
    mask = torch.empty((b, n), dtype=i32, device=dev)
    counts = torch.empty((b, n // tile), dtype=i32, device=dev)
    launch("range_scan_batch", "coax_range_scan_batch", ARGTYPES, dev,
           rows_t, rect_lo_t, rect_hi_t, windows, mask, counts, d, n, b, tile)
    range_scan_batch.launches += 1
    return mask, counts


range_scan_batch.launches = 0    # kernel launches (one per call on CUDA)
