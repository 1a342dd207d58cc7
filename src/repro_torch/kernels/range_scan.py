"""One-rect range scan (paper §6): rect predicate and ``[lo, hi)`` row
window over a column-major record array, with per-tile match counts.

On a CUDA tensor ``range_scan`` launches the hand-written kernel in
``csrc/range_scan.cu`` (built by ``kernels.build`` at first use) and counts
the launch in ``range_scan.launches``; on a CPU tensor it runs the plain
version ``ref.range_scan_ref``.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from . import ref
from ._abi import VP, I, check, launch

DEFAULT_TILE = 512

__all__ = ["range_scan", "DEFAULT_TILE"]


def range_scan(rows_t, rect_lo, rect_hi, window, *, tile: int = DEFAULT_TILE):
    """Evaluate one translated rect over ``rows_t`` (D, N) f32, N a
    multiple of ``tile``: ``rect_lo``/``rect_hi`` (D,) f32, ``window``
    (2,) i32 ``[lo, hi)`` in row ids.

    Returns ``(mask (N,) i32, counts (N / tile,) i32)``.
    """
    if rows_t.dim() != 2:
        raise ValueError("rows_t must be 2-D (D, N)")
    d, n = rows_t.shape
    if tile < 1 or n < 1 or n % tile:
        raise ValueError(f"N={n} must be a positive multiple of tile={tile}")
    dev = rows_t.device
    if dev.type == "cpu":
        return ref.range_scan_ref(rows_t, rect_lo, rect_hi, window, tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"range_scan runs on cuda or cpu tensors, not {dev}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} does not fit the kernel's int32 row ids")
    f32, i32 = torch.float32, torch.int32
    check(rows_t, "rows_t", f32, (d, n), dev)
    check(rect_lo, "rect_lo", f32, (d,), dev)
    check(rect_hi, "rect_hi", f32, (d,), dev)
    check(window, "window", i32, (2,), dev)
    mask = torch.empty(n, dtype=i32, device=dev)
    counts = torch.empty(n // tile, dtype=i32, device=dev)
    launch("range_scan", "coax_range_scan", [VP] * 6 + [I] * 3, dev,
           rows_t, rect_lo, rect_hi, window, mask, counts, d, n, tile)
    range_scan.launches += 1
    return mask, counts


range_scan.launches = 0          # kernel launches (one per call on CUDA)
