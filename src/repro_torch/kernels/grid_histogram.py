"""Algorithm 1's grid bucketing (paper §5, Fig. 3): a ``buckets x buckets``
count of an attribute pair's bucket coordinates.

On a CUDA tensor ``grid_histogram`` launches the hand-written kernel in
``csrc/grid_histogram.cu`` (built by ``kernels.build`` at first use), one
launch a call, and counts it in ``grid_histogram.launches``; on a CPU
tensor it runs the plain version ``ref.grid_histogram_ref``.  There is no
fallback between the two.

The kernel's grid size is queried once per device and bucket count, and
its scratch (the integer bins and the last-block ticket, which each launch
leaves zeroed) is allocated once per device, bucket count and stream.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import ref
from ._abi import SMEM_LIMIT, VP, I, aligned, check, launch

DEFAULT_TILE = 256

_BLOCKS: Dict[Tuple[int, int], int] = {}           # (device, B)
_SCRATCH: Dict[Tuple[int, int, int], torch.Tensor] = {}  # (device, B, stream)

__all__ = ["grid_histogram", "kept_prefix", "DEFAULT_TILE"]


def kept_prefix(n: int, n_valid) -> int:
    """How many leading rows of ``n`` the float32 row-id test keeps: the
    least ``p`` in ``[0, n]`` with ``p == n`` or not ``float32(p) <
    n_valid``.  Rounding an integer to float32 is monotone, so the rows it
    keeps are exactly ``[0, P)``; the kernel finds ``P`` by this same
    binary search and keeps a row by an integer compare."""
    n_valid = np.float32(n_valid)
    lo, hi = 0, int(n)
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(mid) < n_valid:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _blocks(dev, buckets: int) -> int:
    key = (dev.index, buckets)
    blocks = _BLOCKS.get(key)
    if blocks is None:
        from .build import load
        lib = load("grid_histogram")
        fn = lib.coax_grid_histogram_blocks
        fn.argtypes = [I, ctypes.POINTER(I)]
        fn.restype = I
        out = I(0)
        with torch.cuda.device(dev):
            rc = fn(buckets, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"grid_histogram sizing failed: CUDA error "
                               f"{rc}")
        blocks = _BLOCKS[key] = out.value
    return blocks


def _scratch(dev, buckets: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, buckets, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:              # bins, then the ticket: zero once
        scratch = _SCRATCH[key] = torch.zeros(buckets * buckets + 1,
                                              dtype=torch.int32, device=dev)
    return scratch


def grid_histogram(x, d, params, *, buckets: int = 64,
                   tile: int = DEFAULT_TILE):
    """Bucket-count ``(x, d)`` (N,) f32, N a multiple of ``tile``, with
    ``params`` (8,) f32 = ``[x_lo, inv_wx, d_lo, inv_wd, n_valid, 0, 0, 0]``
    on the same device.  Rows whose float32 id is not below ``n_valid``
    are dropped (the reference's contract).

    Returns the (buckets, buckets) f32 histogram, exact below 2^24 a bucket.
    """
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    n = x.shape[0]
    if tile < 1 or n < 1 or n % tile:
        raise ValueError(f"N={n} must be a positive multiple of tile={tile}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} must be below 2^31 (int32 row ids)")
    if buckets < 1 or 4 * buckets * buckets > SMEM_LIMIT:
        raise ValueError(f"buckets={buckets}: a block holds at most "
                         f"{SMEM_LIMIT // 4} bins")
    dev = x.device
    if dev.type == "cpu":
        return ref.grid_histogram_ref(x, d, params, buckets=buckets)
    if dev.type != "cuda":
        raise ValueError(f"grid_histogram runs on cuda or cpu tensors, "
                         f"not {dev}")
    f32 = torch.float32
    check(x, "x", f32, (n,), dev)
    check(d, "d", f32, (n,), dev)
    check(params, "params", f32, (8,), dev)
    blocks = _blocks(dev, buckets)
    hist = torch.empty((buckets, buckets), dtype=f32, device=dev)
    launch("grid_histogram", "coax_grid_histogram", [VP] * 5 + [I] * 3, dev,
           aligned(x), aligned(d), params, _scratch(dev, buckets), hist, n,
           buckets, blocks)
    grid_histogram.launches += 1
    return hist


grid_histogram.launches = 0      # kernel launches (one per call on CUDA)
