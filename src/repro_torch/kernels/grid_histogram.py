"""Algorithm 1's grid bucketing (paper §5, Fig. 3): a ``buckets x buckets``
count of an attribute pair's bucket coordinates.

On a CUDA tensor ``grid_histogram`` launches the hand-written kernel in
``csrc/grid_histogram.cu`` (built by ``kernels.build`` at first use) and
counts the launch in ``grid_histogram.launches``; on a CPU tensor it runs
the plain version ``ref.grid_histogram_ref``.  There is no fallback between
the two.
"""
from __future__ import annotations

import torch

from . import ref
from ._abi import SMEM_LIMIT, VP, I, check, launch

DEFAULT_TILE = 256

__all__ = ["grid_histogram", "DEFAULT_TILE"]


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
    if buckets < 1 or 4 * buckets * buckets > SMEM_LIMIT:
        raise ValueError(f"buckets={buckets}: a block holds at most "
                         f"{SMEM_LIMIT // 4} bins")
    dev = x.device
    if dev.type == "cpu":
        return ref.grid_histogram_ref(x, d, params, buckets=buckets)
    if dev.type != "cuda":
        raise ValueError(f"grid_histogram runs on cuda or cpu tensors, "
                         f"not {dev}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} does not fit the kernel's int32 row ids")
    f32 = torch.float32
    check(x, "x", f32, (n,), dev)
    check(d, "d", f32, (n,), dev)
    check(params, "params", f32, (8,), dev)
    scratch = torch.empty(buckets * buckets, dtype=torch.int32, device=dev)
    hist = torch.empty((buckets, buckets), dtype=f32, device=dev)
    launch("grid_histogram", "coax_grid_histogram", [VP] * 5 + [I] * 2, dev,
           x, d, params, scratch, hist, n, buckets)
    grid_histogram.launches += 1
    return hist


grid_histogram.launches = 0      # kernel launches (one per call on CUDA)
