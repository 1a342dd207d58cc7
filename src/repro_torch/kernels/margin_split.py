"""Algorithm 1's split (paper §5): each row's displacement from the soft-FD
model and whether it lies inside the margin, with per-tile inlier counts.

On a CUDA tensor ``margin_split`` launches the hand-written kernel in
``csrc/margin_split.cu`` (built by ``kernels.build`` at first use) and
counts the launch in ``margin_split.launches``; on a CPU tensor it runs the
plain version ``ref.margin_split_ref``.  There is no fallback between the
two.
"""
from __future__ import annotations

import torch

from . import ref
from ._abi import VP, I, check, launch

DEFAULT_TILE = 1024

__all__ = ["margin_split", "DEFAULT_TILE"]


def margin_split(x, d, params, *, tile: int = DEFAULT_TILE):
    """Split ``(x, d)`` (N,) f32, N a multiple of ``tile``, with ``params``
    (8,) f32 = ``[m, b, eps_lb, eps_ub, n_valid, 0, 0, 0]`` on the same
    device: ``disp = d - (m * x + b)`` rounded as the reference rounds it,
    inlier ``-eps_lb <= disp <= eps_ub`` for rows whose float32 id is below
    ``n_valid``.

    Returns ``(disp (N,) f32, mask (N,) i32, counts (N / tile,) i32)``.
    """
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    n = x.shape[0]
    if tile < 1 or n < 1 or n % tile:
        raise ValueError(f"N={n} must be a positive multiple of tile={tile}")
    dev = x.device
    if dev.type == "cpu":
        return ref.margin_split_ref(x, d, params, tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"margin_split runs on cuda or cpu tensors, not {dev}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} does not fit the kernel's int32 row ids")
    f32, i32 = torch.float32, torch.int32
    check(x, "x", f32, (n,), dev)
    check(d, "d", f32, (n,), dev)
    check(params, "params", f32, (8,), dev)
    disp = torch.empty(n, dtype=f32, device=dev)
    mask = torch.empty(n, dtype=i32, device=dev)
    counts = torch.empty(n // tile, dtype=i32, device=dev)
    launch("margin_split", "coax_margin_split", [VP] * 6 + [I] * 2, dev,
           x, d, params, disp, mask, counts, n, tile)
    margin_split.launches += 1
    return disp, mask, counts


margin_split.launches = 0        # kernel launches (one per call on CUDA)
