"""Padded standalone entries around the kernels.

These handle ragged sizes (padding to tile multiples) and layout, and take
numpy arrays or tensors.  The device serving plane (``engine.device``,
DESIGN.md §4) bypasses them: it calls ``fused_scan`` directly with
plan-resident pre-padded images; ``fused_range_scan`` below is the
standalone entry for tests and notebooks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_scan import fused_scan

__all__ = ["fused_range_scan"]


def _pad_to(t: torch.Tensor, multiple: int, value) -> torch.Tensor:
    rem = (-t.shape[-1]) % multiple
    return F.pad(t, (0, rem), value=value) if rem else t


def fused_range_scan(
    rows_t,                # (D, N) column-major records
    rect_lo,               # (B, D) per-query ceil-rounded lower bounds
    rect_hi,               # (B, D) per-query ceil-rounded upper bounds
    alive=None,            # (N,) liveness; None -> all alive
    coords=None,           # (kk, N) per-dim cell coords (probe stage)
    first=None,            # (B, kk) per-query first cell coord
    last=None,             # (B, kk) per-query last cell coord
    sv=None,               # (N,) in-cell sorted attribute (sort stage)
    tband=None,            # (B, 2) per-query [t_lo, t_hi) sort targets
    *,
    tile: int = 512,
    hit_cap: int = 1024,
    device="cuda",
):
    """Standalone fused scan: pads N to a tile multiple and runs
    ``fused_scan`` on ``device`` (the kernel on ``"cuda"``, its plain
    version on ``"cpu"``).

    Returns ``(counts (B,), hits (B, hit_cap + tile), scanned (B,))``; see
    ``fused_scan`` for the compacted-hits contract.  Positions ≥ the
    original N never appear (pads are dead: rows +inf, alive 0, coords -1).
    """
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device)

    rows_t = f32(rows_t)
    n = rows_t.shape[1]
    padded = _pad_to(rows_t, tile, float("inf")).contiguous()
    if alive is None:
        alive = torch.ones(n, dtype=torch.int32, device=device)
    alive_p = _pad_to(i32(alive), tile, 0)[None, :].contiguous()
    kwargs = {}
    if coords is not None:
        kwargs["coords"] = _pad_to(i32(coords), tile, -1).contiguous()
        kwargs["first"] = i32(first).contiguous()
        kwargs["last"] = i32(last).contiguous()
    if sv is not None:
        kwargs["sv"] = _pad_to(f32(sv), tile, float("inf"))[None, :].contiguous()
        kwargs["tband"] = f32(tband).contiguous()
    flo_t = f32(rect_lo).T.contiguous()
    fhi_t = f32(rect_hi).T.contiguous()
    counts, hits, scanned = fused_scan(padded, flo_t, fhi_t, alive_p,
                                       tile=tile, hit_cap=hit_cap, **kwargs)
    return counts[:, 0], hits, scanned[:, 0]
