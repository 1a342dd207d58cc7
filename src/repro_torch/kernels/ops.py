"""Padded standalone entries around the kernels — the port's counterparts
of ``repro.kernels.ops``, with the same arguments and returns.

These handle ragged sizes (padding to tile multiples), parameter packing
and layout, and take numpy arrays or tensors.  Each runs on ``device``:
the hand-written kernel on ``"cuda"`` (the default), its plain version on
``"cpu"``.  The device serving plane (``engine.device``, DESIGN.md §4)
bypasses them: it calls ``fused_scan`` directly with plan-resident
pre-padded images; ``fused_range_scan`` below is the standalone entry for
tests and notebooks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_scan import fused_scan
from .grid_histogram import grid_histogram
from .margin_split import margin_split
from .range_scan import range_scan
from .range_scan_batch import range_scan_batch

__all__ = ["range_scan_query", "range_scan_batch_query", "fused_range_scan",
           "bucket_histogram", "split_by_margin"]

INF = float("inf")


def _pad_to(t: torch.Tensor, multiple: int, value) -> torch.Tensor:
    rem = (-t.shape[-1]) % multiple
    return F.pad(t, (0, rem), value=value) if rem else t


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def range_scan_query(
    rows_t,                # (D, N) column-major records
    rect_lo,               # (D,)
    rect_hi,               # (D,)
    window=None,           # (2,) [lo, hi) scan window; None -> whole array
    *,
    tile: int = 512,
    device="cuda",
):
    """Count + mask for one translated query (paper §6 scan) on ``device``.

    Returns ``(count (), mask (N,))`` int32, the mask over the ORIGINAL n
    records.
    """
    rows_t = _f32(rows_t, device)
    n = rows_t.shape[1]
    window = _i32([0, n] if window is None else window, device)
    padded = _pad_to(rows_t, tile, INF).contiguous()   # +inf never < hi
    mask, counts = range_scan(padded, _f32(rect_lo, device).contiguous(),
                              _f32(rect_hi, device).contiguous(),
                              window.contiguous(), tile=tile)
    return counts.sum(dtype=torch.int32), mask[:n]


def range_scan_batch_query(
    rows_t,                # (D, N) column-major records
    rect_lo,               # (B, D) per-query lower bounds
    rect_hi,               # (B, D) per-query upper bounds
    windows=None,          # (B, 2) per-query [lo, hi) scan windows; None -> whole
    *,
    tile: int = 512,
    device="cuda",
):
    """Counts + masks for a BATCH of translated queries in one launch on
    ``device``.

    Returns ``(counts (B,), mask (B, N))`` int32, each mask row over the
    ORIGINAL n records.  The kernel takes bounds as (D, B) columns; this
    wrapper transposes.
    """
    rows_t = _f32(rows_t, device)
    rect_lo = _f32(rect_lo, device)
    rect_hi = _f32(rect_hi, device)
    n = rows_t.shape[1]
    b = rect_lo.shape[0]
    if windows is None:
        windows = _i32([0, n], device).expand(b, 2)
    padded = _pad_to(rows_t, tile, INF).contiguous()   # +inf never < hi
    mask, counts = range_scan_batch(
        padded, rect_lo.T.contiguous(), rect_hi.T.contiguous(),
        _i32(windows, device).contiguous(), tile=tile)
    return counts.sum(1, dtype=torch.int32), mask[:, :n]


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
    rows_t = _f32(rows_t, device)
    n = rows_t.shape[1]
    padded = _pad_to(rows_t, tile, INF).contiguous()
    if alive is None:
        alive = torch.ones(n, dtype=torch.int32, device=device)
    alive_p = _pad_to(_i32(alive, device), tile, 0)[None, :].contiguous()
    kwargs = {}
    if coords is not None:
        kwargs["coords"] = _pad_to(_i32(coords, device), tile, -1).contiguous()
        kwargs["first"] = _i32(first, device).contiguous()
        kwargs["last"] = _i32(last, device).contiguous()
    if sv is not None:
        kwargs["sv"] = _pad_to(_f32(sv, device), tile, INF)[None, :].contiguous()
        kwargs["tband"] = _f32(tband, device).contiguous()
    flo_t = _f32(rect_lo, device).T.contiguous()
    fhi_t = _f32(rect_hi, device).T.contiguous()
    counts, hits, scanned = fused_scan(padded, flo_t, fhi_t, alive_p,
                                       tile=tile, hit_cap=hit_cap, **kwargs)
    return counts[:, 0], hits, scanned[:, 0]


def histogram_operands(x, d, *, buckets: int = 64, tile: int = 256,
                       device="cuda"):
    """``grid_histogram``'s operands for ``bucket_histogram``: the columns
    padded with 0.0 to a tile multiple and the params vector, computed on
    ``device`` in float32 exactly as the reference computes them."""
    x = _f32(x, device)
    d = _f32(d, device)
    n = x.shape[0]
    x_lo, x_hi = torch.aminmax(x)
    d_lo, d_hi = torch.aminmax(d)
    wx = torch.clamp((x_hi - x_lo) / buckets, min=1e-30)
    wd = torch.clamp((d_hi - d_lo) / buckets, min=1e-30)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    params = torch.stack([x_lo, 1.0 / wx, d_lo, 1.0 / wd,
                          _f32(n, device), zero, zero, zero])
    return (_pad_to(x, tile, 0.0).contiguous(),
            _pad_to(d, tile, 0.0).contiguous(), params)


def bucket_histogram(x, d, *, buckets: int = 64, tile: int = 256,
                     device="cuda"):
    """Algorithm 1 bucket counts on ``device``; returns (B, B) float32."""
    xp, dp, params = histogram_operands(x, d, buckets=buckets, tile=tile,
                                        device=device)
    return grid_histogram(xp, dp, params, buckets=buckets, tile=tile)


def split_operands(x, d, m, b, eps_lb, eps_ub, *, tile: int = 1024,
                   device="cuda"):
    """``margin_split``'s operands for ``split_by_margin``: the columns
    padded with 0.0 to a tile multiple and the float32 params vector."""
    x = _f32(x, device)
    d = _f32(d, device)
    params = _f32([float(m), float(b), float(eps_lb), float(eps_ub),
                   float(x.shape[0]), 0.0, 0.0, 0.0], device)
    return (_pad_to(x, tile, 0.0).contiguous(),
            _pad_to(d, tile, 0.0).contiguous(), params)


def split_by_margin(x, d, m, b, eps_lb, eps_ub, *, tile: int = 1024,
                    device="cuda"):
    """Fused Alg.-1 split on ``device``: returns ``(disp (N,) f32,
    inlier_mask (N,) bool)``."""
    x = _f32(x, device)
    xp, dp, params = split_operands(x, d, m, b, eps_lb, eps_ub, tile=tile,
                                    device=device)
    disp, mask, _ = margin_split(xp, dp, params, tile=tile)
    return disp[:x.shape[0]], mask[:x.shape[0]].to(torch.bool)
