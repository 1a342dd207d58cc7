"""Plain torch versions of this package's kernels.

Each ``*_ref`` mirrors its kernel's exact contract (same inputs including
padding, same outputs), so the tests can compare the kernel with it on the
card, and the wrappers run it for tensors that lie on the CPU — where it
is also the CPU route of the device serving plane (``engine.device``,
DESIGN.md §4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fused_scan_ref"]


def fused_scan_ref(rows_t, flo_t, fhi_t, alive, coords=None, first=None,
                   last=None, sv=None, tband=None, gidx=None, *,
                   tile: int = 512, hit_cap: int = 1024):
    """Plain version of ``fused_scan.fused_scan`` — identical contract, and
    the CPU route of the §4 device plane.

    Returns ``(counts (Bp, 1) i32, hits (Bp, hit_cap + tile) i32,
    scanned (Bp, 1) i32)`` with ``hits[b, :min(counts[b], hit_cap)]`` the
    matching row positions ascending and every later slot -1.

    Two things differ from the kernel's tile loop, neither observable:

    * **Candidate-gather scan** (``gidx (Bp, R)`` i32): each query's
      predicate evaluation runs over only ``rows_t[:, gidx[b]]`` — the
      device plane fills ``gidx`` with EXACTLY each query's probe-derived
      candidate-box row positions, ascending (each cell in the candidate
      coord box is a contiguous cell-major block), padded with the
      position of a dead ``+inf`` pad row.  Exact because every row a
      query can HIT is a member of its candidate box (rows outside fail
      the coord test in the full scan too), each candidate appears exactly
      once, and pad slots fail the ``alive`` test.  Because membership is
      exact, the ``coords``/``first``/``last`` test is implied and skipped
      on this path (same ``counts``/``hits``/``scanned``).  Hit positions
      come back global via a ``gidx`` gather.  ``gidx=None`` scans the
      full array (the kernel's work).
    * **Bisect compaction**: the j-th defined hit slot is located by
      bisecting the running hit count — same prefix, built by gathers.
    """
    d, n = rows_t.shape
    bp = flo_t.shape[1]
    dev = rows_t.device
    if gidx is not None:
        g = gidx.long()
        width = g.shape[1]
        inside = torch.ones((bp, width), dtype=torch.bool, device=dev)
        for j in range(d):
            v = rows_t[j][g]
            inside &= (v >= flo_t[j][:, None]) & (v < fhi_t[j][:, None])
        cand = alive[0][g] > 0
        # coord-box membership is implied: gidx holds exactly the box rows
        if sv is not None:
            s = sv[0][g]
            cand = cand & (s >= tband[:, :1]) & (s < tband[:, 1:])
    else:
        inside = torch.ones((bp, n), dtype=torch.bool, device=dev)
        for j in range(d):
            inside &= (rows_t[j][None, :] >= flo_t[j][:, None]) & (
                rows_t[j][None, :] < fhi_t[j][:, None])
        cand = (alive > 0).expand(bp, n)
        if coords is not None:
            for j in range(coords.shape[0]):
                cand = cand & (coords[j][None, :] >= first[:, j:j + 1]) & (
                    coords[j][None, :] <= last[:, j:j + 1])
        if sv is not None:
            cand = cand & (sv >= tband[:, :1]) & (sv < tband[:, 1:])
    hit = cand & inside

    running = torch.cumsum(hit, dim=1, dtype=torch.int32)     # nondecreasing
    counts = running[:, -1:]
    scanned = cand.sum(dim=1, dtype=torch.int32)[:, None]
    targets = torch.arange(1, hit_cap + 1, dtype=torch.int32, device=dev)
    targets = targets.expand(bp, hit_cap).contiguous()
    idx = torch.searchsorted(running, targets, side="left")  # j-th hit
    defined = targets <= torch.clamp(counts, max=hit_cap)
    if gidx is not None:                   # local slot -> global row position
        pos = torch.gather(g, 1, torch.clamp(idx, max=g.shape[1] - 1))
    else:
        pos = idx
    body = torch.where(defined, pos.to(torch.int32),
                       torch.tensor(-1, dtype=torch.int32, device=dev))
    hits = F.pad(body, (0, tile), value=-1)
    return counts, hits, scanned
