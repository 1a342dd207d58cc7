"""Baseline multidimensional indexes the paper compares against (§8.1.3):

* ``FullScan``    — every record checked against the predicate.
* ``UniformGrid`` — full-dimensional grid, uniform min..max cell boundaries,
  no sorted dimension, directory = flat cell offsets.
* ``ColumnFiles`` — CDF(quantile)-aligned grid with one in-cell sorted
  dimension (dimensionality reduced by one); 'similar to Flood [28] but does
  not assume the query workload is known'.
* ``STRTree``     — an R-Tree bulk-loaded with Sort-Tile-Recursive packing,
  stored in flat per-level arrays (MBRs + child ranges) so queries are
  vectorisable.  This is the array-native adaptation of the pointer R-tree
  (DESIGN.md §3) — same asymptotics, hardware-honest layout.

All engines share the contract: ``query(rect) -> sorted original row ids`` and
``memory_footprint() -> directory bytes``, so result sets are set-comparable
with COAX and with each other.  They are host engines (numpy, one rect a
call): the grid baselines build their ``GridFile`` on the numpy backend, and
the executor serves an engine without ``query_batch`` rect by rect.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .gridfile import GridFile, fit_cells_per_dim, gather_ranges
from .types import Rect, full_rect, rect_contains

__all__ = ["FullScan", "UniformGrid", "ColumnFiles", "STRTree"]


class FullScan:
    """Ground-truth engine: linear scan with the full predicate."""

    name = "full_scan"

    def __init__(self, data: np.ndarray):
        self.data = np.ascontiguousarray(data, dtype=np.float32)

    def query(self, rect: Rect) -> np.ndarray:
        return np.nonzero(rect_contains(rect, self.data))[0].astype(np.int64)

    def memory_footprint(self) -> int:
        return 0


class UniformGrid:
    """Full grid with uniformly sized cells (paper: 'the full grid')."""

    name = "uniform_grid"

    def __init__(self, data: np.ndarray, cells_per_dim: Optional[int] = None,
                 rows_per_cell: int = 256):
        n, d = data.shape
        if cells_per_dim is None:
            # target occupancy, capped by the paper's §8.2.1 directory budget
            budget_cells = max(int(data.nbytes // 8), 1)
            auto = max(int(round((n / rows_per_cell) ** (1.0 / d))), 2)
            cells_per_dim = min(auto, fit_cells_per_dim(d, budget_cells))
        self.grid = GridFile(
            data, index_dims=list(range(d)), cells_per_dim=cells_per_dim,
            sort_dim=None, quantile=False, backend="numpy",
        )

    def query(self, rect: Rect) -> np.ndarray:
        return self.grid.query(np.asarray(rect, dtype=np.float64), rect)

    def memory_footprint(self) -> int:
        return self.grid.memory_footprint()

    @property
    def last_query_stats(self):
        return self.grid.last_query_stats


class ColumnFiles:
    """Non-uniform (CDF-aligned) grid + one sorted dim (paper §8.1.3)."""

    name = "column_files"

    def __init__(
        self,
        data: np.ndarray,
        cells_per_dim: Optional[int] = None,
        sort_dim: int = 0,
        rows_per_cell: int = 256,
    ):
        n, d = data.shape
        if cells_per_dim is None:
            budget_cells = max(int(data.nbytes // 8), 1)
            auto = max(int(round((n / rows_per_cell) ** (1.0 / max(d - 1, 1)))), 2)
            cells_per_dim = min(auto, fit_cells_per_dim(max(d - 1, 1), budget_cells))
        self.grid = GridFile(
            data, index_dims=list(range(d)), cells_per_dim=cells_per_dim,
            sort_dim=sort_dim, quantile=True, backend="numpy",
        )

    def query(self, rect: Rect) -> np.ndarray:
        return self.grid.query(np.asarray(rect, dtype=np.float64), rect)

    def memory_footprint(self) -> int:
        return self.grid.memory_footprint()

    @property
    def last_query_stats(self):
        return self.grid.last_query_stats


# --------------------------------------------------------------------------- #
# STR-packed R-Tree in flat arrays
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class _Level:
    mbr_lo: np.ndarray    # (M, D)
    mbr_hi: np.ndarray    # (M, D)  (inclusive of contained points)
    child_lo: np.ndarray  # (M,) start index into the level below (or rows)
    child_hi: np.ndarray  # (M,) end index


def _str_order(points: np.ndarray, leaf_cap: int) -> np.ndarray:
    """Sort-Tile-Recursive ordering of row indices for leaf packing."""
    n, d = points.shape
    idx = np.arange(n, dtype=np.int64)

    def recurse(ids: np.ndarray, dim: int) -> np.ndarray:
        if ids.size <= leaf_cap or dim == d - 1:
            return ids[np.argsort(points[ids, dim], kind="stable")]
        ids = ids[np.argsort(points[ids, dim], kind="stable")]
        n_leaves = int(np.ceil(ids.size / leaf_cap))
        rem = d - dim
        n_slabs = max(int(np.ceil(n_leaves ** (1.0 / rem))), 1)
        slab = int(np.ceil(ids.size / n_slabs))
        parts = [recurse(ids[i : i + slab], dim + 1) for i in range(0, ids.size, slab)]
        return np.concatenate(parts)

    return recurse(idx, 0)


class STRTree:
    """Bulk-loaded R-Tree (STR packing), breadth-first array storage.

    node_cap mirrors the paper's tuning range ('best node size for R-Tree is
    between 8 and 12', §8.2.1); default 10.
    """

    name = "r_tree"

    def __init__(self, data: np.ndarray, leaf_cap: int = 10, node_cap: int = 10):
        data = np.ascontiguousarray(data, dtype=np.float32)
        n, d = data.shape
        self.leaf_cap = leaf_cap
        self.node_cap = node_cap
        order = _str_order(data, leaf_cap) if n else np.empty(0, np.int64)
        self.rows = data[order] if n else data
        self.row_ids = order
        self.levels: List[_Level] = []
        if n == 0:
            return

        # Leaf level over packed row ranges.
        starts = np.arange(0, n, leaf_cap, dtype=np.int64)
        ends = np.minimum(starts + leaf_cap, n)
        lo = np.minimum.reduceat(self.rows, starts, axis=0)
        hi = np.maximum.reduceat(self.rows, starts, axis=0)
        self.levels.append(_Level(lo, hi, starts, ends))

        # Internal levels until a single root.
        while self.levels[-1].mbr_lo.shape[0] > 1:
            below = self.levels[-1]
            m = below.mbr_lo.shape[0]
            starts = np.arange(0, m, node_cap, dtype=np.int64)
            ends = np.minimum(starts + node_cap, m)
            lo = np.minimum.reduceat(below.mbr_lo, starts, axis=0)
            hi = np.maximum.reduceat(below.mbr_hi, starts, axis=0)
            self.levels.append(_Level(lo, hi, starts, ends))
        self.levels.reverse()  # root first

    def memory_footprint(self) -> int:
        return sum(
            lv.mbr_lo.nbytes + lv.mbr_hi.nbytes + lv.child_lo.nbytes + lv.child_hi.nbytes
            for lv in self.levels
        )

    def query(self, rect: Rect) -> np.ndarray:
        if not self.levels:
            return np.empty(0, dtype=np.int64)
        rect = np.asarray(rect, dtype=np.float64)
        q_lo, q_hi = rect[:, 0], rect[:, 1]
        cand = np.zeros(1, dtype=np.int64)  # root
        for lv in self.levels:
            lo = lv.mbr_lo[cand]
            hi = lv.mbr_hi[cand]
            # half-open query vs closed MBR: overlap iff mbr_lo < q_hi & mbr_hi >= q_lo
            ok = np.all((lo < q_hi) & (hi >= q_lo), axis=1)
            cand = cand[ok]
            if cand.size == 0:
                return np.empty(0, dtype=np.int64)
            if lv is self.levels[-1]:
                idx = gather_ranges(lv.child_lo[cand], lv.child_hi[cand])
            else:
                cand = gather_ranges(lv.child_lo[cand], lv.child_hi[cand])
        hit = rect_contains(rect, self.rows[idx])
        return np.sort(self.row_ids[idx[hit]])
