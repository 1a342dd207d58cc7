"""Core value types shared across the COAX index stack.

Conventions
-----------
* A *dataset* is a float32 ndarray of shape (N, D): N records, D attributes.
* A *rect* (query rectangle) is a float ndarray of shape (D, 2): column 0 is the
  inclusive-exclusive lower bound, column 1 the upper bound, i.e. the query is
  ``lo <= x < hi`` per dimension... the paper uses open ranges ``lo < x < hi``;
  we standardise on half-open ``lo <= x < hi`` which composes cleanly with
  ``searchsorted`` semantics and makes point queries expressible as
  ``[v, nextafter(v)]``.  Unconstrained dimensions use ``(-inf, +inf)``.
* Batched queries are (Q, D, 2).
* Query answers are sorted int64 arrays of *original row ids* so result-set
  equality across engines is exact set equality.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "LinearModel",
    "FDPair",
    "FDGroup",
    "Rect",
    "full_rect",
    "point_rect",
    "rect_contains",
    "sorted_contains",
    "split_hits",
    "validate_rect",
]

Rect = np.ndarray  # (D, 2)


@dataclasses.dataclass(frozen=True)
class LinearModel:
    """A soft-FD model ``dep ~= m * pred + b`` with asymmetric error margins.

    Inlier condition (Eq. 1 of the paper):
        ``-eps_lb <= dep - (m * pred + b) <= eps_ub``
    """

    m: float
    b: float
    eps_lb: float
    eps_ub: float

    def predict(self, x):
        return self.m * x + self.b

    def displacement(self, x, d):
        """Residual of ``d`` against the model prediction at ``x``."""
        return d - (self.m * x + self.b)

    def inlier_mask(self, x, d):
        r = self.displacement(x, d)
        return (r >= -self.eps_lb) & (r <= self.eps_ub)

    @property
    def width(self) -> float:
        return float(self.eps_lb + self.eps_ub)


@dataclasses.dataclass(frozen=True)
class FDPair:
    """A detected soft functional dependency ``pred -> dep``."""

    pred: int
    dep: int
    model: LinearModel
    score: float          # normalised margin width; lower = more predictable
    inlier_frac: float    # fraction of the detection sample inside the margin


@dataclasses.dataclass
class FDGroup:
    """A merged group of correlated attributes with one predictor.

    ``models[d]`` maps the predictor's value to dependent attribute ``d``.
    """

    predictor: int
    dependents: Tuple[int, ...]
    models: Dict[int, LinearModel]

    def inlier_mask(self, data: np.ndarray) -> np.ndarray:
        """Rows satisfying *every* dependent's margin in this group."""
        x = data[:, self.predictor]
        mask = np.ones(data.shape[0], dtype=bool)
        for d in self.dependents:
            mask &= self.models[d].inlier_mask(x, data[:, d])
        return mask


def full_rect(n_dims: int) -> Rect:
    r = np.empty((n_dims, 2), dtype=np.float64)
    r[:, 0] = -np.inf
    r[:, 1] = np.inf
    return r


def point_rect(point: np.ndarray) -> Rect:
    """A degenerate rectangle matching exactly ``point`` (paper §8.1.2)."""
    p = np.asarray(point, dtype=np.float64)
    return np.stack([p, np.nextafter(p, np.inf)], axis=-1)


def rect_contains(rect: Rect, data: np.ndarray) -> np.ndarray:
    """Boolean mask of rows of ``data`` inside ``rect`` (half-open per dim)."""
    lo, hi = rect[:, 0], rect[:, 1]
    return np.all((data >= lo) & (data < hi), axis=-1)


def sorted_contains(haystack: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Membership mask of ``values`` in a SORTED ``haystack``.

    ``np.isin`` re-sorts the larger operand on every call — O(n log n) per
    lookup against a 50k-id base array; binary search against the already-
    sorted array is O(m log n), the difference between the write path
    scaling with the base size or not (DESIGN.md §5.1).
    """
    values = np.asarray(values)
    if haystack.size == 0 or values.size == 0:
        return np.zeros(values.shape, dtype=bool)
    pos = np.searchsorted(haystack, values)
    pos[pos == haystack.size] = haystack.size - 1
    return haystack[pos] == values


def split_hits(qids: np.ndarray, row_ids: np.ndarray,
               n_queries: int) -> List[np.ndarray]:
    """Flat (query_id, row_id) hit list -> one row-id array per query.

    ``qids`` must be sorted ascending (the ``query_batch`` contract).
    """
    bounds = np.searchsorted(qids, np.arange(n_queries + 1))
    return [row_ids[bounds[i]:bounds[i + 1]] for i in range(n_queries)]


def validate_rect(rect: Rect, n_dims: int) -> Rect:
    rect = np.asarray(rect, dtype=np.float64)
    if rect.shape != (n_dims, 2):
        raise ValueError(f"rect must be ({n_dims}, 2), got {rect.shape}")
    if np.any(rect[:, 0] > rect[:, 1]):
        raise ValueError("rect has lo > hi")
    return rect
