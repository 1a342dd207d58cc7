"""COAX query translation (paper §4, Eq. 2).

A constraint on a *dependent* attribute ``Cd in [lo, hi)`` is mapped through the
inverse soft-FD model onto the *indexed* (predictor) attribute ``Cx``.  Because
every primary-index record satisfies

    m*x + b - eps_lb  <=  d  <=  m*x + b + eps_ub          (Eq. 1)

a record can only match ``d >= lo`` if ``m*x + b + eps_ub >= lo`` and can only
match ``d < hi`` if ``m*x + b - eps_lb < hi``.  Solving for x (slope sign aware)
gives the translated interval; the final constraint on x is the INTERSECTION of
the translated interval and any direct constraint on x (Eq. 2 / Fig. 2).

Translation over-approximates: the scanned S-box contains but may exceed the
result R-box (paper §7.1), so the engine must still apply the original full
predicate to scanned rows.  These helpers are pure numpy host code.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .types import FDGroup, LinearModel, Rect

__all__ = [
    "translate_dependent_interval",
    "translate_rect",
    "translate_rects",
    "reduced_dims",
]


def translate_dependent_interval(
    model: LinearModel, lo: float, hi: float
) -> Tuple[float, float]:
    """Map a dependent-attribute interval [lo, hi) to predictor space.

    Returns the (x_lo, x_hi) interval outside which NO primary-index record can
    satisfy the dependent constraint.  Handles both slope signs; a zero slope
    never reaches here (detection rejects near-flat models).
    """
    m, b = model.m, model.b
    # Record matches only if  m*x + b + eps_ub >= lo  AND  m*x + b - eps_lb <= hi.
    lo_numer = lo - b - model.eps_ub
    hi_numer = hi - b + model.eps_lb
    if m > 0:
        return lo_numer / m, hi_numer / m
    return hi_numer / m, lo_numer / m  # slope < 0 flips the interval


def translate_rect(rect: Rect, groups: Sequence[FDGroup], keep_dims: Sequence[int]) -> Rect:
    """Project a full-dimensional query rect onto the indexed dimensions.

    For every FD group, each constrained dependent contributes a translated
    interval on the group's predictor; all intervals (plus the predictor's own
    direct constraint) are intersected (Eq. 2).  Constraints on dims in
    ``keep_dims`` pass through unchanged.

    Returns a (len(keep_dims), 2) rect in the order of ``keep_dims``.
    """
    rect = np.asarray(rect, dtype=np.float64)
    n_dims = rect.shape[0]
    lo = rect[:, 0].copy()
    hi = rect[:, 1].copy()

    # Start from the direct constraints on the kept dims.
    out_lo = {d: lo[d] for d in keep_dims}
    out_hi = {d: hi[d] for d in keep_dims}

    for g in groups:
        p = g.predictor
        if p not in out_lo:  # predictor not indexed (shouldn't happen) -> skip
            continue
        for d in g.dependents:
            if not (np.isfinite(lo[d]) or np.isfinite(hi[d])):
                continue  # dependent unconstrained: nothing to translate
            t_lo, t_hi = translate_dependent_interval(g.models[d], lo[d], hi[d])
            out_lo[p] = max(out_lo[p], t_lo)
            out_hi[p] = min(out_hi[p], t_hi)

    reduced = np.empty((len(keep_dims), 2), dtype=np.float64)
    for k, d in enumerate(keep_dims):
        reduced[k, 0] = out_lo[d]
        reduced[k, 1] = max(out_hi[d], out_lo[d])  # keep lo<=hi (empty range ok)
    return reduced


def translate_rects(
    rects: np.ndarray, groups: Sequence[FDGroup], keep_dims: Sequence[int]
) -> np.ndarray:
    """Batched Eq. 2: project B full rects onto the indexed dims at once.

    ``rects`` is (B, D, 2); returns (B, len(keep_dims), 2) nav-rects in
    ``keep_dims`` order — BIT-identical to ``translate_rect`` applied per
    row (the property test in ``tests/test_exactness_props.py`` holds the
    two to that), but one vectorised pass over the batch (the batched
    engine's translation stage).

    A dependent with no finite bound is skipped per query, mirroring the
    scalar path: a fully unconstrained dependent ``(-inf, +inf)`` would
    translate to a no-op interval anyway, while a degenerate all-infinite
    constraint like ``[+inf, +inf)`` must not clamp the nav-rect the
    scalar path leaves open.
    """
    rects = np.asarray(rects, dtype=np.float64)
    if rects.ndim != 3 or rects.shape[-1] != 2:
        raise ValueError(f"rects must be (B, D, 2), got {rects.shape}")
    lo = rects[:, :, 0]                               # (B, D)
    hi = rects[:, :, 1]

    keep = list(keep_dims)
    pos = {d: k for k, d in enumerate(keep)}
    out_lo = lo[:, keep].copy()                       # (B, K) direct constraints
    out_hi = hi[:, keep].copy()

    for g in groups:
        if g.predictor not in pos:                    # predictor not indexed
            continue
        k = pos[g.predictor]
        for d in g.dependents:
            mdl = g.models[d]
            lo_numer = lo[:, d] - mdl.b - mdl.eps_ub  # (B,)
            hi_numer = hi[:, d] - mdl.b + mdl.eps_lb
            if mdl.m > 0:
                t_lo, t_hi = lo_numer / mdl.m, hi_numer / mdl.m
            else:
                t_lo, t_hi = hi_numer / mdl.m, lo_numer / mdl.m
            # same per-query skip as the scalar path: only a dependent with
            # a finite bound constrains the predictor
            con = np.isfinite(lo[:, d]) | np.isfinite(hi[:, d])
            out_lo[:, k] = np.where(con, np.maximum(out_lo[:, k], t_lo),
                                    out_lo[:, k])
            out_hi[:, k] = np.where(con, np.minimum(out_hi[:, k], t_hi),
                                    out_hi[:, k])

    out_hi = np.maximum(out_hi, out_lo)               # keep lo<=hi (empty ok)
    return np.stack([out_lo, out_hi], axis=-1)


def reduced_dims(n_dims: int, groups: Sequence[FDGroup]) -> List[int]:
    """Indexed (kept) dimensions: everything that is not a dependent."""
    dropped = {d for g in groups for d in g.dependents}
    return [d for d in range(n_dims) if d not in dropped]
