"""Theoretical results of the paper (§7 + Appendix) and their empirical
counterparts, used by ``benchmarks/bench_theory.py`` and the property tests.

Closed forms
------------
* Eq. 5   effectiveness               = q_y / (2 eps + q_y)
* Thm 7.1 E[keys per linear segment]  = eps^2 / sigma^2        (MET)
* Thm 7.2 optimal slope               = mu (mean gap); drifted MET closed form
* Thm 7.3 Var[keys per segment]       = 2 eps^4 / (3 sigma^4)
* Thm 7.4 segments for n keys         -> n sigma^2 / eps^2

Empirical counterparts simulate the random walk of Appendix C (gaps G_i i.i.d.,
transformed walk Z_i = sum(G_j - a)) and run the greedy segment-splitting
process of Appendix F so the theory can be validated against measurement.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "effectiveness",
    "scanned_area",
    "result_area",
    "met_expectation",
    "met_drifted_expectation",
    "met_variance",
    "expected_segments",
    "simulate_met",
    "greedy_segment_count",
]


# ----------------------------- §7.1 ---------------------------------------- #

def result_area(q_y: float, eps: float, slope: float) -> float:
    """S_r (Eq. 3): area of the result R-box for a Y-only range query."""
    return q_y * 2.0 * eps / slope


def scanned_area(q_y: float, eps: float, slope: float) -> float:
    """S_s (Eq. 4): area of the scanned S-box."""
    return 2.0 * eps * (2.0 * eps + q_y) / slope


def effectiveness(q_y: float, eps: float) -> float:
    """Eq. 5: S_r / S_s = q_y / (2 eps + q_y); ->1 as eps->0."""
    return q_y / (2.0 * eps + q_y)


# ----------------------------- §7.2 ---------------------------------------- #

def met_expectation(eps: float, sigma: float) -> float:
    """Thm 7.1: expected keys covered by a segment with slope mu."""
    return (eps / sigma) ** 2


def met_drifted_expectation(eps: float, sigma: float, drift: float) -> float:
    """Proof of Thm 7.2 (Eq. 14): MET with slope mismatch d = mu - a.

    T(0) = (eps/d) * tanh(eps*d/sigma^2); reduces to eps^2/sigma^2 as d->0.
    """
    if abs(drift) < 1e-12:
        return met_expectation(eps, sigma)
    return (eps / drift) * np.tanh(eps * drift / sigma**2)


def met_variance(eps: float, sigma: float) -> float:
    """Thm 7.3: variance of keys covered by a segment."""
    return 2.0 * eps**4 / (3.0 * sigma**4)


def expected_segments(n: int, eps: float, sigma: float) -> float:
    """Thm 7.4: segments needed to cover a stream of n keys."""
    return n * (sigma / eps) ** 2


# --------------------------- simulations ----------------------------------- #

def simulate_met(
    eps: float,
    sigma: float,
    mu: float = 1.0,
    slope: float = None,
    trials: int = 512,
    max_steps: int = 1_000_000,
    seed: int = 0,
) -> Tuple[float, float]:
    """Monte-Carlo mean/variance of the exit time of the transformed walk
    Z_i = sum_j (G_j - a) from the strip [-eps, +eps] (Appendix C).

    Gaps are N(mu, sigma) truncated positive; slope ``a`` defaults to mu
    (Thm 7.2's optimum).
    """
    a = mu if slope is None else slope
    rng = np.random.default_rng(seed)
    exits = np.zeros(trials, dtype=np.int64)
    # vectorised batched walk: step all trials until everyone exits
    z = np.zeros(trials)
    alive = np.ones(trials, dtype=bool)
    steps = 0
    while alive.any() and steps < max_steps:
        steps += 1
        g = rng.normal(mu, sigma, size=trials)
        z = np.where(alive, z + (g - a), z)
        exited = alive & (np.abs(z) > eps)
        exits[exited] = steps
        alive &= ~exited
    exits[alive] = max_steps
    return float(exits.mean()), float(exits.var())


def greedy_segment_count(gaps: np.ndarray, eps: float, slope: float = None) -> int:
    """Appendix F's renewal process: start a new segment as soon as the walk
    leaves the +-eps strip; returns the number of segments for the stream."""
    gaps = np.asarray(gaps, dtype=np.float64)
    a = float(gaps.mean()) if slope is None else slope
    z = 0.0
    segments = 1
    for g in gaps:
        z += g - a
        if abs(z) > eps:
            segments += 1
            z = 0.0
    return segments
