"""Synthetic datasets matching the paper's evaluation data (Table 1).

The real Airline (80M x 8, US flights 2000-2009) and OSM US-Northeast
(105M x 4) files are not redistributable offline, so these generators
reproduce their published *statistics*: dimensionality, which attribute
groups are correlated, approximate outlier mass (primary-index ratios of
92% / 73%), and the multi-cluster geography of OSM.  Row counts are scaled
by the caller (benchmarks default to a few million on CPU; pass the paper's
counts to regenerate full-scale).

Attribute layouts
-----------------
airline (8 cols):  0 Distance, 1 TimeElapsed, 2 AirTime, 3 DepTime,
                   4 ArrTime, 5 SchedArrTime, 6 DayOfWeek, 7 Carrier
  groups: (0 -> 1, 2)   distance ~ elapsed/air time   [paper §8.1.2]
          (3 -> 4, 5)   departure ~ arrival/scheduled times
osm (4 cols):      0 Id, 1 Timestamp, 2 Lat, 3 Lon
  group:  (0 -> 1)      id ~ timestamp; lat/lon form dense clusters
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["make_airline", "make_osm", "make_generic_fd", "knn_rect_queries", "Dataset"]


@dataclasses.dataclass
class Dataset:
    name: str
    data: np.ndarray              # (N, D) float32
    correlated_groups: tuple      # ground-truth group layout, for tests


def make_airline(n_rows: int = 1_000_000, seed: int = 0, outlier_frac: float = 0.08) -> Dataset:
    """8-attribute airline-like data; ~92% of rows follow the two soft FDs."""
    rng = np.random.default_rng(seed)
    n = n_rows

    distance = rng.gamma(shape=2.2, scale=420.0, size=n) + 80.0       # miles
    # Block time ~ taxi overhead + distance/speed, with per-row jitter.
    elapsed = 28.0 + distance / 7.2 + rng.normal(0.0, 7.0, n)          # minutes
    airtime = elapsed - (18.0 + rng.normal(0.0, 3.0, n))               # minus taxi

    dep = rng.uniform(300.0, 1380.0, n)                                # minutes-of-day
    arr = dep + elapsed * 0.97 + rng.normal(0.0, 9.0, n)
    sched = arr - rng.normal(4.0, 6.0, n)                              # schedule padding

    day = rng.integers(0, 7, n).astype(np.float64) + rng.uniform(0, 0.01, n)
    carrier = rng.integers(0, 14, n).astype(np.float64) + rng.uniform(0, 0.01, n)

    # Outliers: weather/diversion rows breaking the FD pattern (paper: a
    # 'considerable number of outliers' must be supported).
    n_out = int(outlier_frac * n)
    out = rng.choice(n, size=n_out, replace=False)
    half = n_out // 2
    elapsed[out[:half]] += rng.gamma(2.0, 90.0, half)                  # big delays
    arr[out[half:]] = rng.uniform(0.0, 1440.0, n_out - half)           # red-eye wraps

    data = np.stack([distance, elapsed, airtime, dep, arr, sched, day, carrier], axis=1)
    return Dataset("airline", data.astype(np.float32), ((0, 1, 2), (3, 4, 5)))


def make_osm(n_rows: int = 1_000_000, seed: int = 0, outlier_frac: float = 0.27) -> Dataset:
    """4-attribute OSM-like data; id~timestamp soft FD, clustered lat/lon.

    The paper reports a 73% primary-index ratio for OSM — bulk-imported
    regions have ids far off the id~timestamp trend, modelled here as a
    27% outlier mass with its own offset trends.
    """
    rng = np.random.default_rng(seed)
    n = n_rows

    ids = np.sort(rng.uniform(0.0, 7e9, n))
    t0 = 1.1e9
    # timestamp grows with id (sequential editing), sigma ~ weeks
    ts = t0 + ids * 0.065 + rng.normal(0.0, 3e6, n)

    n_out = int(outlier_frac * n)
    out = rng.choice(n, size=n_out, replace=False)
    # bulk imports: clusters of ids re-stamped at a handful of import dates
    import_dates = t0 + rng.uniform(0.0, 4.5e8, 12)
    ts[out] = rng.choice(import_dates, n_out) + rng.normal(0.0, 1e5, n_out)

    # dense population centres (paper: 'Latitude and Longitude coordinates
    # contain multiple dense areas')
    n_clusters = 9
    centres = np.stack(
        [rng.uniform(40.0, 47.0, n_clusters), rng.uniform(-80.0, -67.0, n_clusters)], axis=1
    )
    which = rng.integers(0, n_clusters, n)
    lat = centres[which, 0] + rng.normal(0.0, 0.35, n)
    lon = centres[which, 1] + rng.normal(0.0, 0.45, n)

    data = np.stack([ids, ts, lat, lon], axis=1)
    return Dataset("osm", data.astype(np.float32), ((0, 1),))


def make_generic_fd(
    n_rows: int,
    n_dims: int,
    fd_pairs: Tuple[Tuple[int, int], ...],
    noise: float = 0.02,
    outlier_frac: float = 0.05,
    seed: int = 0,
) -> Dataset:
    """Parametric generator for property tests: arbitrary (pred, dep) pairs."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 1000.0, size=(n_rows, n_dims))
    for pred, dep in fd_pairs:
        m = rng.uniform(0.5, 3.0) * (1 if rng.random() < 0.5 else -1)
        b = rng.uniform(-100.0, 100.0)
        data[:, dep] = m * data[:, pred] + b + rng.normal(0.0, noise * 1000.0, n_rows)
        n_out = int(outlier_frac * n_rows)
        if n_out:
            out = rng.choice(n_rows, size=n_out, replace=False)
            data[out, dep] = rng.uniform(data[:, dep].min(), data[:, dep].max(), n_out)
    return Dataset("generic", data.astype(np.float32), tuple((p, d) for p, d in fd_pairs))


def knn_rect_queries(
    data: np.ndarray,
    n_queries: int,
    k: int,
    seed: int = 0,
    sample_cap: int = 200_000,
) -> np.ndarray:
    """Paper §8.1.2 query workload: pick a random record, take its K nearest
    records, and use the per-dimension min/max of that neighbourhood as the
    query rectangle.  Selectivity is controlled by K.

    KNN runs on a normalised subsample (exact KNN over 100M rows is not the
    point of the workload; the paper's queries target realistic local boxes).
    Returns (Q, D, 2) rects.
    """
    rng = np.random.default_rng(seed)
    n, d = data.shape
    sub = data[rng.choice(n, size=min(sample_cap, n), replace=False)].astype(np.float64)
    scale = sub.std(axis=0)
    scale[scale == 0.0] = 1.0
    sub_n = sub / scale

    centres = data[rng.choice(n, size=n_queries, replace=True)].astype(np.float64)
    rects = np.empty((n_queries, d, 2), dtype=np.float64)
    k_eff = min(k, sub.shape[0])
    for i, c in enumerate(centres):
        dist = np.einsum("nd,nd->n", sub_n - c / scale, sub_n - c / scale)
        nn = np.argpartition(dist, k_eff - 1)[:k_eff]
        pts = sub[nn]
        rects[i, :, 0] = pts.min(axis=0)
        rects[i, :, 1] = np.nextafter(pts.max(axis=0), np.inf)
    return rects
