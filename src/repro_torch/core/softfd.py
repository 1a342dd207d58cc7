"""Soft functional dependency detection and model learning (paper §5, Alg. 1).

Pipeline
--------
1. ``bucket_centres``     — Algorithm 1's grid bucketing: draw a sample, overlay a
   ``bucket_chunks x bucket_chunks`` grid over an attribute pair, drop sparse
   cells, and return the *weighted centres* of the dense cells.  This is the
   (small) training set for the regression.
2. ``bayes_linear_regress`` — conjugate Bayesian linear regression (ridge) on the
   weighted centres.  The paper uses pymc3; for a linear-Gaussian model the
   posterior mean is available in closed form, and the sufficient statistics
   (X'X, X'y) support the paper's incremental-update story directly.
3. ``fit_pair``           — fit one candidate pair, choose margins from residual
   quantiles, Monte-Carlo stability check (paper: "use a Monte Carlo sampler to
   check whether a linear model fits").
4. ``detect_soft_fds``    — scan all unique ordered pairs, keep predictable ones.
5. ``merge_groups``       — union-find merge of pairs sharing attributes; pick the
   predictor that best explains the rest of its group (paper §5 last step).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import FDGroup, FDPair, LinearModel

__all__ = [
    "SoftFDConfig",
    "bucket_centres",
    "bayes_linear_regress",
    "BayesianLinearModel",
    "fit_pair",
    "detect_soft_fds",
    "merge_groups",
    "learn_soft_fds",
]


@dataclasses.dataclass(frozen=True)
class SoftFDConfig:
    """Tuning knobs of Algorithm 1 (paper §5: 'accuracy and runtime of the
    learning step can be adjusted by tuning parameters')."""

    sample_count: int = 32_768      # rows sampled for detection
    bucket_chunks: int = 64         # grid resolution per axis
    cell_threshold: Optional[int] = None  # min hits for a 'dense' cell;
                                    # None -> 2x the uniform-average density
    margin_cover: float = 0.995     # fraction of DENSE rows the margin covers
    max_width_frac: float = 0.35    # accept FD if margin width < frac * range(dep)
    mc_rounds: int = 5              # Monte-Carlo stability fits
    mc_slope_tol: float = 0.25      # max coefficient of variation of the slope
    ridge_lambda: float = 1e-6      # prior precision of the Bayesian regression
    robust_rounds: int = 2          # MAD-trimmed refit rounds after bucket fit
    robust_k: float = 6.0           # trim radius in robust sigmas
    seed: int = 0


# ---------------------------------------------------------------------------
# Step 1: grid bucketing (Algorithm 1, first half)
# ---------------------------------------------------------------------------

def bucket_centres(
    x: np.ndarray,
    d: np.ndarray,
    bucket_chunks: int,
    cell_threshold: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Weighted centres of dense grid cells for the pair (x, d).

    Returns ``(cx, cd, w, dense_rows)``: cell-centre coordinates, their counts,
    and a per-row mask of rows that landed in a dense cell.  Mirrors Algorithm
    1; empty/sparse cells are dropped (paper Fig. 3), which is also what makes
    the margin estimate robust to outlier mass — margins are drawn around the
    dense band, not around stragglers.

    ``cell_threshold=None`` auto-scales to twice the uniform-average density,
    so a 27%-outlier dataset (OSM) still isolates its main trend.
    """
    x = np.asarray(x, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    x_lo, x_hi = float(x.min()), float(x.max())
    d_lo, d_hi = float(d.min()), float(d.max())
    wx = (x_hi - x_lo) / bucket_chunks or 1.0
    wd = (d_hi - d_lo) / bucket_chunks or 1.0

    ix = np.clip(((x - x_lo) / wx).astype(np.int64), 0, bucket_chunks - 1)
    id_ = np.clip(((d - d_lo) / wd).astype(np.int64), 0, bucket_chunks - 1)
    flat = ix * bucket_chunks + id_
    counts = np.bincount(flat, minlength=bucket_chunks * bucket_chunks)

    if cell_threshold is None:
        avg = x.size / float(bucket_chunks * bucket_chunks)
        cell_threshold = max(4, int(2.0 * avg))
    dense_cells = counts > cell_threshold
    if not dense_cells.any():  # fall back: keep every non-empty cell
        dense_cells = counts > 0
    dense = np.nonzero(dense_cells)[0]
    ci = dense // bucket_chunks
    cj = dense % bucket_chunks
    cx = x_lo + (ci + 0.5) * wx
    cd = d_lo + (cj + 0.5) * wd
    return cx, cd, counts[dense].astype(np.float64), dense_cells[flat]


# ---------------------------------------------------------------------------
# Step 2: conjugate Bayesian linear regression
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BayesianLinearModel:
    """Conjugate Gaussian linear regression with sufficient statistics.

    Prior: weights ~ N(0, (lambda I)^-1).  Posterior mean given weighted data
    is the ridge solution; ``update`` folds in new observations without
    refitting from scratch — this is what makes the index updatable (paper §5:
    'we can use the previous gradient and intersect and continuously adjust
    our existing model').
    """

    xtx: np.ndarray  # (2, 2) accumulated design-matrix Gram
    xty: np.ndarray  # (2,)   accumulated cross moment
    lam: float = 1e-6

    @classmethod
    def empty(cls, lam: float = 1e-6) -> "BayesianLinearModel":
        return cls(np.zeros((2, 2)), np.zeros(2), lam)

    def update(self, x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None) -> None:
        # closed-form Gram sums: the design matrix is [x, 1], so the five
        # moments below ARE Xw.T @ X and Xw.T @ y — no (n, 2) stack/matmul
        # per call (this runs on every insert's drift-tracker update)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if w is None:
            sw, sx, sxx = float(x.size), float(x.sum()), float(x @ x)
            sy, sxy = float(y.sum()), float(x @ y)
        else:
            w = np.asarray(w, dtype=np.float64)
            wx = w * x
            sw, sx, sxx = float(w.sum()), float(wx.sum()), float(wx @ x)
            sy, sxy = float(w @ y), float(wx @ y)
        self.xtx[0, 0] += sxx
        self.xtx[0, 1] += sx
        self.xtx[1, 0] += sx
        self.xtx[1, 1] += sw
        self.xty[0] += sxy
        self.xty[1] += sy

    def posterior_mean(self) -> Tuple[float, float]:
        # 2x2 ridge solve by Cramer's rule — ``np.linalg.solve`` costs ~40us
        # of LAPACK dispatch per call, and ``drift_predictability`` evaluates
        # every tracker on every amortized trigger check
        a = self.xtx[0, 0] + self.lam
        b = self.xtx[0, 1]
        c = self.xtx[1, 0]
        d = self.xtx[1, 1] + self.lam
        det = a * d - b * c
        if det == 0.0:
            A = self.xtx + self.lam * np.eye(2)
            m, b = np.linalg.solve(A, self.xty)
            return float(m), float(b)
        t0, t1 = self.xty[0], self.xty[1]
        return float((d * t0 - b * t1) / det), float((a * t1 - c * t0) / det)


def bayes_linear_regress(
    x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None, lam: float = 1e-6
) -> Tuple[float, float]:
    """One-shot weighted Bayesian-ridge fit; returns (slope, intercept)."""
    blm = BayesianLinearModel.empty(lam)
    blm.update(x, y, w)
    return blm.posterior_mean()


# ---------------------------------------------------------------------------
# Step 3: fit one candidate pair with margins + Monte-Carlo stability check
# ---------------------------------------------------------------------------

def _margins_from_residuals(resid: np.ndarray, cover: float) -> Tuple[float, float]:
    """Asymmetric margins (eps_lb, eps_ub) covering ``cover`` of residuals.

    The margins are the paper's two parallel separator lines (Fig. 1): the
    tightest [lo, hi] quantile band of the displacement distribution that keeps
    ``cover`` of the rows in the primary index.
    """
    alpha = 1.0 - cover
    lo = np.quantile(resid, alpha / 2.0)
    hi = np.quantile(resid, 1.0 - alpha / 2.0)
    # eps_lb is a magnitude (inlier iff resid >= -eps_lb), so negate lo.
    eps_lb = max(-float(lo), 0.0)
    eps_ub = max(float(hi), 0.0)
    # Never emit an exactly-zero band: float32 data needs breathing room.
    span = float(resid.max() - resid.min()) or 1.0
    pad = 1e-7 * span
    return eps_lb + pad, eps_ub + pad


def fit_pair(
    x: np.ndarray,
    d: np.ndarray,
    cfg: SoftFDConfig,
    rng: np.random.Generator,
) -> Optional[Tuple[LinearModel, float, float]]:
    """Fit ``d ~ m x + b`` on bucketed centres; return (model, score, inlier_frac).

    Returns None when the pair fails the Monte-Carlo stability check or the
    predictability (width) criterion — i.e., no usable soft FD.
    """
    cx, cd, w, dense_rows = bucket_centres(x, d, cfg.bucket_chunks, cfg.cell_threshold)
    if cx.size < 4:
        return None
    m, b = bayes_linear_regress(cx, cd, w, cfg.ridge_lambda)

    d_range = float(d.max() - d.min())
    x_range = float(x.max() - x.min())
    if d_range == 0.0 or x_range == 0.0:
        return None  # constant attribute: trivially dependent, nothing to index
    # A near-flat model cannot translate dependent-attribute constraints into
    # selective predictor ranges (S-box base ~ (q + 2eps)/|m| -> inf).
    if abs(m) * x_range < 1e-3 * d_range:
        return None

    # Monte-Carlo stability: refit on random half-samples of the centres and
    # require a stable slope (coefficient of variation below tolerance).
    slopes = []
    for _ in range(cfg.mc_rounds):
        take = rng.random(cx.size) < 0.5
        if take.sum() < 4:
            continue
        mi, _ = bayes_linear_regress(cx[take], cd[take], w[take], cfg.ridge_lambda)
        slopes.append(mi)
    if len(slopes) >= 2:
        s = np.asarray(slopes)
        scale = max(abs(m), 1e-12)
        if float(s.std() / scale) > cfg.mc_slope_tol:
            return None

    # Margins from the residuals of DENSE-cell rows only (Fig. 3: the margin is
    # set by 'the density of the data records around the model'); sparse-cell
    # rows are exactly the outliers the margin should NOT chase.  On top of the
    # bucket filter, a couple of MAD-trimmed refits remove dense-but-off-trend
    # bands (e.g. OSM bulk-import timestamp rows) that survive any fixed cell
    # threshold — robust regression in the paper's 'Bayesian method' spirit.
    resid = d - (m * x + b)
    sel = dense_rows
    for _ in range(cfg.robust_rounds):
        r = resid[sel]
        if r.size < 16:
            break
        med = float(np.median(r))
        mad = float(np.median(np.abs(r - med))) * 1.4826 + 1e-12
        keep = np.abs(resid - med) < cfg.robust_k * mad
        new_sel = dense_rows & keep
        if new_sel.sum() < 16:
            break
        sel = new_sel
        m, b = bayes_linear_regress(x[sel], d[sel], lam=cfg.ridge_lambda)
        resid = d - (m * x + b)
    # Margins cover every row inside the robust band (not only dense-cell
    # rows): the bucket filter is a FIT robustness device; restricting the
    # margin to dense cells would under-cover heavy-tailed-but-legitimate
    # residual mass and needlessly inflate the outlier index.
    r_sel = resid[sel]
    if r_sel.size < 4:
        return None
    med = float(np.median(r_sel))
    mad = float(np.median(np.abs(r_sel - med))) * 1.4826 + 1e-12
    in_band = np.abs(resid - med) < cfg.robust_k * mad
    resid_band = resid[in_band]
    if resid_band.size < 4:
        return None
    eps_lb, eps_ub = _margins_from_residuals(resid_band, cfg.margin_cover)
    model = LinearModel(m=m, b=b, eps_lb=eps_lb, eps_ub=eps_ub)
    width = model.width
    score = width / d_range
    if score > cfg.max_width_frac:
        return None
    inlier_frac = float(model.inlier_mask(x, d).mean())
    return model, score, inlier_frac


# ---------------------------------------------------------------------------
# Steps 4-5: detect over all pairs, merge into groups, pick predictors
# ---------------------------------------------------------------------------

def detect_soft_fds(
    data: np.ndarray,
    cfg: SoftFDConfig = SoftFDConfig(),
    candidate_dims: Optional[Sequence[int]] = None,
) -> List[FDPair]:
    """Scan unique attribute pairs of a sample for soft FDs (paper §5)."""
    rng = np.random.default_rng(cfg.seed)
    n, n_dims = data.shape
    dims = list(candidate_dims) if candidate_dims is not None else list(range(n_dims))

    take = rng.choice(n, size=min(cfg.sample_count, n), replace=False)
    sample = np.asarray(data[take], dtype=np.float64)

    pairs: List[FDPair] = []
    for i, j in itertools.combinations(dims, 2):
        # Try both directions; keep the more predictable one (smaller width).
        best: Optional[FDPair] = None
        for pred, dep in ((i, j), (j, i)):
            out = fit_pair(sample[:, pred], sample[:, dep], cfg, rng)
            if out is None:
                continue
            model, score, frac = out
            cand = FDPair(pred=pred, dep=dep, model=model, score=score, inlier_frac=frac)
            if best is None or cand.score < best.score:
                best = cand
        if best is not None:
            pairs.append(best)
    return pairs


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def merge_groups(
    pairs: Sequence[FDPair],
    data: np.ndarray,
    cfg: SoftFDConfig = SoftFDConfig(),
) -> List[FDGroup]:
    """Union-find merge of FD pairs; one predictor per group (paper §5).

    The predictor of a group is the member attribute whose models to every
    other member have the smallest total normalised width — i.e., the best
    single explainer.  Models predictor->dependent are then (re)fit on a data
    sample for each dependent.

    Over-merge recovery: union-find is transitive, so a single weak bridge
    pair (e.g. minted by a burst of FD-violating rows inflating a column's
    range) can fuse two unrelated groups into one component that no single
    predictor explains.  When that happens we keep the best sub-star and
    requeue the unexplained members as their own component rather than
    silently dropping them — so a ~1% contamination burst costs at most the
    bridge pair, never a whole group's worth of eliminated dims
    (DESIGN.md §5.2).
    """
    if not pairs:
        return []
    n_dims = data.shape[1]
    uf = _UnionFind(n_dims)
    in_any = set()
    for p in pairs:
        uf.union(p.pred, p.dep)
        in_any.add(p.pred)
        in_any.add(p.dep)

    members: Dict[int, List[int]] = {}
    for a in sorted(in_any):
        members.setdefault(uf.find(a), []).append(a)

    rng = np.random.default_rng(cfg.seed + 1)
    n = data.shape[0]
    take = rng.choice(n, size=min(cfg.sample_count, n), replace=False)
    sample = np.asarray(data[take], dtype=np.float64)

    groups: List[FDGroup] = []
    work: List[List[int]] = [mem for mem in members.values() if len(mem) >= 2]
    while work:
        mem = work.pop(0)
        # Score each candidate predictor by the total width of its models.
        best_pred, best_cost, best_models = -1, np.inf, None
        for pred in mem:
            cost = 0.0
            models: Dict[int, LinearModel] = {}
            ok = True
            for dep in mem:
                if dep == pred:
                    continue
                out = fit_pair(sample[:, pred], sample[:, dep], cfg, rng)
                if out is None:
                    ok = False
                    break
                model, score, _ = out
                models[dep] = model
                cost += score
            if ok and cost < best_cost:
                best_pred, best_cost, best_models = pred, cost, models
        if best_models is None:
            # No single predictor covers the whole component: the union-find
            # over-merged on a weak bridge pair.  Keep the best sub-star
            # (largest; total width breaks ties) and requeue the unexplained
            # members so their own group survives the bridge.
            star: Dict[int, Dict[int, LinearModel]] = {}
            star_cost: Dict[int, float] = {}
            for pred in mem:
                models = {}
                cost = 0.0
                for dep in mem:
                    if dep == pred:
                        continue
                    out = fit_pair(sample[:, pred], sample[:, dep], cfg, rng)
                    if out is not None:
                        models[dep] = out[0]
                        cost += out[1]
                if models:
                    star[pred] = models
                    star_cost[pred] = cost
            if not star:
                continue
            best_pred = max(star, key=lambda p: (len(star[p]), -star_cost[p]))
            best_models = star[best_pred]
            leftover = [a for a in mem
                        if a != best_pred and a not in best_models]
            if len(leftover) >= 2:
                work.append(leftover)
        groups.append(
            FDGroup(
                predictor=best_pred,
                dependents=tuple(sorted(best_models)),
                models=best_models,
            )
        )
    return groups


def learn_soft_fds(
    data: np.ndarray,
    cfg: SoftFDConfig = SoftFDConfig(),
    candidate_dims: Optional[Sequence[int]] = None,
) -> List[FDGroup]:
    """End-to-end: detect pairs, merge into predictor groups.

    Degenerate inputs (fewer rows than a bucket fit can support — empty
    shards of a partitioned build, freshly emptied indexes) learn nothing:
    every dim stays indexed and the caller's primary grid holds all rows.
    """
    if data.shape[0] < 8:
        return []
    pairs = detect_soft_fds(data, cfg, candidate_dims)
    return merge_groups(pairs, data, cfg)
