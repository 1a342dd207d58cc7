"""Grid-file index with quantile-aligned boundaries and an in-cell sorted
dimension (paper §6, building on Nievergelt et al.'s Grid File [29]).

Modifications from the classic grid file, per the paper:
  * grid lines are chosen from per-dimension QUANTILES (CDF-aligned), the same
    number of lines per attribute;
  * cell addresses are flattened in the original attribute order;
  * each cell's records live in one contiguous block (row-store);
  * rows inside a cell are SORTED on one attribute, so that attribute needs no
    grid lines (binary search instead) — the index loses one grid dimension.

A grid over ``g`` of the indexed dims with one sorted dim indexes
``len(index_dims) - 1`` dimensions, which is how COAX reaches ``n - m - 1``
grid dimensions overall (§6).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from .types import Rect, rect_contains

__all__ = ["GridFile", "BatchStats", "gather_ranges", "fit_cells_per_dim",
           "batched_searchsorted"]


def batched_searchsorted(vals: np.ndarray, blk_lo: np.ndarray,
                         blk_hi: np.ndarray, target,
                         side: str = "left",
                         vals_finite: bool = False) -> np.ndarray:
    """Vectorised per-segment ``searchsorted``.

    For each segment ``[blk_lo[i], blk_hi[i])`` of the globally cell-sorted
    ``vals``, find the insertion point of ``target`` — one binary search run
    simultaneously across every candidate cell (log2(max block) vectorised
    iterations instead of a Python loop per cell; the C implementation's
    per-cell bisect equivalent, DESIGN.md §3).

    ``target`` may be a scalar (one query) or an array aligned with
    ``blk_lo`` (per-segment targets — the batched engine searches every
    (query, cell) pair in one pass).  ``-inf``/``+inf`` targets degenerate
    to ``blk_lo``/``blk_hi`` respectively, i.e. "no constraint" — when the
    whole target is ±inf the loop is skipped outright (the +inf exit needs
    ``vals_finite=True``, a fact callers can certify once at build time,
    because a stored +inf would be a valid insertion point before the end).
    Converged lanes mask their gather index to 0 instead of re-reading
    ``vals`` every iteration — the gather is this loop's hot instruction.
    """
    lo = blk_lo.astype(np.int64).copy()
    hi = blk_hi.astype(np.int64).copy()
    t = np.asarray(target)
    if side == "left" and t.size:
        if np.all(np.isneginf(t)):
            return lo                               # insert at segment start
        if vals_finite and np.all(np.isposinf(t)):
            return np.where(lo < hi, hi, lo)        # insert at segment end
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) // 2
        mv = vals[np.where(active, mid, 0)]         # gather live lanes only
        if side == "left":
            go_right = active & (mv < target)
        else:
            go_right = active & (mv <= target)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)


def f32_ceil(x: np.ndarray) -> np.ndarray:
    """Smallest float32 >= x, elementwise (float64 in, float32 out).

    Lets the batched row filter compare float32 records against float64 rect
    bounds entirely in float32: for any float32 ``v`` and float64 bound ``c``,
    ``v >= c  <=>  v >= f32_ceil(c)`` and ``v < c  <=>  v < f32_ceil(c)``,
    because no float32 lies strictly between a float64 and its float32
    round-up.  Infinities pass through.
    """
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(over="ignore"):
        y = x.astype(np.float32)
        rounded_down = y.astype(np.float64) < x
        # nextafter past f32 max overflows to +inf — the correct ceil there
        return np.where(rounded_down, np.nextafter(y, np.float32(np.inf)), y)


def gather_ranges(los: np.ndarray, his: np.ndarray,
                  lens: Optional[np.ndarray] = None) -> np.ndarray:
    """Concatenate ``arange(lo, hi)`` for many (lo, hi) pairs, vectorised.

    ``lens`` may be supplied when the caller has already computed the
    clamped lengths ``maximum(his - los, 0)`` (the batched query path needs
    them anyway for its query-id expansion) so the (query, cell) expansion
    does a single pass over the pairs.
    """
    los = np.asarray(los, dtype=np.int64)
    his = np.asarray(his, dtype=np.int64)
    if lens is None:
        lens = np.maximum(his - los, 0)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.repeat(los - cum, lens) + np.arange(total, dtype=np.int64)


def fit_cells_per_dim(n_grid_dims: int, budget_cells: int) -> int:
    """Largest per-dim cell count whose directory stays within budget.

    Implements the paper's §8.2.1 rule: 'we limit any index that would require
    more memory overhead for its index directory than memory occupied by the
    underlying data itself'.
    """
    if n_grid_dims == 0:
        return 1
    c = max(int(budget_cells ** (1.0 / n_grid_dims)), 1)
    while (c + 1) ** n_grid_dims <= budget_cells:
        c += 1
    return c


@dataclasses.dataclass
class _QueryStats:
    cells_probed: int = 0
    rows_scanned: int = 0
    rows_matched: int = 0


@dataclasses.dataclass
class BatchStats:
    """Planning-stage work counters for one ``query_batch`` call.

    ``cells_probed``/``rows_scanned`` come from the index's planning stage
    (candidate (query, cell) pairs and scan-window rows respectively), so
    backend comparisons can report work done, not just wall-clock QPS.
    ``fallbacks`` counts device waves that overflowed ``cell_cap`` and were
    re-answered by the numpy path (DESIGN.md §4 submit-time overflow
    contract); ``hit_overflows`` counts individual queries whose exact
    device hit count exceeded ``hit_cap`` and were re-answered on the host
    at drain time (§4 drain-time overflow contract).
    """
    queries: int = 0
    cells_probed: int = 0
    rows_scanned: int = 0
    backend: str = "numpy"
    fallbacks: int = 0
    hit_overflows: int = 0

    def merge(self, other: "BatchStats") -> "BatchStats":
        return BatchStats(
            queries=max(self.queries, other.queries),
            cells_probed=self.cells_probed + other.cells_probed,
            rows_scanned=self.rows_scanned + other.rows_scanned,
            backend=self.backend,
            fallbacks=self.fallbacks + other.fallbacks,
            hit_overflows=self.hit_overflows + other.hit_overflows,
        )


class GridFile:
    """Multidimensional grid index over a chosen subset of attributes.

    Parameters
    ----------
    data : (N, D) float array — FULL rows (all attributes) are stored so the
        final predicate can always be evaluated, even on non-indexed dims.
    index_dims : which attributes get index structure (grid lines or sort).
    cells_per_dim : grid lines per gridded attribute.
    sort_dim : attribute (member of index_dims) kept OUT of the grid and
        sorted inside each cell; None disables the optimisation (pure grid).
    quantile : CDF-aligned boundaries when True (paper/Column-Files style),
        uniform min..max boundaries when False (Uniform-Grid baseline).
    row_ids : original identities of ``data`` rows (defaults to arange(N)).
    backend : ``"device"`` (default) — route ``query_batch`` through the
        frozen device plan (DESIGN.md §4), falling back to numpy when a
        wave's candidate cells overflow the plan's cap (CPU route only) —
        or ``"numpy"``, the exact host path and correctness oracle.
    device_opts : kwargs for ``engine.device.DevicePlan`` (cell_cap,
        hit_cap, tile, min_bucket).
    device : torch device the plan's images live on (default ``"cuda"``;
        the plan raises when that device is absent — ``"cpu"`` runs the
        kernels' plain torch versions).
    epoch : snapshot version label (DESIGN.md §5).  A grid file is an
        immutable snapshot of one epoch; the mutable lifecycle
        (``COAXIndex.compact``) replaces it with a new-epoch instance, which
        is what invalidates any frozen ``DevicePlan`` built from it.
    """

    def __init__(
        self,
        data: np.ndarray,
        index_dims: Sequence[int],
        cells_per_dim: int,
        sort_dim: Optional[int] = None,
        quantile: bool = True,
        row_ids: Optional[np.ndarray] = None,
        backend: str = "device",
        device_opts: Optional[dict] = None,
        epoch: int = 0,
        device: str = "cuda",
    ):
        data = np.ascontiguousarray(data, dtype=np.float32)
        self.epoch = int(epoch)
        n, d_full = data.shape
        self.n_rows = n
        self.d_full = d_full
        self.index_dims = list(index_dims)
        self.sort_dim = sort_dim
        if sort_dim is not None and sort_dim not in self.index_dims:
            raise ValueError("sort_dim must be one of index_dims")
        self.grid_dims = [d for d in self.index_dims if d != sort_dim]
        self.cells_per_dim = int(cells_per_dim)
        self.quantile = quantile

        # --- grid-line boundaries (inner edges only: cells+1 edges total, we
        # store the cells-1 inner ones; outermost cells are open-ended) ------
        self.inner_edges: List[np.ndarray] = []
        for d in self.grid_dims:
            col = data[:, d] if n else np.zeros(1, np.float32)
            if quantile:
                qs = np.linspace(0.0, 1.0, self.cells_per_dim + 1)[1:-1]
                edges = np.quantile(col, qs) if n else np.zeros(0)
            else:
                lo, hi = (float(col.min()), float(col.max())) if n else (0.0, 1.0)
                edges = np.linspace(lo, hi, self.cells_per_dim + 1)[1:-1]
            self.inner_edges.append(np.asarray(edges, dtype=np.float64))

        # --- assign rows to cells, order rows by (cell, sort value) --------
        c = self.cells_per_dim
        n_cells = c ** len(self.grid_dims)
        if n:
            flat = np.zeros(n, dtype=np.int64)
            for edges, d in zip(self.inner_edges, self.grid_dims):
                flat = flat * c + np.searchsorted(edges, data[:, d], side="right")
            if sort_dim is not None:
                order = np.lexsort((data[:, sort_dim], flat))
            else:
                order = np.argsort(flat, kind="stable")
            self.rows = np.ascontiguousarray(data[order])
            self.row_ids = (
                np.arange(n, dtype=np.int64)[order]
                if row_ids is None
                else np.asarray(row_ids, dtype=np.int64)[order]
            )
            counts = np.bincount(flat, minlength=n_cells)
        else:
            self.rows = data
            self.row_ids = np.empty(0, dtype=np.int64)
            counts = np.zeros(n_cells, dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.sort_vals = (
            np.ascontiguousarray(self.rows[:, sort_dim]) if sort_dim is not None else None
        )
        # certified once so batched_searchsorted can take its all-+inf exit
        self._sort_finite = bool(
            np.isfinite(self.sort_vals).all()) if self.sort_vals is not None else True
        # certified once so the batch filter may skip unconstrained dims: a
        # +inf/NaN record value fails `v < +inf` / any compare in the exact
        # scalar and device paths, so the skip is only sound on finite data
        self._rows_finite = bool(np.isfinite(self.rows).all()) if n else True
        self.last_query_stats = _QueryStats()
        self.last_batch_stats = BatchStats()
        self.device_opts = device_opts
        self.device = device
        self.backend = backend

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Snapshot state (DESIGN.md §7.3): the cell-ordered row block, ids,
        directory and build parameters — everything ``from_state`` needs to
        resurrect this exact epoch without re-sorting or re-quantiling.
        Arrays are the live ones (callers serialise; ``np.savez`` copies)."""
        return {
            "rows": self.rows,
            "row_ids": self.row_ids,
            "offsets": self.offsets,
            "inner_edges": (np.stack(self.inner_edges) if self.inner_edges
                            else np.empty((0, max(self.cells_per_dim - 1, 0)),
                                          np.float64)),
            "meta": {
                "d_full": self.d_full,
                "index_dims": self.index_dims,
                "cells_per_dim": self.cells_per_dim,
                "sort_dim": self.sort_dim,
                "quantile": self.quantile,
                "epoch": self.epoch,
            },
        }

    @classmethod
    def from_state(cls, state: dict, backend: str = "device",
                   device_opts: Optional[dict] = None,
                   device: str = "cuda") -> "GridFile":
        """Rebuild a frozen grid file from ``state_dict`` output, bypassing
        the sort/quantile build — the warm-restart path (DESIGN.md §7.3).
        The restored instance is bit-identical to the saved one in every
        query-visible respect; its device plan is rebuilt lazily on first
        device wave, exactly like a post-compaction epoch."""
        meta = state["meta"]
        gf = cls.__new__(cls)
        gf.epoch = int(meta["epoch"])
        gf.rows = np.ascontiguousarray(state["rows"], dtype=np.float32)
        gf.n_rows = gf.rows.shape[0]
        gf.d_full = int(meta["d_full"])
        gf.index_dims = [int(d) for d in meta["index_dims"]]
        gf.sort_dim = None if meta["sort_dim"] is None else int(meta["sort_dim"])
        gf.grid_dims = [d for d in gf.index_dims if d != gf.sort_dim]
        gf.cells_per_dim = int(meta["cells_per_dim"])
        gf.quantile = bool(meta["quantile"])
        edges = np.asarray(state["inner_edges"], dtype=np.float64)
        gf.inner_edges = [np.ascontiguousarray(edges[i])
                          for i in range(len(gf.grid_dims))]
        gf.row_ids = np.asarray(state["row_ids"], dtype=np.int64)
        gf.offsets = np.asarray(state["offsets"], dtype=np.int64)
        gf.sort_vals = (np.ascontiguousarray(gf.rows[:, gf.sort_dim])
                        if gf.sort_dim is not None else None)
        gf._sort_finite = bool(
            np.isfinite(gf.sort_vals).all()) if gf.sort_vals is not None else True
        gf._rows_finite = bool(np.isfinite(gf.rows).all()) if gf.n_rows else True
        gf.last_query_stats = _QueryStats()
        gf.last_batch_stats = BatchStats()
        gf.device_opts = device_opts
        gf.device = device
        gf.backend = backend
        return gf

    # ------------------------------------------------------------------ #
    @property
    def backend(self) -> str:
        return self._backend

    @backend.setter
    def backend(self, value: str) -> None:
        if value not in ("numpy", "device"):
            raise ValueError(f"backend must be 'numpy' or 'device', got {value!r}")
        self._backend = value

    @property
    def device(self) -> str:
        return self._device

    @device.setter
    def device(self, value) -> None:
        """Moving the grid to another device drops the plan built for the
        old one; the next device wave rebuilds it there."""
        self._device = str(value)
        self._device_plan = None

    @property
    def device_plan(self):
        """Lazily-built frozen device plan (engine.device.DevicePlan).

        Built (and uploaded) once on first use.  Raises when the plan's
        device is absent — the device backend never degrades quietly to
        the numpy path.
        """
        if self._device_plan is None:
            from ..engine.device import DevicePlan
            self._device_plan = DevicePlan(self, device=self.device,
                                           **(self.device_opts or {}))
        return self._device_plan

    # ------------------------------------------------------------------ #
    @property
    def n_cells(self) -> int:
        return self.cells_per_dim ** len(self.grid_dims)

    def memory_footprint(self) -> int:
        """Index-directory bytes: grid lines + cell offsets + sort marker.

        Row payloads are the data itself, not index overhead (paper §8.2.4
        compares *index* memory).  ``row_ids`` is likewise payload identity.
        """
        edges = sum(e.nbytes for e in self.inner_edges)
        return edges + self.offsets.nbytes

    # ------------------------------------------------------------------ #
    def _cell_ranges(self, nav_rect: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-grid-dim [first, last] cell coordinates overlapping nav_rect."""
        k = len(self.grid_dims)
        first = np.zeros(k, dtype=np.int64)
        last = np.full(k, self.cells_per_dim - 1, dtype=np.int64)
        for i, (edges, d) in enumerate(zip(self.inner_edges, self.grid_dims)):
            pos = self.index_dims.index(d)
            lo, hi = nav_rect[pos, 0], nav_rect[pos, 1]
            if np.isfinite(lo):
                first[i] = np.searchsorted(edges, lo, side="right")
            if np.isfinite(hi):
                last[i] = np.searchsorted(edges, hi, side="left")
        return first, last

    def _candidate_cells(self, nav_rect: np.ndarray) -> np.ndarray:
        first, last = self._cell_ranges(nav_rect)
        if np.any(last < first):
            return np.empty(0, dtype=np.int64)
        axes = [np.arange(f, l + 1, dtype=np.int64) for f, l in zip(first, last)]
        flat = np.zeros(1, dtype=np.int64)
        for ax in axes:
            flat = (flat[:, None] * self.cells_per_dim + ax[None, :]).reshape(-1)
        return flat

    def query(self, nav_rect: np.ndarray, filter_rect: Rect) -> np.ndarray:
        """Answer a range query.

        nav_rect : (len(index_dims), 2) constraints on the INDEXED dims, in
            index_dims order — for COAX this is the translated rect (Eq. 2).
        filter_rect : (D, 2) the ORIGINAL full-dimensional predicate; applied
            to every scanned row (translation over-approximates, §7.1).

        Returns sorted original row ids.
        """
        stats = _QueryStats()
        cells = self._candidate_cells(nav_rect)
        stats.cells_probed = int(cells.size)
        if cells.size == 0:
            self.last_query_stats = stats
            return np.empty(0, dtype=np.int64)

        blk_lo = self.offsets[cells]
        blk_hi = self.offsets[cells + 1]
        if self.sort_dim is not None:
            pos = self.index_dims.index(self.sort_dim)
            q_lo, q_hi = nav_rect[pos, 0], nav_rect[pos, 1]
            sv = self.sort_vals
            # binary search inside every candidate cell block at once (§6)
            lo_idx = blk_lo
            hi_idx = blk_hi
            if np.isfinite(q_lo):
                lo_idx = batched_searchsorted(sv, blk_lo, blk_hi, q_lo, "left",
                                              vals_finite=self._sort_finite)
            if np.isfinite(q_hi):
                hi_idx = batched_searchsorted(sv, lo_idx, blk_hi, q_hi, "left",
                                              vals_finite=self._sort_finite)
            blk_lo, blk_hi = lo_idx, hi_idx

        idx = gather_ranges(blk_lo, blk_hi)
        stats.rows_scanned = int(idx.size)
        if idx.size == 0:
            self.last_query_stats = stats
            return np.empty(0, dtype=np.int64)
        hit = rect_contains(filter_rect, self.rows[idx])
        out = self.row_ids[idx[hit]]
        stats.rows_matched = int(out.size)
        self.last_query_stats = stats
        return np.sort(out)

    # ------------------------------------------------------------------ #
    # Batched execution path (DESIGN.md §2): B queries share one directory
    # probe and one fused scan instead of B python round-trips.
    # ------------------------------------------------------------------ #
    def plan_batch(self, nav_rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorised directory probe for a batch of nav-rects.

        nav_rects : (B, len(index_dims), 2) translated constraints, in
            index_dims order (the batched analogue of ``query``'s nav_rect).

        Returns ``(query_ids, cells)`` — a flat list of candidate (query,
        cell) pairs covering, for every query, exactly the cells
        ``_candidate_cells`` would visit.  Cells are enumerated per query in
        the same row-major order as the scalar path.
        """
        nav_rects = np.asarray(nav_rects, dtype=np.float64)
        b = nav_rects.shape[0]
        k = len(self.grid_dims)
        c = self.cells_per_dim
        if b == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if k == 0:
            # single cell 0 per query
            return np.arange(b, dtype=np.int64), np.zeros(b, np.int64)

        first = np.zeros((b, k), dtype=np.int64)
        last = np.full((b, k), c - 1, dtype=np.int64)
        for i, (edges, d) in enumerate(zip(self.inner_edges, self.grid_dims)):
            pos = self.index_dims.index(d)
            lo = nav_rects[:, pos, 0]
            hi = nav_rects[:, pos, 1]
            # searchsorted(±inf) lands on the open outermost cells, matching
            # the scalar path's finite-only probing.
            first[:, i] = np.searchsorted(edges, lo, side="right")
            last[:, i] = np.searchsorted(edges, hi, side="left")

        counts = last - first + 1                       # (B, k) cells per dim
        n_cells = np.where((counts > 0).all(axis=1), counts.prod(axis=1), 0)
        total = int(n_cells.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)

        qids = np.repeat(np.arange(b, dtype=np.int64), n_cells)
        starts = np.concatenate([[0], np.cumsum(n_cells)[:-1]])
        local = np.arange(total, dtype=np.int64) - np.repeat(starts, n_cells)

        # Mixed-radix decode of the per-query local cell index into per-dim
        # coordinates (last grid dim least significant, like the scalar path).
        safe = np.maximum(counts, 1)
        strides = np.ones((b, k), dtype=np.int64)
        for i in range(k - 2, -1, -1):
            strides[:, i] = strides[:, i + 1] * safe[:, i + 1]
        flat = np.zeros(total, dtype=np.int64)
        for i in range(k):
            digit = (local // strides[qids, i]) % safe[qids, i]
            flat = flat * c + (first[qids, i] + digit)
        return qids, flat

    def query_batch(
        self, nav_rects: np.ndarray, filter_rects: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Answer B range queries in one vectorised pass.

        nav_rects    : (B, len(index_dims), 2) translated constraints.
        filter_rects : (B, D, 2) the ORIGINAL full predicates, applied to
            every scanned row of the owning query.

        Returns ``(query_ids, row_ids)`` — the flat hit list, sorted by
        (query_id, row_id); per query it equals ``query(nav, filter)``.

        ``backend="device"`` routes through the frozen device plan
        (DESIGN.md §4) under the contract that ``nav_rects``
        over-approximates ``filter_rects`` on the indexed dims — true for
        Eq. 2 translation and for nav == filter; waves whose candidate
        cells overflow the plan's cap fall back to this numpy path.
        """
        nav_rects = np.asarray(nav_rects, dtype=np.float64)
        filter_rects = np.asarray(filter_rects, dtype=np.float64)
        b = nav_rects.shape[0]
        fallbacks = 0
        if self._backend == "device" and b:
            res = self.device_plan.run_wave(nav_rects, filter_rects)
            if res is not None:
                out_q, out_r, s = res
                self.last_batch_stats = BatchStats(
                    queries=b, cells_probed=s["cells_probed"],
                    rows_scanned=s["rows_scanned"], backend="device",
                    hit_overflows=s.get("hit_overflows", 0))
                return out_q, out_r
            fallbacks = 1                       # cell_cap overflow -> numpy
        return self._query_batch_numpy(nav_rects, filter_rects, fallbacks)

    def _query_batch_numpy(
        self, nav_rects: np.ndarray, filter_rects: np.ndarray,
        fallbacks: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The exact host implementation of ``query_batch`` (and the device
        backend's overflow fallback / correctness oracle).

        Telemetry (DESIGN.md §10.1): each pipeline stage — directory
        *probe*, in-cell segment *search*, exact row *filter* — folds its
        wall time into ``coax_stage_seconds{stage,backend="numpy"}``, the
        per-stage breakdown ``bench_queries.py --telemetry`` reports."""
        stats = BatchStats(queries=int(nav_rects.shape[0]),
                           backend="numpy", fallbacks=fallbacks)
        self.last_batch_stats = stats
        with obs.stage_timer("probe"):
            qids, cells = self.plan_batch(nav_rects)
        stats.cells_probed = int(cells.size)
        if cells.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)

        with obs.stage_timer("search"):
            blk_lo = self.offsets[cells]
            blk_hi = self.offsets[cells + 1]
            if self.sort_dim is not None and self.n_rows:
                pos = self.index_dims.index(self.sort_dim)
                q_lo = nav_rects[qids, pos, 0]          # per-(query,cell) targets
                q_hi = nav_rects[qids, pos, 1]
                sv = self.sort_vals
                blk_lo = batched_searchsorted(sv, blk_lo, blk_hi, q_lo, "left",
                                              vals_finite=self._sort_finite)
                blk_hi = batched_searchsorted(sv, blk_lo, blk_hi, q_hi, "left",
                                              vals_finite=self._sort_finite)

        with obs.stage_timer("filter"):
            lens = np.maximum(blk_hi - blk_lo, 0)
            idx = gather_ranges(blk_lo, blk_hi, lens)   # one (query,cell) pass
            stats.rows_scanned = int(idx.size)
            if idx.size == 0:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            row_q = np.repeat(qids, lens)               # owning query per row
            rows = self.rows[idx]                       # (T, D) one f32 gather

            # Row filter in float32 with ceil-rounded bounds (exact: see
            # ``f32_ceil``), one dim at a time so temporaries stay (T,)-sized —
            # float64 (T, D) broadcasts are the batch path's cache killer.
            lo32 = f32_ceil(filter_rects[:, :, 0])      # (B, D)
            hi32 = f32_ceil(filter_rects[:, :, 1])
            hit = np.ones(idx.size, dtype=bool)
            for j in range(self.d_full):
                if self._rows_finite and np.isneginf(lo32[:, j]).all() \
                        and np.isposinf(hi32[:, j]).all():
                    continue                            # dim unconstrained
                v = rows[:, j]
                np.logical_and(hit, v >= lo32[row_q, j], out=hit)
                np.logical_and(hit, v < hi32[row_q, j], out=hit)
            out_q = row_q[hit]
            out_r = self.row_ids[idx[hit]]
            order = np.lexsort((out_r, out_q))
            return out_q[order], out_r[order]
