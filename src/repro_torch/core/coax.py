"""The COAX index (paper §3, Fig. 1): soft-FD learning + query translation +
primary index on reduced dims + full-dimensional outlier index.

Build path (``COAXIndex.fit``):
  1. learn soft-FD groups from a sample (Alg. 1; ``softfd.learn_soft_fds``);
  2. split rows: every group's margins satisfied -> primary, else -> outlier
     (Alg. 1, second half);
  3. primary = grid file over only the INDEXED dims (non-dependents) with an
     in-cell sorted dim -> ``n - m - 1`` grid dimensions (§6);
  4. outliers = an ordinary full-dimensional multidimensional index (§3:
     'a typical multidimensional index structure') — quantile grid here.

Query path (``COAXIndex.query``):
  translate the rect onto indexed dims (Eq. 2), probe the primary with the
  translated nav-rect plus the ORIGINAL full predicate, probe the outlier
  index with the original rect, union row ids.  §8.2.3's optimisation is
  applied: each sub-index is only invoked when the query can intersect it.

Write path (DESIGN.md §5): the two grid files are *epoch-versioned frozen
snapshots*; ``insert``/``delete`` land in per-sub-index ``DeltaPlane``s
(append log + tombstones, organized into tiered sorted runs, §5.3) and
every query unions (snapshot − tombstones) ∪ delta.  Inserts are
margin-checked against the learned FD groups — in-margin rows feed the
primary delta, violators the outlier delta — and stream into per-model
``BayesianLinearModel`` trackers so FD drift is measured from live
sufficient statistics (§5: 'continuously adjust our existing model').
``compact()`` merges deltas into rebuilt snapshots and bumps the epoch; it
fires automatically on delta size, or on drift when the §7.2 predictability
ratio (``theory.met_drifted_expectation``) says the frozen slopes have
decayed.  Trigger evaluation is amortized (every ``compact_check_rows``
written rows or on an L0 spill — ``maybe_compact``), and with
``background_compact`` the rebuild itself moves off the serving thread:
``_begin_background_compact`` freezes the live row set and builds the next
epoch on a daemon thread while the old epoch keeps serving; ``poll_handoff``
installs the finished build at the next write/query/wave boundary and
replays the writes admitted during the build into the new epoch (the
epoch-handoff state machine, DESIGN.md §5.4).  The build thread runs numpy
only: the new epoch's device images upload lazily, on the serving thread,
at its first device wave (``_device_plan_obj``).

Durability (DESIGN.md §7): ``attach_durability`` hooks a ``storage``
durability plane onto the write path — every ``insert``/``delete`` appends
one frame to an epoch-stamped write-ahead log before mutating memory, and
``compact`` rotates the log under a fresh epoch snapshot.  ``save`` writes
a one-shot full-state snapshot (delta planes and drift trackers included);
``restore`` loads the newest complete snapshot and replays the WAL tail
through these same write paths, yielding an index bit-identical to the
never-crashed one on every backend.  The snapshot format is the reference
package's, so a snapshot written by either package restores in the other.
The state of an index fitted elsewhere also comes in through
``COAXIndex.from_state``, and ``state`` hands it out.

Semantic cache and pins (DESIGN.md §9): ``attach_cache`` consults a
rect-containment result cache before every batched wave (only the misses
reach the device), and ``pin_epoch`` opens an MVCC read handle that keeps
answering from the pinned epoch across writes and handoffs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from . import theory
from .delta import DeltaPlane
from .gridfile import BatchStats, GridFile, fit_cells_per_dim
from .softfd import BayesianLinearModel, SoftFDConfig, learn_soft_fds
from .translate import reduced_dims, translate_rect, translate_rects
from .types import FDGroup, LinearModel, Rect, sorted_contains, split_hits

__all__ = ["CoaxConfig", "COAXIndex"]


@dataclasses.dataclass(frozen=True)
class CoaxConfig:
    softfd: SoftFDConfig = SoftFDConfig()
    primary_cells_per_dim: Optional[int] = None   # None -> auto from rows_per_cell
    outlier_cells_per_dim: Optional[int] = None
    sort_dim: Optional[int] = None                # None -> auto (widest kept dim)
    rows_per_cell: int = 256                      # target cell occupancy (sweet
                                                  # spot lever, paper Fig. 8)
    directory_budget_frac: float = 1.0            # directory <= frac * data bytes

    # --- mutable lifecycle (DESIGN.md §5) ------------------------------- #
    auto_compact: bool = True        # insert/delete check triggers themselves
    compact_delta_frac: float = 0.25  # size trigger: delta load > frac * base
    compact_min_delta: int = 1024     # ... and at least this many delta entries
    drift_threshold: float = 0.5      # compact+relearn when the §7.2
                                      # predictability ratio drops below this
    drift_min_delta: int = 256        # drift trigger needs this much fresh data
    drift_seed_rows: int = 4096       # rows seeding the live FD trackers
    drift_track_k: float = 6.0        # slope trackers only ingest rows within
                                      # the margin band expanded by k*width —
                                      # gross violators feed the violation-MASS
                                      # statistic instead (mirrors robust_k)

    # --- LSM write path (DESIGN.md §5.3–§5.4) --------------------------- #
    background_compact: bool = False  # build the next epoch on a daemon
                                      # thread, swap at an atomic handoff
    compact_check_rows: int = 64      # amortize trigger checks: evaluate
                                      # once per this-many written rows (or
                                      # on an L0 spill), not every write
    delta_l0_spill: int = 256         # delta L0 rows that spill into a
                                      # sorted run (§5.3)


class COAXIndex:
    name = "coax"

    def __init__(self, data: np.ndarray, config: CoaxConfig = CoaxConfig(),
                 groups: Optional[Sequence[FDGroup]] = None,
                 backend: str = "device",
                 device_opts: Optional[dict] = None,
                 row_ids: Optional[np.ndarray] = None,
                 device: str = "cuda"):
        """Build the index.  ``groups`` may be supplied to skip detection
        (e.g. when the DBA already knows the FDs, or from a previous fit).

        ``backend="device"`` (the default) routes ``query_batch`` through
        the frozen device plan of both sub-grids (DESIGN.md §4) on the
        torch ``device`` (default ``"cuda"``; the plan raises when that
        device is absent, ``"cpu"`` runs the kernels' plain versions);
        ``backend="numpy"`` is the exact host path and correctness oracle.

        ``row_ids`` assigns the original identities of ``data`` rows
        (defaults to ``arange(N)``); a scratch rebuild of a mutated index
        passes the surviving ids here so result sets stay comparable.
        """
        self.config = config
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.n_dims = self.data.shape[1]
        self.row_ids = (np.arange(self.data.shape[0], dtype=np.int64)
                        if row_ids is None
                        else np.asarray(row_ids, dtype=np.int64).copy())
        if self.row_ids.shape[0] != self.data.shape[0]:
            raise ValueError("row_ids length must match data rows")
        self._next_id = int(self.row_ids.max()) + 1 if self.row_ids.size else 0
        self.epoch = 0
        self.compactions = 0
        self.groups: List[FDGroup] = (
            list(groups) if groups is not None else learn_soft_fds(self.data, config.softfd)
        )
        self.keep_dims = reduced_dims(self.n_dims, self.groups)
        self._device_opts = device_opts
        self._device = str(device)
        self._coax_plan = None          # engine.device.CoaxDevicePlan (lazy)
        self.last_batch_stats = BatchStats()
        self.durable = None             # storage.Durability, via attach_durability
        self._init_write_state()
        self._fit()
        self.backend = backend

    def _init_write_state(self) -> None:
        """Amortized-trigger counters + background-handoff machinery
        (DESIGN.md §5.3–§5.4), fresh — shared by build and ``from_state``."""
        self._write_units = 0           # rows written since the last check
        self._spill_pending = False     # an L0 spill since the last check
        self.trigger_checks = 0         # full trigger evaluations ever run
        self.background_compactions = 0  # handoffs installed
        self.last_handoff_s = 0.0       # build-start → install latency
        self._handoff_t0 = 0.0
        self._handoff_thread = None     # the in-flight compactor thread
        self._handoff_result = None     # [None] | [("ok", fitted, relearned)]
        self._handoff_ops = None        # writes admitted during the build
        self._in_handoff_replay = False
        self._last_compact_relearned = False
        self._viol_total = {}           # per-group arriving-row counts and
        self._viol_bad = {}             # margin violations since tracker reseed
        self.cache = None               # engine.cache.SemanticCache (§9.2)
        self.last_cache_stats = None    # CacheLookup of the latest wave
        self._pins = {}                 # epoch -> live EpochPin count (§9.3)
        self._id_order_cache = None     # (argsort, sorted ids) of row_ids

    # ------------------------------------------------------------------ #
    @property
    def backend(self) -> str:
        return self.primary.backend

    @backend.setter
    def backend(self, value: str) -> None:
        self.primary.backend = value
        self.outlier.backend = value

    @property
    def device(self) -> str:
        """Torch device the device plan's images live on."""
        return self._device

    @device.setter
    def device(self, value) -> None:
        """Moving the index to another device drops the plan built for
        the old one; the next device wave rebuilds it there."""
        value = str(value)
        if value != self._device:
            self._device = value
            self._coax_plan = None
            self.primary.device = value
            self.outlier.device = value

    @property
    def n_rows(self) -> int:
        """LIVE row count: snapshot rows − tombstones + live delta rows."""
        return (self.data.shape[0]
                - self.delta_primary.n_base_dead - self.delta_outlier.n_base_dead
                + self.delta_primary.n_live + self.delta_outlier.n_live)

    @property
    def delta_rows(self) -> int:
        """Live (not yet compacted) inserted rows across both delta planes."""
        return self.delta_primary.n_live + self.delta_outlier.n_live

    @property
    def tombstone_count(self) -> int:
        return self.delta_primary.n_tombstones + self.delta_outlier.n_tombstones

    # ------------------------------------------------------------------ #
    def _fit(self) -> None:
        self._install_fit(self._fit_state(self.data, self.row_ids,
                                          self.groups, self.epoch))

    def _fit_state(self, data: np.ndarray, row_ids: np.ndarray,
                   groups: Sequence[FDGroup], epoch: int) -> dict:
        """Pure fit: build both epoch grids, the base id partitions, the
        §8.2.3 bbox and the tracker seeds for ``data`` under ``groups``,
        stamped ``epoch`` — NO self mutation.  Reads only immutable config,
        so the §5.4 background compactor thread can run it against a frozen
        row set while the serving thread keeps answering from the old epoch
        (``_install_fit`` is the serving-thread half of the handoff)."""
        cfg = self.config
        n = data.shape[0]
        n_dims = data.shape[1]
        keep_dims = reduced_dims(n_dims, groups)
        # Split into primary (all groups' margins hold) and outliers.
        inlier = np.ones(n, dtype=bool)
        for g in groups:
            inlier &= g.inlier_mask(data)
        primary_ratio = float(inlier.mean()) if n else 0.0

        p_rows, p_ids = data[inlier], row_ids[inlier]
        o_rows, o_ids = data[~inlier], row_ids[~inlier]

        # Sorted dim: the kept dim with the widest normalised spread by
        # default — maximises the benefit of in-cell binary search.
        if cfg.sort_dim is not None:
            sort_dim = cfg.sort_dim
        elif n:
            spread = [
                float(np.std(data[:, d])) / (float(np.ptp(data[:, d])) or 1.0)
                for d in keep_dims
            ]
            sort_dim = keep_dims[int(np.argmax(spread))] if keep_dims else 0
        else:
            sort_dim = keep_dims[0] if keep_dims else 0

        budget_cells = max(int(data.nbytes * cfg.directory_budget_frac) // 8, 1)
        n_grid = max(len(keep_dims) - 1, 0)
        target = max(int(p_rows.shape[0] / cfg.rows_per_cell), 1)
        auto = max(int(round(target ** (1.0 / max(n_grid, 1)))), 2)
        p_cells = cfg.primary_cells_per_dim or min(
            auto, fit_cells_per_dim(max(n_grid, 1), budget_cells))
        primary = GridFile(
            p_rows, index_dims=keep_dims, cells_per_dim=p_cells,
            sort_dim=sort_dim if keep_dims else None, quantile=True, row_ids=p_ids,
            device_opts=self._device_opts, epoch=epoch, device=self._device,
        )

        # Outlier index: full-dimensional quantile grid with its own (much
        # smaller) budget — outliers are typically a few % of rows.
        o_budget = max(int(o_rows.nbytes * cfg.directory_budget_frac) // 8, 1)
        o_target = max(int(o_rows.shape[0] / cfg.rows_per_cell), 1)
        o_auto = max(int(round(o_target ** (1.0 / max(n_dims - 1, 1)))), 2)
        o_cells = cfg.outlier_cells_per_dim or min(
            o_auto, fit_cells_per_dim(max(n_dims - 1, 1), o_budget))
        outlier = GridFile(
            o_rows, index_dims=list(range(n_dims)), cells_per_dim=o_cells,
            sort_dim=sort_dim, quantile=True, row_ids=o_ids,
            device_opts=self._device_opts, epoch=epoch, device=self._device,
        )

        trackers, x_scale = self._seed_tracker_state(groups, p_rows)
        return {
            "data": data, "row_ids": row_ids, "epoch": epoch,
            "groups": list(groups), "keep_dims": keep_dims,
            "primary_ratio": primary_ratio,
            "primary": primary, "outlier": outlier,
            # §8.2.3: outlier bbox lets queries skip the outlier probe
            "outlier_lo": o_rows.min(axis=0) if o_rows.shape[0] else None,
            "outlier_hi": o_rows.max(axis=0) if o_rows.shape[0] else None,
            # sorted base id partitions (delete classification)
            "base_primary_ids": np.sort(p_ids),
            "base_outlier_ids": np.sort(o_ids),
            "trackers": trackers, "x_scale": x_scale,
        }

    def _install_fit(self, fitted: dict) -> None:
        """Adopt a ``_fit_state`` result as the CURRENT epoch — the atomic
        serving-thread half of the §5.4 handoff.  Swapping ``primary`` /
        ``outlier`` is what invalidates any frozen device plan (identity
        check in ``_device_plan_obj``); fresh delta planes are keyed on the
        new groups' first dependent (``_delta_key_dim``).  The stale device
        plan is deliberately KEPT on ``_coax_plan``: the identity check in
        ``_device_plan_obj`` rebuilds against the new grids on the next
        wave, and the rebuild ``adopt()``s the stale plan's shape cache and
        counters (pow2-bucketed image shapes keep launch shapes stable)."""
        self.data = fitted["data"]
        self.row_ids = fitted["row_ids"]
        self.epoch = int(fitted["epoch"])
        self.groups = fitted["groups"]
        self.keep_dims = fitted["keep_dims"]
        self.primary_ratio = fitted["primary_ratio"]
        self.primary = fitted["primary"]
        self.outlier = fitted["outlier"]
        self._outlier_lo = fitted["outlier_lo"]
        self._outlier_hi = fitted["outlier_hi"]
        self._base_primary_ids = fitted["base_primary_ids"]
        self._base_outlier_ids = fitted["base_outlier_ids"]
        self._fd_trackers = fitted["trackers"]
        self._x_scale = fitted["x_scale"]
        # violation-mass counters restart with the reseeded trackers: the
        # new margins absorbed (or re-rejected) the old epoch's violators
        self._viol_total = {gi: 0 for gi in range(len(self.groups))}
        self._viol_bad = {gi: 0 for gi in range(len(self.groups))}
        kd, spill = self._delta_key_dim(), self.config.delta_l0_spill
        self.delta_primary = DeltaPlane(self.n_dims, key_dim=kd, l0_spill=spill)
        self.delta_outlier = DeltaPlane(self.n_dims, key_dim=kd, l0_spill=spill)
        # the id->row gather index follows the snapshot arrays (§9.2); any
        # attached SemanticCache survives the swap untouched — its entries
        # are keyed on the pre-swap version and simply never match again,
        # and live EpochPins (§9.3) hold their own refs to the old epoch
        self._id_order_cache = None

    def _delta_key_dim(self) -> int:
        """Run key for the delta planes (DESIGN.md §5.3): the first FD
        dependent (Eq. 2 maps query ranges onto dependents, so key windows
        stay selective), else the primary's sort dim.  Derived from the
        current groups — never serialized — so live, restored and replica
        planes agree by construction."""
        for g in self.groups:
            for dep in g.dependents:
                return int(dep)
        sd = getattr(self.primary, "sort_dim", None) if hasattr(self, "primary") else None
        return int(sd) if sd is not None else 0

    def _seed_tracker_state(self, groups: Sequence[FDGroup],
                            inlier_rows: np.ndarray):
        """Per-(group, dependent) live Bayesian models, seeded from a sample
        of the snapshot's IN-MARGIN rows so the posterior slope starts at the
        frozen trend (outlier mass would bias the seed away from the robust
        fit and fake drift at epoch start).  Pure: returns (trackers,
        x_scale) without touching self."""
        cfg = self.config
        n = inlier_rows.shape[0]
        rng = np.random.default_rng(cfg.softfd.seed + 2)
        take = (rng.choice(n, size=min(cfg.drift_seed_rows, n), replace=False)
                if n else np.empty(0, np.int64))
        sample = inlier_rows[take].astype(np.float64)
        trackers: Dict[Tuple[int, int], BayesianLinearModel] = {}
        x_scale: Dict[int, float] = {}
        for gi, g in enumerate(groups):
            x = sample[:, g.predictor] if sample.size else np.empty(0)
            x_scale[gi] = float(np.std(x)) if x.size else 1.0
            for dep in g.dependents:
                blm = BayesianLinearModel.empty(cfg.softfd.ridge_lambda)
                if x.size:
                    blm.update(x, sample[:, dep])
                trackers[(gi, dep)] = blm
        return trackers, x_scale

    # ------------------------------------------------------------------ #
    # Write path (DESIGN.md §5)
    # ------------------------------------------------------------------ #
    def insert(self, rows: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert rows; returns their assigned original row ids.

        Each row is margin-checked against every learned FD group: rows
        satisfying all margins land in the primary delta, violators in the
        outlier delta (the write-time mirror of the build-time split).  All
        inserts stream into the live ``BayesianLinearModel`` trackers so
        ``drift_predictability`` reflects the data actually arriving.

        ``ids`` lets an owning plane (``engine.sharded.ShardedCOAX``) assign
        ids from a GLOBAL sequence so they stay unique across shards; the
        caller is responsible for never reusing an id.  Default: the index's
        own ``arange`` sequence.
        """
        self._poll_entry()
        rows = np.ascontiguousarray(np.atleast_2d(np.asarray(rows, dtype=np.float32)))
        if rows.ndim != 2 or rows.shape[1] != self.n_dims:
            raise ValueError(f"rows must be (m, {self.n_dims}), got {rows.shape}")
        m = rows.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
            self._next_id += m
        else:
            ids = np.asarray(ids, dtype=np.int64).copy()
            if ids.shape[0] != m:
                raise ValueError("ids length must match rows")
            if m:
                self._next_id = max(self._next_id, int(ids.max()) + 1)
        if m == 0:
            return ids
        if self.durable is not None:    # WAL before memory (DESIGN.md §7.2)
            self.durable.log_insert(rows, ids)
        if self._handoff_ops is not None and not self._in_handoff_replay:
            # a background build is in flight: remember the op so the new
            # epoch can replay it after the handoff (DESIGN.md §5.4)
            self._handoff_ops.append(("i", rows, ids.copy()))
        inlier = np.ones(m, dtype=bool)
        for gi, g in enumerate(self.groups):
            gm = g.inlier_mask(rows)
            # violation MASS per group: the contamination-vs-drift statistic
            # (``drift_predictability``) — a minority of gross violators is
            # outlier-plane work, a majority is a regime change
            self._viol_total[gi] += m
            self._viol_bad[gi] += int(m - gm.sum())
            inlier &= gm
        spilled = self.delta_primary.insert(rows[inlier], ids[inlier])
        spilled += self.delta_outlier.insert(rows[~inlier], ids[~inlier])
        x64 = rows.astype(np.float64)
        k = self.config.drift_track_k
        for (gi, dep), blm in self._fd_trackers.items():
            g = self.groups[gi]
            model = g.models[dep]
            x, d = x64[:, g.predictor], x64[:, dep]
            # robust slope tracking: only rows within the margin band
            # expanded by k*width update the posterior — gross violators
            # would drag the slope and fake drift (they are contamination,
            # measured by the mass counters above, not slope movement)
            slack = k * max(model.width, 1e-12)
            r = d - (model.m * x + model.b)
            band = (r >= -model.eps_lb - slack) & (r <= model.eps_ub + slack)
            if band.any():
                blm.update(x[band], d[band])
        self._write_units += m
        if spilled:
            self._spill_pending = True
        if self.config.auto_compact:
            self.maybe_compact()
        return ids

    def delete(self, row_ids) -> int:
        """Delete rows by original id; returns how many live rows died.

        Ids living in a delta log are tombstoned there; ids frozen into the
        snapshot are classified primary/outlier and tombstoned in the
        matching plane (so each sub-index's hits are masked by exactly its
        own plane).  Unknown or already-dead ids are ignored.
        """
        self._poll_entry()
        ids = np.unique(np.asarray(row_ids, dtype=np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        if self.durable is not None:    # WAL before memory (DESIGN.md §7.2)
            self.durable.log_delete(ids)
        if self._handoff_ops is not None and not self._in_handoff_replay:
            self._handoff_ops.append(("d", ids.copy()))
        self._write_units += int(ids.size)
        removed = 0
        absorbed = self.delta_primary.tombstone_log(ids)
        removed += int(absorbed.sum())
        ids = ids[~absorbed]
        absorbed = self.delta_outlier.tombstone_log(ids)
        removed += int(absorbed.sum())
        ids = ids[~absorbed]
        # base id arrays are sorted (``_fit_state``): binary-search
        # membership instead of ``isin`` re-sorting 50k ids per delete
        in_p = sorted_contains(self._base_primary_ids, ids)
        removed += self.delta_primary.tombstone_base(ids[in_p])
        rest = ids[~in_p]
        in_o = sorted_contains(self._base_outlier_ids, rest)
        removed += self.delta_outlier.tombstone_base(rest[in_o])
        if self.config.auto_compact:
            self.maybe_compact()
        return removed

    # ------------------------------------------------------------------ #
    def drift_predictability(self) -> float:
        """§7.2 predictability of the frozen models against live statistics
        (the drift-vs-contamination statistic, DESIGN.md §5.2).

        For each (group, dependent) model, the live posterior slope's
        mismatch ``d = |m_live − m_frozen| · std(x)`` is scored with the
        drifted mean-exit-time ratio
        ``met_drifted_expectation(ε, σ, d) / met_expectation(ε, σ)``
        (= tanh(u)/u, u = εd/σ²) with ε = half the margin width and the
        σ = ε/2 convention; 1.0 = no drift, →0 as the frozen slope decays.

        The slope trackers are ROBUST (``drift_track_k``): gross margin
        violators never enter the posterior, so a contamination burst — a
        minority of rows following a different trend, which the write path
        already routes to the outlier delta — cannot fake slope drift and
        trigger a relearn that would return the very same models.  What
        gross violators feed instead is the per-group violation-MASS
        fraction; its complement ``1 − bad/total`` joins the min, so a
        MAJORITY of arriving rows breaking a margin (a genuine regime
        change, where relearning finds different models) still degrades
        predictability below any sane threshold.

        Returns the minimum over all models and mass fractions (the
        weakest link triggers the relearn), or 1.0 when no FDs are
        tracked.
        """
        worst = 1.0
        for (gi, dep), blm in self._fd_trackers.items():
            model = self.groups[gi].models[dep]
            eps = model.width / 2.0
            if eps <= 0.0:
                continue
            m_live, _ = blm.posterior_mean()
            d = abs(m_live - model.m) * self._x_scale[gi]
            sigma = eps / 2.0
            ratio = (theory.met_drifted_expectation(eps, sigma, d)
                     / theory.met_expectation(eps, sigma))
            worst = min(worst, float(ratio))
        for gi, total in self._viol_total.items():
            if total:
                worst = min(worst, 1.0 - self._viol_bad[gi] / total)
        return worst

    def maybe_compact(self) -> bool:
        """Evaluate the compaction triggers (DESIGN.md §5) — AMORTIZED: the
        size+drift evaluation only runs once per ``compact_check_rows``
        written rows, or when a delta L0 spill signalled that the write
        plane grew a run (§5.3); evaluations are counted in
        ``trigger_checks``.  The counters are serialized with the index, so
        check timing — and therefore every auto-compaction decision — is
        bit-reproducible across snapshot/restore and WAL replay (§7.3).

        * size — delta load (live inserts + tombstones) exceeds both
          ``compact_min_delta`` and ``compact_delta_frac`` of the snapshot;
        * drift — predictability fell below ``drift_threshold`` with at
          least ``drift_min_delta`` of fresh delta evidence (the relearn
          path: compaction re-runs ``learn_soft_fds``).

        With ``background_compact`` a fired trigger starts a §5.4
        background build instead of compacting synchronously — except
        during WAL replay and during the handoff tail replay, both of
        which compact SYNCHRONOUSLY: replay must land on the same state a
        single-threaded run of the same ops would (§7.3), so a trigger
        firing mid-replay fires exactly where the sync world fires it.
        """
        if self._handoff_thread is not None:
            # one build at a time: fold it in if done, else keep serving
            return self.poll_handoff()
        cfg = self.config
        if self._write_units < cfg.compact_check_rows and not self._spill_pending:
            return False
        self._write_units = 0
        self._spill_pending = False
        self.trigger_checks += 1
        load = self.delta_rows + self.tombstone_count
        size_trigger = load >= max(cfg.compact_min_delta,
                                   int(cfg.compact_delta_frac * max(self.data.shape[0], 1)))
        drift_trigger = (load >= cfg.drift_min_delta
                         and self.drift_predictability() < cfg.drift_threshold)
        if not (size_trigger or drift_trigger):
            return False
        if (cfg.background_compact and not self._in_handoff_replay
                and not (self.durable is not None and self.durable._replaying)):
            self._begin_background_compact(relearn=drift_trigger or None)
            return True
        self.compact(relearn=drift_trigger or None)
        return True

    # ------------------------------------------------------------------ #
    # Background compaction + epoch handoff (DESIGN.md §5.4)
    # ------------------------------------------------------------------ #
    def _poll_entry(self) -> None:
        """Cheap per-call handoff check at write/query entry points."""
        if self._handoff_thread is not None:
            self.poll_handoff()

    def _begin_background_compact(self, relearn: Optional[bool]) -> None:
        """Kick off the §5.4 background build: freeze the live row set,
        decide the relearn flag NOW (from the serving thread's trackers),
        and hand the pure ``_fit_state`` to a daemon thread.  The old epoch
        keeps serving; writes admitted during the build land in its delta
        planes AND are recorded for the post-handoff tail replay.  The
        thread runs numpy only and never touches torch: the new epoch's
        device plan is built on the serving thread after the install."""
        with obs.span("compact.freeze", epoch=self.epoch):
            rows, ids = self.live_rows()       # the frozen build input
            data = np.ascontiguousarray(rows, dtype=np.float32)
            row_ids = np.asarray(ids, dtype=np.int64).copy()
        if relearn is None:
            relearn = self.drift_predictability() < self.config.drift_threshold
        relearned = bool(relearn) and data.shape[0] >= 64
        epoch = self.epoch + 1
        groups_in = list(self.groups)
        cfg = self.config
        result = [None]
        # the build span is opened HERE (serving thread, implicit parent)
        # and finished by the builder thread — the §10.2 cross-thread case
        tr = obs.tracer()
        bsp = tr.start("compact.build", rows=int(data.shape[0]),
                       epoch=epoch, relearn=relearned) if tr else None

        def _build():
            try:
                groups = (learn_soft_fds(data, cfg.softfd)
                          if relearned else groups_in)
                result[0] = ("ok",
                             self._fit_state(data, row_ids, groups, epoch),
                             relearned)
            except BaseException as e:         # surfaced at the next poll
                result[0] = ("err", e)
            finally:
                if bsp is not None:
                    tr.finish(bsp)

        self._handoff_ops = []
        self._handoff_result = result
        self._handoff_t0 = time.perf_counter()
        t = threading.Thread(target=_build, name="coax-compactor", daemon=True)
        self._handoff_thread = t
        t.start()

    def poll_handoff(self, wait: bool = False) -> bool:
        """Fold a finished background build into the serving state — the
        atomic epoch handoff (DESIGN.md §5.4).  Called at every write/query
        entry and at wave boundaries; ``wait=True`` blocks for an in-flight
        build (``finish_handoff`` — the graceful-shutdown join).  Returns
        True iff a handoff was installed.  SERVING THREAD ONLY: installation
        swaps the grids the next wave is answered from.

        Install order (crash-safe, §7.5): adopt the built epoch, reset the
        amortized-trigger counters → open the new WAL → replay the recorded
        tail through the ordinary write paths (journaled into the new WAL;
        a trigger firing inside the replay compacts synchronously) → fsync
        → publish the new-epoch snapshot → delete old WALs.  A crash before
        the snapshot publish recovers from the old pair, whose WAL still
        holds the trigger record and the full tail.
        """
        t = self._handoff_thread
        if t is None:
            return False
        if not wait and t.is_alive():
            return False
        t.join()
        self._handoff_thread = None
        status = self._handoff_result[0] if self._handoff_result else None
        self._handoff_result = None
        ops, self._handoff_ops = (self._handoff_ops or []), None
        if status is None or status[0] == "err":
            err = status[1] if status else None
            raise RuntimeError("background compaction failed") from err
        _, fitted, relearned = status
        bk = self.backend
        with obs.span("compact.install", epoch=self.epoch + 1):
            self._install_fit(fitted)  # atomic swap: new epoch serves next
        self.compactions += 1
        self.backend = bk
        self._last_compact_relearned = relearned
        # Counter convergence with the synchronous world: a sync compaction
        # at the trigger leaves ``write_units`` at 0 and the tail ops then
        # tick the ordinary check schedule.  Resetting here and replaying
        # the tail WITH live counters lands the amortized-trigger phase
        # exactly where the sync world lands it, so future trigger timing
        # agrees.
        self._write_units = 0
        self._spill_pending = False

        def _replay_tail():
            self._in_handoff_replay = True
            try:
                with obs.span("compact.tail_replay", ops=len(ops)):
                    for op in ops:
                        if op[0] == "i":
                            self.insert(op[1], ids=op[2])
                        else:
                            self.delete(op[1])
            finally:
                self._in_handoff_replay = False

        if self.durable is not None:
            self.durable.handoff_rotate(self, _replay_tail, relearned)
        else:
            _replay_tail()
        self.background_compactions += 1
        self.last_handoff_s = time.perf_counter() - self._handoff_t0
        g = obs.get_registry()
        g.counter("coax_compactions_total", "epoch rebuilds installed",
                  ("mode",)).inc(mode="background")
        g.histogram("coax_handoff_seconds",
                    "background build start -> tail replayed").observe(
                        self.last_handoff_s)
        return True

    def finish_handoff(self) -> bool:
        """Block until any in-flight background build is installed —
        called before checkpoints, a synchronous ``compact()`` and at
        ``QueryServer.close`` (the §8.1 graceful-shutdown join)."""
        return self.poll_handoff(wait=True)

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, ids) of every live row: snapshot survivors + delta logs —
        the compaction feed, and the scratch-rebuild oracle's input."""
        dead = self._dead_ids()
        if dead.size:
            keep = ~sorted_contains(dead, self.row_ids)
            rows, ids = self.data[keep], self.row_ids[keep]
        else:
            rows, ids = self.data, self.row_ids
        dp_rows, dp_ids = self.delta_primary.live_log()
        do_rows, do_ids = self.delta_outlier.live_log()
        if dp_ids.size or do_ids.size:
            rows = np.concatenate([rows, dp_rows, do_rows])
            ids = np.concatenate([ids, dp_ids, do_ids])
        return rows, ids

    def compact(self, relearn: Optional[bool] = None) -> dict:
        """Merge the delta planes into rebuilt snapshot grids.

        Materialises the live row set, optionally re-runs ``learn_soft_fds``
        (``relearn=None`` relearns iff the drift gate says the frozen models
        decayed), refits both grid files, resets the delta planes, and bumps
        the epoch — which is what invalidates any frozen ``DevicePlan``:
        the rebuilt ``GridFile``s carry the new epoch and lazily build fresh
        plans on first device use (DESIGN.md §5 invalidation contract).
        Any in-flight background build is folded in first, so explicit
        compaction composes with the §5.4 handoff machinery.
        """
        self.poll_handoff(wait=True)   # fold an in-flight handoff first
        if relearn is None:
            relearn = self.drift_predictability() < self.config.drift_threshold
        t0 = time.perf_counter()
        with obs.span("compact.sync", epoch=self.epoch + 1):
            rows, ids = self.live_rows()
            bk = self.backend
            self.data = np.ascontiguousarray(rows, dtype=np.float32)
            self.row_ids = np.asarray(ids, dtype=np.int64)
            relearned = bool(relearn) and self.data.shape[0] >= 64
            if relearned:
                self.groups = learn_soft_fds(self.data, self.config.softfd)
                self.keep_dims = reduced_dims(self.n_dims, self.groups)
            self.epoch += 1
            self.compactions += 1
            self._fit()
            self.backend = bk
        g = obs.get_registry()
        g.counter("coax_compactions_total", "epoch rebuilds installed",
                  ("mode",)).inc(mode="sync")
        g.histogram("coax_compact_sync_seconds",
                    "stop-the-world rebuild time").observe(
                        time.perf_counter() - t0)
        # what THIS compaction decided (the rotation control frame a
        # replication hub ships, DESIGN.md §8.2, replays it verbatim)
        self._last_compact_relearned = relearned
        if self.durable is not None:
            # new epoch snapshot + WAL rotation — the §7.5 truncation point
            self.durable.on_compact(self)
        return {"epoch": self.epoch, "rows": int(self.data.shape[0]),
                "relearned": relearned}

    def _dead_ids(self) -> np.ndarray:
        """Tombstoned ids across both planes, SORTED (the hit-masking
        paths binary-search this instead of ``isin``-sorting per wave)."""
        dead = np.concatenate([self.delta_primary.dead_ids(),
                               self.delta_outlier.dead_ids()])
        dead.sort()
        return dead

    # ------------------------------------------------------------------ #
    # State handover and durability (DESIGN.md §7): full-state capture,
    # save/restore
    # ------------------------------------------------------------------ #
    def _tracker_keys(self) -> List[Tuple[int, int]]:
        """(group index, dependent) pairs in the canonical (frozen) order —
        the serialisation order of tracker sufficient statistics."""
        return [(gi, dep) for gi, g in enumerate(self.groups)
                for dep in g.dependents]

    def state(self) -> dict:
        """This index as the plain data ``from_state`` takes (arrays are
        the live ones, not copies) — also what a snapshot packs.  An
        in-flight background build is folded in first, so the state is one
        whole epoch; called from inside ``poll_handoff`` and ``compact``
        (the durability plane's snapshots), the build is already cleared
        and the join is a no-op."""
        self.finish_handoff()
        keys = self._tracker_keys()
        n_groups = range(len(self.groups))
        return {
            "data": self.data, "row_ids": self.row_ids,
            "next_id": self._next_id, "epoch": self.epoch,
            "compactions": self.compactions,
            "primary_ratio": self.primary_ratio,
            "config": dataclasses.asdict(self.config),
            "groups": [{"predictor": g.predictor,
                        "dependents": list(g.dependents),
                        "models": {d: dataclasses.astuple(m)
                                   for d, m in g.models.items()}}
                       for g in self.groups],
            "primary": self.primary.state_dict(),
            "outlier": self.outlier.state_dict(),
            "outlier_lo": self._outlier_lo, "outlier_hi": self._outlier_hi,
            "delta_primary": self.delta_primary.state_dict(),
            "delta_outlier": self.delta_outlier.state_dict(),
            "write_units": self._write_units,
            "spill_pending": self._spill_pending,
            "trigger_checks": self.trigger_checks,
            "tracker_xtx": [self._fd_trackers[k].xtx for k in keys],
            "tracker_xty": [self._fd_trackers[k].xty for k in keys],
            "tracker_lam": [self._fd_trackers[k].lam for k in keys],
            "x_scale": [self._x_scale[gi] for gi in n_groups],
            "viol_total": [self._viol_total[gi] for gi in n_groups],
            "viol_bad": [self._viol_bad[gi] for gi in n_groups],
        }

    @classmethod
    def from_state(cls, state: dict, backend: str = "device",
                   device_opts: Optional[dict] = None,
                   device: str = "cuda") -> "COAXIndex":
        """Rebuild an index from plain data WITHOUT refitting: grids,
        trackers and delta planes come back verbatim, so every query on
        any backend, and every future write/compaction decision, behaves
        exactly as the index that produced ``state`` would have.

        ``state`` holds numpy arrays, numbers and dicts only: ``data``,
        ``row_ids``, ``next_id``, ``epoch``, ``compactions``,
        ``primary_ratio``, ``outlier_lo``/``outlier_hi`` (None when there
        are no outliers), ``primary``/``outlier`` (``GridFile.state_dict``
        dicts), ``delta_primary``/``delta_outlier``
        (``DeltaPlane.state_dict`` dicts), ``write_units``,
        ``spill_pending``, ``trigger_checks``, ``tracker_xtx``/
        ``tracker_xty``/``tracker_lam``, ``x_scale``, ``viol_total``/
        ``viol_bad``; ``config`` is a dict of ``CoaxConfig`` fields (its
        ``softfd`` a dict of ``SoftFDConfig`` fields) and ``groups`` a list
        of ``{"predictor", "dependents", "models": {dep: (m, b, eps_lb,
        eps_ub)}}``."""
        cfg = dict(state["config"])
        cfg["softfd"] = SoftFDConfig(**cfg["softfd"])
        config = CoaxConfig(**cfg)
        idx = cls.__new__(cls)
        idx.config = config
        idx.data = np.ascontiguousarray(state["data"], dtype=np.float32)
        idx.n_dims = idx.data.shape[1]
        idx.row_ids = np.asarray(state["row_ids"], dtype=np.int64)
        idx._next_id = int(state["next_id"])
        idx.epoch = int(state["epoch"])
        idx.compactions = int(state["compactions"])
        idx.primary_ratio = float(state["primary_ratio"])
        idx.groups = [
            FDGroup(int(g["predictor"]),
                    tuple(int(d) for d in g["dependents"]),
                    {int(d): LinearModel(*(float(v) for v in mdl))
                     for d, mdl in g["models"].items()})
            for g in state["groups"]]
        idx.keep_dims = reduced_dims(idx.n_dims, idx.groups)
        idx._device_opts = device_opts
        idx._device = str(device)
        idx._coax_plan = None
        idx.last_batch_stats = BatchStats()
        idx.durable = None
        idx.primary = GridFile.from_state(state["primary"],
                                          device_opts=device_opts,
                                          device=idx._device)
        idx.outlier = GridFile.from_state(state["outlier"],
                                          device_opts=device_opts,
                                          device=idx._device)
        idx._outlier_lo = state["outlier_lo"]
        idx._outlier_hi = state["outlier_hi"]
        idx._base_primary_ids = np.sort(idx.primary.row_ids)
        idx._base_outlier_ids = np.sort(idx.outlier.row_ids)
        kd = idx._delta_key_dim()
        spill = idx.config.delta_l0_spill
        idx.delta_primary = DeltaPlane.from_state(
            idx.n_dims, state["delta_primary"], key_dim=kd, l0_spill=spill)
        idx.delta_outlier = DeltaPlane.from_state(
            idx.n_dims, state["delta_outlier"], key_dim=kd, l0_spill=spill)
        idx._init_write_state()
        idx._write_units = int(state["write_units"])
        idx._spill_pending = bool(state["spill_pending"])
        idx.trigger_checks = int(state["trigger_checks"])
        keys = idx._tracker_keys()
        xtx, xty = state["tracker_xtx"], state["tracker_xty"]
        lam = state["tracker_lam"]
        idx._fd_trackers = {
            k: BayesianLinearModel(np.array(xtx[i], np.float64),
                                   np.array(xty[i], np.float64),
                                   float(lam[i]))
            for i, k in enumerate(keys)
        }
        idx._x_scale = {gi: float(s) for gi, s in enumerate(state["x_scale"])}
        idx._viol_total = {gi: int(v)
                           for gi, v in enumerate(state["viol_total"])}
        idx._viol_bad = {gi: int(v) for gi, v in enumerate(state["viol_bad"])}
        idx.backend = backend
        return idx

    def save(self, directory, keep: Optional[int] = None):
        """One-shot full-state snapshot into ``directory`` (atomic staged
        rename; newest-complete wins at restore).  Returns the snapshot
        path.  Saving into the attached durability directory routes through
        ``Durability.checkpoint`` so the snapshot's ``wal_seq`` stays
        consistent with the journal; any other target gets a self-contained
        snapshot (the cold-start-replica / shard-migration artifact)."""
        from pathlib import Path
        from ..storage import write_snapshot
        if (self.durable is not None
                and Path(directory).resolve() == self.durable.directory.resolve()):
            return self.durable.checkpoint(keep=keep)
        return write_snapshot(self, directory, keep=keep)

    @classmethod
    def restore(cls, directory, backend: str = "device",
                device_opts: Optional[dict] = None,
                durable: bool = False, device: str = "cuda") -> "COAXIndex":
        """Load the newest complete snapshot under ``directory`` and replay
        the matching WAL tail; ``durable=True`` re-attaches the durability
        plane so the recovered index keeps journaling where the crashed one
        stopped.  See ``repro_torch.storage.restore``."""
        from ..storage import restore as _restore
        idx = _restore(directory, backend=backend, device_opts=device_opts,
                       durable=durable, device=device)
        if not isinstance(idx, cls):
            raise TypeError(f"{directory} holds a {type(idx).__name__} "
                            f"snapshot, not {cls.__name__}")
        return idx

    def attach_durability(self, directory, keep: int = 3,
                          sync_every_op: bool = False) -> "COAXIndex":
        """Start journaling this index's writes under ``directory``: writes
        the current epoch snapshot if missing and opens the epoch's WAL.
        Returns self."""
        from ..storage import Durability
        Durability.attach(self, directory, keep=keep,
                          sync_every_op=sync_every_op)
        return self

    # ------------------------------------------------------------------ #
    def translate(self, rect: Rect) -> np.ndarray:
        """Eq. 2 translation of a full rect onto the indexed dims."""
        return translate_rect(rect, self.groups, self.keep_dims)

    def query(self, rect: Rect) -> np.ndarray:
        self._poll_entry()
        rect = np.asarray(rect, dtype=np.float64)
        nav = self.translate(rect)
        hits = [self.primary.query(nav, rect)]
        # half-open rects: [lo, hi) intersects [blo, bhi] iff lo <= bhi, hi > blo
        if self._outlier_lo is not None and bool(
            np.all((rect[:, 0] <= self._outlier_hi) & (rect[:, 1] > self._outlier_lo))
        ):
            o_nav = rect.copy()
            hits.append(self.outlier.query(o_nav, rect))
        out = np.concatenate(hits) if len(hits) > 1 else hits[0]
        dead = self._dead_ids()
        if dead.size and out.size:
            out = out[~sorted_contains(dead, out)]
        d1 = self.delta_primary.scan(rect)
        d2 = self.delta_outlier.scan(rect)
        if d1.size or d2.size:
            out = np.concatenate([out, d1, d2])
        return np.sort(out)

    # ------------------------------------------------------------------ #
    def translate_batch(self, rects: np.ndarray) -> np.ndarray:
        """Batched Eq. 2: (B, D, 2) full rects -> (B, K, 2) nav-rects."""
        return translate_rects(rects, self.groups, self.keep_dims)

    def query_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Answer B range queries in one vectorised pass.

        rects : (B, D, 2).  Returns ``(query_ids, row_ids)`` sorted by
        (query_id, row_id); per query the row-id set is exactly what
        ``query`` returns.  One translation pass, one primary directory
        probe and one outlier probe are shared by the whole batch; the
        §8.2.3 outlier skip is a vectorised bbox test.

        ``backend="device"`` serves the wave from the §4 COAX device plan —
        primary + outlier + delta/tombstone segments in ONE wave dispatch
        (``query_batch_submit`` + ``query_batch_collect``, which pipelined
        callers may drive directly to overlap waves); on the CPU route,
        waves whose candidate cells overflow ``cell_cap`` fall back to the
        host path.  Either way the answer is bit-identical to the numpy
        backend.

        With an attached ``SemanticCache`` (``attach_cache``) the wave is
        consulted first (DESIGN.md §9.2): exact/contained rects answer from
        the cache, only the misses run the pipeline (and are admitted
        back), and the merged answer is bit-identical to the uncached path.
        """
        self._poll_entry()
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        if b == 0:
            self.last_batch_stats = BatchStats(backend=self.backend)
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if self.backend == "device":
            return self.query_batch_collect(self.query_batch_submit(rects))
        route = self._cache_route(rects)
        if route is None:
            q_p, r_p, stats = self._query_batch_host(rects,
                                                     self.translate_batch(rects))
            self.last_batch_stats = stats
            return q_p, r_p
        answers, miss, version = route
        if miss.size:
            sub = np.ascontiguousarray(rects[miss])
            q_m, r_m, stats = self._query_batch_host(sub,
                                                     self.translate_batch(sub))
            self._cache_admit(version, sub, q_m, r_m)
        else:
            q_m = r_m = np.empty(0, np.int64)
            stats = BatchStats(backend=self.backend)
        self.last_batch_stats = dataclasses.replace(stats, queries=b)
        return self._merge_cached(answers, miss, q_m, r_m)

    def _query_batch_host(self, rects: np.ndarray, nav: np.ndarray,
                          fallbacks: int = 0):
        """The exact host composition (DESIGN.md §5): snapshot grids via the
        numpy path, tombstone mask, exact delta scans — the numpy backend's
        ``query_batch`` body and the device plan's ``cell_cap``-fallback
        path.  Returns ``(query_ids, row_ids, BatchStats)``."""
        b = rects.shape[0]
        q_p, r_p = self.primary._query_batch_numpy(nav, rects)
        stats = dataclasses.replace(self.primary.last_batch_stats,
                                    queries=b, backend=self.backend,
                                    fallbacks=fallbacks)

        if self._outlier_lo is not None:
            # same half-open/closed-bbox intersection test as ``query``
            touch = np.all(
                (rects[:, :, 0] <= self._outlier_hi) & (rects[:, :, 1] > self._outlier_lo),
                axis=1,
            )
            if touch.any():
                sub = rects[touch]
                q_o, r_o = self.outlier._query_batch_numpy(sub, sub)
                stats = stats.merge(self.outlier.last_batch_stats)
                if r_o.size:
                    q_o = np.nonzero(touch)[0][q_o]    # sub-batch ids -> batch ids
                    q_p = np.concatenate([q_p, q_o])
                    r_p = np.concatenate([r_p, r_o])
                    order = np.lexsort((r_p, q_p))     # merge the two hit lists
                    q_p, r_p = q_p[order], r_p[order]

        q_d1, r_d1 = self.delta_primary.scan_batch(rects)
        q_d2, r_d2 = self.delta_outlier.scan_batch(rects)
        with obs.stage_timer("merge", self.backend):
            dead = self._dead_ids()
            if dead.size and r_p.size:
                keep = ~sorted_contains(dead, r_p)
                q_p, r_p = q_p[keep], r_p[keep]
            if r_d1.size or r_d2.size:
                q_p = np.concatenate([q_p, q_d1, q_d2])
                r_p = np.concatenate([r_p, r_d1, r_d2])
                order = np.lexsort((r_p, q_p))
                q_p, r_p = q_p[order], r_p[order]
        # delta work actually done: run-window candidates + dense L0 rows
        # (was b * delta_rows before the §5.3 tiered runs)
        stats.rows_scanned += (self.delta_primary.last_scan_probed
                               + self.delta_outlier.last_scan_probed)
        return q_p, r_p, stats

    # ------------------------------------------------------------------ #
    # Semantic result cache (DESIGN.md §9.1–§9.2) + pinned-epoch MVCC
    # reads (§9.3).  The cache consults BEFORE the pipeline and admits
    # after it; pins capture the current epoch's objects for readers that
    # must stay on it across background-compaction handoffs.
    # ------------------------------------------------------------------ #
    def attach_cache(self, byte_budget: int = 64 << 20,
                     max_entries: int = 512,
                     shard_id: Optional[int] = None) -> "COAXIndex":
        """Attach a rect-containment ``SemanticCache`` (DESIGN.md §9.2) to
        every batched read path (numpy and device).  ``shard_id`` is set by
        ``ShardedCOAX.attach_cache`` so entries key on (shard, the shard's
        OWN version), never an aggregate epoch.  Returns self."""
        from ..engine.cache import SemanticCache
        self.cache = SemanticCache(byte_budget=byte_budget,
                                   max_entries=max_entries,
                                   shard_id=shard_id)
        self.last_cache_stats = None
        return self

    def detach_cache(self) -> None:
        self.cache = None
        self.last_cache_stats = None

    def _cache_version(self) -> tuple:
        """The write-state version cache entries are keyed on (§9.2):
        epoch plus both planes' log/tombstone counters.  Every component
        is monotone within an epoch and the epoch is monotone across
        compactions, so ANY write — insert, delete, or an installed
        handoff — moves the key and strands stale entries."""
        dp, do = self.delta_primary, self.delta_outlier
        return (self.epoch, dp.n_log, dp.n_tombstones,
                do.n_log, do.n_tombstones)

    def _cache_route(self, rects: np.ndarray):
        """Consult the cache for a wave: ``None`` when no cache is
        attached, else ``(answers, miss_indices, version)`` with per-wave
        stats latched on ``last_cache_stats`` (read by the executor at
        submit time, §9.2)."""
        if self.cache is None:
            return None
        with obs.span("cache.route", queries=int(rects.shape[0])) as sp:
            with obs.stage_timer("cache_route", self.backend):
                version = self._cache_version()
                answers, stats = self.cache.lookup_wave(version, rects)
            if sp is not None:
                sp.args.update(hits=stats.hits, partial=stats.partial)
        self.last_cache_stats = stats
        miss = np.array([i for i, a in enumerate(answers) if a is None],
                        dtype=np.int64)
        return answers, miss, version

    def _cache_admit(self, version: tuple, rects: np.ndarray,
                     qids: np.ndarray, rids: np.ndarray) -> None:
        """Admit freshly answered rects.  Skipped wholesale when the live
        version moved since the wave was routed (the §9.2 stale-admission
        gate: a pipelined device wave may drain after writes — or a
        handoff — landed; its answer is correct for the OLD version but
        must not be stored under the new key)."""
        if self.cache is None or version != self._cache_version():
            return
        with obs.span("cache.admit", queries=int(rects.shape[0])):
            with obs.stage_timer("cache_admit", self.backend):
                for rect, ids in zip(rects,
                                     split_hits(qids, rids, rects.shape[0])):
                    self.cache.admit(version, rect, ids,
                                     self.rows_for_ids(ids))

    @staticmethod
    def _merge_cached(answers, miss, q_m, r_m):
        """Merge cached per-query answers with the miss sub-batch's flat
        hits back into the ``query_batch`` contract, sorted by (query,
        row), without a sort: cached id arrays are sorted, the miss hits
        come sorted by (sub-batch query, row) and ``miss`` is increasing,
        so laying the per-query arrays out in query order is that order."""
        parts = list(answers)
        if miss.size:
            for i, ids in zip(miss.tolist(), split_hits(q_m, r_m, miss.size)):
                parts[i] = ids
        sizes = np.array([0 if a is None else a.size for a in parts],
                         dtype=np.int64)
        if not sizes.any():
            return np.empty(0, np.int64), np.empty(0, np.int64)
        q = np.repeat(np.arange(len(parts), dtype=np.int64), sizes)
        r = np.concatenate([a for a in parts if a is not None and a.size])
        return q, r

    def rows_for_ids(self, ids: np.ndarray) -> np.ndarray:
        """(m, D) f32 row values for LIVE original ids — the §9.2 cache-
        admission gather.  Snapshot ids resolve through a cached argsort of
        ``row_ids`` (reset at every epoch install), the rest through the
        delta planes' own gathers.  Raises ``KeyError`` for ids in neither
        (a query's hit ids are always resolvable at its own version)."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((ids.shape[0], self.n_dims), dtype=np.float32)
        if ids.size == 0:
            return out
        if self._id_order_cache is None:
            order = np.argsort(self.row_ids, kind="stable")
            self._id_order_cache = (order, self.row_ids[order])
        order, sids = self._id_order_cache
        if sids.size:
            pos = np.searchsorted(sids, ids)
            pos[pos == sids.size] = sids.size - 1
            found = sids[pos] == ids
            if found.any():
                out[found] = self.data[order[pos[found]]]
        else:
            found = np.zeros(ids.shape, dtype=bool)
        rest = np.nonzero(~found)[0]
        if rest.size:
            f1, rows1 = self.delta_primary.rows_for_ids(ids[rest])
            out[rest[f1]] = rows1
            rem = rest[~f1]
            if rem.size:
                f2, rows2 = self.delta_outlier.rows_for_ids(ids[rem])
                out[rem[f2]] = rows2
                if not f2.all():
                    raise KeyError(
                        f"{int((~f2).sum())} ids not in snapshot or delta logs")
        return out

    def pin_epoch(self):
        """Open an MVCC read handle on the CURRENT epoch (DESIGN.md §9.3):
        the returned ``EpochPin`` keeps this epoch's grids, device plan and
        a frozen delta image alive — refcounted in ``_pins`` — so its
        answers stay bit-identical to this instant while writes and
        background-compaction handoffs (§5.4) move the serving index to
        newer epochs.  Release (or ``with``-exit) the pin to free the old
        epoch once the serving index has moved on."""
        self._poll_entry()
        from ..engine.cache import EpochPin
        pin = EpochPin(self)
        self._pins[pin.epoch] = self._pins.get(pin.epoch, 0) + 1
        return pin

    def _release_pin(self, epoch: int) -> None:
        n = self._pins.get(epoch, 0)
        if n <= 1:
            self._pins.pop(epoch, None)
        else:
            self._pins[epoch] = n - 1

    @property
    def pinned_epochs(self) -> List[int]:
        """Epochs with at least one live ``EpochPin`` (§9.3)."""
        return sorted(self._pins)

    # ------------------------------------------------------------------ #
    # Device wave pipelining (DESIGN.md §4): submit launches the fused
    # kernel without transferring results; collect is the drain point.
    # ------------------------------------------------------------------ #
    def _device_plan_obj(self):
        """Lazily (re)build the §4 COAX device plan for the CURRENT epoch
        grids; compaction swaps the grids, which invalidates by identity.
        Raises when the plan's device is absent — the device backend never
        degrades quietly to the host path."""
        plan = self._coax_plan
        if (plan is not None and plan.primary is self.primary
                and plan.outlier is self.outlier):
            return plan
        from ..engine.device import CoaxDevicePlan
        fresh = CoaxDevicePlan(self, device=self._device,
                               **(self._device_opts or {}))
        if plan is not None:       # carry counters AND the shape cache
            fresh.adopt(plan)      # across epoch swaps
        self._coax_plan = fresh
        return fresh

    def query_batch_submit(self, rects: np.ndarray,
                           nav: Optional[np.ndarray] = None):
        """Launch one device wave (ONE dispatch) and return a handle for
        ``query_batch_collect`` — results stay device-resident until then.
        Waves the plan cannot serve (``cell_cap`` overflow, CPU route only)
        are answered synchronously here by the host path, so the handle ALWAYS reflects
        this submit's snapshot+delta state even if writes land before
        collection (per-wave snapshot semantics).  A finished background
        build is folded in HERE, before the wave's snapshot is captured —
        wave-boundary handoff visibility (§5.4).
        With a cache attached the wave is consulted against it first and
        only the misses are submitted; the handle carries the cached
        answers so ``query_batch_collect`` can merge them back (§9.2)."""
        self._poll_entry()
        rects = np.asarray(rects, dtype=np.float64)
        route = self._cache_route(rects) if rects.shape[0] else None
        if route is None:
            return self._submit_uncached(rects, nav)
        answers, miss, version = route
        if miss.size == rects.shape[0]:          # all missed: plain wave
            sub = rects
            inner = self._submit_uncached(rects, nav)
        elif miss.size:                          # partial: submit subset
            sub = np.ascontiguousarray(rects[miss])
            inner = self._submit_uncached(sub, None)
        else:                                    # fully answered from cache
            sub = rects[:0]
            inner = ("host", np.empty(0, np.int64), np.empty(0, np.int64),
                     BatchStats(backend=self.backend))
        return ("cache", answers, miss, version, sub, inner)

    def _submit_uncached(self, rects: np.ndarray,
                         nav: Optional[np.ndarray] = None):
        """``query_batch_submit`` without the cache: one device wave (or
        its host fallback) over exactly ``rects``."""
        if nav is None:
            nav = self.translate_batch(rects) if rects.shape[0] else None
        fallbacks = 0
        if rects.shape[0]:
            plan = self._device_plan_obj()
            ticket = plan.submit_wave(nav, rects)
            if ticket is not None:
                return ("dev", plan, ticket)
            fallbacks = 1                      # cell_cap overflow -> host
            q, r, stats = self._query_batch_host(rects, nav, fallbacks)
        else:
            q = r = np.empty(0, np.int64)
            stats = BatchStats(backend=self.backend)
        return ("host", q, r, stats)

    def query_batch_collect(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Drain one submitted wave (wait on its completion event, copy the
        compacted hit buffers back) and return its ``query_batch`` answer.
        Cache-wrapped handles drain the miss sub-wave, admit its answers
        (gated on the version still matching, §9.2), and merge with the
        handle's cached answers."""
        if handle[0] != "cache":
            return self._collect_uncached(handle)
        _, answers, miss, version, sub, inner = handle
        q_m, r_m = self._collect_uncached(inner)
        if miss.size:
            self._cache_admit(version, sub, q_m, r_m)
        self.last_batch_stats = dataclasses.replace(
            self.last_batch_stats, queries=len(answers))
        return self._merge_cached(answers, miss, q_m, r_m)

    def _collect_uncached(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        if handle[0] == "host":
            _, q, r, stats = handle
            self.last_batch_stats = stats
            return q, r
        _, plan, ticket = handle
        q, r, stats = plan.collect(ticket)
        self.last_batch_stats = dataclasses.replace(stats,
                                                    backend=self.backend)
        return q, r

    def device_stats(self) -> Optional[dict]:
        """Device-plane rollups (distinct launch shapes, wave dispatches,
        transfer bytes both ways), or None before any device wave."""
        plan = self._coax_plan
        if plan is None:
            return None
        return {"compile_count": plan.compile_count,
                "dispatches": plan.dispatch_count,
                "bytes_h2d": plan.bytes_h2d,
                "bytes_d2h": plan.bytes_d2h}

    def query_batch_split(self, rects: np.ndarray) -> List[np.ndarray]:
        """``query_batch`` reshaped to one sorted row-id array per rect."""
        rects = np.asarray(rects, dtype=np.float64)
        qids, rids = self.query_batch(rects)
        return split_hits(qids, rids, rects.shape[0])

    # ------------------------------------------------------------------ #
    def memory_footprint(self) -> int:
        """Bytes actually held beyond the snapshot payload: both grid
        directories, the soft-FD model parameters, the live drift trackers,
        the §8.2.3 outlier bbox arrays, the delta structures, the cache's
        resident entries and — when a durability plane is attached — the
        WAL tail appended but not yet fsynced (page-cache resident until
        the wave-boundary sync, §7.2)."""
        model_bytes = sum(len(g.dependents) * 4 * 8 + 8 for g in self.groups)
        tracker_bytes = len(self._fd_trackers) * 7 * 8     # xtx(4)+xty(2)+lam
        bbox_bytes = (self._outlier_lo.nbytes + self._outlier_hi.nbytes
                      if self._outlier_lo is not None else 0)
        delta_bytes = self.delta_primary.nbytes() + self.delta_outlier.nbytes()
        wal_pending = (self.durable.wal_pending_bytes
                       if self.durable is not None else 0)
        cache_bytes = self.cache.nbytes if self.cache is not None else 0
        return (self.primary.memory_footprint() + self.outlier.memory_footprint()
                + model_bytes + tracker_bytes + bbox_bytes + delta_bytes
                + wal_pending + cache_bytes)

    def describe(self) -> dict:
        return {
            "n_rows": self.n_rows,
            "base_rows": int(self.data.shape[0]),
            "n_dims": self.n_dims,
            "groups": [
                {
                    "predictor": g.predictor,
                    "dependents": list(g.dependents),
                    "models": {
                        int(d): dataclasses.asdict(m) for d, m in g.models.items()
                    },
                }
                for g in self.groups
            ],
            "indexed_dims": self.keep_dims,
            "grid_dims": self.primary.grid_dims,
            "sort_dim": self.primary.sort_dim,
            "primary_ratio": self.primary_ratio,
            "primary_cells": self.primary.n_cells,
            "outlier_cells": self.outlier.n_cells,
            "epoch": self.epoch,
            "compactions": self.compactions,
            "trigger_checks": self.trigger_checks,
            "write_units": self._write_units,
            "background": {
                "enabled": self.config.background_compact,
                "in_flight": self._handoff_thread is not None,
                "completed": self.background_compactions,
                "last_handoff_s": self.last_handoff_s,
            },
            "delta_primary": self.delta_primary.describe(),
            "delta_outlier": self.delta_outlier.describe(),
            "tombstones": self.tombstone_count,
            "drift_predictability": self.drift_predictability(),
            "outlier_bbox_bytes": (self._outlier_lo.nbytes + self._outlier_hi.nbytes
                                   if self._outlier_lo is not None else 0),
            "memory_footprint_bytes": self.memory_footprint(),
            "pinned_epochs": self.pinned_epochs,
            "cache": (self.cache.describe() if self.cache is not None else None),
            "durability": (self.durable.describe()
                           if self.durable is not None else None),
        }
