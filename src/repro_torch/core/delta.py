"""Delta plane: the write path of the mutable index lifecycle (DESIGN.md §5).

A ``DeltaPlane`` is the mutable companion of one frozen sub-index snapshot
(a ``GridFile`` epoch): an append-only log of inserted rows plus a tombstone
set for deletes.  Every query's full predicate is evaluated *exactly*
against every live log row — correctness never depends on any learned
structure — but the plane no longer scans the whole log linearly per query.

Tiered sorted runs (DESIGN.md §5.3): the canonical append-order log is
untouched (it is the WAL-replay image and the compaction feed), but the
plane maintains *derived* sorted views over prefixes of it:

* **L0** — the unorganized tail of the log, at most ``l0_spill`` rows,
  scanned densely per query (it is tiny by construction);
* **L1+ runs** — when L0 reaches ``l0_spill`` rows it *spills*: a stable
  argsort of the tail's ``key_dim`` values becomes a new sorted run
  (a permutation of log positions + their sorted keys).  Adjacent runs
  tier-merge while the older neighbour is ≤ 2x the newer one, so run
  count stays O(log n) and merge work is amortized O(log n) per row.

A query then probes each run with two ``searchsorted`` calls on the key
dimension — ``[searchsorted(keys, lo), searchsorted(keys, hi))`` is exactly
the half-open membership ``lo <= key < hi`` after the f32→f64 upcast — and
evaluates the remaining dimensions only on rows inside the window.  Run
structure is a cache detail for *results* (any partition of the log yields
the same hit set), but the ``organized`` boundary is serialized so the L0
fill level — and therefore spill-triggered compaction-check timing — is
bit-reproducible across snapshot/restore (DESIGN.md §7.3).

Tombstones cover two id populations with one mechanism:

* *base* ids — rows frozen into the snapshot this plane shadows; the
  snapshot keeps returning them, so query paths mask them out with
  ``is_dead``;
* *log* ids — rows inserted after the snapshot; ``scan``/``scan_batch``
  exclude them at the source.  The log itself is never rewritten (append
  only); space is reclaimed at compaction, when live log rows merge into
  the next snapshot epoch and the plane resets empty.

Exactness argument (delta ∪ snapshot; DESIGN.md §5): scans compare the
float32 log rows against the float64 rect with numpy's usual upcast —
mathematically ``lo <= v < hi`` on the exact f32 value, the same membership
test the frozen numpy/device paths implement (``f32_ceil`` rounding is
provably equivalent, see ``gridfile.f32_ceil``).  The key-dim window probe
is the same predicate evaluated by binary search on the sorted (upcast)
keys, so a row hits in a run iff it would hit in the dense scan.  The union
(snapshot hits − tombstones) ∪ (live log hits) equals a scratch rebuild
from the final row set, bit for bit, on every backend.

Durability (DESIGN.md §7): the plane is exactly the state the write-ahead
log reconstructs — ``storage.wal`` records one frame per ``COAXIndex``
insert/delete call, and replaying them through the ordinary write paths
refills these logs and tombstone sets bit for bit.  ``state_dict`` /
``from_state`` additionally let a mid-epoch snapshot (``COAXIndex.save``)
carry the plane directly, so restore cost is bounded by the WAL tail, not
the epoch's whole write history.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from .. import obs
from .types import Rect, rect_contains, sorted_contains

__all__ = ["DeltaPlane", "FrozenDelta"]

L0_SPILL_DEFAULT = 256


def _multi_arange(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(starts[i], starts[i]+lens[i])`` without a
    Python loop (the cumsum trick, same as ``engine.device._multi_arange``).
    All ``lens`` must be > 0."""
    total = int(lens.sum())
    step = np.ones(total, dtype=np.int64)
    step[0] = starts[0]
    ends = starts + lens
    offs = np.cumsum(lens[:-1])
    step[offs] = starts[1:] - ends[:-1] + 1
    return np.cumsum(step)


class DeltaPlane:
    """Append log of inserted rows + tombstone set for one sub-index,
    organized into tiered sorted runs for sub-linear range probes.

    Parameters
    ----------
    n_dims : attribute count of the table (log rows are (M, n_dims) f32).
    key_dim : the dimension runs are sorted on — the owning index passes
        its first FD-dependent attribute (the dimension range queries are
        translated onto, so windows are selective) or its sort dim.
    l0_spill : L0 rows that trigger a spill into a sorted run.
    """

    def __init__(self, n_dims: int, key_dim: int = 0,
                 l0_spill: int = L0_SPILL_DEFAULT):
        self.n_dims = int(n_dims)
        key_dim = int(key_dim)
        self.key_dim = key_dim if 0 <= key_dim < self.n_dims else 0
        self.l0_spill = max(int(l0_spill), 1)
        self._chunks: List[np.ndarray] = []      # appended (m, D) f32 blocks
        self._id_chunks: List[np.ndarray] = []   # appended (m,) i64 blocks
        self._dead: set = set()                  # tombstoned ids (log or base)
        self.n_log = 0                           # rows ever appended
        self.n_log_dead = 0                      # log rows later tombstoned
        self.n_base_dead = 0                     # snapshot rows tombstoned
        # tiered runs: (abs log positions, sorted f64 keys) per run, oldest
        # first; positions [_organized, n_log) are the L0 tail
        self._runs: List[Tuple[np.ndarray, np.ndarray]] = []
        self._organized = 0
        self.spills = 0                          # L0 → run spills performed
        self.merges = 0                          # tier merges performed
        self.rows_probed = 0                     # candidate rows ever touched
        self.last_scan_probed = 0                # ... by the latest scan_batch
        self._rows_cache: Optional[np.ndarray] = None
        self._rows64_cache: Optional[np.ndarray] = None
        self._ids_cache: Optional[np.ndarray] = None
        self._log_id_set: set = set()            # O(1) tombstone membership
        self._live_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._alive_cache: Optional[np.ndarray] = None
        self._dead_cache: Optional[np.ndarray] = None
        self._order_cache: Optional[np.ndarray] = None   # argsort of log_ids

    # ------------------------------------------------------------------ #
    @property
    def n_live(self) -> int:
        """Live (non-tombstoned) log rows."""
        return self.n_log - self.n_log_dead

    @property
    def n_tombstones(self) -> int:
        """All tombstones this plane holds (log + base)."""
        return self.n_log_dead + self.n_base_dead

    @property
    def n_runs(self) -> int:
        return len(self._runs)

    @property
    def l0_rows(self) -> int:
        """Rows in the unorganized L0 tail."""
        return self.n_log - self._organized

    def __len__(self) -> int:
        return self.n_live

    # ------------------------------------------------------------------ #
    def insert(self, rows: np.ndarray, ids: np.ndarray) -> int:
        """Append rows with their (new, never-seen) original ids.

        Returns the number of L0 spills this append caused (0 or 1) — the
        owning index uses a spill as an amortized compaction-check signal.
        """
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        ids = np.asarray(ids, dtype=np.int64)
        if rows.ndim != 2 or rows.shape[1] != self.n_dims:
            raise ValueError(f"rows must be (m, {self.n_dims}), got {rows.shape}")
        if rows.shape[0] != ids.shape[0]:
            raise ValueError("rows/ids length mismatch")
        m = rows.shape[0]
        if m == 0:
            return 0
        self._chunks.append(rows)
        self._id_chunks.append(ids)
        self._log_id_set.update(ids.tolist())
        self.n_log += m
        self._rows_cache = self._ids_cache = None
        self._rows64_cache = None
        self._live_cache = None
        self._order_cache = None
        if self._alive_cache is not None:   # fresh ids are never dead
            self._alive_cache = np.concatenate(
                [self._alive_cache, np.ones(m, dtype=bool)])
        if self.n_log - self._organized >= self.l0_spill:
            self._spill()
            return 1
        return 0

    def _spill(self) -> None:
        """Organize the whole L0 tail into one sorted run, then tier-merge."""
        lo, hi = self._organized, self.n_log
        keys = self._log_rows()[lo:hi, self.key_dim].astype(np.float64)
        order = np.argsort(keys, kind="stable")
        self._runs.append((np.arange(lo, hi, dtype=np.int64)[order],
                           keys[order]))
        self._organized = hi
        self.spills += 1
        # tier policy: merge while the older neighbour is not much bigger,
        # so run sizes stay geometric and run count O(log n)
        while (len(self._runs) >= 2
               and self._runs[-2][0].size <= 2 * self._runs[-1][0].size):
            p_new, k_new = self._runs.pop()
            p_old, k_old = self._runs.pop()
            keys = np.concatenate([k_old, k_new])
            order = np.argsort(keys, kind="stable")
            self._runs.append((np.concatenate([p_old, p_new])[order],
                               keys[order]))
            self.merges += 1

    def log_ids(self) -> np.ndarray:
        """All ids ever appended (dead included), in append order."""
        if self._ids_cache is None:
            self._ids_cache = (np.concatenate(self._id_chunks)
                               if self._id_chunks else np.empty(0, np.int64))
        return self._ids_cache

    def _log_rows(self) -> np.ndarray:
        if self._rows_cache is None:
            self._rows_cache = (np.concatenate(self._chunks)
                                if self._chunks else
                                np.empty((0, self.n_dims), np.float32))
        return self._rows_cache

    def _log_rows64(self) -> np.ndarray:
        if self._rows64_cache is None:
            self._rows64_cache = self._log_rows().astype(np.float64)
        return self._rows64_cache

    def _alive_mask(self) -> np.ndarray:
        """Per-log-position liveness (False where the id was tombstoned)."""
        if self._alive_cache is None:
            if self._dead:
                self._alive_cache = ~sorted_contains(self.dead_ids(),
                                                     self.log_ids())
            else:
                self._alive_cache = np.ones(self.n_log, dtype=bool)
        return self._alive_cache

    # ------------------------------------------------------------------ #
    def tombstone_log(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone the subset of ``ids`` (UNIQUE ids — the
        ``COAXIndex.delete`` contract) that are live rows of THIS log.

        Returns the boolean mask of ids absorbed (callers route the rest to
        base classification or to another plane).
        """
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0 or self.n_log == 0:
            return np.zeros(ids.shape, dtype=bool)
        # set membership: each delete touches a handful of ids against a
        # log that every insert grows — hashing beats re-sorting per call
        lset, dead = self._log_id_set, self._dead
        absorbed = np.fromiter(
            ((i in lset and i not in dead) for i in ids.tolist()),
            dtype=bool, count=ids.size)
        n_fresh = int(absorbed.sum())
        if n_fresh:
            self._dead.update(ids[absorbed].tolist())
            self.n_log_dead += n_fresh
            self._live_cache = self._dead_cache = self._alive_cache = None
        return absorbed

    def tombstone_base(self, ids: np.ndarray) -> int:
        """Tombstone snapshot ids (caller has verified they belong to this
        plane's base partition).  Returns the count newly dead."""
        ids = np.asarray(ids, dtype=np.int64)
        fresh = set(ids.tolist()) - self._dead
        self._dead |= fresh
        self.n_base_dead += len(fresh)
        if fresh:
            self._dead_cache = self._alive_cache = None
        return len(fresh)

    def dead_ids(self) -> np.ndarray:
        """Sorted array of every tombstoned id (log + base)."""
        if self._dead_cache is None:
            self._dead_cache = np.fromiter(
                self._dead, dtype=np.int64, count=len(self._dead))
            self._dead_cache.sort()
        return self._dead_cache

    def is_dead(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if not self._dead:
            return np.zeros(ids.shape, dtype=bool)
        return sorted_contains(self.dead_ids(), ids)

    # ------------------------------------------------------------------ #
    def live_log(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, ids) of live log entries in APPEND order — the compaction
        feed (append order seeds the next epoch's sampling rng, so it is
        part of bit-identity; run order never leaks here)."""
        if self._live_cache is None:
            rows, ids = self._log_rows(), self.log_ids()
            if self.n_log_dead:
                keep = self._alive_mask()
                rows, ids = rows[keep], ids[keep]
            self._live_cache = (rows, ids)
        return self._live_cache

    def scan(self, rect: Rect) -> np.ndarray:
        """Exact scan: ids of live log rows inside ``rect`` (unsorted)."""
        rows, ids = self.live_log()
        if ids.size == 0:
            return np.empty(0, np.int64)
        return ids[rect_contains(np.asarray(rect, np.float64), rows)]

    def scan_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Exact batched scan: flat (query_ids, row_ids) over live log rows.

        Each sorted run is probed with two ``searchsorted`` calls per query
        on the key dim — ``[ss(keys, lo, 'left'), ss(keys, hi, 'left'))`` is
        exactly ``lo <= key < hi`` on the upcast f32 keys — and only rows
        inside the window are checked on the remaining dims (f64 compares
        against the f32 log rows are exact after upcast).  The L0 tail
        (< ``l0_spill`` rows) is scanned densely.  Pair order is arbitrary;
        callers lexsort the merged hit list.

        Telemetry (DESIGN.md §10): wall time folds into
        ``coax_stage_seconds{stage="delta_scan"}``; with tracing enabled
        each call is one ``delta.scan`` span under its wave.
        """
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        self.last_scan_probed = 0
        if b == 0 or self.n_live == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        t_start = time.perf_counter()
        try:
            with obs.span("delta.scan", queries=b, live=self.n_live):
                return self._scan_batch_inner(rects, b)
        finally:
            obs.stage_hist().observe(time.perf_counter() - t_start,
                                     stage="delta_scan", backend="numpy")

    def _scan_batch_inner(self, rects: np.ndarray, b: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        rows64 = self._log_rows64()
        alive = self._alive_mask()
        k = self.key_dim
        lo_all = np.ascontiguousarray(rects[:, :, 0])   # (b, D) per-query
        hi_all = np.ascontiguousarray(rects[:, :, 1])   # bounds, gather-ready
        lo, hi = lo_all[:, k], hi_all[:, k]
        probed = 0
        qid_parts: List[np.ndarray] = []
        pos_parts: List[np.ndarray] = []
        for run_pos, keys in self._runs:
            s = np.searchsorted(keys, lo, side="left")
            e = np.searchsorted(keys, hi, side="left")
            lens = e - s
            nz = np.nonzero(lens > 0)[0]
            if nz.size == 0:
                continue
            flat = _multi_arange(s[nz], lens[nz])
            qf = np.repeat(nz, lens[nz])
            pf = run_pos[flat]
            probed += pf.size
            keep = alive[pf]
            qf, pf = qf[keep], pf[keep]
            if pf.size:
                # one bounds gather + two (m, D) compares instead of a
                # python loop of per-dim gathers; the key-dim column is
                # re-checked but the window already made it True
                sub = rows64[pf]
                ok = np.all((sub >= lo_all[qf]) & (sub < hi_all[qf]), axis=1)
                qf, pf = qf[ok], pf[ok]
            if pf.size:
                qid_parts.append(qf)
                pos_parts.append(pf)
        t0 = self._organized
        if t0 < self.n_log:                       # dense L0 tail scan
            tail = rows64[t0:]
            m = tail.shape[0]
            hit = np.ones((b, m), dtype=bool)
            for j in range(self.n_dims):
                v = tail[:, j]
                np.logical_and(hit, v[None, :] >= rects[:, j, 0][:, None], out=hit)
                np.logical_and(hit, v[None, :] < rects[:, j, 1][:, None], out=hit)
            hit &= alive[t0:][None, :]
            probed += b * m
            qf, pf = np.nonzero(hit)
            if pf.size:
                qid_parts.append(qf.astype(np.int64))
                pos_parts.append(pf.astype(np.int64) + t0)
        self.last_scan_probed = probed
        self.rows_probed += probed
        if not qid_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        q = np.concatenate(qid_parts).astype(np.int64, copy=False)
        p = np.concatenate(pos_parts)
        return q, self.log_ids()[p]

    def rows_for_ids(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(found_mask, rows) for ``ids`` among this plane's log entries —
        the cache-admission gather (DESIGN.md §9.2): a query's hit ids must
        be re-joined to their row values so a contained sub-query can later
        be filtered from the cached superset without re-probing.  The
        argsort of the append-order ids is cached (reset on insert), so a
        gather is two ``searchsorted`` passes, not a re-sort per wave."""
        ids = np.asarray(ids, dtype=np.int64)
        lids = self.log_ids()
        if ids.size == 0 or lids.size == 0:
            return (np.zeros(ids.shape, dtype=bool),
                    np.empty((0, self.n_dims), np.float32))
        if self._order_cache is None:
            self._order_cache = np.argsort(lids, kind="stable")
        order = self._order_cache
        sids = lids[order]
        pos = np.searchsorted(sids, ids)
        pos[pos == sids.size] = sids.size - 1
        found = sids[pos] == ids
        return found, self._log_rows()[order[pos[found]]]

    def freeze(self) -> "FrozenDelta":
        """Immutable point-in-time image of the LIVE log — the delta half
        of a pinned-epoch MVCC read (DESIGN.md §9.3).  Rows are copied and
        upcast once, so later appends/tombstones on this plane can never
        leak into a pinned reader's answers."""
        rows, ids = self.live_log()
        return FrozenDelta(rows, ids)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Serializable state: the append log (dead rows included, order
        preserved), the tombstone set, the split counters, and the
        ``organized`` run boundary (the L0 fill level must survive restore
        so spill-triggered check timing stays deterministic, §7.3).  Run
        *partitioning* is NOT serialized — any partition yields the same
        hit set, so restore rebuilds one run over the organized prefix."""
        return {
            "rows": self._log_rows(),
            "ids": self.log_ids(),
            "dead": self.dead_ids(),
            "n_log_dead": self.n_log_dead,
            "n_base_dead": self.n_base_dead,
            "organized": self._organized,
        }

    @classmethod
    def from_state(cls, n_dims: int, state: dict, key_dim: int = 0,
                   l0_spill: int = L0_SPILL_DEFAULT) -> "DeltaPlane":
        """Rebuild a plane from ``state_dict`` output.  The log lands as a
        single chunk — chunk granularity is a cache detail, every query and
        compaction path sees the concatenated log either way — and the
        organized prefix comes back as ONE sorted run."""
        dp = cls(n_dims, key_dim=key_dim, l0_spill=l0_spill)
        rows = np.ascontiguousarray(state["rows"], dtype=np.float32)
        ids = np.asarray(state["ids"], dtype=np.int64)
        if rows.shape[0]:
            dp._chunks.append(rows.reshape(-1, n_dims))
            dp._id_chunks.append(ids)
            dp._log_id_set = set(ids.tolist())
        dp.n_log = int(ids.shape[0])
        dp._dead = set(np.asarray(state["dead"], dtype=np.int64).tolist())
        dp.n_log_dead = int(state["n_log_dead"])
        dp.n_base_dead = int(state["n_base_dead"])
        organized = int(state.get("organized", 0))
        organized = min(max(organized, 0), dp.n_log)
        if organized:
            keys = rows[:organized, dp.key_dim].astype(np.float64)
            order = np.argsort(keys, kind="stable")
            dp._runs.append((order.astype(np.int64), keys[order]))
        dp._organized = organized
        return dp

    # ------------------------------------------------------------------ #
    def nbytes(self) -> int:
        """Bytes actually held: log rows + log ids + tombstone ids + the
        sorted-run views (one i64 position + one f64 key per organized row)."""
        return (self.n_log * self.n_dims * 4      # f32 rows
                + self.n_log * 8                  # i64 ids
                + len(self._dead) * 8             # i64 tombstones
                + self._organized * 16)           # run views (pos + key)

    def describe(self) -> dict:
        return {
            "log_rows": self.n_log,
            "live_rows": self.n_live,
            "tombstones": self.n_tombstones,
            "bytes": self.nbytes(),
            "key_dim": self.key_dim,
            "runs": len(self._runs),
            "run_sizes": [int(p.size) for p, _ in self._runs],
            "l0_rows": self.l0_rows,
            "spills": self.spills,
            "merges": self.merges,
            "rows_probed": self.rows_probed,
        }


class FrozenDelta:
    """Immutable snapshot of a ``DeltaPlane``'s live log at freeze time —
    the write-plane half of a pinned-epoch MVCC read (DESIGN.md §9.3).

    A pinned reader composes exactly what the live host path composes —
    (snapshot hits − frozen tombstones) ∪ frozen-delta hits — but against
    state that can never move: rows are a private f64 copy (the same upcast
    the live ``scan_batch`` compares under, so membership is bit-identical),
    and tombstones were already folded into the pin's frozen dead-id array.
    Run structure is deliberately NOT carried over: a pin is a bounded
    analytical read, the frozen log is bounded by the compaction trigger,
    and the dense scan is the simplest thing that is provably the same
    predicate."""

    def __init__(self, rows: np.ndarray, ids: np.ndarray):
        self._rows64 = np.array(rows, dtype=np.float64)   # private copy
        self._ids = np.array(ids, dtype=np.int64)

    @property
    def n_live(self) -> int:
        return int(self._ids.shape[0])

    def scan(self, rect: Rect) -> np.ndarray:
        """Ids of frozen live rows inside ``rect`` (unsorted)."""
        if self._ids.size == 0:
            return np.empty(0, np.int64)
        return self._ids[rect_contains(np.asarray(rect, np.float64),
                                       self._rows64)]

    def scan_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Exact batched scan over the frozen rows: flat (query_ids,
        row_ids), same half-open f64 predicate as ``DeltaPlane.scan_batch``
        — a pinned answer is bit-identical to what the live path returned
        at pin time."""
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        m = self._ids.shape[0]
        if b == 0 or m == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        hit = np.ones((b, m), dtype=bool)
        for j in range(self._rows64.shape[1]):
            v = self._rows64[:, j]
            np.logical_and(hit, v[None, :] >= rects[:, j, 0][:, None], out=hit)
            np.logical_and(hit, v[None, :] < rects[:, j, 1][:, None], out=hit)
        qf, pf = np.nonzero(hit)
        return qf.astype(np.int64), self._ids[pf]

    def nbytes(self) -> int:
        return int(self._rows64.nbytes + self._ids.nbytes)
