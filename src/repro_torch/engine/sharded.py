"""Sharded scatter-gather serving plane (DESIGN.md §6).

``ShardedCOAX`` partitions rows across K independent ``COAXIndex`` shards —
hash or range partitioning on a chosen attribute — and each shard learns its
*own* soft FDs from only its rows, so per-region correlations sharpen (the
Tsunami insight: correlation-aware structure wins hardest when every data
region gets its own model).  Queries scatter-gather: a per-shard bounding
box prunes shards a rect cannot touch, surviving shards answer their
sub-batch through their own ``query_batch`` (numpy or device backend; on
the device backend each shard's wave is its own ``fused_scan`` dispatch on
the torch ``device``), and
the hits merge back into the same flat ``(query_id, row_id)`` contract —
bit-identical to a single ``COAXIndex`` over the union of rows, because
every shard is exact over its disjoint row set and the merge re-sorts by
(query, row) exactly as the single-index path does.

Writes route per shard: ``insert`` hashes/ranges each row to its shard and
assigns ids from ONE global sequence (``COAXIndex.insert(rows, ids=...)``),
``delete`` broadcasts ids (globally unique, so per-shard removal counts sum
exactly).  Every shard keeps its own delta planes, drift trackers and
compaction epochs — DESIGN.md §5's invariants hold shard-locally, and one
shard compacting never invalidates another shard's device plan.

Each shard holds its own device plan, images and hit buffers on the
card, and a wave runs the shards one after another (no
``query_batch_submit``: the executor drives a plane synchronously).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core import COAXIndex, CoaxConfig
from ..core.gridfile import BatchStats
from ..core.types import Rect, split_hits
from .cache import CacheLookup
from .device import _resolve_device

__all__ = ["ShardedCOAX", "partition_rows"]

_KNUTH = np.uint32(2654435761)


def _hash_route(values: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic shard of each float32 value via its bit pattern.

    Fibonacci-hash the raw 32 bits so nearby values spread across shards;
    any fixed value always routes to the same shard, which is all insert
    routing needs (deletes are broadcast, ids are globally unique).
    """
    bits = np.ascontiguousarray(values, dtype=np.float32).view(np.uint32)
    return ((bits * _KNUTH) >> np.uint32(16)).astype(np.int64) % n_shards


def partition_rows(data: np.ndarray, n_shards: int, partition: str,
                   partition_dim: int,
                   boundaries: Optional[np.ndarray] = None,
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Shard index of every row; returns ``(shard_of_row, boundaries)``.

    ``partition="hash"`` bit-hashes the partition attribute; ``"range"``
    splits at K-1 quantile boundaries of the attribute (computed from
    ``data`` when ``boundaries`` is None — the build; passed back in for
    insert routing, so routing stays frozen between compactions).
    """
    col = np.ascontiguousarray(data[:, partition_dim], dtype=np.float32)
    if n_shards == 1:
        return np.zeros(data.shape[0], dtype=np.int64), boundaries
    if partition == "hash":
        return _hash_route(col, n_shards), None
    if partition != "range":
        raise ValueError(f"partition must be 'hash' or 'range', got {partition!r}")
    if boundaries is None:
        qs = np.arange(1, n_shards) / n_shards
        boundaries = (np.quantile(col.astype(np.float64), qs)
                      if col.size else np.zeros(n_shards - 1))
    return np.searchsorted(boundaries, col.astype(np.float64),
                           side="right").astype(np.int64), boundaries


class ShardedCOAX:
    """K independent ``COAXIndex`` shards behind one index interface.

    Exposes the full ``COAXIndex`` serving surface (``query``,
    ``query_batch``, ``query_batch_split``, ``insert``, ``delete``,
    ``live_rows``, stats properties) so ``BatchQueryExecutor`` and
    ``QueryServer`` drive it unchanged; ``last_shard_stats`` additionally
    carries one ``BatchStats`` per shard for per-shard wave rollups.

    Parameters
    ----------
    data : (N, D) rows, partitioned across shards at build.
    config : per-shard ``CoaxConfig`` (compaction triggers fire per shard).
    n_shards : K.
    partition : ``"hash"`` (uniform load) or ``"range"`` (quantile split —
        shard bboxes become disjoint along ``partition_dim``, so pruning
        actually bites).
    partition_dim : the attribute rows are partitioned on.
    groups : optional pre-learned FD groups forced onto EVERY shard;
        default None lets each shard learn its own FDs (the point).
    row_ids : original identities of ``data`` rows (default arange(N)).
    backend, device : every shard's backend (``"device"`` by default) and
        torch device (``"cuda"`` by default); the device backend asked for
        an absent device raises here, before any shard is built.
    """

    name = "sharded_coax"

    def __init__(self, data: np.ndarray, config: CoaxConfig = CoaxConfig(),
                 n_shards: int = 4, partition: str = "range",
                 partition_dim: int = 0, groups=None,
                 backend: str = "device", device_opts: Optional[dict] = None,
                 row_ids: Optional[np.ndarray] = None, device: str = "cuda"):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if backend == "device":
            _resolve_device(device)        # no card: raise, never fall back
        data = np.ascontiguousarray(data, dtype=np.float32)
        self.n_dims = data.shape[1]
        self.n_shards = int(n_shards)
        self.partition = partition
        self.partition_dim = int(partition_dim)
        self.config = config
        ids = (np.arange(data.shape[0], dtype=np.int64) if row_ids is None
               else np.asarray(row_ids, dtype=np.int64))
        if ids.shape[0] != data.shape[0]:
            raise ValueError("row_ids length must match data rows")
        self._next_id = int(ids.max()) + 1 if ids.size else 0

        shard_of, self._boundaries = partition_rows(
            data, self.n_shards, partition, self.partition_dim)
        self.shards: List[COAXIndex] = []
        self._shard_lo: List[Optional[np.ndarray]] = []
        self._shard_hi: List[Optional[np.ndarray]] = []
        for k in range(self.n_shards):
            mask = shard_of == k
            rows_k = data[mask]
            self.shards.append(COAXIndex(
                rows_k, config, groups=groups, backend=backend,
                device_opts=device_opts, row_ids=ids[mask], device=device))
            if rows_k.shape[0]:
                self._shard_lo.append(rows_k.min(axis=0).astype(np.float64))
                self._shard_hi.append(rows_k.max(axis=0).astype(np.float64))
            else:
                self._shard_lo.append(None)
                self._shard_hi.append(None)
        self.last_batch_stats = BatchStats()
        self.last_shard_stats: List[BatchStats] = [BatchStats()
                                                   for _ in self.shards]
        self.durable = None     # storage.ShardedDurability, via attach_durability
        self.last_cache_stats = None   # merged CacheLookup of the last wave (§9)
        self._cache_attached = False

    # ------------------------------------------------------------------ #
    @classmethod
    def from_index(cls, index: COAXIndex, n_shards: int,
                   partition: str = "range", partition_dim: int = 0,
                   ) -> "ShardedCOAX":
        """Re-shard an existing (possibly mutated) index: partition its
        live row set, keeping original ids, config and backend.

        A journaled donor is refused: the new plane would start with
        ``durable=None`` while the donor's single-index snapshot+WAL sat
        stale on disk, so every acknowledged write after the re-partition
        would silently vanish at the next recovery.  Save the donor to a
        fresh directory and re-attach the sharded plane explicitly."""
        if getattr(index, "durable", None) is not None:
            raise ValueError(
                "cannot re-partition a journaled index: its durability "
                "history would be silently forked; detach/save first and "
                "attach_durability on the sharded plane")
        rows, ids = index.live_rows()
        out = cls(rows, index.config, n_shards=n_shards,
                  partition=partition, partition_dim=partition_dim,
                  backend=index.backend, device_opts=index._device_opts,
                  row_ids=ids, device=index.device)
        # carry the donor's id high-water mark: the max live id understates
        # it when the highest-id rows were deleted, and a reused id would
        # alias a client's handle to a dead row
        out._next_id = max(out._next_id, int(getattr(index, "_next_id", 0)))
        return out

    # ------------------------------------------------------------------ #
    # Durability (DESIGN.md §7.6)
    # ------------------------------------------------------------------ #
    @classmethod
    def _restore_parts(cls, spec: dict, shards: List[COAXIndex],
                       backend: str = "device") -> "ShardedCOAX":
        """Assemble a plane from a recovered partitioner spec + per-shard
        recovered indexes (``storage.durability._restore_sharded``).

        Shard bboxes are recomputed from each shard's live rows — tighter
        than the crashed plane's widen-only boxes is fine, because a bbox
        only gates PRUNING and every live row stays covered (conservative
        over-approximation, §6).  The global id sequence resumes at the max
        of the spec's checkpointed high-water mark and every shard's
        recovered ``_next_id`` (each insert journaled its assigned ids into
        its shard, so the max never understates the crashed sequence)."""
        out = cls.__new__(cls)
        out.n_dims = int(spec["n_dims"])
        out.n_shards = int(spec["n_shards"])
        out.partition = spec["partition"]
        out.partition_dim = int(spec["partition_dim"])
        out.config = shards[0].config if shards else None
        out._boundaries = (None if spec["boundaries"] is None
                           else np.asarray(spec["boundaries"], np.float64))
        out.shards = list(shards)
        out._shard_lo, out._shard_hi = [], []
        for s in out.shards:
            rows, _ = s.live_rows()
            if rows.shape[0]:
                out._shard_lo.append(rows.min(axis=0).astype(np.float64))
                out._shard_hi.append(rows.max(axis=0).astype(np.float64))
            else:
                out._shard_lo.append(None)
                out._shard_hi.append(None)
        out._next_id = max([int(spec["next_id"])]
                           + [s._next_id for s in out.shards])
        out.last_batch_stats = BatchStats()
        out.last_shard_stats = [BatchStats() for _ in out.shards]
        out.durable = None
        out.last_cache_stats = None
        out._cache_attached = False
        out.backend = backend
        return out

    def save(self, directory, keep: Optional[int] = None):
        """Full-state save: partitioner spec + one self-contained snapshot
        per shard.  Saving into the attached durability directory routes
        through ``ShardedDurability.checkpoint`` (journal-consistent
        ``wal_seq`` stamps); any other target gets a standalone copy —
        the shard-migration / replica-seeding artifact."""
        from pathlib import Path
        from ..storage import ShardedDurability, write_snapshot
        directory = Path(directory)
        if (self.durable is not None
                and directory.resolve() == self.durable.directory.resolve()):
            return self.durable.checkpoint(keep=keep)
        ShardedDurability(self, directory).write_spec()
        return [write_snapshot(s, ShardedDurability.shard_dir(directory, k),
                               keep=keep)
                for k, s in enumerate(self.shards)]

    @classmethod
    def restore(cls, directory, backend: str = "device",
                device_opts: Optional[dict] = None,
                durable: bool = False, device: str = "cuda") -> "ShardedCOAX":
        """Recover a sharded plane (per-shard snapshot + WAL replay); see
        ``repro_torch.storage.restore``."""
        from ..storage import restore as _restore
        out = _restore(directory, backend=backend, device_opts=device_opts,
                       durable=durable, device=device)
        if not isinstance(out, cls):
            raise TypeError(f"{directory} holds a {type(out).__name__} "
                            f"snapshot, not {cls.__name__}")
        return out

    def attach_durability(self, directory, keep: int = 3,
                          sync_every_op: bool = False) -> "ShardedCOAX":
        """Journal every shard's writes under ``directory`` (per-shard
        WALs + snapshots, one partitioner spec).  Returns self."""
        from ..storage import ShardedDurability
        ShardedDurability.attach(self, directory, keep=keep,
                                 sync_every_op=sync_every_op)
        return self

    # ------------------------------------------------------------------ #
    @property
    def backend(self) -> str:
        return self.shards[0].backend

    @backend.setter
    def backend(self, value: str) -> None:
        for s in self.shards:
            s.backend = value

    @property
    def device(self) -> str:
        """Torch device of every shard's device plan."""
        return self.shards[0].device

    @device.setter
    def device(self, value) -> None:
        for s in self.shards:
            s.device = value

    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.shards)

    @property
    def delta_rows(self) -> int:
        return sum(s.delta_rows for s in self.shards)

    @property
    def tombstone_count(self) -> int:
        return sum(s.tombstone_count for s in self.shards)

    @property
    def epoch(self) -> int:
        """Monotone plane version: total compactions across shards (each
        shard's epoch advances independently; the sum stamps wave stats).

        The sum is AMBIGUOUS as a cache/snapshot key — shard A at epoch 2 +
        shard B at 0 sums the same as A at 1 + B at 1 — so the §9 semantic
        cache never keys on it: ``attach_cache`` gives each shard its own
        cache keyed on ``(shard_id, the shard's OWN version)``."""
        return sum(s.epoch for s in self.shards)

    @property
    def compactions(self) -> int:
        return sum(s.compactions for s in self.shards)

    @property
    def trigger_checks(self) -> int:
        return sum(s.trigger_checks for s in self.shards)

    @property
    def background_compactions(self) -> int:
        return sum(s.background_compactions for s in self.shards)

    def poll_handoff(self, wait: bool = False) -> bool:
        """Fan the §5.4 epoch-handoff poll across shards (each shard's
        background compactor runs independently); True iff any shard
        installed a finished build."""
        installed = False
        for s in self.shards:
            installed |= s.poll_handoff(wait=wait)
        return installed

    def finish_handoff(self) -> bool:
        """Join every shard's in-flight background compaction — the
        graceful-shutdown barrier, fanned out."""
        return self.poll_handoff(wait=True)

    # ------------------------------------------------------------------ #
    # Semantic cache + MVCC pins (DESIGN.md §9), fanned out per shard
    # ------------------------------------------------------------------ #
    def attach_cache(self, byte_budget: int = 64 << 20,
                     max_entries: int = 512) -> "ShardedCOAX":
        """Attach one §9.2 ``SemanticCache`` PER SHARD (budget split K
        ways), each keyed on ``(shard_id, the shard's own version)`` —
        never the aggregate ``epoch`` sum, which is ambiguous (a compaction
        in shard A and an insert in shard B can collide).  Returns self."""
        per = max(int(byte_budget) // self.n_shards, 1)
        for k, s in enumerate(self.shards):
            s.attach_cache(byte_budget=per, max_entries=max_entries,
                           shard_id=k)
        self._cache_attached = True
        self.last_cache_stats = None
        return self

    def detach_cache(self) -> None:
        for s in self.shards:
            s.detach_cache()
        self._cache_attached = False
        self.last_cache_stats = None

    def pin_epoch(self):
        """One §9.3 MVCC handle over the whole plane: pins every shard's
        current epoch at once (plus frozen copies of the pruning bboxes),
        so scatter-gather reads through the handle stay bit-identical to
        this instant while any shard compacts underneath."""
        from .cache import ShardedEpochPin
        return ShardedEpochPin(self)

    @property
    def pinned_epochs(self) -> List[List[int]]:
        return [s.pinned_epochs for s in self.shards]

    # ------------------------------------------------------------------ #
    # Write path: route per shard, ids from one global sequence
    # ------------------------------------------------------------------ #
    def _route(self, rows: np.ndarray) -> np.ndarray:
        shard_of, _ = partition_rows(rows, self.n_shards, self.partition,
                                     self.partition_dim,
                                     boundaries=self._boundaries)
        return shard_of

    def insert(self, rows: np.ndarray) -> np.ndarray:
        """Insert rows, routed to their shard; returns globally unique ids
        in input order (identical to the ids a single ``COAXIndex`` would
        assign for the same insert sequence)."""
        rows = np.ascontiguousarray(np.atleast_2d(
            np.asarray(rows, dtype=np.float32)))
        if rows.ndim != 2 or rows.shape[1] != self.n_dims:
            raise ValueError(f"rows must be (m, {self.n_dims}), got {rows.shape}")
        m = rows.shape[0]
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._next_id += m
        if m == 0:
            return ids
        shard_of = self._route(rows)
        for k in np.unique(shard_of):
            mask = shard_of == k
            sub = rows[mask]
            self.shards[k].insert(sub, ids=ids[mask])
            lo, hi = sub.min(axis=0).astype(np.float64), sub.max(axis=0).astype(np.float64)
            if self._shard_lo[k] is None:
                self._shard_lo[k], self._shard_hi[k] = lo, hi
            else:   # bbox only ever widens: over-approximation keeps pruning safe
                self._shard_lo[k] = np.minimum(self._shard_lo[k], lo)
                self._shard_hi[k] = np.maximum(self._shard_hi[k], hi)
        return ids

    def delete(self, row_ids) -> int:
        """Delete by original id, broadcast to every shard — ids are
        globally unique, so at most one shard absorbs each and the per-shard
        removal counts sum exactly."""
        ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        return sum(s.delete(ids) for s in self.shards)

    def compact(self, relearn: Optional[bool] = None) -> List[dict]:
        """Force-compact every shard (auto-compaction fires per shard on
        its own triggers; this is the explicit all-shards form)."""
        return [s.compact(relearn=relearn) for s in self.shards]

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, ids) of every live row across shards — the scratch-
        rebuild oracle's input, ordered shard-major."""
        parts = [s.live_rows() for s in self.shards]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    # ------------------------------------------------------------------ #
    # Read path: prune by shard bbox, scatter, gather, merge
    # ------------------------------------------------------------------ #
    def _touch_mask(self, rects: np.ndarray) -> np.ndarray:
        """(K, B) bool: can rect b intersect shard k's bounding box?
        Half-open rect [lo, hi) vs closed bbox [blo, bhi]: lo <= bhi and
        hi > blo on every dim — the §8.2.3 test, per shard."""
        b = rects.shape[0]
        out = np.zeros((self.n_shards, b), dtype=bool)
        for k in range(self.n_shards):
            if self._shard_lo[k] is None:
                continue
            out[k] = np.all((rects[:, :, 0] <= self._shard_hi[k])
                            & (rects[:, :, 1] > self._shard_lo[k]), axis=1)
        return out

    def query(self, rect: Rect) -> np.ndarray:
        rect = np.asarray(rect, dtype=np.float64)
        touch = self._touch_mask(rect[None])[:, 0]
        hits = [self.shards[k].query(rect)
                for k in range(self.n_shards) if touch[k]]
        if not hits:
            return np.empty(0, np.int64)
        return np.sort(np.concatenate(hits))

    def query_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter-gather B queries across shards.

        Each shard answers only the sub-batch of rects that can touch its
        bbox; sub-batch query ids are remapped to batch ids and the K hit
        lists merge under one (query, row) lexsort — bit-identical to a
        single index over the union of rows, because shard row sets are
        disjoint and each shard's answer is exact.
        """
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        self.last_shard_stats = [BatchStats(backend=self.backend)
                                 for _ in self.shards]
        if b == 0:
            self.last_batch_stats = BatchStats(backend=self.backend)
            return np.empty(0, np.int64), np.empty(0, np.int64)
        touch = self._touch_mask(rects)
        q_parts: List[np.ndarray] = []
        r_parts: List[np.ndarray] = []
        merged = BatchStats(queries=b, backend=self.backend)
        cache_stats = None
        hit_shards = 0
        with obs.span("shard.scatter", queries=b,
                      shards=self.n_shards) as sp:
            for k in range(self.n_shards):
                if not touch[k].any():
                    continue
                hit_shards += 1
                sub = rects[touch[k]]
                with obs.span("shard.query", shard=k, queries=len(sub)):
                    q_k, r_k = self.shards[k].query_batch(sub)
                stats_k = dataclasses.replace(
                    self.shards[k].last_batch_stats,
                    queries=int(touch[k].sum()))
                self.last_shard_stats[k] = stats_k
                merged = merged.merge(stats_k)
                cs_k = self.shards[k].last_cache_stats
                if cs_k is not None:
                    cache_stats = cs_k if cache_stats is None \
                        else cache_stats.merge(cs_k)
                if r_k.size:
                    q_parts.append(np.nonzero(touch[k])[0][q_k])
                    r_parts.append(r_k)
            if sp is not None:
                sp.args["shards_hit"] = hit_shards
        reg = obs.get_registry()
        reg.counter("coax_shard_subqueries_total",
                    "(rect, shard) pairs dispatched after bbox pruning."
                    ).inc(int(touch.sum()))
        reg.counter("coax_shard_subqueries_pruned_total",
                    "(rect, shard) pairs skipped by bbox pruning."
                    ).inc(int(touch.size - touch.sum()))
        merged.queries = b
        self.last_batch_stats = merged
        if self._cache_attached:
            self.last_cache_stats = cache_stats or CacheLookup()
        if not q_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        qids = np.concatenate(q_parts)
        rids = np.concatenate(r_parts)
        order = np.lexsort((rids, qids))
        return qids[order], rids[order]

    def query_batch_split(self, rects: np.ndarray) -> List[np.ndarray]:
        rects = np.asarray(rects, dtype=np.float64)
        qids, rids = self.query_batch(rects)
        return split_hits(qids, rids, rects.shape[0])

    # ------------------------------------------------------------------ #
    def shard_sizes(self) -> List[int]:
        return [s.n_rows for s in self.shards]

    def memory_footprint(self) -> int:
        bbox = sum(lo.nbytes + hi.nbytes
                   for lo, hi in zip(self._shard_lo, self._shard_hi)
                   if lo is not None)
        bounds = self._boundaries.nbytes if self._boundaries is not None else 0
        return sum(s.memory_footprint() for s in self.shards) + bbox + bounds

    def describe(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "partition": self.partition,
            "partition_dim": self.partition_dim,
            "n_rows": self.n_rows,
            "shard_sizes": self.shard_sizes(),
            "epoch": self.epoch,
            "compactions": self.compactions,
            "delta_rows": self.delta_rows,
            "tombstones": self.tombstone_count,
            "trigger_checks": self.trigger_checks,
            "background": {
                "enabled": bool(self.config.background_compact)
                if self.config is not None else False,
                "in_flight": sum(s._handoff_thread is not None
                                 for s in self.shards),
                "completed": self.background_compactions,
            },
            "delta_runs": [s.delta_primary.n_runs + s.delta_outlier.n_runs
                           for s in self.shards],
            "shard_epochs": [s.epoch for s in self.shards],
            "cache": ([s.cache.describe() for s in self.shards]
                      if self._cache_attached else None),
            "pinned_epochs": self.pinned_epochs,
            "shard_groups": [[(g.predictor, list(g.dependents))
                              for g in s.groups] for s in self.shards],
            "memory_footprint_bytes": self.memory_footprint(),
            "durability": (self.durable.describe()
                           if self.durable is not None else None),
        }
