"""Semantic result cache + pinned-epoch MVCC read handles (DESIGN.md §9).

Two read-side constructions that exploit the epoch versioning the mutable
lifecycle already maintains (§5):

``SemanticCache`` — a rect-containment result cache.  Entries store a
    *superset* rect, its flat hit ids and the hit rows (upcast to f64
    once).  A later query whose rect is CONTAINED in a cached rect is
    answered by filtering the cached rows with the exact half-open f32
    predicate (``lo <= v < hi`` after upcast) — the identical membership
    test every backend's pipeline evaluates, so the filtered answer is
    bit-identical to a full probe.  Exactness argument (§9.1): for rects
    Q ⊆ S, every row matching Q matches S (per-dim ``S.lo <= Q.lo`` and
    ``Q.hi <= S.hi``), so S's hit set is a superset of Q's, and filtering
    it with Q's own predicate yields exactly Q's hit set.  This is the
    cache-shaped face of the nav⊇filter invariant: a superset candidate
    set plus the exact filter is always a correct answer.

    Entries are keyed on ``(version, rect-bytes)`` where ``version`` is the
    owning index's write-state version — epoch PLUS the per-plane log and
    tombstone counters, so any write (not just a compaction) moves the key
    and stale entries simply never match (§9.2).  On a sharded plane each
    shard owns its own cache keyed ``(shard_id, shard's OWN version)`` —
    the plane-level aggregate epoch (a sum) is ambiguous as a key and is
    never used (§9.2).  Eviction is LRU under both a byte budget and an
    entry count; a version bump purges the dead generation wholesale.

``EpochPin`` / ``ShardedEpochPin`` — MVCC snapshot-read handles (§9.3).
    ``pin_epoch()`` captures strong references to the pinned epoch's
    ``GridFile`` pair, device plan (its device images stay resident) and a
    ``FrozenDelta`` image of each write plane, refcounted in the index's
    ``_pins`` table.  A background compaction handoff (§5.4) swaps the
    serving index to a new epoch, but the pin keeps the old epoch's objects
    alive and keeps answering from them — release (or ``with`` exit) drops
    the references and the old epoch is freed.  On the device backend a
    pinned read is one wave of a frozen twin of the epoch's device plan
    (``fused_scan`` on the card), elsewhere the exact host composition;
    either way it is bit-identical to what the live index answered at pin
    time, no matter how many handoffs install meanwhile.  The twin holds
    the epoch's images (about 1 GB at 20M rows on the card), so they stay
    allocated until the last pin of that epoch releases.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.translate import translate_rects
from ..core.types import rect_contains, sorted_contains, split_hits

__all__ = ["CacheLookup", "SemanticCache", "EpochPin", "ShardedEpochPin"]

# OrderedDict slot + entry object + key tuple bookkeeping, amortized
_ENTRY_OVERHEAD = 128


@dataclasses.dataclass(frozen=True)
class CacheLookup:
    """Outcome of one wave's cache consult — threaded into ``WaveStats``
    as ``cache_hits``/``cache_partial``/``cache_bytes`` (§9.2)."""

    queries: int = 0
    hits: int = 0        # exact rect matches (same bytes, same version)
    partial: int = 0     # answered by filtering a containing superset entry
    misses: int = 0      # fell through to the full pipeline
    bytes: int = 0       # cache-resident bytes after the consult

    def merge(self, other: "CacheLookup") -> "CacheLookup":
        return CacheLookup(self.queries + other.queries,
                           self.hits + other.hits,
                           self.partial + other.partial,
                           self.misses + other.misses,
                           self.bytes + other.bytes)


class _Entry:
    __slots__ = ("rect", "ids", "rows64", "nbytes")

    def __init__(self, rect, ids, rows64, nbytes):
        self.rect = rect          # (D, 2) f64 superset rect
        self.ids = ids            # sorted i64 hit ids
        self.rows64 = rows64      # (M, D) f64 hit rows, aligned with ids
        self.nbytes = nbytes


class SemanticCache:
    """Rect-containment semantic cache for one index (or one shard).

    Parameters
    ----------
    byte_budget : resident-bytes ceiling; LRU entries evict past it.
    max_entries : entry-count ceiling (bounds the containment scan).
    shard_id : set by ``ShardedCOAX.attach_cache`` — prefixes every version
        key so entries are keyed ``(shard_id, shard's own version)``, never
        the plane's ambiguous aggregate epoch (§9.2).
    """

    def __init__(self, byte_budget: int = 64 << 20, max_entries: int = 512,
                 shard_id: Optional[int] = None):
        if byte_budget < 1 or max_entries < 1:
            raise ValueError("byte_budget and max_entries must be >= 1")
        self.byte_budget = int(byte_budget)
        self.max_entries = int(max_entries)
        self.shard_id = shard_id
        self._prefix = () if shard_id is None else (int(shard_id),)
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._nbytes = 0
        self._vseen: Optional[tuple] = None
        self._stack = None        # lazily stacked (keys, lo, hi, sizes)
        # lifetime counters (per-wave outcomes live in CacheLookup)
        self.hits = 0
        self.partial = 0
        self.misses = 0
        self.admissions = 0
        self.evictions = 0
        self.invalidations = 0    # entries purged by a version bump
        self.rejections = 0       # admissions refused (entry > whole budget)

    # ------------------------------------------------------------------ #
    @property
    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self) -> int:
        return len(self._entries)

    def _vkey(self, version) -> tuple:
        return self._prefix + tuple(int(v) for v in version)

    def _purge_stale(self, vkey: tuple) -> None:
        """Version moved: every resident entry belongs to a dead generation
        and can never match again — drop them all (the 'invalidation for
        free on epoch bump' contract, §9.2)."""
        if self._vseen == vkey:
            return
        if self._entries:
            self.invalidations += len(self._entries)
            self._entries.clear()
            self._nbytes = 0
            self._stack = None
        self._vseen = vkey

    def _stacked(self):
        """Entry rects stacked for one vectorised containment test per
        wave: (keys, lo (E, D), hi (E, D), sizes (E,))."""
        if self._stack is None:
            keys = list(self._entries.keys())
            rects = np.stack([self._entries[k].rect for k in keys])
            self._stack = (keys,
                           np.ascontiguousarray(rects[:, :, 0]),
                           np.ascontiguousarray(rects[:, :, 1]),
                           np.array([self._entries[k].ids.size for k in keys],
                                    dtype=np.int64))
        return self._stack

    def _evict_lru(self) -> None:
        _, e = self._entries.popitem(last=False)
        self._nbytes -= e.nbytes
        self.evictions += 1
        obs.get_registry().counter(
            "coax_cache_evictions_total", "LRU evictions.").inc()
        self._stack = None

    # ------------------------------------------------------------------ #
    def lookup_wave(self, version, rects: np.ndarray,
                    ) -> Tuple[List[Optional[np.ndarray]], CacheLookup]:
        """Consult the cache for a whole wave.

        Returns ``(answers, stats)``: ``answers[i]`` is the sorted hit-id
        array for ``rects[i]`` — from an exact entry or filtered out of a
        containing superset entry — or ``None`` for a miss the caller must
        run through the full pipeline (and may ``admit`` back)."""
        vkey = self._vkey(version)
        self._purge_stale(vkey)
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        answers: List[Optional[np.ndarray]] = [None] * b
        hits = partial = 0
        open_idx: List[int] = []
        for i in range(b):
            key = (vkey, rects[i].tobytes())
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                answers[i] = e.ids
                hits += 1
            else:
                open_idx.append(i)
        if open_idx and self._entries:
            keys, lo, hi, sizes = self._stacked()
            sub = rects[open_idx]                       # (m, D, 2)
            # contained[m, e]: per-dim S.lo <= Q.lo and Q.hi <= S.hi (§9.1)
            contained = (np.all(lo[None, :, :] <= sub[:, None, :, 0], axis=2)
                         & np.all(sub[:, None, :, 1] <= hi[None, :, :], axis=2))
            for j, i in enumerate(open_idx):
                cand = np.nonzero(contained[j])[0]
                if cand.size == 0:
                    continue
                # smallest containing hit set => cheapest exact filter
                key = keys[cand[np.argmin(sizes[cand])]]
                e = self._entries[key]
                self._entries.move_to_end(key)
                answers[i] = e.ids[rect_contains(rects[i], e.rows64)]
                partial += 1
        misses = b - hits - partial
        self.hits += hits
        self.partial += partial
        self.misses += misses
        # one registry touch per wave (not per rect): §10 overhead budget
        c = obs.get_registry().counter(
            "coax_cache_lookups_total", "Cache lookup outcomes per rect.",
            ("outcome",))
        if hits:
            c.inc(hits, outcome="hit")
        if partial:
            c.inc(partial, outcome="partial")
        if misses:
            c.inc(misses, outcome="miss")
        return answers, CacheLookup(queries=b, hits=hits, partial=partial,
                                    misses=misses, bytes=self._nbytes)

    def admit(self, version, rect: np.ndarray, ids: np.ndarray,
              rows: np.ndarray) -> bool:
        """Store one answered rect with its hit ids + rows.  The caller
        guarantees ``version`` is still the index's CURRENT version (the
        §9.2 stale-admission gate — a pipelined device wave may drain
        after a handoff installed a new epoch)."""
        vkey = self._vkey(version)
        self._purge_stale(vkey)
        rect = np.ascontiguousarray(rect, dtype=np.float64)
        key = (vkey, rect.tobytes())
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        rows64 = np.ascontiguousarray(rows, dtype=np.float64)
        nbytes = rect.nbytes + ids.nbytes + rows64.nbytes + _ENTRY_OVERHEAD
        if nbytes > self.byte_budget:
            self.rejections += 1          # would evict everything and still
            return False                  # not fit — never admit it
        self._entries[key] = _Entry(rect, ids, rows64, nbytes)
        self._nbytes += nbytes
        self.admissions += 1
        obs.get_registry().counter(
            "coax_cache_admissions_total", "Entries admitted.").inc()
        self._stack = None
        while (self._nbytes > self.byte_budget
               or len(self._entries) > self.max_entries):
            self._evict_lru()
        return True

    def clear(self) -> None:
        self._entries.clear()
        self._nbytes = 0
        self._stack = None

    def describe(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes": self._nbytes,
            "byte_budget": self.byte_budget,
            "max_entries": self.max_entries,
            "shard_id": self.shard_id,
            "hits": self.hits,
            "partial": self.partial,
            "misses": self.misses,
            "admissions": self.admissions,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "rejections": self.rejections,
        }


class EpochPin:
    """MVCC read handle over one ``COAXIndex`` epoch (DESIGN.md §9.3).

    Construction captures strong references to everything a read needs —
    both epoch ``GridFile``s, the learned groups/keep-dims, the §8.2.3
    outlier bbox, a frozen dead-id array, one ``FrozenDelta`` per write
    plane, and on the device backend a frozen twin of the epoch's device
    plan (``CoaxDevicePlan.pinned``: the epoch's images, liveness masks and
    delta image as of pin time; built here, so a missing card raises at
    pin time) — and registers in the index's ``_pins`` refcount table.
    On the device backend a pinned wave is one dispatch through that plan
    (``fused_scan`` on the card); on the numpy backend, and for a CPU-route
    wave over ``cell_cap``, it runs the exact HOST composition against the
    frozen state.  Either way answers are bit-identical to the live index
    at pin time, across any number of background-compaction handoffs.
    ``release()`` (idempotent; also the ``with`` exit) drops every
    reference and decrements the refcount — once the last pin of an old
    epoch releases, its grids, device images and delta image become
    garbage and the epoch's memory is actually freed.
    """

    def __init__(self, index):
        self.epoch = int(index.epoch)
        self.n_dims = int(index.n_dims)
        self.released = False
        self._index = index
        self._groups = list(index.groups)
        self._keep_dims = list(index.keep_dims)
        self._primary = index.primary
        self._outlier = index.outlier
        lo, hi = index._outlier_lo, index._outlier_hi
        self._outlier_lo = None if lo is None else np.array(lo)
        self._outlier_hi = None if hi is None else np.array(hi)
        self._dead = index._dead_ids()              # fresh sorted array
        self._delta_primary = index.delta_primary.freeze()
        self._delta_outlier = index.delta_outlier.freeze()
        self._plan = (index._device_plan_obj().pinned()
                      if index.backend == "device" else None)

    # ------------------------------------------------------------------ #
    def _check(self) -> None:
        if self.released:
            raise RuntimeError("pin released: this epoch handle no longer "
                               "holds its snapshot")

    def query_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Flat ``(query_ids, row_ids)`` against the pinned epoch: one wave
        of the pinned device plan, or the exact host composition of
        ``COAXIndex._query_batch_host`` over frozen state (grids − frozen
        tombstones ∪ frozen delta)."""
        self._check()
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        if b == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        nav = translate_rects(rects, self._groups, self._keep_dims)
        if self._plan is not None:
            ticket = self._plan.submit_wave(nav, rects)
            if ticket is not None:             # None: CPU-route cell_cap
                q, r, _ = self._plan.collect(ticket)
                return q, r
        q, r = self._primary._query_batch_numpy(nav, rects)
        if self._outlier_lo is not None:
            touch = np.all((rects[:, :, 0] <= self._outlier_hi)
                           & (rects[:, :, 1] > self._outlier_lo), axis=1)
            if touch.any():
                sub = rects[touch]
                q_o, r_o = self._outlier._query_batch_numpy(sub, sub)
                if r_o.size:
                    q = np.concatenate([q, np.nonzero(touch)[0][q_o]])
                    r = np.concatenate([r, r_o])
        if self._dead.size and r.size:
            keep = ~sorted_contains(self._dead, r)
            q, r = q[keep], r[keep]
        q1, r1 = self._delta_primary.scan_batch(rects)
        q2, r2 = self._delta_outlier.scan_batch(rects)
        if r1.size or r2.size:
            q = np.concatenate([q, q1, q2])
            r = np.concatenate([r, r1, r2])
        order = np.lexsort((r, q))
        return q[order], r[order]

    def query_batch_split(self, rects: np.ndarray) -> List[np.ndarray]:
        rects = np.asarray(rects, dtype=np.float64)
        qids, rids = self.query_batch(rects)
        return split_hits(qids, rids, rects.shape[0])

    def query(self, rect) -> np.ndarray:
        _, rids = self.query_batch(np.asarray(rect, np.float64)[None])
        return rids

    # ------------------------------------------------------------------ #
    def release(self) -> None:
        if self.released:
            return
        self.released = True
        index, self._index = self._index, None
        self._groups = self._keep_dims = None
        self._primary = self._outlier = self._plan = None
        self._outlier_lo = self._outlier_hi = self._dead = None
        self._delta_primary = self._delta_outlier = None
        if index is not None:
            index._release_pin(self.epoch)

    def __enter__(self) -> "EpochPin":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShardedEpochPin:
    """MVCC read handle over a ``ShardedCOAX`` plane: one ``EpochPin`` per
    shard plus a frozen copy of the shard bboxes (widen-only on the live
    plane, so the frozen copy stays a conservative over-approximation of
    the pinned rows).  Scatter-gathers exactly like the live plane, so a
    pinned sharded read is bit-identical to the plane at pin time (§9.3)."""

    def __init__(self, plane):
        self.n_dims = int(plane.n_dims)
        self.n_shards = int(plane.n_shards)
        self.epoch = int(plane.epoch)
        self.released = False
        self._pins = [s.pin_epoch() for s in plane.shards]
        self._lo = [None if lo is None else np.array(lo)
                    for lo in plane._shard_lo]
        self._hi = [None if hi is None else np.array(hi)
                    for hi in plane._shard_hi]

    @property
    def shard_epochs(self) -> List[int]:
        return [p.epoch for p in self._pins]

    def query_batch(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.released:
            raise RuntimeError("pin released: this epoch handle no longer "
                               "holds its snapshot")
        rects = np.asarray(rects, dtype=np.float64)
        b = rects.shape[0]
        if b == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        q_parts: List[np.ndarray] = []
        r_parts: List[np.ndarray] = []
        for k, pin in enumerate(self._pins):
            if self._lo[k] is None:
                continue
            touch = np.all((rects[:, :, 0] <= self._hi[k])
                           & (rects[:, :, 1] > self._lo[k]), axis=1)
            if not touch.any():
                continue
            q_k, r_k = pin.query_batch(rects[touch])
            if r_k.size:
                q_parts.append(np.nonzero(touch)[0][q_k])
                r_parts.append(r_k)
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

    def query(self, rect) -> np.ndarray:
        _, rids = self.query_batch(np.asarray(rect, np.float64)[None])
        return rids

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        pins, self._pins = self._pins, []
        self._lo = self._hi = None
        for p in pins:
            p.release()

    def __enter__(self) -> "ShardedEpochPin":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
