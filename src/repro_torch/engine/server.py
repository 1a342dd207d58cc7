"""Range-query admission server (DESIGN.md §2, §5).

Adapts ``runtime.router.CoaxRouter``'s continuous-batching admission pattern
to range-query traffic: clients ``submit`` rects into a pending pool, the
server ``drain``s the pool in priority-then-FIFO waves of ``max_batch``
queries, and each wave is one fused ``BatchQueryExecutor`` call.  Per-wave
stats mirror the router's so the serving plane exposes one vocabulary
(waves, pending, qps) whether it batches decode requests or index probes.

Writes (DESIGN.md §5): ``insert``/``delete`` enqueue mutations next to the
query pool; ``drain`` applies every queued write at each wave boundary
(``flush_writes``) before forming the wave, so all queries fused into one
wave answer against the same snapshot+delta state — per-wave snapshot
semantics.  A query admitted before a write but drained after it observes
the write; two queries in the same wave can never observe different states.

Durability (DESIGN.md §7): when the index carries a durability plane, the
server fsyncs its WAL right after each wave-boundary flush — the durable
frontier advances in the same per-wave steps as the visibility frontier
(§7.2 fsync contract) — and every ``checkpoint_every`` waves it publishes
a mid-epoch snapshot to bound replay cost.  ``QueryServer.recover`` is the
restart constructor: snapshot + WAL replay, then serve.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs.watchdog import PauseWatchdog
from .executor import BatchQueryExecutor

__all__ = ["PendingQuery", "QueryServer"]


@dataclasses.dataclass
class PendingQuery:
    qid: int
    rect: np.ndarray              # (D, 2)
    priority: float
    arrival: float


class QueryServer:
    """Submit range queries and writes, drain them in batched waves.

    Parameters
    ----------
    index : engine handed to ``BatchQueryExecutor`` (COAXIndex, ShardedCOAX
        or baseline).
    max_batch : queries fused per wave.
    backend : forwarded to ``BatchQueryExecutor`` — ``"device"`` serves
        waves from the index's device-resident plan (DESIGN.md §4).
    shards : forwarded to ``BatchQueryExecutor`` — ``K`` serves waves from a
        K-shard scatter-gather plane (DESIGN.md §6), re-partitioning a
        single mutable index when needed; stats gain per-shard rollups.
    checkpoint_every : publish a durability checkpoint (mid-epoch snapshot
        stamped with the journal position, DESIGN.md §7) every this many
        drained waves; None disables the cadence.  No-op unless the index
        has a durability plane attached.
    cache_bytes : byte budget for a §9 semantic result cache on the served
        index (forwarded to ``BatchQueryExecutor``); None leaves it off.
    device : forwarded to ``BatchQueryExecutor`` — the torch device of the
        index's plan (``"cuda"`` by default, ``"cpu"`` for the kernels'
        plain versions).
    shutdown : a ``runtime.failure.GracefulShutdown`` to honour: when its
        flag flips (SIGTERM on a managed host), ``drain`` finishes the
        in-flight wave, stops forming new ones, and returns — the caller
        then runs ``close()`` (flush queued writes, fsync the WAL, release
        the handle) and exits cleanly instead of dying mid-wave.
    watchdog : serving-pause monitor (DESIGN.md §10.3) fed one tick per
        completed wave; pauses exceeding N× the trailing median gap raise
        ``serving_pause_total{culprit=...}`` with the responsible
        background span attached.  Defaults to an always-on
        ``obs.PauseWatchdog()``; pass your own to tune factor/callback,
        or ``watchdog=None`` after construction to disable.
    """

    def __init__(self, index, max_batch: int = 64,
                 executor: Optional[BatchQueryExecutor] = None,
                 backend: Optional[str] = None,
                 shards: Optional[int] = None,
                 checkpoint_every: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 shutdown=None,
                 watchdog: Optional[PauseWatchdog] = None,
                 device: str = "cuda"):
        self.executor = executor or BatchQueryExecutor(
            index, max_batch=max_batch, backend=backend, shards=shards,
            cache_bytes=cache_bytes, device=device)
        self.checkpoint_every = checkpoint_every
        self.shutdown = shutdown
        self.watchdog = watchdog if watchdog is not None else PauseWatchdog()
        self.closed = False
        self._pending: Dict[int, PendingQuery] = {}
        self._ids = itertools.count()
        self._write_queue: List[Tuple[int, str, object]] = []
        self._write_ids = itertools.count()
        self.write_results: Dict[int, object] = {}
        self.waves_drained = 0
        self.writes_applied = 0
        self.rows_inserted = 0
        self.rows_deleted = 0
        self.checkpoints_written = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def recover(cls, directory, max_batch: int = 64,
                backend: Optional[str] = None,
                shards: Optional[int] = None,
                checkpoint_every: Optional[int] = None,
                durable: bool = True, device: str = "cuda",
                **restore_kwargs) -> "QueryServer":
        """Restart constructor (DESIGN.md §7.4): recover the index from a
        durability directory — newest complete snapshot + WAL-tail replay,
        single or sharded, sniffed from the layout — and serve it on the
        torch ``device``.  With ``durable`` (default) the recovered index
        resumes journaling where the crashed process stopped.  Asked for
        the device backend on an absent device, it raises before reading
        the directory."""
        from ..storage import restore
        index = restore(directory, backend=backend or "device",
                        durable=durable, device=device, **restore_kwargs)
        return cls(index, max_batch=max_batch, backend=backend,
                   shards=shards, checkpoint_every=checkpoint_every,
                   device=device)

    # ------------------------------------------------------------------ #
    def submit(self, rect: np.ndarray, priority: float = 0.0,
               arrival: Optional[float] = None) -> int:
        """Queue one rect; returns its query id.

        ``arrival`` defaults to ``time.perf_counter()`` — the SAME clock
        the executor's wave timing uses and the one callers supplying
        explicit stamps are documented against.  (It used to default to
        ``time.time()``: epoch-seconds ~1.7e9 vs perf-counter seconds
        meant the drain sort compared stamps from two different clocks,
        so any explicit-arrival query always out-sorted defaults.)"""
        rect = np.asarray(rect, dtype=np.float64)
        if rect.ndim != 2 or rect.shape[1] != 2:
            raise ValueError(f"rect must be (D, 2), got {rect.shape}")
        n_dims = getattr(self.executor.index, "n_dims", None)
        if n_dims is not None and rect.shape[0] != n_dims:
            raise ValueError(f"rect has {rect.shape[0]} dims, index has {n_dims}")
        qid = next(self._ids)
        self._pending[qid] = PendingQuery(
            qid, rect, priority,
            arrival if arrival is not None else time.perf_counter())
        return qid

    def submit_many(self, rects: np.ndarray, priority: float = 0.0) -> List[int]:
        return [self.submit(r, priority=priority) for r in rects]

    def cancel(self, qid: int) -> bool:
        """Remove a pending query before it is drained; True iff it was
        still pending (False: unknown id, or already answered)."""
        return self._pending.pop(qid, None) is not None

    # ------------------------------------------------------------------ #
    # Write admission (DESIGN.md §5)
    # ------------------------------------------------------------------ #
    def insert(self, rows: np.ndarray) -> int:
        """Queue an insert; returns a write id.  The assigned row ids land
        in ``write_results[write_id]`` once the write is applied (at the
        next wave boundary, or an explicit ``flush_writes``)."""
        index = self.executor.index
        if not hasattr(index, "insert"):
            raise TypeError(f"{type(index).__name__} does not support insert")
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        n_dims = getattr(index, "n_dims", None)
        if n_dims is not None and rows.shape[1] != n_dims:
            raise ValueError(f"rows have {rows.shape[1]} dims, index has {n_dims}")
        wid = next(self._write_ids)
        self._write_queue.append((wid, "insert", rows))
        return wid

    def delete(self, row_ids) -> int:
        """Queue a delete by original row ids; returns a write id.  The
        count of rows actually removed lands in ``write_results``."""
        index = self.executor.index
        if not hasattr(index, "delete"):
            raise TypeError(f"{type(index).__name__} does not support delete")
        wid = next(self._write_ids)
        self._write_queue.append(
            (wid, "delete", np.asarray(row_ids, dtype=np.int64)))
        return wid

    def flush_writes(self) -> Dict[int, object]:
        """Apply every queued write in admission order; returns the results
        of the writes applied by THIS call ({write_id: ids | count}).

        Adjacent queued inserts are COALESCED into one index call: row ids
        are assigned in admission order either way, so the final state is
        identical, and the per-op fixed cost (margin checks, tracker
        update, trigger check, WAL record) is paid once per run of inserts
        instead of once per admission."""
        applied: Dict[int, object] = {}
        index = self.executor.index
        q = self._write_queue
        while q:
            if q[0][1] == "insert":
                run = []
                while q and q[0][1] == "insert":
                    run.append(q.pop(0))
                rows = (run[0][2] if len(run) == 1 else
                        np.concatenate([p for _, _, p in run], axis=0))
                ids = index.insert(rows)
                self.rows_inserted += int(np.asarray(ids).size)
                off = 0
                for wid, _, p in run:
                    applied[wid] = ids[off:off + p.shape[0]]
                    off += p.shape[0]
                self.writes_applied += len(run)
            else:
                wid, _, payload = q.pop(0)
                res = index.delete(payload)
                self.rows_deleted += int(res)
                applied[wid] = res
                self.writes_applied += 1
        self.write_results.update(applied)
        return applied

    def pin_epoch(self):
        """Open an MVCC read handle on the served index (DESIGN.md §9.3).

        Queued writes are flushed FIRST so the pin captures the state a
        drain at this instant would serve, then the index's ``pin_epoch``
        freezes it: the handle answers bit-identically to now while
        subsequent drains, writes, and background-compaction handoffs move
        the server forward.  Release the handle to free the old epoch."""
        index = self.executor.index
        pin = getattr(index, "pin_epoch", None)
        if pin is None:
            raise TypeError(f"{type(index).__name__} has no pin_epoch")
        self.flush_writes()
        return pin()

    # ------------------------------------------------------------------ #
    def _finish_wave(self, wave, answers, dur,
                     results: Dict[int, np.ndarray]) -> None:
        """Drain-side bookkeeping shared by the pipelined and sync paths."""
        for q, ans in zip(wave, answers):
            results[q.qid] = ans
        self.waves_drained += 1
        if self.watchdog is not None:
            self.watchdog.wave_done()          # §10.3 pause detection
        if (dur is not None and self.checkpoint_every
                and self.waves_drained % self.checkpoint_every == 0):
            dur.checkpoint()
            self.checkpoints_written += 1

    def drain(self, max_waves: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Run pending queries to completion (or for ``max_waves`` waves).

        Returns {query_id: sorted row ids} for every query answered.  Wave
        formation is priority-then-FIFO, like the router's admission sort.
        Queued writes are flushed at every wave boundary, so each wave
        observes one consistent index state (per-wave snapshot semantics);
        a durability plane, if attached, fsyncs its WAL at the same
        boundary — the log and the wave agree on what happened (§7.2).

        On the device backend the drain loop is DOUBLE-BUFFERED (DESIGN.md
        §4): each wave is submitted via ``executor.execute_submit`` — one
        dispatch, results left device-resident — and drained one wave
        behind, so wave ``i+1``'s write flush + upload + launch overlaps
        wave ``i``'s kernels.  Snapshot semantics survive the
        overlap because the device plan captures epoch/delta/tombstone
        state at SUBMIT, before the next boundary's writes are flushed.

        With tracing enabled (``obs.enable_tracing``) the whole call is
        one ``server.drain`` span parenting every ``wave`` span the
        executor opens (DESIGN.md §10.2).
        """
        with obs.span("server.drain", pending=len(self._pending)):
            return self._drain(max_waves)

    def _drain(self, max_waves: Optional[int] = None) -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        width = self.executor.max_batch
        waves_this_call = 0
        inflight: List[tuple] = []             # [(wave_queries, pending)]
        dur = getattr(self.executor.index, "durable", None)
        while self._pending or self._write_queue:
            if max_waves is not None and waves_this_call >= max_waves:
                break
            if self.shutdown_requested:
                break                      # in-flight waves still collected
            self.flush_writes()
            if dur is not None:
                dur.sync()
            if not self._pending:
                break
            cands = sorted(self._pending.values(),
                           key=lambda q: (-q.priority, q.arrival, q.qid))
            wave = cands[:width]
            rects = np.stack([q.rect for q in wave])
            for q in wave:                     # claimed at formation so the
                del self._pending[q.qid]       # next wave can't re-pick them
            waves_this_call += 1
            pending = self.executor.execute_submit(rects)
            if pending is not None:            # pipelined device path
                inflight.append((wave, pending))
                if len(inflight) >= 2:
                    w, p = inflight.pop(0)
                    self._finish_wave(w, self.executor.execute_collect(p),
                                      dur, results)
                continue
            while inflight:                    # backend flipped mid-drain
                w, p = inflight.pop(0)
                self._finish_wave(w, self.executor.execute_collect(p),
                                  dur, results)
            self._finish_wave(wave, self.executor.execute(rects),
                              dur, results)
        while inflight:
            w, p = inflight.pop(0)
            self._finish_wave(w, self.executor.execute_collect(p),
                              dur, results)
        return results

    # ------------------------------------------------------------------ #
    # Graceful shutdown (DESIGN.md §8.1)
    # ------------------------------------------------------------------ #
    @property
    def shutdown_requested(self) -> bool:
        return self.shutdown is not None and self.shutdown.requested

    def close(self) -> None:
        """Orderly exit: apply every queued write, JOIN any in-flight
        background compaction (installing its epoch — the §5.4 graceful-
        shutdown contract: the compactor's work is never abandoned), fsync
        the journal tail, release the WAL handle.  Idempotent (the
        durability plane's close is), so signal handlers and ``finally``
        blocks can both call it."""
        self.flush_writes()
        fh = getattr(self.executor.index, "finish_handoff", None)
        if fh is not None:
            fh()
        dur = getattr(self.executor.index, "durable", None)
        if dur is not None:
            dur.sync()
            dur.close()
        self.closed = True

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        s = self.executor.stats()
        index = self.executor.index
        s.update(
            pending=len(self._pending),
            waves_drained=self.waves_drained,
            writes_pending=len(self._write_queue),
            writes_applied=self.writes_applied,
            rows_inserted=self.rows_inserted,
            rows_deleted=self.rows_deleted,
            epoch=int(getattr(index, "epoch", 0)),
            compactions=int(getattr(index, "compactions", 0)),
            delta_rows=int(getattr(index, "delta_rows", 0)),
            tombstones=int(getattr(index, "tombstone_count", 0)),
            checkpoints_written=self.checkpoints_written,
            shutdown_requested=self.shutdown_requested,
            closed=self.closed,
        )
        dur = getattr(index, "durable", None)
        if dur is not None:
            d = dur.describe()
            s.update(
                wal_records=d["wal_records"],
                wal_bytes=d["wal_bytes"],
                wal_pending_bytes=d["wal_pending_bytes"],
                last_snapshot_bytes=d["last_snapshot_bytes"],
            )
        if self.watchdog is not None:
            w = self.watchdog.describe()
            s.update(pauses=w["pauses"],
                     pause_median_gap_s=w["median_gap_s"],
                     last_pause_culprit=w["last_culprit"])
        return s
