"""Wave-sliced batch executor over any index exposing ``query_batch``.

The executor is the throughput layer between "a pile of rects" and the
vectorised index path: it slices the pile into waves of at most
``max_batch`` queries (bounding the flat candidate/hit buffers the batched
grid probe materialises), runs each wave through one ``query_batch`` call,
and keeps per-wave stats so the serving loop can report QPS and hit rates.
Per-wave ``rows_scanned``/``cells_probed`` come from the index's planning
stage (``last_batch_stats``), so backend comparisons report work done, not
just wall-clock throughput.

``backend="device"`` routes waves through the index's device-resident plan
(DESIGN.md §4) on the torch ``device`` the executor puts the index on
(default ``"cuda"``); ``backend="numpy"`` is the correctness oracle.  When
the index exposes the split ``query_batch_submit``/``query_batch_collect``
wave API, device waves are DOUBLE-BUFFERED: the executor keeps up to two
waves in flight, uploading + launching wave ``i+1`` before draining wave
``i``'s device-resident hit buffers, so host-side wave prep overlaps the
previous wave's kernels.  ``WaveStats.latency_s`` is then the full
submit→drain latency of that wave (the p50/p99 the benchmark reports)
while ``stats()['total_s']`` counts non-overlapping wall-clock, so QPS
reflects the pipelining win instead of double-counting overlap.

Telemetry (DESIGN.md §10): per-wave rollups land in a per-executor
``MetricsRegistry`` — the ONE source of truth ``stats()`` reads from in
O(1), replacing the old re-reduce over the whole wave list — and are
mirrored into the process-global registry (`coax_waves_total`,
`coax_queries_total`, `coax_wave_seconds{backend}`) for exposition.  The
retained per-wave rows live in a bounded ring (``wave_history``, default
1024): a long-running server keeps the trailing window for debugging
while the aggregates stay exact over the full run.  With tracing enabled
each wave is one ``wave`` span covering submit→drain; drain-side work
re-attaches wave *k*'s span explicitly so the pipelined wave *k+1* on
the stack never adopts its children (§10.2).

Under the mutable lifecycle (DESIGN.md §5) the index may compact between
waves — the executor re-validates ``index.backend`` per wave and stamps
each ``WaveStats`` with the epoch/delta/tombstone state it was SUBMITTED
from (the snapshot the device plan answers from, even if writes land
before the drain).  Indexes without a ``query_batch`` (e.g. the §8.1.3
baselines) degrade to a per-rect loop inside the same interface, which is
also what the benchmark's ``--batch`` mode compares against.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.types import split_hits
from ..obs.metrics import MetricsRegistry

__all__ = ["BatchQueryExecutor", "WaveStats", "split_hits"]

PIPELINE_DEPTH = 2     # waves in flight: upload i+1 while i's kernel runs

WAVE_HISTORY = 1024    # per-wave rows retained (ring); aggregates are exact


@dataclasses.dataclass
class WaveStats:
    wave: int
    n_queries: int
    n_hits: int
    latency_s: float
    rows_scanned: int = 0        # scan-window rows the planning stage visited
    cells_probed: int = 0        # candidate (query, cell) pairs enumerated
    backend: str = "numpy"       # backend that answered this wave
    fallbacks: int = 0           # device waves re-answered by numpy (§4)
    hit_overflows: int = 0       # queries whose hits overflowed the §4
                                 # device hit buffer (re-answered at drain)
    epoch: int = 0               # snapshot epoch the wave was served from (§5)
    delta_rows: int = 0          # live delta-log rows unioned into the wave
    tombstones: int = 0          # tombstoned ids masked out of the wave

    @property
    def qps(self) -> float:
        return self.n_queries / self.latency_s if self.latency_s > 0 else float("inf")


class BatchQueryExecutor:
    """Runs rect batches through an index in bounded waves.

    Parameters
    ----------
    index : any engine with ``query(rect)``; ``query_batch(rects)`` (flat
        (query_ids, row_ids) contract) is used when present.
    max_batch : wave width — queries per fused ``query_batch`` call.
    backend : ``None`` leaves the index's backend untouched; ``"numpy"`` /
        ``"device"`` set it on indexes that expose one (GridFile/COAXIndex)
        before the first wave.  Requesting ``"device"`` on an index without
        backend support raises.
    device : torch device set on indexes that expose one (``"cuda"`` by
        default; ``"cpu"`` runs the kernels' plain versions).
    wave_history : per-wave ``WaveStats`` rows retained in the bounded
        ring behind the ``wave_stats`` property (§10.4 satellite — the
        old unbounded list grew O(waves) on a long-running server).
        Aggregates in ``stats()`` stay exact regardless of eviction.
    """

    def __init__(self, index, max_batch: int = 64,
                 backend: Optional[str] = None,
                 wave_history: int = WAVE_HISTORY,
                 device: str = "cuda"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if wave_history < 1:
            raise ValueError("wave_history must be >= 1")
        if hasattr(index, "device"):
            index.device = device
        self.index = index
        self.max_batch = max_batch
        self.wave_history = int(wave_history)
        self._batched = hasattr(index, "query_batch")
        self._requested_backend = backend
        if backend is not None:
            if hasattr(index, "backend"):
                index.backend = backend
            elif backend != "numpy":
                raise ValueError(
                    f"{type(index).__name__} has no device backend")
        self.reset_stats()

    def reset_stats(self) -> None:
        """Fresh ring + fresh per-executor registry (the global-registry
        mirror is monotonic and NOT reset — process counters never go
        backwards)."""
        self._ring: deque = deque(maxlen=self.wave_history)
        self._wave_seq = 0       # waves ever run (ring may hold fewer)
        self._wall_s = 0.0       # non-overlapping busy time (pipelined QPS)
        self._last_done = 0.0    # perf_counter stamp of the last drain
        self._epochs: set = set()
        m = self.metrics = MetricsRegistry()
        self._c_queries = m.counter("queries", "queries answered")
        self._c_hits = m.counter("hits", "hit rows returned")
        self._c_rows = m.counter("rows_scanned", "planning-stage rows")
        self._c_cells = m.counter("cells_probed", "candidate (q,cell) pairs")
        self._c_fallbacks = m.counter("device_fallbacks",
                                      "device waves re-answered on host")
        self._c_fb_waves = m.counter("fallback_waves",
                                     "waves with >=1 fallback")
        self._c_overflows = m.counter("hit_overflows",
                                      "per-query device hit-buffer overflows")
        self._h_wave = m.histogram("wave_seconds", "submit->drain latency",
                                   ("backend",))
        self._g_delta = m.gauge("delta_rows", "live delta rows at last wave")
        self._g_tomb = m.gauge("tombstones", "tombstones at last wave")

    @property
    def wave_stats(self) -> List[WaveStats]:
        """Trailing window of per-wave rows (bounded ring, §10.4).  Sums
        over it equal ``stats()`` totals only while nothing has been
        evicted (``stats()['waves'] <= wave_history``)."""
        return list(self._ring)

    @property
    def backend(self) -> str:
        """The backend the next wave will be served from — re-read from the
        index every time rather than cached at construction, so an index
        compaction (epoch swap, DESIGN.md §5) or an external backend flip
        mid-stream can never be reported (or served) stale."""
        return self._requested_backend or getattr(self.index, "backend", "numpy")

    def _revalidate_backend(self) -> None:
        """Re-assert the requested backend on the index before a wave: if
        anything reset it (compaction path, another executor sharing the
        index), the wave would otherwise silently serve from the wrong
        plane.  Also the wave-boundary handoff point (DESIGN.md §5.4): a
        finished background compaction installs here, BEFORE the wave
        captures its snapshot, so every wave serves one whole epoch."""
        poll = getattr(self.index, "poll_handoff", None)
        if poll is not None:
            poll()
        if self._requested_backend is None:
            return
        cur = getattr(self.index, "backend", None)
        if cur is not None and cur != self._requested_backend:
            self.index.backend = self._requested_backend

    # ------------------------------------------------------------------ #
    def _run_wave(self, rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self._batched:
            return self.index.query_batch(rects)
        hits = [np.asarray(self.index.query(r), dtype=np.int64) for r in rects]
        qids = np.repeat(np.arange(len(hits), dtype=np.int64),
                         [h.size for h in hits])
        rids = np.concatenate(hits) if hits else np.empty(0, np.int64)
        return qids, rids

    def _wave_meta(self) -> Tuple[int, int, int]:
        """Epoch/delta/tombstone state captured at SUBMIT time — the frozen
        snapshot + write-plane state the wave is answered from (§4/§5)."""
        return (int(getattr(self.index, "epoch", 0)),
                int(getattr(self.index, "delta_rows", 0)),
                int(getattr(self.index, "tombstone_count", 0)))

    def _record_wave(self, wave: np.ndarray, qids: np.ndarray,
                     rids: np.ndarray, t0: float,
                     meta: Tuple[int, int, int],
                     ) -> List[np.ndarray]:
        """Shared drain-side bookkeeping: wall-clock accounting, per-wave
        stats row (ring), registry aggregates, hit splitting.
        ``latency_s`` is submit→drain; the busy accumulator only charges
        time not already charged to an overlapping wave, so pipelined QPS
        is wall-clock-true."""
        done = time.perf_counter()
        self._wall_s += done - max(t0, self._last_done)
        self._last_done = done
        bs = getattr(self.index, "last_batch_stats", None) \
            if self._batched else None
        ws = WaveStats(
            self._wave_seq, int(wave.shape[0]), int(rids.size),
            done - t0,
            rows_scanned=bs.rows_scanned if bs else 0,
            cells_probed=bs.cells_probed if bs else 0,
            backend=bs.backend if bs else self.backend,
            fallbacks=bs.fallbacks if bs else 0,
            hit_overflows=getattr(bs, "hit_overflows", 0) if bs else 0,
            epoch=meta[0], delta_rows=meta[1], tombstones=meta[2])
        self._wave_seq += 1
        self._ring.append(ws)
        # -- registry aggregates (stats() reads these in O(1), §10.1) -- #
        self._c_queries.inc(ws.n_queries)
        self._c_hits.inc(ws.n_hits)
        self._c_rows.inc(ws.rows_scanned)
        self._c_cells.inc(ws.cells_probed)
        if ws.fallbacks:
            self._c_fallbacks.inc(ws.fallbacks)
            self._c_fb_waves.inc()
        if ws.hit_overflows:
            self._c_overflows.inc(ws.hit_overflows)
        self._h_wave.observe(ws.latency_s, backend=ws.backend)
        self._g_delta.set(ws.delta_rows)
        self._g_tomb.set(ws.tombstones)
        self._epochs.add(ws.epoch)
        # process-global mirror (exposition; DESIGN.md §10.1)
        g = obs.get_registry()
        g.counter("coax_waves_total", "waves served",
                  ("backend",)).inc(backend=ws.backend)
        g.counter("coax_queries_total", "queries served",
                  ("backend",)).inc(ws.n_queries, backend=ws.backend)
        g.histogram("coax_wave_seconds", "wave submit->drain latency",
                    ("backend",)).observe(ws.latency_s, backend=ws.backend)
        return split_hits(qids, rids, wave.shape[0])

    # -- split wave API (device pipelining; DESIGN.md §4) -------------- #
    def execute_submit(self, rects: Sequence[np.ndarray]):
        """Submit ONE wave (≤ ``max_batch`` rects) without draining it.

        Returns an opaque pending handle for ``execute_collect``, or
        ``None`` when the index has no split wave API / the backend is not
        the device plane — callers then fall back to ``execute``.  The
        device plan snapshots epoch + delta + tombstones here, so writes
        applied before the drain don't leak into the wave."""
        if not (self._batched and self.backend == "device"
                and hasattr(self.index, "query_batch_submit")):
            return None
        wave = np.asarray(rects, dtype=np.float64)
        self._revalidate_backend()
        tr = obs.tracer()
        wsp = tr.start("wave", queries=int(wave.shape[0]),
                       backend="device") if tr else None
        t0 = time.perf_counter()
        if wsp is not None:
            with tr.attach(wsp):       # dispatch spans nest under it
                handle = self.index.query_batch_submit(wave)
        else:
            handle = self.index.query_batch_submit(wave)
        return (wave, handle, t0, self._wave_meta(), wsp)

    def execute_collect(self, pending) -> List[np.ndarray]:
        """Drain one ``execute_submit`` wave; returns one sorted row-id
        array per rect (same contract as ``execute``).  Drain-side spans
        re-attach THIS wave's span (explicit parent), not whatever wave
        is currently on the submit stack (§10.2)."""
        wave, handle, t0, meta, wsp = pending
        tr = obs.tracer()
        if wsp is not None and tr is not None:
            with tr.attach(wsp):
                qids, rids = self.index.query_batch_collect(handle)
            out = self._record_wave(wave, qids, rids, t0, meta)
            tr.finish(wsp, hits=int(rids.size))
            return out
        qids, rids = self.index.query_batch_collect(handle)
        return self._record_wave(wave, qids, rids, t0, meta)

    def execute(self, rects: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Answer every rect; returns one sorted row-id array per rect.

        Device waves with a split submit/collect index API are pipelined
        ``PIPELINE_DEPTH`` deep: wave ``i+1``'s host prep + upload + launch
        happens while wave ``i``'s fused kernel output is still device-
        resident, and only then is ``i`` drained."""
        rects = np.asarray(rects, dtype=np.float64)
        n = rects.shape[0]
        out: List[np.ndarray] = []
        inflight: deque = deque()
        for start in range(0, n, self.max_batch):
            wave = rects[start:start + self.max_batch]
            pending = self.execute_submit(wave)
            if pending is not None:            # pipelined device path
                inflight.append(pending)
                if len(inflight) >= PIPELINE_DEPTH:
                    out.extend(self.execute_collect(inflight.popleft()))
                continue
            while inflight:                    # backend flipped mid-stream
                out.extend(self.execute_collect(inflight.popleft()))
            self._revalidate_backend()
            tr = obs.tracer()
            wsp = tr.start("wave", queries=int(wave.shape[0]),
                           backend=self.backend) if tr else None
            t0 = time.perf_counter()
            if wsp is not None:
                with tr.attach(wsp):
                    qids, rids = self._run_wave(wave)
            else:
                qids, rids = self._run_wave(wave)
            out.extend(self._record_wave(wave, qids, rids, t0,
                                         self._wave_meta()))
            if wsp is not None:
                tr.finish(wsp, hits=int(rids.size))
        while inflight:
            out.extend(self.execute_collect(inflight.popleft()))
        return out

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """O(1) rollup read from the per-executor registry (§10.1) — the
        old implementation re-reduced the whole ``wave_stats`` list on
        every call, O(waves) on the serving path."""
        total_q = int(self._c_queries.total())
        total_s = self._wall_s      # non-overlapping busy time; < sum of
        lat = self._h_wave          # latencies when the pipeline overlapped
        return {
            "waves": self._wave_seq,
            "queries": total_q,
            "hits": int(self._c_hits.total()),
            "rows_scanned": int(self._c_rows.total()),
            "cells_probed": int(self._c_cells.total()),
            "device_fallbacks": int(self._c_fallbacks.total()),
            "fallback_waves": int(self._c_fb_waves.total()),
            "hit_overflows": int(self._c_overflows.total()),
            "total_s": total_s,
            "qps": total_q / total_s if total_s > 0 else 0.0,
            "wave_p50_ms": lat.quantile(0.5) * 1e3,
            "wave_p99_ms": lat.quantile(0.99) * 1e3,
            "batched": self._batched,
            "backend": self.backend,
            "epochs": sorted(self._epochs),
            "delta_rows": int(self._g_delta.value()) if self._wave_seq
                          else int(getattr(self.index, "delta_rows", 0)),
            "tombstones": int(self._g_tomb.value()) if self._wave_seq
                          else int(getattr(self.index, "tombstone_count", 0)),
        }
