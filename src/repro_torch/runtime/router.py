"""COAX-indexed request router for continuous-batching admission
(DESIGN.md §2: the paper's index in the serving plane).

The port of ``repro.runtime.router``.  The pending-request pool is a
multidimensional table (arrival_time, prompt_len, predicted_decode_len,
priority); admission is a range query ("prompt_len in [lo, hi) and
priority >= p, oldest first") that forms length-homogeneous decode
batches.  prompt_len -> predicted_decode_len is a soft FD, so COAX
indexes the pool with a reduced-dimensionality primary index.

The router is rebuild-on-dirty: between rebuilds new arrivals sit in a
small overflow list scanned linearly (bounded by ``rebuild_threshold``),
and admitted rows stay in the index as tombstones, filtered by pool
membership.

On the device backend (the default, on ``cuda``) each admission against a
built index is ONE wave through ``COAXIndex.query_batch`` — the
``CoaxDevicePlan`` and one group of ``fused_scan`` launches; the
single-rect ``query`` runs the host path on every backend, so the router
sends its one rect as a batch of one.  The answer is the same row set
(``query_batch``'s contract).  ``backend="numpy"`` calls ``query``, as the
reference does.  A missing card raises at construction.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import COAXIndex, CoaxConfig, full_rect, rect_contains
from ..obs import MetricsRegistry
from ..storage.snapshot import require_device

__all__ = ["Request", "CoaxRouter", "COLS"]

COLS = ("arrival", "prompt_len", "predicted_decode", "priority")


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt: np.ndarray                 # token ids
    max_new_tokens: int
    priority: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


def _predict_decode_len(prompt_len: int, max_new: int) -> float:
    # serving-time heuristic: decode budget tracks prompt length (soft FD)
    return float(min(max_new, 16 + 0.25 * prompt_len))


class CoaxRouter:
    def __init__(self, rebuild_threshold: int = 256,
                 config: Optional[CoaxConfig] = None, *,
                 backend: str = "device", device: str = "cuda"):
        require_device(backend, device)      # no card: raise here, not later
        self.config = config or CoaxConfig()
        self.rebuild_threshold = rebuild_threshold
        self.backend = backend
        self.device = device
        self._pool: Dict[int, Request] = {}
        self._index: Optional[COAXIndex] = None
        self._index_rids: np.ndarray = np.empty(0, np.int64)
        self._overflow: List[int] = []
        self._tombstones = 0          # admitted rows still in the index
        self._ids = itertools.count()
        # private registry (DESIGN.md §10.4): stats() delegates here so the
        # router shares the exposition schema with the serving planes
        self.metrics = MetricsRegistry()
        self._c_submits = self.metrics.counter(
            "coax_router_submits_total", "Requests submitted to the pool.")
        self._c_admitted = self.metrics.counter(
            "coax_router_admitted_total", "Requests admitted into batches.")
        self._c_rebuilds = self.metrics.counter(
            "coax_router_rebuilds_total", "Lazy index rebuilds.")
        self._h_admit = self.metrics.histogram(
            "coax_router_admit_seconds", "Latency of admit() calls.")

    # ------------------------------------------------------------------ #
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: float = 0.0, arrival: Optional[float] = None) -> int:
        rid = next(self._ids)
        req = Request(rid, arrival if arrival is not None else time.time(),
                      np.asarray(prompt), max_new_tokens, priority)
        self._pool[rid] = req
        self._overflow.append(rid)
        self._c_submits.inc()
        if len(self._overflow) >= self.rebuild_threshold:
            self._rebuild()
        return rid

    def _row(self, req: Request) -> np.ndarray:
        return np.array([req.arrival, req.prompt_len,
                         _predict_decode_len(req.prompt_len, req.max_new_tokens),
                         req.priority], np.float32)

    def _rebuild(self) -> None:
        self._c_rebuilds.inc()
        if self._index is not None:
            self._index.release_plan()
        if not self._pool:
            self._index, self._index_rids = None, np.empty(0, np.int64)
            self._overflow = []
            return
        rids = np.array(sorted(self._pool), np.int64)
        rows = np.stack([self._row(self._pool[r]) for r in rids])
        self._index = (COAXIndex(rows, self.config, backend=self.backend,
                                 device=self.device)
                       if len(rows) >= 64 else None)
        self._index_rids = rids
        self._overflow = []
        self._tombstones = 0

    def _index_hits(self, rect: np.ndarray) -> np.ndarray:
        if self.backend == "device":
            return self._index.query_batch(rect[None])[1]     # one wave
        return self._index.query(rect)

    # ------------------------------------------------------------------ #
    def admit(self, batch_size: int, *,
              prompt_len_range: Tuple[float, float] = (0, np.inf),
              min_priority: float = -np.inf,
              max_predicted_decode: float = np.inf) -> List[Request]:
        """Form a batch: range query over the pool, oldest-first."""
        t0 = time.perf_counter()
        rect = full_rect(len(COLS))
        rect[1] = prompt_len_range
        rect[2, 1] = max_predicted_decode
        rect[3, 0] = min_priority

        hit_rids: List[int] = []
        if self._index is not None:
            rows_idx = self._index_hits(rect)
            hit_rids.extend(int(self._index_rids[i]) for i in rows_idx)
        # overflow (not yet indexed) checked in one vectorised pass
        ov = [r for r in self._overflow if r in self._pool]
        if ov:
            ov_rows = np.stack([self._row(self._pool[r]) for r in ov])
            hit_rids.extend(r for r, ok in zip(ov, rect_contains(rect, ov_rows)) if ok)

        cands = [self._pool[r] for r in dict.fromkeys(hit_rids) if r in self._pool]
        cands.sort(key=lambda r: (-r.priority, r.arrival))
        batch = cands[:batch_size]
        for r in batch:
            self._pool.pop(r.rid, None)
        # admitted rows become tombstones (filtered by pool membership
        # above); the index is rebuilt lazily once tombstones + overflow
        # cross the threshold
        self._tombstones += len(batch)
        if self._tombstones + len(self._overflow) >= self.rebuild_threshold:
            self._rebuild()
        self._c_admitted.inc(len(batch))
        self._h_admit.observe(time.perf_counter() - t0)
        return batch

    def __len__(self) -> int:
        return len(self._pool)

    def stats(self) -> Dict:
        """Pool shape plus the registry-backed counters (DESIGN.md §10.4):
        pool/index gauges are derived live, event counts delegate to
        ``self.metrics``."""
        lat = self._h_admit.summary()
        return {
            "pending": len(self._pool),
            "indexed": int(self._index_rids.size),
            "overflow": len(self._overflow),
            "index_memory": self._index.memory_footprint() if self._index else 0,
            "index_groups": [
                (g.predictor, list(g.dependents)) for g in self._index.groups
            ] if self._index else [],
            "submits": self._c_submits.value(),
            "admitted": self._c_admitted.value(),
            "rebuilds": self._c_rebuilds.value(),
            "admit_p50_ms": lat["p50"] * 1e3,
            "admit_p99_ms": lat["p99"] * 1e3,
        }
