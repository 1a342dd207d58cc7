"""COAX-indexed data curation: the paper's index as a first-class feature of
the training data plane (DESIGN.md §2).

The port of ``repro.data.curation``.  Sample-selection queries over
document metadata ("length in [1k, 8k), quality > 0.8, crawled after T")
are multidimensional range queries; the metadata columns carry soft FDs
(byte_len ~ token_len, compute_cost ~ token_len, timestamp ~ doc_id), so
COAX indexes fewer dimensions than a conventional grid.

On the device backend (the default, on ``cuda``) ``select`` is ONE wave
through ``COAXIndex.query_batch``: the ``CoaxDevicePlan`` and its
``fused_scan`` launches.  The reference's ``select`` calls ``query``,
a host path on every backend; ``query_batch`` answers the same sorted
row set (its contract), so the doc ids are the reference's.
``backend="numpy"`` calls ``query``.  A missing card raises at
construction.

``CuratedSelector`` returns doc-id sets consumable by ``ShardedLoader``:
the full path data -> COAX -> loader -> train loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core import COAXIndex, CoaxConfig, FullScan, full_rect
from ..storage.snapshot import require_device
from .pipeline import DocCorpus

__all__ = ["CuratedSelector", "MetaQuery"]


@dataclasses.dataclass
class MetaQuery:
    """Half-open constraints on named metadata columns."""
    token_len: Optional[Tuple[float, float]] = None
    byte_len: Optional[Tuple[float, float]] = None
    compute_cost: Optional[Tuple[float, float]] = None
    timestamp: Optional[Tuple[float, float]] = None
    doc_id: Optional[Tuple[float, float]] = None
    domain_id: Optional[Tuple[float, float]] = None
    quality: Optional[Tuple[float, float]] = None

    def rect(self, corpus: DocCorpus) -> np.ndarray:
        r = full_rect(len(corpus.META_COLS))
        for i, name in enumerate(corpus.META_COLS):
            bounds = getattr(self, name, None)
            if bounds is not None:
                r[i, 0], r[i, 1] = bounds
        return r


class CuratedSelector:
    """COAX index over corpus metadata with a full-scan reference engine."""

    def __init__(self, corpus: DocCorpus, config: CoaxConfig = CoaxConfig(),
                 *, backend: str = "device", device: str = "cuda"):
        require_device(backend, device)      # no card: raise here, not later
        self.corpus = corpus
        self.backend = backend
        t0 = time.time()
        self.index = COAXIndex(corpus.meta, config, backend=backend,
                               device=device)
        self.build_time = time.time() - t0
        self.reference = FullScan(corpus.meta)

    def select(self, query: MetaQuery) -> np.ndarray:
        """Doc ids matching the query (sorted)."""
        rect = query.rect(self.corpus)
        if self.backend == "device":
            return self.index.query_batch(rect[None])[1]     # one wave
        return self.index.query(rect)

    def select_reference(self, query: MetaQuery) -> np.ndarray:
        return self.reference.query(query.rect(self.corpus))

    def describe(self) -> Dict:
        d = self.index.describe()
        d["build_time_s"] = self.build_time
        d["meta_cols"] = list(self.corpus.META_COLS)
        return d

    def curriculum(self, stages: Sequence[MetaQuery]) -> Dict[int, np.ndarray]:
        """Resolve a staged curriculum (e.g. short->long documents) into
        per-stage doc-id sets via the index."""
        return {i: self.select(q) for i, q in enumerate(stages)}
