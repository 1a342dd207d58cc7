"""Sharded, resumable, prefetching LM data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy and threading
only): ``make_corpus(seed)`` and every batch of ``ShardedLoader`` equal
the reference's bit for bit, across epoch boundaries and after
``load_state``.  Batches are numpy (int32 ``tokens`` and ``labels``); a
train step moves them to the model's device.

Documents carry multidimensional metadata with natural soft-FD structure
(byte_len ~ token_len; compute_cost ~ token_len; timestamp ~ doc id), which
is what `curation.py` indexes with COAX.  The token stream itself is
synthetic (deterministic from seed) — the pipeline machinery (sharding,
resumability, prefetch) is the production part.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DocCorpus", "ShardedLoader", "make_corpus"]


@dataclasses.dataclass
class DocCorpus:
    """A corpus of documents with correlated metadata columns.

    meta columns: 0 doc_id, 1 timestamp, 2 token_len, 3 byte_len,
                  4 compute_cost, 5 domain_id, 6 quality
    """
    meta: np.ndarray           # (N, 7) float32
    seed: int
    vocab_size: int

    META_COLS = ("doc_id", "timestamp", "token_len", "byte_len",
                 "compute_cost", "domain_id", "quality")

    def tokens_for(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + int(doc_id))
        n = int(self.meta[int(doc_id), 2])
        return rng.integers(0, self.vocab_size, size=n).astype(np.int32)


def make_corpus(n_docs: int = 50_000, vocab_size: int = 32_000,
                seed: int = 0) -> DocCorpus:
    rng = np.random.default_rng(seed)
    doc_id = np.arange(n_docs, dtype=np.float64)
    # crawl time grows with id (soft FD), with re-crawl outliers
    ts = 1.6e9 + doc_id * 30.0 + rng.normal(0, 3600.0, n_docs)
    recrawl = rng.random(n_docs) < 0.05
    ts[recrawl] += rng.uniform(3e6, 3e7, recrawl.sum())
    token_len = np.clip(rng.lognormal(6.2, 0.8, n_docs), 64, 32768)
    byte_len = token_len * rng.normal(4.2, 0.25, n_docs)          # soft FD
    compute_cost = token_len * rng.normal(1.0, 0.05, n_docs)      # tight FD
    domain = rng.integers(0, 24, n_docs).astype(np.float64)
    quality = np.clip(rng.beta(4, 2, n_docs) + 0.05 * (domain % 3 == 0), 0, 1)
    meta = np.stack([doc_id, ts, token_len, byte_len, compute_cost,
                     domain, quality], axis=1).astype(np.float32)
    return DocCorpus(meta=meta, seed=seed, vocab_size=vocab_size)


class ShardedLoader:
    """Deterministic, resumable, host-sharded batch iterator with prefetch.

    Every host computes the same global permutation per epoch and takes its
    strided shard — no coordination traffic.  ``state_dict``/``load_state``
    capture (epoch, cursor) so a restore resumes mid-epoch on the exact next
    batch (checkpoint/restart correctness is tested).
    """

    def __init__(self, corpus: DocCorpus, *, batch_size: int, seq_len: int,
                 process_index: int = 0, process_count: int = 1,
                 doc_ids: Optional[np.ndarray] = None, seed: int = 0,
                 prefetch: int = 2):
        self.corpus = corpus
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.doc_ids = (np.arange(corpus.meta.shape[0], dtype=np.int64)
                        if doc_ids is None else np.asarray(doc_ids, np.int64))
        self.epoch = 0
        self.cursor = 0  # batches CONSUMED within this epoch (this host)
        self._prefetch = prefetch
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------- state ------------------------------- #
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor}

    def load_state(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])

    # --------------------------- iteration ----------------------------- #
    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.doc_ids)
        return order[self.process_index::self.process_count]

    def _build_batch(self, docs: np.ndarray) -> Dict[str, np.ndarray]:
        toks = np.zeros((self.batch_size, self.seq_len + 1), np.int32)
        for i, d in enumerate(docs):
            stream = self.corpus.tokens_for(int(d))
            reps = int(np.ceil((self.seq_len + 1) / len(stream)))
            toks[i] = np.tile(stream, reps)[: self.seq_len + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _next_indices(self, epoch: int, cursor: int):
        """Docs for position (epoch, cursor) plus the position AFTER it.

        Pure in the loader's public state: the prefetch worker runs ahead of
        the consumer with its own local position, and ``self.epoch``/
        ``self.cursor`` only advance when a batch is actually consumed — so
        ``state_dict`` is exact however far prefetch has run.
        """
        order = self._epoch_order(epoch)
        per_epoch = len(order) // self.batch_size
        if cursor >= per_epoch:
            epoch += 1
            cursor = 0
            order = self._epoch_order(epoch)
        lo = cursor * self.batch_size
        docs = order[lo: lo + self.batch_size]
        return docs, epoch, cursor + 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        def work(epoch: int, cursor: int):
            while not self._stop.is_set():
                docs, epoch, cursor = self._next_indices(epoch, cursor)
                item = (epoch, cursor, self._build_batch(docs))
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        if self._worker is not None and self._worker.is_alive():
            self._stop.set()                  # retire any previous worker
            self._worker.join()               # before it can feed the new queue
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self._prefetch)  # drop stale prefetch
        self._worker = threading.Thread(
            target=work, args=(self.epoch, self.cursor), daemon=True)
        self._worker.start()
        try:
            while True:
                epoch, cursor, batch = self._queue.get()
                # commit the consumed position (epoch rollover sets cursor=1)
                self.epoch, self.cursor = epoch, cursor
                yield batch
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
