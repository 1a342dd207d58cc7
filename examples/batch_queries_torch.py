"""Batched query engine on the PyTorch port (DESIGN.md §2, §5).

    PYTHONPATH=src python examples/batch_queries_torch.py                # cuda
    PYTHONPATH=src python examples/batch_queries_torch.py --device cpu

The twin of ``examples/batch_queries.py`` on ``repro_torch``: builds a
COAX index over airline-like data, submits a mixed-priority range query
stream to the QueryServer, drains it in fused waves on the device plan,
and compares engine throughput against the per-query loop.  Then goes
live: inserts and deletes are admitted next to queries (applied at wave
boundaries), answered from the delta plane, and folded back in by a
compaction.  Asked for ``cuda`` without a card it raises before any work.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import COAXIndex
from repro_torch.data import knn_rect_queries, make_airline
from repro_torch.engine import QueryServer
from repro_torch.storage.snapshot import require_device


def main(device: str = "cuda", *, rows: int = 100_000, queries: int = 192,
         k: int = 64, inserts: int = 2_000, deletes: int = 500) -> dict:
    """Serve, write, compact; returns the facts it printed."""
    require_device("device", device)
    ds = make_airline(rows, seed=0)
    idx = COAXIndex(ds.data, device=device)
    n_groups = len(idx.groups)
    print(f"built COAX over {ds.data.shape}: "
          f"{n_groups} FD groups, primary ratio {idx.primary_ratio:.2f}")

    rects = knn_rect_queries(ds.data, queries, k, seed=1, sample_cap=50_000)
    srv = QueryServer(idx, max_batch=64, device=device)
    rng = np.random.default_rng(2)
    qids = [srv.submit(r, priority=float(rng.integers(0, 3))) for r in rects]
    print(f"submitted {len(qids)} range queries; pending={len(srv)}")

    t0 = time.perf_counter()
    results = srv.drain()
    batch_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    loop = [idx.query(r) for r in rects]
    loop_s = time.perf_counter() - t0

    assert all(np.array_equal(results[q], l) for q, l in zip(qids, loop))
    s = srv.stats()
    print(f"drained {s['queries']} queries in {s['waves_drained']} waves: "
          f"{len(rects)/batch_s:.0f} QPS batched vs {len(rects)/loop_s:.0f} QPS "
          f"looped ({loop_s/batch_s:.2f}x)")
    total_hits = sum(r.size for r in results.values())
    print(f"total hits {total_hits}, index directory "
          f"{idx.memory_footprint()/1024:.1f} KiB")

    # --- the write path (DESIGN.md §5) -------------------------------- #
    fresh = make_airline(inserts, seed=7).data
    w_ins = srv.insert(fresh)                       # queued ...
    w_del = srv.delete(rng.choice(rows, deletes, replace=False))
    qid = srv.submit(rects[0])
    res = srv.drain()                               # ... applied at the wave
    new_ids = srv.write_results[w_ins]
    print(f"inserted {new_ids.size} rows / deleted {srv.write_results[w_del]}; "
          f"delta={idx.delta_rows} tombstones={idx.tombstone_count} "
          f"epoch={idx.epoch}")
    assert np.array_equal(res[qid], idx.query(rects[0]))
    live = dict(delta=idx.delta_rows, tombstones=idx.tombstone_count,
                epoch=idx.epoch, deleted=srv.write_results[w_del],
                after_writes=res[qid])
    idx.compact()
    print(f"compacted -> epoch {idx.epoch}, {idx.n_rows} live rows, "
          f"delta={idx.delta_rows}, drift predictability "
          f"{idx.drift_predictability():.3f}")
    assert np.array_equal(res[qid], idx.query(rects[0]))  # answers survive
    return {"groups": n_groups, "waves": s["waves_drained"],
            "hits": [results[q] for q in qids], "total_hits": total_hits,
            "live": live, "epoch": idx.epoch, "n_rows": idx.n_rows,
            "drift": idx.drift_predictability()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
