"""Serving driver on the PyTorch port: batched request serving with
COAX-routed admission.

    PYTHONPATH=src python examples/serve_requests_torch.py             # LM serving
    PYTHONPATH=src python examples/serve_requests_torch.py --durable   # kill-and-resume
    PYTHONPATH=src python examples/serve_requests_torch.py --failover  # replicated failover
    (each with ``--device cpu`` to run on the host)

The twin of ``examples/serve_requests.py`` on ``repro_torch``; every mode
runs on ``--device`` (default ``cuda``; asked for ``cuda`` without a card
it raises before any work).

Default mode: requests with correlated (arrival, prompt_len,
predicted_decode, priority) attributes stream into the router; admission
queries form length-homogeneous waves through the COAX index on the
device plan (the serving-plane integration, DESIGN.md §2), and the model
decodes each wave on the same device.

``--durable`` demos the durability plane (DESIGN.md §7): a journaled
``QueryServer`` absorbs query waves and writes, honours a SIGTERM-style
graceful-shutdown request (finish the wave, flush writes, fsync, close),
then gets "killed" mid-stream — with its WAL torn mid-record, as a real
crash would leave it — and a fresh process recovers from snapshot + WAL
replay, answers the same queries bit-identically, and keeps serving.

``--failover`` demos the replication plane (DESIGN.md §8): a
``ReplicatedServer`` ships WAL frames to two read replicas on the device
backend over a faulty transport (drops, tears, duplicates, reordering —
all repaired), routes reads to healthy replicas, loses its primary
mid-stream, promotes the most-caught-up replica without losing an
acknowledged write, and keeps serving bit-identical answers.
"""
import argparse
import dataclasses
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.storage.snapshot import require_device


def main_failover(device: str = "cuda") -> dict:
    """Replicated serving: faulty shipping, primary death, promotion."""
    from repro_torch.core import COAXIndex, CoaxConfig
    from repro_torch.data import knn_rect_queries, make_airline
    from repro_torch.replication import ReplicatedServer
    from repro_torch.runtime.failure import FaultPlan

    require_device("device", device)
    workdir = Path(tempfile.mkdtemp(prefix="coax_failover_"))
    try:
        ds = make_airline(30_000, seed=7)
        base, pool = ds.data[:25_000], ds.data[25_000:]
        rects = knn_rect_queries(base, 32, 64, seed=1)

        print("== replicated serving under injected faults ==")
        plan = FaultPlan({
            "ship.replica-0": {3: "drop", 7: "tear", 11: "dup"},
            "ship.replica-1": {5: "reorder", 9: ("error", 1)},
        })
        idx = COAXIndex(base, CoaxConfig(auto_compact=False), device=device)
        srv = ReplicatedServer(idx, workdir, n_replicas=2, plan=plan,
                               device=device)
        for i in range(10):
            srv.insert(pool[i * 120:(i + 1) * 120])
            if i % 3 == 2:
                srv.delete(np.arange(i * 400, i * 400 + 150))
            srv.tick()
        srv.compact()                     # ships the ROTATE control frame
        srv.tick()
        expected = [np.sort(srv.primary.query(r)) for r in rects]
        agree = all(np.array_equal(np.sort(srv.query(r)), expected[i])
                    for i, r in enumerate(rects))
        st = srv.stats()
        lags = {r["name"]: r["lag_frames"] for r in st["replicas"]}
        print(f"  shipped {st['ship']['shipped_frames']} frames "
              f"({st['ship']['shipped_bytes']} B); faults "
              f"{st['transport_faults']}; replica lag {lags}")
        print(f"  routed {st['reads']['replica']} reads to replicas: "
              f"{'bit-identical to primary' if agree else 'MISMATCH'}")
        assert agree and all(v == 0 for v in lags.values())
        shipped = dict(frames=st["ship"]["shipped_frames"],
                       bytes=st["ship"]["shipped_bytes"],
                       faults=st["transport_faults"],
                       replica_reads=st["reads"]["replica"])

        print("== primary dies mid-stream; promote ==")
        srv.insert(pool[1200:1400])       # acked, but replicas not yet pumped
        srv.kill_primary()
        acked = srv.acked
        promoted = srv.promote()
        print(f"  promoted {promoted.name}: frontier {promoted.frontier} "
              f">= last ack {acked}; no acknowledged write lost")
        srv.insert(pool[1400:1600])
        srv.delete(np.arange(50))
        srv.tick()
        post = [np.sort(srv.primary.query(r)) for r in rects]
        agree2 = all(np.array_equal(np.sort(srv.query(r)), post[i])
                     for i, r in enumerate(rects))
        st = srv.stats()
        print(f"  serving resumed under {st['primary_dir']}: replicas "
              f"re-seeded, {'answers bit-identical' if agree2 else 'MISMATCH'}"
              f"; promotions={st['promotions']}")
        assert agree2
        return dict(shipped, promoted=promoted.name,
                    frontier=promoted.frontier, acked=acked,
                    promotions=st["promotions"], answers=post)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main_durable(device: str = "cuda") -> dict:
    """Kill-and-resume: journal, crash (torn WAL tail included), recover."""
    import os

    from repro_torch.core import COAXIndex, CoaxConfig
    from repro_torch.data import knn_rect_queries, make_airline
    from repro_torch.engine import QueryServer
    from repro_torch.runtime.failure import GracefulShutdown
    from repro_torch.storage import latest_snapshot, read_manifest, wal_path

    require_device("device", device)
    workdir = Path(tempfile.mkdtemp(prefix="coax_durable_"))
    try:
        ds = make_airline(30_000, seed=7)
        base, pool = ds.data[:25_000], ds.data[25_000:]
        rects = knn_rect_queries(base, 48, 64, seed=1)

        print("== process 1: journaled serving ==")
        idx = COAXIndex(base, CoaxConfig(compact_min_delta=2_000,
                                         compact_delta_frac=0.05),
                        device=device)
        idx.attach_durability(workdir)
        srv = QueryServer(idx, max_batch=16, checkpoint_every=2,
                          device=device)
        first = {}
        for i in range(4):
            srv.insert(pool[i * 200:(i + 1) * 200])
            srv.delete(np.arange(i * 300, i * 300 + 120))
            for r in rects[i * 12:(i + 1) * 12]:
                first[srv.submit(r)] = r
        answers1 = srv.drain()
        s = srv.stats()
        print(f"  served {s['queries']} queries in {s['waves']} waves; "
              f"inserted {s['rows_inserted']}, deleted {s['rows_deleted']}; "
              f"epoch {s['epoch']}, wal_records {s['wal_records']}, "
              f"checkpoints {s['checkpoints_written']}")

        # the durable frontier is here: everything drained + fsynced.  One
        # more write dies mid-append — tear its record as a crash would —
        # so it was never acknowledged and recovery must NOT contain it.
        expected = {qid: idx.query(r) for qid, r in first.items()}
        srv.insert(pool[900:1100]); srv.flush_writes()
        idx.durable.sync()
        wfile = wal_path(workdir, idx.epoch)
        os.truncate(wfile, wfile.stat().st_size - 9)
        del srv, idx
        print("  ...killed (last WAL record torn mid-append)")

        print("== process 2: recover and resume ==")
        t0 = time.time()
        srv2 = QueryServer.recover(workdir, max_batch=16, checkpoint_every=2,
                                   device=device)
        dt = time.time() - t0
        man = read_manifest(latest_snapshot(workdir))
        print(f"  recovered in {dt*1e3:.0f} ms from snapshot "
              f"epoch={man['epoch']} wal_seq={man['wal_seq']} "
              f"+ WAL replay; n_rows={srv2.executor.index.n_rows}")
        qids = {srv2.submit(r): qid for qid, r in first.items()}
        answers2 = srv2.drain()
        agree = all(np.array_equal(answers2[q2], expected[q1])
                    for q2, q1 in qids.items())
        print(f"  re-answered {len(qids)} queries: "
              f"{'bit-identical to pre-crash index' if agree else 'MISMATCH'}")
        assert agree
        srv2.insert(pool[1100:1300]); srv2.flush_writes()
        srv2.executor.index.durable.sync()
        print(f"  resumed journaling: "
              f"{srv2.stats()['wal_records']} records in the live WAL")
        recovered = dict(epoch=man["epoch"], wal_seq=man["wal_seq"],
                         n_rows=srv2.executor.index.n_rows,
                         wal_records=srv2.stats()["wal_records"])

        print("== process 2: SIGTERM -> graceful shutdown ==")
        with GracefulShutdown() as stop:
            srv2.shutdown = stop
            for r in rects:
                srv2.submit(r)
            srv2.insert(pool[1300:1400])
            partial = srv2.drain(max_waves=1)   # mid-stream...
            stop.request()                      # ...the preemption notice lands
            partial.update(srv2.drain())        # finishes in-flight, forms no more
            srv2.close()                        # flush writes + fsync + release WAL
        s2 = srv2.stats()
        print(f"  answered {len(partial)} before the flag; {s2['pending']} "
              f"queries left for the next incarnation; writes flushed "
              f"(pending={s2['writes_pending']}), WAL synced, "
              f"closed={s2['closed']}")
        assert s2["writes_pending"] == 0 and s2["closed"]
        return dict(recovered, served=s["queries"], waves=s["waves"],
                    answered=len(partial), left=s2["pending"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def make_model(device: str = "cuda"):
    """The reference's small danube-style config, initialised from a
    seeded ``torch.Generator`` on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(
        get_config("h2o-danube-3-4b"),
        n_layers=4, d_model=256, d_ff=768, vocab_size=8192,
        n_heads=8, n_kv_heads=4, head_dim=32, window=256)
    model = build_model(cfg, device=device)
    return model.init(torch.Generator(device=device).manual_seed(0))


def main(device: str = "cuda", *, n_requests: int = 48, model=None) -> dict:
    """Serve ``n_requests`` through the COAX router; ``model`` (default
    ``make_model(device)``) must live on ``device``.  Returns the results
    and the waves."""
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    require_device("device", device)
    model = model if model is not None else make_model(device)
    srv = Server(model, ServeConfig(batch_size=8, max_new_tokens=24,
                                    cache_len=512, eos_token=0),
                 device=device)

    rng = np.random.default_rng(7)
    for i in range(n_requests):
        plen = int(rng.choice([16, 24, 48, 96, 192]))
        srv.submit(rng.integers(1, 8000, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(8, 24)),
                   priority=float(rng.random()))
    print(f"submitted {n_requests} requests; router stats: {srv.router.stats()}")

    t0 = time.time()
    results = srv.run_until_drained()
    dt = time.time() - t0
    toks = sum(r.tokens.size for r in results)
    print(f"served {len(results)} requests in {srv.waves} waves, "
          f"{toks} tokens in {dt:.1f}s ({toks/dt:.0f} tok/s on {device})")
    by_wave = {}
    for r in results:
        by_wave.setdefault(r.wave, []).append(r.prompt_len)
    for w, lens in sorted(by_wave.items()):
        print(f"  wave {w}: {len(lens)} reqs, prompt lens {sorted(lens)}")
    return {"results": results, "waves": srv.waves}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--durable", action="store_true",
                    help="kill-and-resume durability demo (DESIGN.md §7)")
    ap.add_argument("--failover", action="store_true",
                    help="replicated failover demo (DESIGN.md §8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.failover:
        main_failover(args.device)
    elif args.durable:
        main_durable(args.device)
    else:
        main(args.device)
