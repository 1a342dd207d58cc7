"""Telemetry plane walkthrough on the PyTorch port (DESIGN.md §10).

    PYTHONPATH=src python examples/telemetry_torch.py                # cuda
    PYTHONPATH=src python examples/telemetry_torch.py --device cpu

The twin of ``examples/telemetry.py`` on ``repro_torch``: serves a mixed
read/write stream on the device plan with background compaction while
the full telemetry plane is on, then shows the three layers:

1. the metrics registry — Prometheus-style text exposition plus the
   per-stage latency breakdown (probe/search/filter/merge/delta scan);
2. span tracing — the wave timeline, exported as Chrome ``trace_event``
   JSON that chrome://tracing or Perfetto opens directly;
3. the serving-pause watchdog — wave-gap outliers attributed to the
   background span (compaction install, WAL fsync) that overlapped them.

Asked for ``cuda`` without a card it raises before any work.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch import obs
from repro_torch.core import COAXIndex, CoaxConfig
from repro_torch.data import knn_rect_queries, make_airline
from repro_torch.engine import QueryServer
from repro_torch.storage.snapshot import require_device


def main(device: str = "cuda", *, rows: int = 60_000, queries: int = 256,
         k: int = 64, rounds: int = 3, inserts: int = 128) -> dict:
    """Serve with the telemetry plane on; returns the facts it printed."""
    require_device("device", device)
    ds = make_airline(rows, seed=0)
    rects = knn_rect_queries(ds.data, queries, k, seed=1, sample_cap=50_000)

    tracer = obs.enable_tracing(capacity=16384)   # spans no-op without this
    try:
        idx = COAXIndex(ds.data, CoaxConfig(background_compact=True,
                                            compact_min_delta=512,
                                            compact_delta_frac=0.01,
                                            compact_check_rows=64),
                        device=device)
        srv = QueryServer(idx, max_batch=64, device=device)

        rng = np.random.default_rng(7)
        for _ in range(rounds):          # enough writes to cross the
            for start in range(0, len(rects), 64):   # compaction trigger
                srv.insert(ds.data[rng.integers(0, len(ds.data), inserts)])
                for r in rects[start:start + 64]:
                    srv.submit(r)
                srv.drain()
        idx.finish_handoff()

        # -- layer 1: the registry -------------------------------------- #
        s = srv.stats()
        print(f"served {s['queries']} queries in {s['waves_drained']} "
              f"waves, epoch {idx.epoch}, "
              f"{idx.background_compactions} background compaction(s)")
        print("\nper-stage latency (coax_stage_seconds):")
        hist = obs.stage_hist()
        series = []
        for entry in obs.get_registry().snapshot()[
                "coax_stage_seconds"]["series"]:
            lab = entry["labels"]
            summ = hist.summary(**lab)
            series.append((lab["stage"], lab["backend"], summ["count"]))
            print(f"  {lab['stage']:>11}/{lab['backend']}: "
                  f"n={summ['count']:<4} p50={summ['p50']*1e6:8.1f}us "
                  f"p99={summ['p99']*1e6:8.1f}us "
                  f"total={summ['sum']*1e3:7.2f}ms")
        exposition = obs.get_registry().render_text()
        wal_lines = [l for l in exposition.splitlines()
                     if l.startswith(("coax_compactions",
                                      "coax_handoff_seconds_"))]
        print("\nexposition excerpt (registry.render_text()):")
        for line in wal_lines[:6]:
            print(f"  {line}")

        # -- layer 2: the trace ----------------------------------------- #
        evs = tracer.events()
        ok, problems = tracer.validate()
        by_name = {}
        for e in evs:
            by_name.setdefault(e["name"], []).append(e)
        print(f"\ntrace: {len(evs)} spans "
              f"({'valid' if ok else problems[:2]}), "
              f"{tracer.dropped} evicted from the ring")
        for name in sorted(by_name):
            spans = by_name[name]
            total = sum(e["t1"] - e["t0"] for e in spans)
            print(f"  {name:<20} x{len(spans):<4} {total*1e3:8.2f}ms total")
        out = Path(tempfile.gettempdir()) / "coax_trace_torch.json"
        out.write_text(json.dumps(tracer.to_chrome()))
        print(f"chrome://tracing timeline written to {out}")

        # -- layer 3: the watchdog -------------------------------------- #
        wd = srv.watchdog.describe()
        print(f"\nwatchdog: {wd['pauses']} pause(s) over a "
              f"{wd['median_gap_s']*1e3:.2f}ms median wave gap"
              + (f", last culprit {wd['last_culprit']}"
                 if wd["last_culprit"] else ""))
    finally:
        obs.disable_tracing()
    return {"queries": s["queries"], "waves": s["waves_drained"],
            "epoch": idx.epoch, "compactions": idx.background_compactions,
            "series": series, "spans": {n: len(v) for n, v in by_name.items()},
            "valid": ok}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
