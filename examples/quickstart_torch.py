"""Quickstart on the PyTorch port: build a COAX index on correlated
multidimensional data and run exact range queries through the soft-FD
translation path, then answer the same queries in one wave on the card.

    PYTHONPATH=src python examples/quickstart_torch.py                # cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Asked for
``cuda`` without a card it raises before any work.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import COAXIndex, FullScan
from repro_torch.data import knn_rect_queries, make_airline
from repro_torch.storage.snapshot import require_device


def main(device: str = "cuda", *, rows: int = 500_000, queries: int = 10,
         k: int = 200) -> dict:
    """Build, describe, query; returns the facts it printed."""
    require_device("device", device)
    # 1. An airline-like dataset: (Distance -> TimeElapsed, AirTime) and
    #    (DepTime -> ArrTime, SchedArrTime) are soft functional dependencies.
    ds = make_airline(rows, seed=0)
    print(f"dataset: {ds.data.shape[0]:,} rows x {ds.data.shape[1]} attrs")

    # 2. Build: COAX detects the FDs, learns linear models with error margins,
    #    splits inliers/outliers, and indexes ONLY the predictor dims.
    t0 = time.time()
    index = COAXIndex(ds.data, device=device)
    print(f"built in {time.time() - t0:.2f}s")
    d = index.describe()
    for g in d["groups"]:
        print(f"  soft FD: attr {g['predictor']} -> {g['dependents']}")
    print(f"  indexed dims: {d['indexed_dims']} (of {ds.data.shape[1]});"
          f" primary ratio: {d['primary_ratio']:.1%};"
          f" directory: {d['memory_footprint_bytes']/1024:.0f} KiB")

    # 3. Query: rectangles over ALL dims; constraints on dependent attrs are
    #    translated onto the indexed attrs (Eq. 2).  Results are exact.
    rects = knn_rect_queries(ds.data, queries, k, seed=1, sample_cap=50_000)
    ref = FullScan(ds.data)
    t0 = time.time()
    hits = [index.query(r) for r in rects]
    coax_ms = (time.time() - t0) / len(rects) * 1e3
    t0 = time.time()
    truth = [ref.query(r) for r in rects]
    scan_ms = (time.time() - t0) / len(rects) * 1e3
    assert np.array_equal(hits[-1], truth[-1]), \
        "COAX must return the exact result set"
    print(f"query: COAX {coax_ms:.2f} ms vs full scan {scan_ms:.2f} ms "
          f"({scan_ms / coax_ms:.0f}x) — exact results verified")

    # 4. The same rectangles in one wave through the device plan.
    t0 = time.time()
    wave = index.query_batch_split(rects)
    wave_ms = (time.time() - t0) * 1e3
    assert all(np.array_equal(w, t) for w, t in zip(wave, truth)), \
        "the device wave must return the exact result sets"
    print(f"device wave on {device}: {len(rects)} queries in {wave_ms:.2f} ms"
          f" — exact results verified")
    return {"groups": [(g["predictor"], g["dependents"]) for g in d["groups"]],
            "indexed_dims": d["indexed_dims"],
            "primary_ratio": d["primary_ratio"], "hits": hits, "wave": wave}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
