"""Data-curation driver on the PyTorch port: COAX as the metadata index of
a training data plane.

    PYTHONPATH=src python examples/coax_curation_torch.py                # cuda
    PYTHONPATH=src python examples/coax_curation_torch.py --device cpu

The twin of ``examples/coax_curation.py`` on ``repro_torch``: builds a
document corpus whose metadata columns carry soft FDs (token_len ~
byte_len ~ compute_cost, doc_id ~ timestamp), indexes them with COAX, and
resolves a staged curriculum through range queries, one device wave a
stage, comparing latency and exactness against a full scan.  Asked for
``cuda`` without a card it raises before any work.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.data.curation import CuratedSelector, MetaQuery
from repro_torch.data.pipeline import make_corpus
from repro_torch.storage.snapshot import require_device

CURRICULUM = [
    MetaQuery(token_len=(64, 512), quality=(0.6, 1.1)),      # stage 0: short
    MetaQuery(token_len=(512, 4096), quality=(0.6, 1.1)),    # stage 1: medium
    MetaQuery(token_len=(4096, 32768), quality=(0.7, 1.1)),  # stage 2: long
]


def main(device: str = "cuda", *, docs: int = 200_000) -> dict:
    """Index the corpus, select each stage; returns the facts it printed."""
    require_device("device", device)
    corpus = make_corpus(docs, seed=0)
    sel = CuratedSelector(corpus, device=device)
    d = sel.describe()
    print(f"corpus: {d['n_rows']:,} docs, meta cols {d['meta_cols']}")
    print(f"COAX detected groups: "
          f"{[(g['predictor'], g['dependents']) for g in d['groups']]}")
    print(f"indexed dims {d['indexed_dims']}; directory "
          f"{d['memory_footprint_bytes']/1024:.0f} KiB; "
          f"build {d['build_time_s']*1e3:.0f} ms")

    stages = []
    for i, q in enumerate(CURRICULUM):
        t0 = time.perf_counter()
        got = sel.select(q)
        t_coax = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = sel.select_reference(q)
        t_scan = time.perf_counter() - t0
        assert np.array_equal(got, want)
        print(f"stage {i}: {got.size:,} docs | COAX {t_coax*1e3:.2f} ms vs "
              f"scan {t_scan*1e3:.2f} ms ({t_scan/t_coax:.1f}x) — exact")
        stages.append(got)
    return {"groups": [(g["predictor"], g["dependents"]) for g in d["groups"]],
            "indexed_dims": d["indexed_dims"], "stages": stages}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
