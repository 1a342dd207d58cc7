"""The dry run's roofline table, from its JSON cells.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir build/dryrun_torch]

The port of ``repro.launch.report``: the same table and summary lines.
"fits HBM" holds a cell's peak against ``HBM``, the NVIDIA H100 80GB
HBM3's device memory as ``torch.cuda.get_device_properties(0)
.total_memory`` reports it (85,017,493,504 bytes, 79.18 GiB, on the card
at 700 W that ``chip_smoke.py``'s ``[dryrun]`` phase reads it from and
checks it against).  The numbers are derived from the dry run's counts
and the data sheet's rates (``launch.roofline``), not measured.
"""
from __future__ import annotations

import argparse
import json
from glob import glob
from pathlib import Path

HBM = 85_017_493_504


def load(dir_: Path, tag: str = "baseline"):
    cells = {}
    for f in sorted(glob(str(dir_ / f"*__{tag}.json"))):
        d = json.loads(Path(f).read_text())
        cells[(d["arch"], d["shape"], d["mesh"])] = d
    return cells


def fmt_row(d):
    if d["status"] != "ok":
        return (f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — | — | — "
                f"| — | {d['status']} |")
    r = d["roofline"]
    mem = d["memory"]["peak_bytes_per_device"] / 2**30
    mfu = d.get("roofline_mfu_bound") or 0
    fit = "yes" if d["memory"]["peak_bytes_per_device"] <= HBM else "**NO**"
    return (f"| {d['arch']} | {d['shape']} | {d['mesh']} | {mem:.1f} | "
            f"{r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} | "
            f"{r['collective_s']*1e3:.1f} | {r['dominant']} | "
            f"{mfu:.3f} | {fit} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(
        Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    args = ap.parse_args(argv)
    cells = load(Path(args.dir), args.tag)

    print("| arch | shape | mesh | GiB/dev | compute ms | memory ms | "
          "collective ms | dominant | MFU-bound | fits HBM |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for key in sorted(cells):
        d = cells[key]
        if args.mesh and d["mesh"] != args.mesh:
            continue
        print(fmt_row(d))

    ok = [d for d in cells.values() if d["status"] == "ok"]
    sk = [d for d in cells.values() if d["status"] == "skipped"]
    fit = [d for d in ok if d["memory"]["peak_bytes_per_device"] <= HBM]
    print(f"\ncells={len(cells)} ok={len(ok)} skipped={len(sk)} "
          f"fit_hbm={len(fit)}/{len(ok)}")
    if ok:
        worst = min(ok, key=lambda d: d.get("roofline_mfu_bound") or 0)
        coll = max(ok, key=lambda d: d["roofline"]["collective_s"]
                   / max(d["roofline"]["step_time_bound_s"], 1e-12))
        print(f"worst MFU-bound: {worst['arch']}/{worst['shape']}/{worst['mesh']} "
              f"= {worst.get('roofline_mfu_bound') or 0:.4f}")
        print(f"most collective-bound: {coll['arch']}/{coll['shape']}/{coll['mesh']}")


if __name__ == "__main__":
    main()
