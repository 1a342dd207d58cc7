#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of COAX (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, one line of output each:
  card      nvidia-smi's name and power limit, torch's device name and count;
  build     nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
            (registers, shared memory and spills from ``-Xptxas -v``);
  kernel    each kernel against its plain torch version on the card, on all
            four fused_scan specialisations, small shapes and a hit_cap
            overflow case — exact equality;
  main      the serving path at real size: 20M airline rows, 512 knn range
            queries through QueryServer in 64-query waves, inserts and
            deletes between waves, a compaction, one more wave, then one
            pipelined drain of all 512 — every wave's answer equal to the
            port's numpy host path at the same write state; fused_scan
            launch counts read around exactly this run;
  segments  the kernel against its plain version at the main path's own
            segment inputs (primary Bp=64 over its ~19M rows; outlier;
            delta) — the plain version in chunks of 4 queries;
  times     per-launch kernel time (CUDA events), plain-version time, bound,
            server QPS and wave latency, device busy share.
Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result.  It also exits non-zero without a
result when no card is present or the package's sources are missing.

``--rehearse`` runs the same flow at a tiny size on the CPU, through the
kernels' plain versions, to check the control flow without a card; it
prints no result and exits 3.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

FULL = dict(rows=20_000_000, queries=512, wave=64, knn=64, sample_cap=50_000,
            inserts=2_000, deletes=500, waves=8, reps=20, chunk=4)
REHEARSE = dict(rows=200_000, queries=64, wave=16, knn=64, sample_cap=20_000,
                inserts=200, deletes=50, waves=4, reps=1, chunk=4)
PAPER_ROWS = 80_000_000       # the paper's airline table


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say("card", f"{line} | torch: {kind} x{count} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return line, kind, count


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    parts = []
    for name in libs:
        log = build.build_log(name)
        for fn, body in re.findall(
                r"Function properties for (\S+)\n(.*?)(?=ptxas info\s+: "
                r"Compile time|\Z)", log, re.S):
            m = re.search(r"(count_pass|scan_pass|write_pass)"
                          r"(?:ILb(\d)ELb(\d)E)?", fn)
            label = m.group(1) + (f"<{m.group(2)},{m.group(3)}>"
                                  if m.group(2) else "")
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            smem = re.search(r"(\d+) bytes smem", body)
            parts.append(f"{label}: {regs.group(1) if regs else '?'} regs, "
                         f"{spill.group(1) if spill else '?'} B spill, "
                         f"{smem.group(1) if smem else 0} B static smem")
    say("build", f"{', '.join(libs)} built in {secs:.1f} s (sm_90a); "
        + "; ".join(parts))


def compare(got, want, cap):
    """Exact comparison of two (counts, hits, scanned) triples; returns the
    largest absolute difference (0 when equal) and raises on any."""
    c_g, h_g, s_g = (x.cpu().numpy().astype(np.int64) for x in got)
    c_w, h_w, s_w = (x.cpu().numpy().astype(np.int64) for x in want)
    err = max(int(np.abs(c_g - c_w).max(initial=0)),
              int(np.abs(s_g - s_w).max(initial=0)),
              int(np.abs(h_g - h_w).max(initial=0)))
    take = np.minimum(c_w[:, 0], cap)
    for q in range(take.size):
        if not np.array_equal(h_g[q, :take[q]], h_w[q, :take[q]]):
            raise AssertionError(f"hit prefix of query {q} differs")
    if err:
        raise AssertionError(f"kernel differs from plain version by {err}")
    return err


def kernel_phase(torch, dev):
    from repro_torch.kernels import fused_range_scan, ref
    from repro_torch.kernels.ops import _pad_to
    rng = np.random.default_rng(0)
    cases = 0
    for n, b, d, tile, cap in [(5_000, 70, 8, 512, 1024),
                               (3_000, 16, 8, 128, 8)]:
        rows_t = rng.normal(0, 10, (d, n)).astype(np.float32)
        lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
        hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
        alive = (rng.random(n) > 0.1).astype(np.int32)
        coords = np.sort(rng.integers(0, 6, (3, n)), axis=1).astype(np.int32)
        first = rng.integers(0, 4, (b, 3)).astype(np.int32)
        last = first + rng.integers(0, 3, (b, 3)).astype(np.int32)
        sv = rows_t[0]
        tband = np.stack([lo[:, 0], hi[:, 0]], 1)
        probe = dict(coords=coords, first=first, last=last)
        sort = dict(sv=sv, tband=tband)
        for stages in ({}, probe, sort, {**probe, **sort}):
            got = fused_range_scan(rows_t, lo, hi, alive, **stages,
                                   tile=tile, hit_cap=cap, device=dev)
            # the plain version on the same card, same padded inputs
            t = {k: torch.as_tensor(v, device=dev) for k, v in stages.items()}
            kw = {}
            if "coords" in t:
                kw.update(coords=_pad_to(t["coords"], tile, -1).contiguous(),
                          first=t["first"], last=t["last"])
            if "sv" in t:
                kw.update(sv=_pad_to(t["sv"], tile, float("inf"))[None],
                          tband=t["tband"])
            rows_p = _pad_to(torch.as_tensor(rows_t, device=dev), tile,
                             float("inf"))
            alive_p = _pad_to(torch.as_tensor(alive, device=dev), tile, 0)[None]
            want = ref.fused_scan_ref(
                rows_p, torch.as_tensor(lo, device=dev).T.contiguous(),
                torch.as_tensor(hi, device=dev).T.contiguous(), alive_p,
                tile=tile, hit_cap=cap, **kw)
            compare((got[0][:, None], got[1], got[2][:, None]), want, cap)
            cases += 1
    say("kernel", f"fused_scan == plain version on {cases} cases (4 "
        "specialisations x 2 shapes, one with hit_cap=8 overflowing): "
        "max_abs_err 0")


def check_wave(idx, rects, answers, split_hits):
    """The wave's device answers against the numpy host path at the same
    write state (bit-identical row-id sets per query)."""
    idx.backend = "numpy"
    q, r = idx.query_batch(rects)
    idx.backend = "device"
    want = split_hits(q, r, rects.shape[0])
    for i, (a, w) in enumerate(zip(answers, want)):
        if a.dtype != np.int64 or not np.array_equal(a, w):
            raise AssertionError(f"query {i}: device answer != host answer")
    return int(r.size)


def main_phase(torch, dev, cfg):
    from repro_torch.core import COAXIndex
    from repro_torch.data import knn_rect_queries, make_airline
    from repro_torch.engine import QueryServer, split_hits
    from repro_torch.kernels import fused_scan

    t0 = time.perf_counter()
    ds = make_airline(cfg["rows"], seed=0)
    idx = COAXIndex(ds.data, device=dev)      # the documented defaults
    build_s = time.perf_counter() - t0
    rects = knn_rect_queries(ds.data, cfg["queries"], cfg["knn"], seed=1,
                             sample_cap=cfg["sample_cap"])
    srv = QueryServer(idx, max_batch=cfg["wave"], device=dev)
    rng = np.random.default_rng(2)
    wave = cfg["wave"]
    hits = 0
    max_hits = 0

    fused_scan.launches = 0                 # ---- the main path's run ----
    for w in range(cfg["waves"]):
        if w:
            srv.insert(make_airline(cfg["inserts"], seed=100 + w).data)
            srv.delete(rng.choice(cfg["rows"], cfg["deletes"], replace=False))
        batch = rects[(w * wave) % len(rects):][:wave]
        qids = srv.submit_many(batch)
        got = srv.drain()
        hits += check_wave(idx, batch, [got[q] for q in qids], split_hits)
        max_hits = max(max_hits, max(got[q].size for q in qids))
    delta_rows, tombstones = idx.delta_rows, idx.tombstone_count
    t_c = time.perf_counter()
    idx.compact()
    compact_s = time.perf_counter() - t_c
    batch = rects[:wave]
    qids = srv.submit_many(batch)
    got = srv.drain()
    hits += check_wave(idx, batch, [got[q] for q in qids], split_hits)
    before = srv.executor.stats()
    srv.executor.reset_stats()
    qids = srv.submit_many(rects)
    torch.cuda.synchronize() if dev != "cpu" else None
    t_d = time.perf_counter()
    got = srv.drain()
    drain_s = time.perf_counter() - t_d
    launches = fused_scan.launches          # ---- read right after ----
    after = srv.executor.stats()
    hits += check_wave(idx, rects, [got[q] for q in qids], split_hits)

    max_hits = max(max_hits, max(got[q].size for q in qids))
    fallbacks = before["device_fallbacks"] + after["device_fallbacks"]
    overflows = before["hit_overflows"] + after["hit_overflows"]
    dstats = idx.device_stats()
    if dev != "cpu" and launches <= 0:
        raise AssertionError("the main path launched no fused_scan kernel")
    if dev != "cpu" and fallbacks:        # cell_cap binds the CPU route only
        raise AssertionError(f"{fallbacks} waves fell back to the host path")
    if dstats["dispatches"] != srv.waves_drained:
        raise AssertionError(f"{dstats['dispatches']} dispatches for "
                             f"{srv.waves_drained} device waves")
    plan = idx._coax_plan
    resident = sum(img.bytes_resident for img in (plan.p_img, plan.o_img)
                   if img is not None)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    say("main", f"airline {cfg['rows']:,} rows x {ds.data.shape[1]} dims "
        f"(cut from the paper's {PAPER_ROWS:,} for host build time), built "
        f"in {build_s:.1f} s; {srv.waves_drained} waves of {wave} "
        f"({len(rects)} knn queries), writes between waves (delta "
        f"{delta_rows} rows, {tombstones} tombstones), compaction "
        f"{compact_s:.1f} s -> epoch {idx.epoch}; every answer == host "
        f"path ({hits:,} hits); fused_scan launches {launches}, dispatches "
        f"{dstats['dispatches']}, fallbacks {fallbacks}, hit_overflows "
        f"{overflows} (hit_cap {plan.hit_cap:,}; most hits of one query "
        f"{max_hits:,}); resident images {resident / 2**20:.1f} MiB, peak "
        f"device memory {peak / 2**20:.1f} MiB; default device options")
    return dict(idx=idx, rects=rects, launches=launches, srv=srv,
                drain_s=drain_s, stats=after, plan=plan)


def segment_inputs(idx, plan, rects):
    """The main path's own per-segment kernel inputs for one wave of
    ``rects``, built by the plan as ``submit_wave`` builds them:
    (name, seg dict, config) for the primary, outlier and delta segments."""
    out, _, _, _ = plan.wave_segments(idx.translate_batch(rects), rects)
    names = []
    for seg in out["segs"]:
        if plan.p_img is not None and seg["rows"] is plan.p_img.rows_t:
            name = "primary"
        elif plan.o_img is not None and seg["rows"] is plan.o_img.rows_t:
            name = "outlier"
        else:
            name = "delta"
        # the CPU route may split a grid segment into thin and fat parts
        names.append(name if name not in names else f"{name}.fat")
    return list(zip(names, out["segs"], out["cfgs"]))


def _call(fn, seg, cfg, q0=None, q1=None):
    tile, cap, probe, has_sort, _ = cfg
    sl = slice(q0, q1)
    kw = {}
    if probe:
        kw.update(coords=seg["coords"], first=seg["first"][sl],
                  last=seg["last"][sl])
    if has_sort:
        kw.update(sv=seg["sv"], tband=seg["tband"][sl])
    return fn(seg["rows"], seg["flo"][:, sl].contiguous(),
              seg["fhi"][:, sl].contiguous(), seg["alive"], tile=tile,
              hit_cap=cap, **kw)


def plain_chunked(torch, seg, cfg, chunk):
    """The plain version over the whole wave, ``chunk`` queries at a time
    so its (chunk, N_pad) temporaries stay a few GB."""
    from repro_torch.kernels import ref
    bp = seg["flo"].shape[1]
    parts = [_call(ref.fused_scan_ref, seg, cfg, q, q + chunk)
             for q in range(0, bp, chunk)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def seg_bound(seg, cfg, scanned, hits):
    """Least time for one launch: bytes (each input read once, each output
    written once) over the memory rate vs operations (one compare to reject
    each (query, row) pair plus 2 compares per dim for each candidate row)
    over the float32 rate; the larger wins.  Rows are the segment's real
    ones (``seg["n"]``): the pad rows are work the function does not need.
    The hit buffer counts the columns the wave's counts fill."""
    tile, cap, probe, has_sort, _ = cfg
    d = seg["rows"].shape[0]
    n = int(seg["n"])
    bp = seg["flo"].shape[1]
    nbytes = 4 * (d * n + n + 2 * d * bp)            # rows, alive, flo/fhi
    if probe:
        k = seg["coords"].shape[0]
        nbytes += 4 * (k * n + 2 * bp * k)
    if has_sort:
        nbytes += 4 * (n + 2 * bp)
    nbytes += 4 * (2 * bp + hits)                    # counts, scanned, hits
    ops = bp * n + 2 * d * int(scanned)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def segments_phase(torch, run, cfg, dev):
    from repro_torch.data import make_airline
    from repro_torch.kernels import fused_scan
    idx, plan = run["idx"], run["plan"]
    # a live delta for the delta segment (the main path's counts are read)
    idx.insert(make_airline(cfg["inserts"], seed=999).data)
    rects = run["rects"][:cfg["wave"]]
    segs = segment_inputs(idx, plan, rects)
    out = {}
    for name, seg, c in segs:
        got = _call(fused_scan, seg, c)
        want = plain_chunked(torch, seg, c, cfg["chunk"])
        err = compare(got, want, c[1])
        out[name] = dict(seg=seg, cfg=c, err=err,
                         scanned=int(got[2].sum()),
                         hits=int(got[0].clamp(max=c[1]).sum()),
                         n=int(seg["n"]), n_pad=int(seg["rows"].shape[1]),
                         bp=int(seg["flo"].shape[1]))
    say("segments", "; ".join(
        f"{k}: Bp={v['bp']} rows={v['n']:,} N_pad={v['n_pad']:,} "
        f"tile={v['cfg'][0]} hit_cap={v['cfg'][1]:,} "
        f"scanned={v['scanned']:,} hits={v['hits']:,} == plain (max_abs_err "
        f"{v['err']})" for k, v in out.items()))
    return out


def device_busy_share(torch, srv, rects):
    """Share of one pipelined drain's wall time the card was busy, from
    torch.profiler's device times; None when the trace has none."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    qids = srv.submit_many(rects)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del qids
    busy = kern = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        busy += us
        if re.search(r"count_pass|scan_pass|write_pass", evt.key):
            kern += us
    if busy <= 0:
        return None
    return busy / 1e6 / wall, kern / 1e6 / wall, wall


def pass_breakdown(torch, seg, c, reps=5):
    """Device time per kernel pass (and the wrapper's fill of the hit
    buffer) over ``reps`` launches of one segment, from torch.profiler."""
    from repro_torch.kernels import fused_scan
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            _call(fused_scan, seg, c)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        m = re.search(r"count_pass|scan_pass|write_pass", evt.key)
        name = m.group(0) if m else "other"
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def host_breakdown(idx, rects, top=6):
    """Where one synchronous 64-query wave spends host time: cProfile's
    top functions by own time (native numpy time is charged to the
    calling numpy function; profiling inflates Python-heavy code)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    idx.query_batch(rects)
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    parts = [f"{fn[2]} {tt * 1e3:.0f} ms" for fn, (_, _, tt, _, _) in rows]
    return wall, parts


def times_phase(torch, run, segs, cfg, card_line):
    from repro_torch.kernels import fused_scan
    reps = cfg["reps"]
    entry = None
    lines = []
    for name, s in segs.items():
        seg, c = s["seg"], s["cfg"]
        ms = time_ms(torch, lambda: _call(fused_scan, seg, c), reps)
        plain = time_ms(torch, lambda: plain_chunked(torch, seg, c,
                                                     cfg["chunk"]),
                        max(1, reps // 10))
        bound, by, nbytes, ops = seg_bound(seg, c, s["scanned"], s["hits"])
        lines.append(f"{name} {ms:.4f} ms (plain {plain:.2f} ms, bound "
                     f"{bound:.4g} ms by {by}: {nbytes / 1e9:.4g} GB, "
                     f"{ops:.4g} ops)")
        if name == "primary":
            entry = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    passes = pass_breakdown(torch, segs["primary"]["seg"],
                            segs["primary"]["cfg"])
    wall, host = host_breakdown(run["idx"], run["rects"][:cfg["wave"]])
    say("breakdown", "primary launch by pass: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(passes.items()))
        + f"; one synchronous wave {wall * 1e3:.0f} ms on the host, top own "
        f"time: {', '.join(host)}")
    st = run["stats"]
    qps = len(run["rects"]) / run["drain_s"]
    busy = device_busy_share(torch, run["srv"], run["rects"])
    busy_txt = ("device busy %.3f of the drain (fused_scan passes %.3f), "
                "profiled drain %.3f s" % busy if busy else
                "device busy share not measured")
    say("times", f"fused_scan per launch: {'; '.join(lines)}; library_ms: "
        f"none (no single PyTorch call computes this function); server "
        f"{qps:.1f} QPS over {len(run['rects'])} queries in "
        f"{st['waves']} pipelined waves, wave latency p50 "
        f"{st['wave_p50_ms']:.2f} ms p99 {st['wave_p99_ms']:.2f} ms; "
        f"{busy_txt}; card {card_line}")
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run through the plain versions; prints "
                         "no result and exits 3")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no package sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if args.rehearse:
        run = main_phase(torch, "cpu", REHEARSE)
        segments_phase(torch, run, REHEARSE, "cpu")
        print("chip_smoke: rehearsal on the CPU finished; no card, no "
              "result", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    cfg = FULL
    card_line, kind, count = card_phase(torch)
    build_phase()
    kernel_phase(torch, "cuda")
    run = main_phase(torch, "cuda", cfg)
    segs = segments_phase(torch, run, cfg, "cuda")
    entry = times_phase(torch, run, segs, cfg, card_line)
    kernels = [{
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan.py:62",
        "launches": run["launches"],
        "max_abs_err": max(s["err"] for s in segs.values()),
        "ms": entry["ms"], "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
