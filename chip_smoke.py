#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of COAX (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, one line of output each:
  card      nvidia-smi's name and power limit, torch's device name and count;
  build     nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
            (registers, shared memory and spills from ``-Xptxas -v``);
  kernel    each kernel against its plain torch version on the card, exact
            equality: fused_scan on all four specialisations, small shapes,
            a hit_cap overflow case, Bp=130, a 2^20-row segment (its stage
            ring wraps many times), hit_cap 37 (cut mid-word), a run of dead
            tiles and a one-tile delta segment, each twice bit-identical
            with one launch counted per call; range_scan_batch and range_scan on
            ragged N, windows that cut tiles, subnormal and ±inf bounds;
            grid_histogram at 16/64/128 buckets; margin_split on rows where
            a fused and an unfused m*x + b round apart (disp bitwise); both
            of the last two at n = 2^24 + 1, where the float32 row-id test
            drops row 2^24;
  lm_serve  the LM serving path, once for each of h2o-danube-3-4b (24
            layers, 3.84B parameters) at full width and depth,
            zamba2-2.7b (30 of its 54 Mamba2 layers, both shared
            attention blocks) and minicpm3-4b (31 of its 62 MLA layers)
            at full width, cut for the run's time limit, and
            mixtral-8x7b at full width and 8 of its 32 layers (11.74B;
            the full depth does not fit one card), gemma2-27b at full
            width and 28 of its 46 layers (14 local/global pairs; the
            float32 masters of more do not fit beside the serving
            state), minitron-4b at full width and depth (4.31B) and
            phi3.5-moe-42b-a6.6b at full width and 8 of its 32 layers
            (10.53B), with bfloat16
            weights, behind a Server whose COAX router runs on the device
            backend; 512 requests (288 for all but h2o and mixtral)
            drawn as launch/serve.py draws them, drained in waves of 8; every admission equal to a
            numpy-backend twin router, one plan dispatch per admission on
            a built index, fused_scan launches counted around the drain;
            the first wave's logits against one forward (replayed at
            float32 activations, an MoE's at a capacity that drops no
            pair; as served, at bfloat16, where that holds the bfloat16
            bar), a reduced-depth
            full-width prefill against the CPU (zamba2 at 12 layers, both
            shared blocks; an MoE at float32, its top-2 choices
            compared); prefill and decode ms against their bounds,
            tokens/s, admission latency, a torch.profiler breakdown; each
            model is freed (checked) before the next;
  lm_steps  qwen2-vl-2b (1,024 stub patch embeddings + 128 tokens) and
            seamless-m4t-large-v2 (1,024 stub frames + a 1-token prompt)
            at full width and depth, batch 8, through runtime/steps.py's
            prefill and serve steps (the serve loop passes neither
            patches nor frames; no COAX path): prefill and greedy decode
            steps timed against their bounds, the decoded logits at
            float32 activations against one forward, a 2-layer (2 + 2)
            full-width prefill against the CPU;
  lm_train  curation through fused_scan, h2o-danube-3-4b trained at full
            width and depth, mixtral-8x7b (2 of its 32 layers),
            qwen2-vl-2b and seamless-m4t-large-v2 (full depth) trained
            at full width on the curated docs with seeded stub patches
            and frames, 2-layer full-width train steps card vs CPU
            (h2o, mamba2-130m and those three), and the training
            launcher at its
            defaults (mamba2-130m, full size, --curate) to step 20,
            resumed to 30, served from its checkpoint (the phase's
            function says more);
  mesh      the distribution layer on a 1x1 mesh (``mesh_phase``);
  dryrun    the dry run (launch/dryrun.py) beside the card: the mesh
            phase's h2o-danube-3-4b train step (8 x 256, full depth)
            counted on fake tensors (a subprocess started at the top of the
            run, one fake rank) and on the card by the same counter, the
            FLOPs equal; the predicted peak beside max_memory_allocated, the
            roofline bound beside the step's ms; the full train_4k cell
            on the 256-rank fake mesh, and two cells at probe depth that
            torch 2.11 refuses unless the mesh's products run locally
            (qwen2-vl-2b prefill_32k, context parallel; mamba2-130m
            long_500k), each a subprocess since the top of the run, each
            with status ok;
  examples  the six example twins (examples/*_torch.py) on the card, eight
            runs (serve_requests_torch.py also --durable and --failover;
            train_lm_torch.py at --steps 20), each a subprocess that must
            exit 0; wall seconds, first and last lines printed;
  main      the serving path at real size: 10M airline rows, 512 knn range
            queries through QueryServer in 64-query waves, inserts and
            deletes between waves, a compaction, one more wave, then one
            pipelined drain of all 512 — every wave's answer equal to the
            port's numpy host path at the same write state; fused_scan
            launch counts read around exactly this run;
  segments  the kernel against its plain version at the main path's own
            segment inputs (primary Bp=64 over its ~19M rows; outlier;
            delta) — the plain version in chunks of 4 queries;
  ops       the entry points of ``repro_torch.kernels`` at the main path's
            size, launch counts read around exactly one call of each:
            range_scan_batch_query over the primary image with the timed
            wave's 64 rects and their probe-box windows, range_scan_query
            on the first, bucket_histogram (64 buckets) and split_by_margin
            on the first FD group's predictor and dependent over all rows;
            each kernel equal to its plain version, timed (CUDA events
            over back-to-back calls, and the kernel's own device time from
            torch.profiler), with its bound;
  times     per-launch kernel time (CUDA events), plain-version time, bound,
            server QPS and wave latency, device busy share;
  background  the main phase's index rebuilt with COAXIndex.from_state
            (no refit) under background_compact=True and a size trigger
            that the main phase's trickle of writes fires within a few
            waves; pipelined QueryServer rounds of two waves, writes
            between rounds, served back to back until the background build
            installs (inside a drain, at a wave boundary) and 8 rounds
            after; then every wave checked against a host twin (the same
            state on the numpy host path, given the same writes); prints
            wave latency before, during and after the build, build start
            -> install seconds, where it installed, the replayed tail, the
            main phase's synchronous compaction time for contrast.
  (cache, sharded and durable as their functions' docstrings say)
  replicated  the main index handed over with from_state as the primary of
            a ReplicatedServer (journal under build/, two replicas on the
            device backend, a FaultPlan that drops, tears, duplicates and
            reorders frames to replica-0 and crashes replica-1 mid-apply);
            rounds of a write batch, catch-up and one replica wave, each
            equal to the primary's host path; a write that fires the size
            trigger kills the primary mid-rotation; promote(); one wave of
            the promoted primary and one of the reseeded replica, checked;
            device memory after the reseed within 5% of before promote().
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
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

# 10M rows, cut from the paper's 80M (and from 20M) so that every phase,
# the LM families' included, ends inside the 1,200 s budget on a slow host
FULL = dict(rows=10_000_000, queries=512, wave=64, knn=64, sample_cap=50_000,
            inserts=2_000, deletes=500, waves=8, reps=20, chunk=4)
REHEARSE = dict(rows=200_000, queries=64, wave=16, knn=64, sample_cap=20_000,
                inserts=200, deletes=50, waves=4, reps=1, chunk=4)
# the background phase: write batches (each inserts + deletes) and the size
# trigger, in batches; the build fires on the 8th batch and the rest of the
# batches (the replayed tail) stay below the trigger, so the replay fires
# no nested synchronous compaction.  During the build a batch goes in every
# BG_EVERY rounds of two waves; BG_AFTER rounds are served after the install
BG_BATCHES, BG_TRIGGER, BG_EVERY, BG_AFTER, BG_WAIT_S = 14, 8, 2, 8, 900
# the cache phase's byte budget and hot-rect pool; the sharded phase's shard
# count; the durable phase's waves (a checkpoint every 4, a rotation after 4)
CACHE_BYTES, CACHE_HOT, SHARDS, DURABLE_WAVES = 256 << 20, 16, 4, 8
# the replicated phase: rounds of (write batch, catch-up, replica wave), the
# round before which the crashed replica is revived, and the fault schedule
# (the shape of the reference suite's WIRE and REPLICA_CRASH schedules; the
# primary's first rotation, fired by the size trigger, kills it)
REP_ROUNDS, REP_REVIVE = 8, 3
REP_FAULTS = {"ship.replica-0": {1: "drop", 3: "tear", 5: "dup", 8: "reorder"},
              "replica-1.apply": {4: "crash"},
              "primary.rotate": {0: "crash"}}
# a replica is healthy while its last heartbeat is younger than this: a
# round at 10M rows (writes, catch-up, a wave and its host check) takes
# several seconds, longer than the server's 5 s default, and a reordered
# heartbeat can leave a replica a whole round without a fresh one
REP_HEARTBEAT_S = 60.0
PAPER_ROWS = 80_000_000       # the paper's airline table
PASSES = r"count_pass|scan_pass|expand_pass"     # fused_scan's kernels

# the kernels behind the ops entries, and the TPU kernel body each replaces
OPS_KERNELS = (
    ("range_scan_batch", "src/repro/kernels/range_scan_batch.py:34"),
    ("range_scan", "src/repro/kernels/range_scan.py:32"),
    ("grid_histogram", "src/repro/kernels/grid_histogram.py:28"),
    ("margin_split", "src/repro/kernels/margin_split.py:26"),
)


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
            m = re.search(r"(count_pass|scan_pass|expand_pass|"
                          r"range_scan_batch_kernel|range_scan_kernel|"
                          r"histogram_kernel|margin_split_kernel)"
                          r"(?:IL[bi](\d)EL[bi](\d)E)?", fn)
            if m is None:
                continue
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
                               (3_000, 16, 8, 128, 8),
                               (5_000, 130, 8, 512, 1024)]:
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
    edges = fused_scan_edges(torch, dev)
    say("kernel", f"fused_scan == plain version on {cases} cases (4 "
        "specialisations x 3 shapes: one with hit_cap=8 overflowing, one "
        f"with Bp=130) and {edges}: max_abs_err 0")
    return ops_kernel_checks(torch, dev)


def cell_major(rng, n, n_pad, b, dead=(), d=8, k=3, c=8):
    """A grid-shaped segment on the host as the device plane lays it out
    (rows cell-major, dead padding tail, ``dead`` row ranges tombstoned):
    the base operands and the four stage sets."""
    cell = np.sort(rng.integers(0, c ** k, n))
    coords = np.full((k, n_pad), -1, np.int32)
    for j in range(k):
        coords[j, :n] = (cell // c ** (k - 1 - j)) % c
    rows_t = np.full((d, n_pad), np.inf, np.float32)
    rows_t[:, :n] = rng.normal(0, 10, (d, n))
    alive = np.zeros((1, n_pad), np.int32)
    alive[0, :n] = rng.random(n) > 0.05
    for lo, hi in dead:
        alive[0, lo:hi] = 0
    sv = np.full((1, n_pad), np.inf, np.float32)
    sv[0, :n] = rows_t[0, :n]
    first = rng.integers(0, c, (b, k)).astype(np.int32)
    last = np.minimum(first + rng.integers(0, 3, (b, k)), c - 1).astype(
        np.int32)
    lo = rng.uniform(-20, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (b, d)).astype(np.float32)
    probe = dict(coords=coords, first=first, last=last)
    sort = dict(sv=sv, tband=np.stack([lo[:, 0], hi[:, 0]], 1))
    return ([rows_t, lo.T.copy(), hi.T.copy(), alive],
            [{}, probe, sort, {**probe, **sort}])


def fused_scan_edges(torch, dev):
    """fused_scan against its plain version where the kernel's design has
    edges: a ring of tile stages that wraps many times (2^20 rows), a
    hit_cap that cuts inside a tile and a bitmap word, a run of dead tiles,
    a one-tile delta-shaped segment; two launches bit-identical; one
    launch counted per call."""
    from repro_torch.kernels import fused_scan, ref
    rng = np.random.default_rng(3)
    cases = {
        "2^20 rows": (cell_major(rng, 2 ** 20 - 300, 2 ** 20, 64), 512, 1024),
        "hit_cap 37": (cell_major(rng, 60_000, 60_416, 64), 512, 37),
        "dead tiles 8..39": (cell_major(rng, 60_000, 60_416, 64,
                                        dead=[(4_096, 20_480)]), 512, 1024),
        "one delta tile": (cell_major(rng, 100, 128, 64), 128, 128),
    }
    for name, ((base, stage_sets), tile, cap) in cases.items():
        if name == "one delta tile":
            stage_sets = [{}]
        for stages in stage_sets:
            args = [torch.as_tensor(a, device=dev) for a in base]
            kw = {key: torch.as_tensor(a, device=dev)
                  for key, a in stages.items()}
            before = fused_scan.launches
            got = fused_scan(*args, **kw, tile=tile, hit_cap=cap)
            again = fused_scan(*args, **kw, tile=tile, hit_cap=cap)
            if dev != "cpu" and fused_scan.launches != before + 2:
                raise AssertionError(f"{name}: two calls counted "
                                     f"{fused_scan.launches - before}")
            for x, y in zip(got, again):
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: two launches differ")
            want = ref.fused_scan_ref(*args, **kw, tile=tile, hit_cap=cap)
            compare(got, want, cap)
            exact(got[1], want[1], f"{name} hits with their -1 tail")
    return ("on " + ", ".join(cases) + " (every specialisation; each twice, "
            "bit-identical, one launch counted per call)")


def exact(got, want, what, bits=False):
    """Hold a kernel's output against its plain version's: same type and
    shape, and equal (float32 bit for bit where ``bits``).  Returns the
    largest absolute difference, 0, and raises on any difference."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {want.dtype}{tuple(want.shape)}")
    same = (torch.equal(got.view(torch.int32), want.view(torch.int32))
            if bits else torch.equal(got, want))
    if not same:
        diff = (got.double() - want.double()).abs().nan_to_num(float("inf"))
        raise AssertionError(f"{what} differs from its plain version "
                             f"(max abs err {float(diff.max())})")
    return 0.0


def scan_case(rng, n, b, d, tile):
    """Rows, (B, D) rects and (B, 2) windows; query 0's window cuts its
    first and last tile."""
    rows = rng.normal(0, 10, (d, n)).astype(np.float32)
    lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
    w_lo = rng.integers(0, n // 2, b)
    wins = np.stack([w_lo, w_lo + rng.integers(1, n, b)], 1).astype(np.int32)
    wins[0] = (tile // 3, n - tile // 5)
    return rows, lo, hi, wins


def check_scans(torch, dev, rows, lo, hi, wins, tile, singles=3):
    """range_scan_batch on every query and range_scan on the first
    ``singles``, each against its plain version on the same padded
    inputs."""
    from repro_torch.kernels import range_scan, range_scan_batch, ref
    from repro_torch.kernels.ops import _pad_to
    rows_p = _pad_to(torch.as_tensor(rows, device=dev), tile,
                     float("inf")).contiguous()
    lo_t = torch.as_tensor(lo.T.copy(), device=dev)
    hi_t = torch.as_tensor(hi.T.copy(), device=dev)
    w = torch.as_tensor(wins, device=dev)
    got = range_scan_batch(rows_p, lo_t, hi_t, w, tile=tile)
    want = ref.range_scan_batch_ref(rows_p, lo_t, hi_t, w, tile=tile)
    err = max(exact(got[0], want[0], "range_scan_batch mask"),
              exact(got[1], want[1], "range_scan_batch counts"))
    for q in range(min(singles, lo.shape[0])):
        args = (rows_p, lo_t[:, q].contiguous(), hi_t[:, q].contiguous(),
                w[q].contiguous())
        got = range_scan(*args, tile=tile)
        want = ref.range_scan_ref(*args, tile=tile)
        err = max(err, exact(got[0], want[0], "range_scan mask"),
                  exact(got[1], want[1], "range_scan counts"))
    return err


def check_histogram(torch, dev, x, d, buckets):
    from repro_torch.kernels import grid_histogram, ref
    from repro_torch.kernels.ops import histogram_operands
    ops = histogram_operands(x, d, buckets=buckets, device=dev)
    got = grid_histogram(*ops, buckets=buckets)
    err = exact(got, ref.grid_histogram_ref(*ops, buckets=buckets),
                f"grid_histogram ({buckets} buckets, n={x.size})")
    return err, int(got.double().sum())


def check_split(torch, dev, x, d, m, b, eps_lb, eps_ub):
    from repro_torch.kernels import margin_split, ref
    from repro_torch.kernels.ops import split_operands
    ops = split_operands(x, d, m, b, eps_lb, eps_ub, device=dev)
    got = margin_split(*ops)
    want = ref.margin_split_ref(*ops)
    err = max(exact(got[0], want[0], "margin_split disp", bits=True),
              exact(got[1], want[1], "margin_split mask"),
              exact(got[2], want[2], "margin_split counts"))
    return err, got


def ops_kernel_checks(torch, dev):
    """The kernels behind the ``ops`` entries against their plain versions
    at small shapes and on their edge cases.  Returns name -> max abs err."""
    rng = np.random.default_rng(1)
    errs = dict(range_scan_batch=0.0, range_scan=0.0, grid_histogram=0.0,
                margin_split=0.0)
    # ragged N, > 64 queries (two shared-memory chunks), a tile that is not
    # a multiple of 32, windows cutting tiles
    for n, b, d, tile in [(5_003, 70, 8, 512), (3_000, 16, 3, 128),
                          (1_000, 5, 2, 100)]:
        e = check_scans(torch, dev, *scan_case(rng, n, b, d, tile), tile)
        errs["range_scan_batch"] = errs["range_scan"] = max(
            errs["range_scan"], e)
    # subnormal rows and bounds, ±inf and ±3.4e38 bounds
    tiny = np.float32(1e-45)
    vals = np.array([0.0, -0.0, tiny, -tiny, 2 * tiny, 1e-38, -1e-38,
                     3.4e38, -3.4e38, np.inf, -np.inf, 1.0], np.float32)
    rows = np.tile(vals, (2, 43))[:, :512].copy()
    lo = np.array([[0.0, -np.inf], [tiny, tiny], [-tiny, -3.4e38],
                   [-np.inf, -np.inf], [3.4e38, 0.0]], np.float32)
    hi = np.array([[tiny, np.inf], [np.inf, 2 * tiny], [0.0, 3.4e38],
                   [np.inf, np.inf], [np.inf, np.inf]], np.float32)
    wins = np.array([[0, 512]] * 5, np.int32)
    e = check_scans(torch, dev, rows, lo, hi, wins, 256, singles=5)
    errs["range_scan_batch"] = errs["range_scan"] = max(errs["range_scan"], e)

    for buckets in (16, 64, 128):
        for n in (999, 100_003):
            x = rng.normal(0, 3, n).astype(np.float32)
            d = (0.5 * x + rng.gamma(2.0, 0.2, n)).astype(np.float32)
            e, _ = check_histogram(torch, dev, x, d, buckets)
            errs["grid_histogram"] = max(errs["grid_histogram"], e)
    # tile 1, unpadded: the rows after the last 4-row vector, and n_valid
    # cutting into them
    from repro_torch.kernels import grid_histogram, ref
    from repro_torch.kernels.ops import histogram_operands
    for n in (1, 3, 1_002, 100_001):
        x = rng.normal(0, 3, n).astype(np.float32)
        xt = torch.as_tensor(x, device=dev)
        params = histogram_operands(x, x, buckets=16, device=dev)[2].clone()
        for n_valid in (n, n - 1):
            params[4] = float(n_valid)
            errs["grid_histogram"] = max(errs["grid_histogram"], exact(
                grid_histogram(xt, xt, params, buckets=16, tile=1),
                ref.grid_histogram_ref(xt, xt, params, buckets=16),
                f"grid_histogram (tile 1, n={n}, n_valid={n_valid})",
                bits=True))

    # d on the unfused m*x + b, eps 0: every row with disp == 0 is an
    # inlier, and a fused multiply-add would flip the rows rounded apart
    m, b, n_split = np.float32(1.7), np.float32(-3.3), 100_003
    x = rng.uniform(-100, 100, n_split).astype(np.float32)
    unfused = m * x + b
    fused = (np.float64(m) * x.astype(np.float64)
             + np.float64(b)).astype(np.float32)
    apart = int((unfused != fused).sum())
    e, got = check_split(torch, dev, x, unfused, m, b, 0.0, 0.0)
    if apart == 0 or int(got[2].sum()) != n_split:
        raise AssertionError(f"margin_split: {apart} rows rounded apart, "
                             f"{int(got[2].sum())} of {n_split} inliers")
    x2 = rng.uniform(-1e3, 1e3, 70_001).astype(np.float32)
    d2 = (2.5 * x2 + 1 + rng.normal(0, 5, 70_001)).astype(np.float32)
    e2, _ = check_split(torch, dev, x2, d2, 2.5, 1.0, 4.0, 6.0)
    errs["margin_split"] = max(e, e2)

    # the float32 row-id test: row 2^24 of 2^24 + 1 is dropped
    big = 2 ** 24 + 1
    x = rng.uniform(0, 1_000, big).astype(np.float32)
    d = (2 * x + 5 + rng.normal(0, 3, big)).astype(np.float32)
    e, h_rows = check_histogram(torch, dev, x, d, 64)
    errs["grid_histogram"] = max(errs["grid_histogram"], e)
    e, got = check_split(torch, dev, x, d, 2.0, 5.0, 6.0, 6.0)
    errs["margin_split"] = max(errs["margin_split"], e)
    last_in = -6.0 <= float(got[0][big - 1]) <= 6.0
    if h_rows != big - 1 or int(got[1][big - 1]) != 0:
        raise AssertionError(f"n={big}: histogram counted {h_rows} rows, "
                             f"split mask of row {big - 1} is "
                             f"{int(got[1][big - 1])}")
    say("kernel", f"range_scan_batch, range_scan == plain versions on 4 "
        f"cases (ragged N, 70 queries, tile 100, windows cutting tiles, "
        f"subnormal and ±inf bounds); grid_histogram == plain at 16/64/128 "
        f"buckets x n 999/100,003 and unpadded at tile 1 for n 1/3/1,002/"
        f"100,001 (n % 4 rows binned by scalar loads); margin_split disp bitwise == plain on "
        f"{apart:,} rows where fused and unfused m*x+b round apart (all "
        f"{n_split:,} rows inliers at eps 0); at n = "
        f"{big:,} both drop row {big - 1:,} (histogram counted {h_rows:,}; "
        f"that row inside the margin by disp: {last_in}, mask 0): "
        f"max_abs_err {max(errs.values())}")
    return errs


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
    resident = plan_bytes(plan)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    say("main", f"airline {cfg['rows']:,} rows x {ds.data.shape[1]} dims "
        f"(cut from the paper's {PAPER_ROWS:,} for the time limit), built "
        f"in {build_s:.1f} s; {srv.waves_drained} waves of {wave} "
        f"({len(rects)} knn queries), writes between waves (delta "
        f"{delta_rows} rows, {tombstones} tombstones; wave latency p50 "
        f"{before['wave_p50_ms']:.2f} ms p99 {before['wave_p99_ms']:.2f} ms), "
        f"compaction {compact_s:.1f} s -> epoch {idx.epoch}; every answer == "
        f"host path ({hits:,} hits); fused_scan launches {launches}, dispatches "
        f"{dstats['dispatches']}, fallbacks {fallbacks}, hit_overflows "
        f"{overflows} (hit_cap {plan.hit_cap:,}; most hits of one query "
        f"{max_hits:,}); resident images {resident / 2**20:.1f} MiB, peak "
        f"device memory {peak / 2**20:.1f} MiB; default device options")
    return dict(idx=idx, rects=rects, launches=launches, srv=srv,
                drain_s=drain_s, stats=after, plan=plan, data=ds.data,
                rows=cfg["rows"], compact_s=compact_s)


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


def probe_windows(torch, seg, b):
    """Each query's ``[lo, hi)`` row window: the smallest span that holds
    every row whose cell coordinates lie in its probe box; ``[0, 0)`` for
    an empty box."""
    coords = seg["coords"]
    wins = np.zeros((b, 2), np.int32)
    for q in range(b):
        inbox = ((coords >= seg["first"][q][:, None])
                 & (coords <= seg["last"][q][:, None])).all(0)
        idx = torch.nonzero(inbox)
        if idx.numel():
            wins[q] = (int(idx[0]), int(idx[-1]) + 1)
    return wins


def rows_covered(wins):
    """Rows inside at least one ``[lo, hi)`` window."""
    total = end = 0
    for lo, hi in sorted(map(tuple, wins.tolist())):
        lo = max(lo, end)
        if hi > lo:
            total += hi - lo
            end = hi
    return total


def bound(nbytes, ops):
    """Least time in ms: bytes over the memory rate vs operations over the
    float32 rate; the larger wins."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# each ops kernel's name in a profiler trace
KERNEL_EVENTS = dict(range_scan_batch=r"range_scan_batch_kernel",
                     range_scan=r"range_scan_kernel",
                     grid_histogram=r"histogram_kernel",
                     margin_split=r"margin_split_kernel")


def device_ms(torch, fn, pattern, reps):
    """The kernel's own device time per call (torch.profiler, events whose
    name matches ``pattern``) over ``reps`` calls after a warm-up; None
    when the trace has no such event."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if re.search(pattern, evt.key):
            t = getattr(evt, "self_device_time_total", None)
            us += getattr(evt, "self_cuda_time_total", 0.0) if t is None else t
    return us / 1e3 / reps if us > 0 else None


def ops_phase(torch, run, segs, cfg, dev):
    """The ``repro_torch.kernels`` entry points at the main path's size:
    one call of each with the launch counts set to 0 just before and read
    just after, then each kernel against its plain version, timed."""
    from repro_torch.kernels import (bucket_histogram, grid_histogram,
                                     margin_split, range_scan,
                                     range_scan_batch, range_scan_batch_query,
                                     range_scan_query, ref, split_by_margin)
    from repro_torch.kernels.ops import histogram_operands, split_operands
    idx, b, chunk, reps = run["idx"], cfg["wave"], cfg["chunk"], cfg["reps"]
    seg = segs["primary"]["seg"]
    rows = seg["rows"]                          # (D, N_pad), +inf pad rows
    lo_t = seg["flo"][:, :b].contiguous()       # translated, ceil-rounded
    hi_t = seg["fhi"][:, :b].contiguous()
    lo, hi = lo_t.T.contiguous(), hi_t.T.contiguous()
    wins_np = probe_windows(torch, seg, b)
    wins = torch.as_tensor(wins_np, device=dev)
    grp = idx.groups[0]
    dep = grp.dependents[0]
    fd = grp.models[dep]
    buckets = idx.config.softfd.bucket_chunks
    xcol = np.ascontiguousarray(run["data"][:, grp.predictor])
    dcol = np.ascontiguousarray(run["data"][:, dep])
    n = xcol.size
    d, n_pad = rows.shape
    kernels = (range_scan_batch, range_scan, grid_histogram, margin_split)

    for k in kernels:                       # ---- the ops path's run ----
        k.launches = 0
    counts_b, mask_b = range_scan_batch_query(rows, lo, hi, wins, device=dev)
    count_1, mask_1 = range_scan_query(rows, lo[0], hi[0], wins[0],
                                       device=dev)
    hist = bucket_histogram(xcol, dcol, buckets=buckets, device=dev)
    disp, inlier = split_by_margin(xcol, dcol, fd.m, fd.b, fd.eps_lb,
                                   fd.eps_ub, device=dev)
    launches = {k.__name__: k.launches for k in kernels}   # read right after
    if dev != "cpu" and min(launches.values()) < 1:
        raise AssertionError(f"an ops entry launched no kernel: {launches}")

    def plain_batch(check=False):
        err = 0.0
        for q0 in range(0, b, chunk):
            sl = slice(q0, q0 + chunk)
            m, c = ref.range_scan_batch_ref(rows, lo_t[:, sl].contiguous(),
                                            hi_t[:, sl].contiguous(),
                                            wins[sl].contiguous())
            if check:
                err = max(err, exact(mask_b[sl], m, "range_scan_batch mask"),
                          exact(counts_b[sl], c.sum(1, dtype=torch.int32),
                                "range_scan_batch counts"))
        return err

    out = {k.__name__: dict(launches=launches[k.__name__]) for k in kernels}
    out["range_scan_batch"]["err"] = plain_batch(check=True)
    args_1 = (rows, lo_t[:, 0].contiguous(), hi_t[:, 0].contiguous(),
              wins[0].contiguous())
    m1, c1 = ref.range_scan_ref(*args_1)
    out["range_scan"]["err"] = max(
        exact(mask_1, m1, "range_scan mask"),
        exact(count_1, c1.sum(dtype=torch.int32), "range_scan count"))
    h_ops = histogram_operands(xcol, dcol, buckets=buckets, device=dev)
    out["grid_histogram"]["err"] = exact(
        hist, ref.grid_histogram_ref(*h_ops, buckets=buckets),
        "grid_histogram")
    s_ops = split_operands(xcol, dcol, fd.m, fd.b, fd.eps_lb, fd.eps_ub,
                           device=dev)
    w_disp, w_mask, _ = ref.margin_split_ref(*s_ops)
    out["margin_split"]["err"] = max(
        exact(disp, w_disp[:n], "margin_split disp", bits=True),
        exact(inlier, w_mask[:n].bool(), "margin_split mask"))

    # bounds: each input read once, each output written once; rows outside
    # every window cannot match and need not be read
    tiles = n_pad // 512
    win_rows = (wins_np[:, 1] - wins_np[:, 0]).clip(0)
    out["range_scan_batch"]["bound"] = bound(
        4 * (d * rows_covered(wins_np) + 2 * d * b + 2 * b + b * n_pad
             + b * tiles), 2 * b * n_pad + 2 * d * int(win_rows.sum()))
    out["range_scan"]["bound"] = bound(
        4 * (d * int(win_rows[0]) + 2 * d + 2 + n_pad + tiles),
        2 * n_pad + 2 * d * int(win_rows[0]))
    hp = h_ops[0].shape[0]
    out["grid_histogram"]["bound"] = bound(4 * (2 * hp + 8 + buckets ** 2),
                                           9 * hp)
    sp = s_ops[0].shape[0]
    out["margin_split"]["bound"] = bound(4 * (4 * sp + 8 + sp // 1024),
                                         6 * sp)

    lib_note = "not measured on the CPU"
    if dev != "cpu":
        timed = {
            "range_scan_batch": (
                lambda: range_scan_batch(rows, lo_t, hi_t, wins),
                plain_batch),
            "range_scan": (lambda: range_scan(*args_1),
                           lambda: ref.range_scan_ref(*args_1)),
            "grid_histogram": (
                lambda: grid_histogram(*h_ops, buckets=buckets),
                lambda: ref.grid_histogram_ref(*h_ops, buckets=buckets)),
            "margin_split": (lambda: margin_split(*s_ops),
                             lambda: ref.margin_split_ref(*s_ops)),
        }
        for name, (kern, plain) in timed.items():
            out[name]["ms"] = time_ms(torch, kern, reps)
            out[name]["device_ms"] = device_ms(torch, kern,
                                               KERNEL_EVENTS[name], reps)
            out[name]["plain_ms"] = time_ms(torch, plain, max(1, reps // 10))
        # the counting step alone, on the precomputed flat bucket index
        x_lo, inv_wx, d_lo, inv_wd, n_valid = h_ops[2][:5]
        ix = torch.clamp((h_ops[0] - x_lo) * inv_wx, 0, buckets - 1).long()
        jd = torch.clamp((h_ops[1] - d_lo) * inv_wd, 0, buckets - 1).long()
        flat = (ix * buckets + jd)[:n]
        bc_ms = time_ms(torch, lambda: torch.bincount(
            flat, minlength=buckets * buckets), reps)
        lib_note = (f"torch.bincount on the precomputed flat index (the "
                    f"counting step alone) {bc_ms:.4f} ms")
    hist_rows = int(hist.double().sum())
    say("ops", f"range_scan_batch_query: primary image D={d} x {n_pad:,} "
        f"rows, {b} wave rects, probe-box windows {int(win_rows.min()):,}.."
        f"{int(win_rows.max()):,} rows ({rows_covered(wins_np):,} covered), "
        f"{int(counts_b.sum()):,} matches; range_scan_query on rect 0: "
        f"{int(count_1):,} matches; bucket_histogram of FD group 0 (column "
        f"{grp.predictor} -> {dep}) at {buckets} buckets counted "
        f"{hist_rows:,} of {n:,} rows, largest bucket {int(hist.max()):,}; "
        f"split_by_margin (m={fd.m:.6g} b={fd.b:.6g} eps_lb={fd.eps_lb:.6g} "
        f"eps_ub={fd.eps_ub:.6g}): {int(inlier.sum()):,} of {n:,} rows "
        f"inliers, row {n - 1:,} inside the margin by disp: "
        f"{bool(-fd.eps_lb <= float(disp[-1]) <= fd.eps_ub)}, mask "
        f"{int(inlier[-1])}; launches {launches}; every kernel == plain "
        f"(max_abs_err {max(v['err'] for v in out.values())})")
    if dev != "cpu":
        say("ops", "; ".join(
            f"{k} {v['ms']:.4f} ms (device {fmt_ms(v['device_ms'])}, plain "
            f"{v['plain_ms']:.3f} ms, bound {v['bound'][0]:.4g} ms by "
            f"{v['bound'][1]})" for k, v in out.items())
            + f"; library_ms: none for each (no single PyTorch call computes "
            f"these functions); {lib_note}")
    return out


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
        if re.search(PASSES, evt.key):
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
        m = re.search(PASSES, evt.key)
        name = m.group(0) if m else "other"
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def ring_sweep(torch, seg, c, reps, rows=(512, 256), depths=(1, 2, 3)):
    """The primary launch's time for each count-pass row tile and ring
    depth, forced through the plan's limits (restored after), each
    configuration's output equal to the default plan's: (rows, stages,
    blocks per SM its shared memory allows, ms)."""
    import importlib
    fs_mod = importlib.import_module("repro_torch.kernels.fused_scan")
    names = ("MAX_TILE_ROWS", "MAX_STAGES", "BLOCKS_PER_SM")
    default = [getattr(fs_mod, name) for name in names]
    d, n = seg["rows"].shape
    k = seg["coords"].shape[0] if c[2] else 0
    bp = seg["flo"].shape[1]
    want = _call(fs_mod.fused_scan, seg, c)
    out = []
    try:
        for r in rows:
            for depth in depths:
                for name, v in zip(names, (r, depth, 1)):
                    setattr(fs_mod, name, v)
                plan = fs_mod.launch_plan(d, k, c[3], c[0], n, bp)
                got = _call(fs_mod.fused_scan, seg, c)
                for g, w in zip(got, want):
                    exact(g, w, f"{plan.tile_rows} rows x {plan.stages} "
                          "stages against the default plan")
                per_sm = fs_mod.SM_SMEM // (plan.smem + fs_mod.BLOCK_RESERVED)
                ms = time_ms(torch, lambda: _call(fs_mod.fused_scan, seg, c),
                             reps)
                out.append((plan.tile_rows, plan.stages, per_sm, ms))
    finally:
        for name, v in zip(names, default):
            setattr(fs_mod, name, v)
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
    ring = ring_sweep(torch, segs["primary"]["seg"], segs["primary"]["cfg"],
                      reps)
    parts = []
    for name, s in segs.items():
        passes = pass_breakdown(torch, s["seg"], s["cfg"])
        parts.append(f"{name} launch by pass: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(passes.items())))
    wall, host = host_breakdown(run["idx"], run["rects"][:cfg["wave"]])
    say("breakdown", "; ".join(parts) + f"; one synchronous wave "
        f"{wall * 1e3:.0f} ms on the host, top own time: {', '.join(host)}")
    say("ring", "primary launch by the count pass's row tile and ring "
        "depth (blocks per SM its shared memory allows): " + "; ".join(
            f"{r} rows x {st} stages, {per_sm}/SM: {ms:.4f} ms"
            for r, st, per_sm, ms in ring))
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


def pct(lat_s, q):
    return float(np.percentile(np.asarray(lat_s) * 1e3, q)) if lat_s else 0.0


def background_phase(torch, run, cfg, dev, card_line):
    """The main phase's index, handed over with ``from_state`` (no refit)
    under ``background_compact=True``, served through a pipelined
    QueryServer while its next epoch builds on the compactor thread.

    Nothing but the server touches the index while it serves, so the
    epoch can only install inside ``srv.drain``, at a wave boundary.  Every
    wave's answer is checked afterwards against a host twin: a second
    index from the same state on the numpy host path, given the same
    write batches up to that wave's write state.

    One round before the build fires (before the 8th write batch is
    queued) the served index is pinned (``srv.pin_epoch``), and the pin's
    answers to the previous round's rects, taken then, must equal what
    that round served; after the install the pin, on the old epoch, must
    still give them bit for bit.  Both pinned reads are waves of the
    pinned device plan: each must launch ``fused_scan``, counted around
    that read alone (the served rounds' count leaves them out).  Peak
    device memory is read with the pin held across the install (both
    epochs' images resident)."""
    import copy
    import gc
    from repro_torch import obs
    from repro_torch.core import COAXIndex
    from repro_torch.data import make_airline
    from repro_torch.engine import QueryServer, split_hits
    from repro_torch.kernels import fused_scan
    batch = cfg["inserts"] + cfg["deletes"]
    state = run["idx"].state()
    twin_state = copy.deepcopy(state)         # arrays of the twin's own
    state["config"] = dict(state["config"], background_compact=True,
                           compact_min_delta=BG_TRIGGER * batch,
                           compact_delta_frac=1e-4)
    t0 = time.perf_counter()
    idx = COAXIndex.from_state(state, device=dev)
    load_s = time.perf_counter() - t0
    epoch0, delta0 = idx.epoch, idx.delta_rows
    rects, wave = run["rects"], cfg["wave"]
    srv = QueryServer(idx, max_batch=wave, device=dev)
    rng = np.random.default_rng(4)
    tracer = obs.enable_tracing(capacity=1 << 16)
    lat = {}                 # (when, writes queued) -> wave latencies s
    writes = []              # (insert write id, rows, deleted ids) a batch
    served = []              # (write batches applied, rect indices, answers)
    rounds = rounds_after = 0
    install_round = None
    pin = None               # (pin, round, rect indices, answers at pin
    pin_launches = 0         # time, its launches): the pinned read's own
    deadline = time.perf_counter() + BG_WAIT_S
    fused_scan.launches = 0                 # ---- this path's run ----
    try:
        while rounds_after < BG_AFTER:
            building = idx.describe()["background"]["in_flight"]
            if (pin is None and not building and served
                    and len(writes) == BG_TRIGGER - 1):
                pin = pin_served(torch, srv, rects, served[-1], rounds, dev)
                pin_launches = pin[4]
            wrote = len(writes) < BG_BATCHES and (not building
                                                  or rounds % BG_EVERY == 0)
            if wrote:                # applied at the drain's wave boundary
                rows = make_airline(cfg["inserts"], seed=300 + len(writes)).data
                ids = rng.choice(cfg["rows"], cfg["deletes"], replace=False)
                writes.append((srv.insert(rows), rows, ids))
                srv.delete(ids)
            done = idx.background_compactions
            sel = (2 * rounds * wave + np.arange(2 * wave)) % len(rects)
            qids = srv.submit_many(rects[sel])    # two pipelined waves
            got = srv.drain()
            installed = idx.background_compactions > done
            if installed:
                install_round = rounds
            # a build in flight at any point of the round: at its start, at
            # its end, or started and installed inside it
            key = ("during" if building or installed
                   or idx.describe()["background"]["in_flight"]
                   else "after" if done else "before")
            lat.setdefault((key, wrote), []).extend(
                w.latency_s for w in srv.executor.wave_stats[-2:])
            served.append((len(writes), sel, [got[q] for q in qids]))
            rounds += 1
            if key == "after":
                rounds_after += 1
            if time.perf_counter() > deadline:
                raise AssertionError(f"no handoff within {BG_WAIT_S} s")
        srv.close()
        launches = fused_scan.launches - pin_launches  # -- read right after
    finally:
        obs.disable_tracing()
    if pin is None:
        raise AssertionError("the served index was never pinned")
    handle, pin_round, pin_sel, pin_want, _ = pin
    fused_scan.launches = 0                 # ---- the pinned read's run ----
    again = handle.query_batch_split(rects[pin_sel])
    pin_after = fused_scan.launches         # ---- read right after ----
    for k, (a, w) in enumerate(zip(again, pin_want)):
        if not np.array_equal(a, w):
            raise AssertionError(f"pinned rect {k}: answer moved across "
                                 f"the install")
    if not handle.epoch < idx.epoch or idx.pinned_epochs != [handle.epoch]:
        raise AssertionError(f"pinned epoch {handle.epoch}, served "
                             f"{idx.epoch}, pins {idx.pinned_epochs}")
    if dev != "cpu" and (pin_launches <= 0 or pin_after <= 0):
        raise AssertionError(f"pinned reads launched fused_scan "
                             f"{pin_launches} / {pin_after} times")
    peak_pin = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    held = torch.cuda.memory_allocated() if dev != "cpu" else 0
    handle.release()
    gc.collect()
    freed = held - torch.cuda.memory_allocated() if dev != "cpu" else 0
    if idx.pinned_epochs:
        raise AssertionError(f"pins left after release: {idx.pinned_epochs}")
    spans = {e["name"]: e for e in tracer.events()
             if e["name"].startswith("compact.")}
    if (idx.background_compactions != 1 or idx.epoch != epoch0 + 1
            or install_round is None):
        raise AssertionError(f"handoffs {idx.background_compactions}, "
                             f"epoch {epoch0} -> {idx.epoch}, installed in "
                             f"a drain: {install_round is not None}")
    during = sum(len(v) for (k, _), v in lat.items() if k == "during")
    if not during or dev != "cpu" and launches <= 0:
        raise AssertionError(f"{during} waves during the build, "
                             f"{launches} fused_scan launches")

    # every wave against the host twin at that wave's write state
    t_c = time.perf_counter()
    twin = COAXIndex.from_state(twin_state, backend="numpy", device="cpu")
    applied = hits = checked = 0
    for s in sorted({rec[0] for rec in served}):
        for wid, rows, ids in writes[applied:s]:
            if not np.array_equal(twin.insert(rows), srv.write_results[wid]):
                raise AssertionError(f"write batch {applied}: row ids differ")
            twin.delete(ids)
            applied += 1
        recs = [rec for rec in served if rec[0] == s]
        union = np.unique(np.concatenate([rec[1] for rec in recs]))
        q, r = twin.query_batch(rects[union])
        want = dict(zip(union.tolist(), split_hits(q, r, union.size)))
        for _, sel, answers in recs:
            for k, a in zip(sel.tolist(), answers):
                if a.dtype != np.int64 or not np.array_equal(a, want[k]):
                    raise AssertionError(f"write state {s}, rect {k}: "
                                         f"device answer != host answer")
                hits += a.size
                checked += 1
    check_s = time.perf_counter() - t_c
    build = spans["compact.build"]
    tail = spans["compact.tail_replay"]["args"]["ops"]
    say("background", f"from_state of the main index ({run['rows']:,} base "
        f"rows, delta {delta0:,}) in {load_s:.1f} s, size trigger "
        f"{BG_TRIGGER * batch:,} delta entries; {rounds} rounds of 2 "
        f"pipelined waves of {wave}, {len(writes)} write batches of "
        f"{cfg['inserts']:,} inserts + {cfg['deletes']} deletes (one a "
        f"round outside the build, one every {BG_EVERY} rounds during it); "
        f"waves (rounds with a write batch | reads only): "
        + "; ".join(f"{label} {fmt_lat(lat.get((k, True)))} | "
                    f"{fmt_lat(lat.get((k, False)))}" for k, label in (
                        ("before", "before the build"), ("during", "during it"),
                        ("after", "after the install")))
        + f"; build on the compactor thread "
        f"{build['t1'] - build['t0']:.2f} s ({build['args']['rows']:,} "
        f"rows), build start -> install {idx.last_handoff_s:.2f} s, "
        f"installed inside round {install_round}'s srv.drain at a wave "
        f"boundary, tail replayed {tail} ops; epoch {epoch0} -> {idx.epoch}, "
        f"background compactions {idx.background_compactions}; fused_scan "
        f"launches {launches}; every one of the {checked:,} answers == the "
        f"host twin's at its write state ({hits:,} hits, checked after "
        f"serving in {check_s:.1f} s); the main phase's synchronous "
        f"compaction {run['compact_s']:.2f} s; pinned epoch {handle.epoch} "
        f"(pinned before round {pin_round}, whose write batch fired the "
        f"build) still answered round {pin_round - 1}'s {len(pin_sel)} rects "
        f"bit for bit at served epoch {idx.epoch}, on the pinned device plan "
        f"(fused_scan launches {pin_launches} at pin time, {pin_after} after "
        f"the install, not in the count above); peak device memory with "
        f"the pin held across the install {peak_pin / 2**20:.1f} MiB, "
        f"released {freed / 2**20:.1f} MiB, pins left {idx.pinned_epochs}; "
        f"card {card_line}")


def pin_served(torch, srv, rects, last, rounds, dev):
    """Pin the served index before round ``rounds``; its answers to the
    previous round's rects must equal what that round served (no write
    landed between).  Returns the pin, the round, the rect indices, the
    pinned answers and the ``fused_scan`` launches of the pinned read.
    Resets the peak-memory counter: the phase reads it with the pin held
    across the install."""
    from repro_torch.kernels import fused_scan
    _, sel, answers = last
    handle = srv.pin_epoch()
    before = fused_scan.launches
    got = handle.query_batch_split(rects[sel])
    launches = fused_scan.launches - before
    for k, (a, w) in enumerate(zip(got, answers)):
        if not np.array_equal(a, w):
            raise AssertionError(f"pin: rect {k} != the served answer")
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    return handle, rounds, sel, got, launches


def zipf_rects(data, n, n_hot, alpha, nest_frac, seed, sample_cap):
    """A Zipfian hot-rect stream (the script's own copy of the generator in
    ``tests/workloads.py``): ``n`` draws from ``n_hot`` knn rects (k = 64)
    under Zipf(``alpha``) popularity, repeats bit-identical to their pool
    rect, a ``nest_frac`` share shrunk strictly inside it."""
    from repro_torch.data import knn_rect_queries
    rng = np.random.default_rng(seed)
    pool = np.asarray(knn_rect_queries(data, n_hot, 64, seed=seed,
                                       sample_cap=sample_cap), np.float64)
    w = np.arange(1, n_hot + 1, dtype=np.float64) ** -float(alpha)
    rects = pool[rng.choice(n_hot, size=n, p=w / w.sum())].copy()
    nest = rng.random(n) < nest_frac
    if nest.any():
        sub = rects[nest]
        width = sub[:, :, 1] - sub[:, :, 0]
        lo_shrink = rng.uniform(0.0, 0.3, size=width.shape) * width
        hi_shrink = rng.uniform(0.0, 0.3, size=width.shape) * width
        sub[:, :, 0] = sub[:, :, 0] + lo_shrink
        sub[:, :, 1] = np.maximum(sub[:, :, 1] - hi_shrink, sub[:, :, 0])
        rects[nest] = sub
    return rects


def sync(torch, dev):
    if dev != "cpu":
        torch.cuda.synchronize()


def same_answers(got, want, what):
    for k, (a, w) in enumerate(zip(got, want)):
        if a.dtype != np.int64 or not np.array_equal(a, w):
            raise AssertionError(f"{what}: rect {k} differs")


def cache_phase(torch, run, cfg, dev, card_line):
    """The main index through ``QueryServer(..., cache_bytes=256 MiB)`` on
    a Zipfian hot-rect stream: an uncached drain, a cold and a warm cached
    drain, a write batch, one more cached drain; every answer equal to the
    same index's uncached answer at the same write state (the first wave
    also to the host path).  Only misses launch ``fused_scan``: each
    drain's launches are counted around that drain alone; the cold and the
    after-writes drains must launch, the warm drain must not.  One warm
    wave is profiled (``cache_breakdown``)."""
    from repro_torch.data import make_airline
    from repro_torch.engine import QueryServer, split_hits
    from repro_torch.kernels import fused_scan
    idx, wave = run["idx"], cfg["wave"]
    budget = CACHE_BYTES
    rects = zipf_rects(run["data"], cfg["queries"], CACHE_HOT, 1.1, 0.25,
                       seed=5, sample_cap=cfg["sample_cap"])
    srv = QueryServer(idx, max_batch=wave, cache_bytes=budget, device=dev)
    n_waves = -(-len(rects) // wave)
    rows = []

    def drain(label):
        before = fused_scan.launches
        qids = srv.submit_many(rects)
        sync(torch, dev)
        t0 = time.perf_counter()
        got = srv.drain()
        sync(torch, dev)
        secs = time.perf_counter() - t0
        ws = srv.executor.wave_stats[-n_waves:]
        hits = sum(w.cache_hits for w in ws)
        part = sum(w.cache_partial for w in ws)
        c = idx.cache
        rows.append((label, hits, part, len(rects) - hits - part,
                     len(rects) / secs, pct([w.latency_s for w in ws], 50),
                     pct([w.latency_s for w in ws], 99),
                     fused_scan.launches - before,
                     c.nbytes if c is not None else 0,
                     len(c) if c is not None else 0))
        return [got[q] for q in qids]

    idx.detach_cache()                       # the first drain: no cache
    plain = drain("uncached")
    check_wave(idx, rects[:wave], plain[:wave], split_hits)
    idx.attach_cache(byte_budget=budget)
    same_answers(drain("cold"), plain, "cold cached drain")
    same_answers(drain("warm"), plain, "warm cached drain")
    before = fused_scan.launches
    prof = cache_breakdown(idx, rects[:wave])
    if fused_scan.launches != before:
        raise AssertionError("the profiled warm wave launched fused_scan")
    rng = np.random.default_rng(7)
    srv.insert(make_airline(cfg["inserts"], seed=700).data)
    srv.delete(rng.choice(cfg["rows"], cfg["deletes"], replace=False))
    after = drain("cached after writes")
    desc = idx.cache.describe()
    idx.detach_cache()                       # same write state, no cache
    same_answers(after, drain("uncached after writes"), "cached after writes")
    if rows[2][3]:
        raise AssertionError(f"{rows[2][3]} misses in the warm drain")
    cold, warm, written = (rows[k][7] for k in (1, 2, 3))
    if dev != "cpu" and (cold <= 0 or warm != 0 or written <= 0):
        raise AssertionError(f"cached drains launched fused_scan {cold} "
                             f"(cold), {warm} (warm), {written} (after "
                             f"writes): the misses must launch, hits not")
    launches = cold + warm + written         # the cached drains' misses
    say("cache", f"{len(rects)} Zipfian rects ({CACHE_HOT} hot knn rects, "
        f"alpha 1.1, 25% nested) over the main index ({idx.n_rows:,} live "
        f"rows) in waves of {wave}, cache budget {budget >> 20} MiB; per "
        "drain (hits / partial / misses, QPS, wave p50 / p99 ms, fused_scan "
        "launches, resident MiB / entries after): " + "; ".join(
            f"{lab} {h} / {pa} / {mi}, {qps:.1f} QPS, {p50:.2f} / {p99:.2f}"
            f", {ln} launches, {nb / 2**20:.1f} MiB / {ne}"
            for lab, h, pa, mi, qps, p50, p99, ln, nb, ne in rows)
        + f"; one warm wave of {wave} profiled: {prof}"
        + f"; lifetime admissions {desc['admissions']}, evictions "
        f"{desc['evictions']}, invalidations {desc['invalidations']}, "
        f"rejections {desc['rejections']}; every answer == the uncached "
        f"answer at its write state (first wave == host path); fused_scan "
        f"launches of the cached drains (misses only) {launches}; card "
        f"{card_line}")
    return dict(launches=launches)


def cache_breakdown(idx, rects):
    """Where one warm cached wave (every rect answered from the cache)
    spends host time, by cProfile: cumulative time in the lookup
    (``lookup_wave``: exact hits and the containment scan), in the exact
    filter of partial hits inside it (``rect_contains``), in the merge
    back into the flat ``query_batch`` contract (``_merge_cached``; its own
    time holds its native lexsort and concatenations), and the wall time
    of the wave; profiling inflates Python-heavy code."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    q, _ = idx.query_batch(rects)
    prof.disable()
    wall = time.perf_counter() - t0
    cum = {"lookup_wave": 0.0, "rect_contains": 0.0, "_merge_cached": 0.0}
    own = 0.0
    for (_, _, fn), (_, _, tt, ct, _) in pstats.Stats(prof).stats.items():
        if fn in cum:
            cum[fn] += ct
        if fn == "_merge_cached":
            own += tt
    return (f"wall {wall * 1e3:.1f} ms for {q.size:,} hits; lookup_wave "
            f"{cum['lookup_wave'] * 1e3:.1f} ms (rect_contains, the partial "
            f"hits' filter, {cum['rect_contains'] * 1e3:.1f} ms of it); "
            f"_merge_cached {cum['_merge_cached'] * 1e3:.1f} ms ({own * 1e3:.1f}"
            f" ms its own: lexsort, concatenations)")


def plan_bytes(plan):
    """Bytes of a COAX device plan's resident grid images."""
    return sum(img.bytes_resident for img in (plan.p_img, plan.o_img)
               if img is not None) if plan is not None else 0


def sharded_phase(torch, run, cfg, dev, card_line):
    """``QueryServer(idx, shards=4)`` over the main index's live rows (range
    partitioning on dim 0): the 512 knn rects in waves of 64, a write batch
    before each wave after the first, one ``compact()`` of the plane after
    wave 4; every wave equal to the main index given the same writes (same
    ids by construction) on the device path.  Launches are counted around
    the plane's waves alone (``submit_many`` and ``drain``), never around
    the single index's reference waves."""
    from repro_torch.data import make_airline
    from repro_torch.engine import QueryServer, split_hits
    from repro_torch.kernels import fused_scan
    idx, rects, wave = run["idx"], run["rects"], cfg["wave"]
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = QueryServer(idx, max_batch=wave, shards=SHARDS, device=dev)
    build_s = time.perf_counter() - t0
    plane = srv.executor.index
    if plane.n_shards != SHARDS or plane._next_id != idx._next_id:
        raise AssertionError("the plane did not take the index's live rows")
    rng = np.random.default_rng(8)
    compact_s = None
    launches = 0
    for w in range(len(rects) // wave):
        if w:
            rows = make_airline(cfg["inserts"], seed=800 + w).data
            dead = rng.choice(cfg["rows"], cfg["deletes"], replace=False)
            wid = srv.insert(rows)
            srv.delete(dead)
            ids = idx.insert(rows)
            idx.delete(dead)
        batch = rects[w * wave:(w + 1) * wave]
        fused_scan.launches = 0              # ---- the plane's wave ----
        qids = srv.submit_many(batch)
        got = srv.drain()
        sync(torch, dev)
        launches += fused_scan.launches      # ---- read right after ----
        if w and not np.array_equal(srv.write_results[wid], ids):
            raise AssertionError(f"wave {w}: the plane assigned other ids")
        q, r = idx.query_batch(batch)
        same_answers([got[k] for k in qids], split_hits(q, r, len(batch)),
                     f"sharded wave {w}")
        if w == 3:
            t_c = time.perf_counter()
            plane.compact()
            compact_s = time.perf_counter() - t_c
    if dev != "cpu" and launches <= 0:
        raise AssertionError("the sharded phase launched no fused_scan kernel")
    st = srv.stats()
    dispatched = sum(p["queries"] for p in st["per_shard"])
    resident = sum(plan_bytes(s._coax_plan) for s in plane.shards)
    peak = (torch.cuda.max_memory_allocated() - mem0) if dev != "cpu" else 0
    groups = [[(g.predictor, list(g.dependents)) for g in s.groups]
              for s in plane.shards]
    say("sharded", f"{SHARDS} range shards on dim 0 of the main index's "
        f"{sum(plane.shard_sizes()):,} live rows, built in {build_s:.1f} s; "
        f"rows {plane.shard_sizes()}, learned groups {groups}; "
        f"{st['waves']} waves of {wave} ({st['queries']} knn rects), a "
        f"write batch ({cfg['inserts']:,} inserts + {cfg['deletes']} "
        f"deletes) before each wave after the first, plane compaction "
        f"{compact_s:.1f} s after wave 4 (shard epochs "
        f"{[s.epoch for s in plane.shards]}); (rect, shard) pairs "
        f"dispatched {dispatched}, pruned "
        f"{SHARDS * st['queries'] - dispatched}; per shard queries "
        f"{[p['queries'] for p in st['per_shard']]}, rows scanned "
        f"{[p['rows_scanned'] for p in st['per_shard']]}; {st['qps']:.1f} "
        f"QPS, wave p50 {st['wave_p50_ms']:.2f} ms p99 "
        f"{st['wave_p99_ms']:.2f} ms (synchronous waves); fused_scan "
        f"launches {launches}; every wave == the single index given the "
        f"same writes; resident shard images {resident / 2**20:.1f} MiB, "
        f"peak device memory above the phase's start "
        f"{peak / 2**20:.1f} MiB; card {card_line}")
    return dict(launches=launches)


def durable_phase(torch, run, cfg, dev, card_line):
    """The main index, handed over with ``from_state``, journaled under the
    gitignored ``build/``: ``attach_durability(keep=2)``, a server with
    ``checkpoint_every=4``, 8 waves each after a write batch, one
    synchronous compaction (the WAL rotation) after wave 4, one more write
    batch applied and fsynced at a wave boundary; then a crash (server and
    index dropped, no ``close``) and ``QueryServer.recover``, whose first
    wave and counters must equal a twin's that ran the same ops with no
    durability plane.  The journaled server's waves and the recovered
    server's first wave each count their own ``fused_scan`` launches, and
    each must launch.  The directory is removed whatever happens."""
    import shutil
    directory = ROOT / "build" / "durable_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    try:
        return journaled_run(torch, run, cfg, dev, card_line, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def journaled_run(torch, run, cfg, dev, card_line, directory):
    """The body of ``durable_phase`` inside its journal ``directory``."""
    import copy
    import gc
    import shutil
    from repro_torch import obs
    from repro_torch.core import COAXIndex
    from repro_torch.data import make_airline
    from repro_torch.engine import QueryServer, split_hits
    from repro_torch.kernels import fused_scan
    free = shutil.disk_usage(directory).free
    say("durable", f"free disk under {directory.relative_to(ROOT)}: "
        f"{free / 2**30:.1f} GiB")
    rects, wave = run["rects"], cfg["wave"]
    state = run["idx"].state()
    twin = COAXIndex.from_state(copy.deepcopy(state), device=dev)
    idx = COAXIndex.from_state(state, device=dev)
    tracer = obs.enable_tracing(capacity=1 << 16)
    try:
        t0 = time.perf_counter()
        idx.attach_durability(directory, keep=2)
        attach_s = time.perf_counter() - t0
        snap_bytes = idx.durable.last_snapshot_bytes
        srv = QueryServer(idx, max_batch=wave, checkpoint_every=4,
                          device=dev)
        rng = np.random.default_rng(9)

        def write(seed):
            rows = make_airline(cfg["inserts"], seed=seed).data
            dead = rng.choice(cfg["rows"], cfg["deletes"], replace=False)
            srv.insert(rows)
            srv.delete(dead)
            twin.insert(rows)
            twin.delete(dead)

        fused_scan.launches = 0              # ---- this path's run ----
        served = 0
        for w in range(DURABLE_WAVES):
            write(900 + w)
            fused_scan.launches = 0          # ---- the journaled wave ----
            srv.submit_many(rects[(w * wave) % len(rects):][:wave])
            srv.drain()
            sync(torch, dev)
            served += fused_scan.launches    # ---- read right after ----
            if w == 3:                       # the WAL rotation
                t_c = time.perf_counter()
                idx.compact()
                twin.compact()
                both_compact_s = time.perf_counter() - t_c
        write(990)                           # the tail the restart replays
        srv.flush_writes()
        idx.durable.sync()                   # a wave boundary's fsync
        written = srv.checkpoints_written
        wal_records = idx.durable.wal.next_seq
        del srv, idx                         # the crash: no close()
        gc.collect()
        t0 = time.perf_counter()
        rec_srv = QueryServer.recover(directory, max_batch=wave, device=dev)
        restore_s = time.perf_counter() - t0
        rec = rec_srv.executor.index
        batch = rects[:wave]
        fused_scan.launches = 0              # ---- the recovered wave ----
        qids = rec_srv.submit_many(batch)
        sync(torch, dev)
        t0 = time.perf_counter()
        got = rec_srv.drain()
        sync(torch, dev)
        first_wave_s = time.perf_counter() - t0
        launches = fused_scan.launches       # ---- read right after ----
        rec_srv.close()
    finally:
        obs.disable_tracing()
    spans = {}
    for e in tracer.events():
        spans.setdefault(e["name"], []).append(e)
    q, r = twin.query_batch(batch)
    same_answers([got[k] for k in qids], split_hits(q, r, len(batch)),
                 "recovered wave")
    for attr in ("epoch", "compactions", "_next_id", "delta_rows",
                 "tombstone_count", "trigger_checks"):
        if getattr(rec, attr) != getattr(twin, attr):
            raise AssertionError(f"recovered {attr} {getattr(rec, attr)} != "
                                 f"the twin's {getattr(twin, attr)}")
    if dev != "cpu" and (served <= 0 or launches <= 0):
        raise AssertionError(f"fused_scan launches: journaled waves {served},"
                             f" the recovered wave {launches}")
    replayed = spans["wal.replay"][-1]["args"]["records"]
    if replayed != 2:
        raise AssertionError(f"replayed {replayed} records, expected 2")

    def secs(name):
        return ", ".join(f"{e['t1'] - e['t0']:.2f}" for e in spans.get(name, []))

    load = spans["snapshot.load"][-1]
    replay = spans["wal.replay"][-1]
    say("durable", f"from_state of the main index ({twin.n_rows:,} live "
        f"rows); attach_durability (first snapshot, keep=2) {attach_s:.2f} s,"
        f" snapshot {snap_bytes / 2**30:.3f} GiB; {DURABLE_WAVES} waves of "
        f"{wave}, a write batch ({cfg['inserts']:,} inserts + "
        f"{cfg['deletes']} deletes) before each, WAL fsync at each wave "
        f"boundary; checkpoints written {written} (s: "
        f"{secs('durability.checkpoint')}); synchronous compaction after "
        f"wave 4, its WAL rotation (snapshot publish) {secs('wal.rotate')} s "
        f"(both compactions {both_compact_s:.1f} s); one more batch fsynced,"
        f" WAL at {wal_records} records; crash; QueryServer.recover "
        f"{restore_s:.2f} s: snapshot load {load['t1'] - load['t0']:.2f} s "
        f"({load['args']['path']}), WAL replay {replay['t1'] - replay['t0']:.3f}"
        f" s ({replayed} records), first device wave {first_wave_s:.2f} s; "
        f"recovered wave == the live twin's; epoch {rec.epoch}, compactions "
        f"{rec.compactions}, next id {rec._next_id}, delta rows "
        f"{rec.delta_rows}, tombstones {rec.tombstone_count} == the twin's; "
        f"fused_scan launches: the {DURABLE_WAVES} journaled waves {served}, "
        f"the recovered first wave {launches}; directory removed; card "
        f"{card_line}")
    return dict(launches=served + launches)


def replicated_phase(torch, run, cfg, dev, card_line):
    """The main index, handed over with ``from_state``, as the primary of a
    ``ReplicatedServer`` with two replicas on the device backend, its
    journal under the gitignored ``build/``; the body is
    ``replicated_run``.  The directory is removed whatever happens."""
    import shutil
    directory = ROOT / "build" / "replicated_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    try:
        return replicated_run(torch, run, cfg, dev, card_line, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def dispatches(idx):
    st = idx.device_stats()
    return st["dispatches"] if st else 0


def wave_segments(idx, rects):
    """Segments the index's last device wave scanned, one ``fused_scan``
    launch each on the card: the primary grid, the outlier grid when a rect
    meets its bounding box, the delta."""
    plan = idx._coax_plan
    n = (plan.p_img is not None) + (plan._delta is not None)
    if plan.o_img is not None and plan.outlier_lo is not None:
        n += bool(np.all((rects[:, :, 0] <= plan.outlier_hi)
                         & (rects[:, :, 1] > plan.outlier_lo), axis=1).any())
    return n


def settle(srv, limit=8):
    """``tick`` until every live replica is at the hub's frontier; returns
    the frames applied."""
    applied = 0
    for _ in range(limit):
        applied += srv.tick()
        if all(not r.alive or r.frontier == srv.hub.frontier
               for r in srv.replicas):
            return applied
    raise AssertionError("replicas failed to converge: "
                         + str([r.describe() for r in srv.replicas]))


def replicated_run(torch, run, cfg, dev, card_line, directory):
    """The primary (the main index's state, no refit, a size trigger that
    the phase's ninth write fires) serves behind ``ReplicatedServer`` with
    two replicas on the device backend and ``REP_FAULTS``.  Each of
    ``REP_ROUNDS`` rounds applies a write batch (2,000 inserts, every 4th
    batch FD-violating, 500 deletes), ticks until the live replicas reach
    the hub's frontier and serves one wave through ``query_batch_split``
    (round-robin over healthy replicas), which must be one device wave of
    one replica, a ``fused_scan`` launch per segment, and equal to the
    primary's host path.  Then the ninth write fires the trigger and the
    injected crash kills the primary inside the rotation; each replica
    applies the shipped trigger record (its own implicit rotation);
    ``promote()``; one wave of the promoted primary, a write batch through
    it, one wave of the reseeded replica, each checked.  Device memory after
    the reseed must stay within 5% of what was allocated just before
    ``promote()``: the reseeded replica's old plan must be gone."""
    import gc
    import resource
    from repro_torch import obs
    from repro_torch.core import COAXIndex
    from repro_torch.data import make_airline
    from repro_torch.kernels import fused_scan
    from repro_torch.replication import ReplicatedServer
    from repro_torch.runtime import FaultPlan
    t_phase = time.perf_counter()
    rects, wave = run["rects"], cfg["wave"]
    main = run["idx"]
    main.release_plan()                      # earlier phases' device plans
    run.pop("plan", None)
    run.pop("srv", None)
    gc.collect()
    mem0 = 0
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    batch = cfg["inserts"] + cfg["deletes"]
    trigger = (main.delta_rows + main.tombstone_count + REP_ROUNDS * batch
               + cfg["inserts"] // 2)
    state = main.state()
    state["config"] = dict(state["config"], background_compact=False,
                           auto_compact=True, compact_min_delta=trigger,
                           compact_delta_frac=0.0, drift_threshold=0.0)
    primary = COAXIndex.from_state(state, device=dev)
    plan = FaultPlan({k: dict(v) for k, v in REP_FAULTS.items()})
    tracer = obs.enable_tracing(capacity=1 << 16)
    try:
        t0 = time.perf_counter()
        srv = ReplicatedServer(primary, directory, n_replicas=2, plan=plan,
                               replica_backend="device", device=dev,
                               heartbeat_timeout=REP_HEARTBEAT_S)
        setup_s = time.perf_counter() - t0
        snap_bytes = primary.durable.last_snapshot_bytes
        out = replicated_rounds(torch, srv, primary, rects, cfg, dev, mem0)
    finally:
        obs.disable_tracing()
    spans = {}
    for e in tracer.events():
        spans.setdefault(e["name"], []).append(e["t1"] - e["t0"])
    st, pre, post = out["stats"], out["pre"], out["post"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    mem = out["mem"]
    say("replicated", f"primary: from_state of the main index "
        f"({primary.data.shape[0]:,} base rows), size trigger {trigger:,} "
        f"delta entries; ReplicatedServer (journal + 2 replicas on the "
        f"device backend, {dev}) set up in {setup_s:.2f} s (snapshot "
        f"{snap_bytes / 2**30:.3f} GiB, two seeds); {REP_ROUNDS} rounds of "
        f"{cfg['inserts']:,} inserts (every 4th batch FD-violating) + "
        f"{cfg['deletes']} deletes, catch-up, one {wave}-query replica wave; "
        f"wire to replica-0: {pre['transport_faults']}; replica-1 crashed "
        f"mid-apply in round {out['crash_round']}, revived before round "
        f"{REP_REVIVE}; shipped {pre['ship']['shipped_frames']} write frames, "
        f"{pre['ship']['shipped_bytes']:,} bytes, {pre['ship']['heartbeats']} "
        f"heartbeats, send retries {pre['ship']['send_retries']}, ship "
        f"failures {pre['ship']['ship_failures']}; per replica (corrupt, "
        f"duplicate, catch-up fetches, reseeds, implicit rotations, "
        f"crashes): {out['per_replica']}; apply {out['apply_ms']:.3f} ms per "
        f"write frame ({out['frames']} frames in {out['apply_s']:.2f} s of "
        f"ticks); replica waves {fmt_lat(out['lat'])}, first wave of each "
        f"replica (plan build, upload) {out['first']}; waves by replica "
        f"{out['by_replica']}; primary warm-up wave {out['warm_s']:.2f} s")
    say("replicated", f"the ninth write fired the trigger: primary "
        f"compaction + rotation {out['primary_rot_s']:.2f} s until the "
        f"injected crash ({out['crash']}); compact.sync spans (s) "
        f"{', '.join(f'{x:.2f}' for x in spans.get('compact.sync', []))}; "
        f"wal.rotate spans (s) "
        f"{', '.join(f'{x:.2f}' for x in spans.get('wal.rotate', []))}; "
        f"replicas applied the trigger record and rotated implicitly: "
        f"{out['rot_s']}; acked {out['acked']}; promote() {out['promote_s']:.2f}"
        f" s (pump {out['split']['pump']:.2f}, drain_from_disk "
        f"{out['split']['drain']:.2f}, attach_durability and the rest "
        f"{out['split']['attach']:.2f}, survivor reseed "
        f"{out['split']['reseed']:.2f}); failover.promote span "
        f"{', '.join(f'{x:.2f}' for x in spans.get('failover.promote', []))}"
        f" s; promoted {out['promoted']} at {out['frontier']} >= acked; "
        f"promoted primary's first wave {out['promoted_wave_s']:.2f} s, the "
        f"reseeded replica's first wave after a write batch "
        f"{out['survivor_wave_s']:.2f} s; after promotion: shipped "
        f"{post['ship']['shipped_frames']} frames, reseeds "
        f"{[r['reseeds'] for r in post['replicas']]}, promotions "
        f"{st['promotions']}, reads {st['reads']}")
    say("replicated", f"every one of the {out['checked']} waves == the "
        f"host path at its frontier ({out['hits']:,} hits); fused_scan "
        f"launches {out['launches']} over the phase's waves (per replica wave "
        f"{out['wave_launches']}, each >= its segments "
        f"{out['wave_segments']}); resident images per plan (MiB): "
        f"{mem['resident']}; device memory: phase start "
        f"{mem['start'] / 2**20:.1f} MiB, peak with the primary's and two "
        f"replicas' plans {mem['peak'] / 2**20:.1f} MiB, before promote() "
        f"{mem['before'] / 2**20:.1f} MiB, after the reseed and both waves "
        f"{mem['after'] / 2**20:.1f} MiB ({mem['ratio']:.4f} of before); "
        f"peak host RSS {rss:.2f} GiB; the phase "
        f"{time.perf_counter() - t_phase:.1f} s; card {card_line}")
    return dict(launches=out["launches"])


def replicated_rounds(torch, srv, primary, rects, cfg, dev, mem0):
    """The body of ``replicated_run`` once the server is up; ``mem0`` is
    the device memory allocated at the phase's start."""
    from repro_torch.data import make_airline
    from repro_torch.engine import split_hits
    from repro_torch.kernels import fused_scan
    wave = cfg["wave"]
    rng = np.random.default_rng(16)
    mem = {"start": mem0}
    res = dict(lat=[], first={}, by_replica={}, wave_launches=[],
               wave_segments=[], launches=0, checked=0, hits=0, frames=0,
               apply_s=0.0, crash_round=None)

    def checked_wave(label, serve, index_of, sel, host):
        """One wave: serve it, count its launches, find which index's plan
        dispatched it, and hold it against ``host``'s host path."""
        indexes = index_of()
        before = {k: dispatches(ix) for k, ix in indexes.items()}
        n0 = fused_scan.launches
        sync(torch, dev)
        t0 = time.perf_counter()
        got = serve(sel)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        n = fused_scan.launches - n0
        who = [k for k, ix in indexes.items() if dispatches(ix) > before[k]]
        if len(who) != 1:
            raise AssertionError(f"{label}: device waves on {who}")
        need = wave_segments(indexes[who[0]], sel)
        if dev != "cpu" and n < need:
            raise AssertionError(f"{label}: {n} fused_scan launches for "
                                 f"{need} segments")
        res["hits"] += check_wave(host, sel, got, split_hits)
        res["launches"] += n
        res["checked"] += 1
        return who[0], secs, n, need

    def replicas():
        return {r.name: r.index for r in srv.replicas}

    def write(seed, violate):
        rows = make_airline(cfg["inserts"], seed=seed).data
        if violate:                          # break FD group 0 (1 = f(0))
            rows[:, 1] = rows[:, 1] * 3.0 + 1000.0
        srv.insert(rows)
        srv.delete(rng.choice(cfg["rows"], cfg["deletes"], replace=False))

    sel = rects[:wave]
    _, res["warm_s"], _, _ = checked_wave(
        "primary warm-up", primary.query_batch_split,
        lambda: {"primary": primary}, sel, primary)
    for r in range(REP_ROUNDS):
        write(1600 + r, r % 4 == 3)
        if r == REP_REVIVE:
            for rep in srv.replicas:
                if not rep.alive:
                    rep.revive()
        t0 = time.perf_counter()
        res["frames"] += settle(srv)
        res["apply_s"] += time.perf_counter() - t0
        if res["crash_round"] is None and not all(
                rep.alive for rep in srv.replicas):
            res["crash_round"] = r
        sel = rects[(r * wave) % len(rects):][:wave]
        who, secs, n, need = checked_wave(
            f"round {r}", srv.query_batch_split, replicas, sel, primary)
        if who in res["first"]:
            res["lat"].append(secs)
        else:
            res["first"][who] = round(secs, 2)
        res["by_replica"][who] = res["by_replica"].get(who, 0) + 1
        res["wave_launches"].append(n)
        res["wave_segments"].append(need)
    res["apply_ms"] = res["apply_s"] * 1e3 / max(res["frames"], 1)
    if res["crash_round"] is None or any(not r.alive for r in srv.replicas):
        raise AssertionError("replica-1 did not crash and come back")
    if len(res["by_replica"]) != 2:
        raise AssertionError(f"waves served by {res['by_replica']}")

    # the ninth write fires the size trigger; the rotation kills the primary
    epoch0 = primary.epoch
    t0 = time.perf_counter()
    try:
        srv.insert(make_airline(cfg["inserts"], seed=1600 + REP_ROUNDS).data)
    except RuntimeError as e:
        res["crash"] = str(e)
    else:
        raise AssertionError("the ninth write did not fire the trigger")
    res["primary_rot_s"] = time.perf_counter() - t0
    if primary.epoch != epoch0 + 1 or "primary.rotate" not in res["crash"]:
        raise AssertionError(f"epoch {epoch0} -> {primary.epoch}: "
                             f"{res['crash']}")
    res["acked"] = srv.acked
    srv.kill_primary()
    res["rot_s"] = {}
    for rep in srv.replicas:                # the shipped trigger record
        t0 = time.perf_counter()
        rep.pump()
        res["rot_s"][rep.name] = round(time.perf_counter() - t0, 2)
        if rep.implicit_rotations != 1 or rep.frontier != srv.hub.frontier:
            raise AssertionError(f"{rep.name}: {rep.describe()}")
    res["pre"] = srv.stats()
    res["per_replica"] = {
        r["name"]: (r["frames_corrupt"], r["frames_duplicate"],
                    r["catchup_fetches"], r["reseeds"],
                    r["implicit_rotations"], r["crashes"])
        for r in res["pre"]["replicas"]}
    faults = res["pre"]["transport_faults"]
    if (any(faults[k] != 1 for k in ("drops", "tears", "dups", "reorders"))
            or res["per_replica"]["replica-0"][0] < 1
            or res["per_replica"]["replica-0"][2] < 1
            or res["per_replica"]["replica-1"][5] != 1):
        raise AssertionError(f"fault schedule not exercised: {faults}, "
                             f"{res['per_replica']}")
    plans = {"primary": primary, **replicas()}
    res["mem"] = mem
    mem["resident"] = {k: round(plan_bytes(ix._coax_plan) / 2**20, 1)
                       for k, ix in plans.items()}
    if dev != "cpu":
        torch.cuda.synchronize()
        mem["before"] = torch.cuda.memory_allocated()
        mem["peak"] = torch.cuda.max_memory_allocated()
    else:
        mem["before"] = mem["peak"] = 0

    # promote: time each step of the candidate promote() picks
    cand = max(srv.replicas, key=lambda r: r.frontier)
    split = dict(pump=0.0, drain=0.0, reseed=0.0)

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key] += time.perf_counter() - t
        setattr(obj, name, wrapper)

    timed(cand, "pump", "pump")
    timed(cand, "drain_from_disk", "drain")
    for rep in srv.replicas:
        if rep is not cand:
            timed(rep, "reseed", "reseed")
    t0 = time.perf_counter()
    promoted = srv.promote()
    res["promote_s"] = time.perf_counter() - t0
    split["attach"] = res["promote_s"] - sum(split.values())
    res["split"] = split
    if promoted is not cand or promoted.frontier < res["acked"]:
        raise AssertionError(f"promoted {promoted.name} at "
                             f"{promoted.frontier}, acked {res['acked']}")
    res["promoted"], res["frontier"] = promoted.name, promoted.frontier
    newp = srv.primary
    sel = rects[wave:2 * wave]
    _, res["promoted_wave_s"], _, _ = checked_wave(
        "promoted primary", newp.query_batch_split,
        lambda: {"promoted": newp}, sel, newp)
    write(1700, False)
    settle(srv)
    sel = rects[2 * wave:3 * wave]
    who, res["survivor_wave_s"], _, _ = checked_wave(
        "reseeded replica", srv.query_batch_split, replicas, sel, newp)
    if dev != "cpu":
        torch.cuda.synchronize()
        mem["after"] = torch.cuda.memory_allocated()
        mem["ratio"] = mem["after"] / mem["before"]
        if mem["ratio"] > 1.05:
            raise AssertionError(
                f"device memory {mem['after'] / 2**20:.1f} MiB after the "
                f"reseed, {mem['before'] / 2**20:.1f} MiB before promote(): "
                f"a replaced plan was not freed")
    else:
        mem["after"], mem["ratio"] = 0, 0.0
    res["stats"] = res["post"] = srv.stats()
    srv.close()
    return res


def fmt_lat(lat_s):
    """Count, p50, p99 and max of wave latencies in ms."""
    if not lat_s:
        return "none"
    return (f"{len(lat_s)} (p50 {pct(lat_s, 50):.2f} ms, p99 "
            f"{pct(lat_s, 99):.2f} ms, max {max(lat_s) * 1e3:.2f} ms)")


# the lm_serve phase: the serve launcher's default arch and the other archs
# at full width, the launcher's traffic at 512 requests (the router builds
# its index only once 256 are pending), and the bfloat16 bar of the
# reference's own prefill/forward test
LM_ARCH, LM_SEED, LM_REQUESTS = "h2o-danube-3-4b", 0, 512
# the rehearsal's requests: enough for the router to build its index (256
# pending), fewer waves of the CPU's slow bfloat16 products
LM_REHEARSE_REQUESTS = 288
LM_SERVE_ARCHS = (LM_ARCH, "zamba2-2.7b", "minicpm3-4b", "mixtral-8x7b",
                  "gemma2-27b", "minitron-4b", "phi3.5-moe-42b-a6.6b")
# all but h2o and mixtral serve 288 requests (still past the router's
# 256-pending index build): on a slow host zamba2's and minicpm3's 384 took
# 75.6 and 101.5 s of a 1,062.7 s smoke on an H100 80GB HBM3 at 700 W
# (PERF.md §4)
LM_SERVE_REQUESTS = {arch: 288 for arch in LM_SERVE_ARCHS[1:]
                     if arch != "mixtral-8x7b"}
# archs served at a cut depth on one card: mixtral-8x7b's 32 layers hold
# 46.57B parameters, 93.1 GB of bfloat16 weights, past the card's 80 GB;
# 8 layers at full width hold 23.5 GB, and their float32 masters (47.0
# GB, alive while they are initialised and cast) fit, where 16 layers'
# (94 GB) would not.  phi3.5-moe's 32 layers hold 41.74B (83.5 GB of
# bfloat16); 8 layers hold 10.53B, 42.1 GB of float32 masters at init.
# gemma2-27b's 46 layers hold 27.23B (54.5 GB of bfloat16, 108.9 GB of
# masters); while their masters were initialised and cast, 18 layers
# peaked at 46.76 GiB and 26 at 63.67 GiB on an H100 80GB HBM3 (PERF.md
# §4), 2.11 GiB a layer: 28 layers (17.03B) reach ~67.9 GiB and leave
# ~11.3 of the card's 79.2 GiB free, where 30 would leave ~7.1; the depth
# stays even, whole local/global pairs.
# zamba2-2.7b and minicpm3-4b, the two slowest host-bound decoders, serve
# at about half their depth (zamba2 five of its nine segments of 6 Mamba2
# layers, both shared blocks still run) so the smoke keeps its margin
# under its time limit: at full depth and 288 requests a slow host took
# 90.7 and 103.0 s of a 1,119.5 s run on an H100 80GB HBM3 at 700 W
# (PERF.md §4)
SERVE_DEPTH = {"mixtral-8x7b": 8, "zamba2-2.7b": 30, "minicpm3-4b": 31,
               "gemma2-27b": 28, "phi3.5-moe-42b-a6.6b": 8}
# why each arch of SERVE_DEPTH is cut
FITS = "the full depth's weights do not fit one card"
DEPTH_CUT = {"mixtral-8x7b": FITS, "phi3.5-moe-42b-a6.6b": FITS,
             "gemma2-27b": "the float32 masters of more layers do not fit "
                           "one card beside the serving state",
             "zamba2-2.7b": "the smoke's time limit",
             "minicpm3-4b": "the smoke's time limit"}
LM_SERVE = dict(batch_size=8, max_new_tokens=16, cache_len=512, eos_token=0)
LM_TOL = dict(rtol=0.05, atol=0.08)
PROFILED_STEPS = 4            # decode steps of the first wave profiled
# the first wave replayed at float32 activations against the forward:
# float32 GEMMs of 8 rows (decode) and of 8 x s rows (forward) sum in other
# orders on the card, and over 24-63 blocks the logits moved apart by up to
# 6.6e-5 (PERF.md §6); the bar is 400x under the bfloat16 one
F32_TOL = dict(rtol=1e-4, atol=2e-4)
# archs whose bfloat16 first wave holds the bfloat16 bar against the
# forward: over zamba2's 63 blocks and minicpm3's 62 layers bfloat16
# rounding compounds past it, in the reference too (PERF.md §6), as over
# gemma2's (0.1326 at 28 layers), and in an MoE a bfloat16 near-tie flips
# a top-2 choice (2.75 and 2.88 for mixtral and phi3.5-moe on an H100
# 80GB HBM3, PERF.md §6); their wave is held at float32 alone
BF16_WAVE_GATED = (LM_ARCH, "minitron-4b")
BF16_OPS_PER_S = 989e12       # H100 SXM bfloat16 dense (NVIDIA data sheet)
CONV_K = 4                    # Mamba2's causal-conv taps (models/ssm.py)


def mamba_ops(cfg, b, s):
    """Operations of one Mamba2 layer over ``b`` x ``s`` tokens: the five
    input projections and the output one, the causal conv, and the SSD:
    for a prompt its chunked form at ``cfg.ssd_chunk`` (the C.B^T scores
    and the gated product inside each chunk, the chunk states and the
    entering states' read-out), for one token the state update (3 a
    state element) and read-out (2)."""
    d, h, p, n = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_p, cfg.ssm_state
    t = b * s
    proj = 2 * t * d * (2 * h * p + 2 * n + h) + 2 * t * h * p * d
    conv = 2 * CONV_K * t * (h * p + 2 * n)
    if s == 1:
        return proj + conv + 5 * b * h * p * n
    l = min(cfg.ssd_chunk, s)
    nc = s // l
    ssd = 2 * b * nc * l * l * (n + h * p) + 2 * 2 * t * n * h * p
    return proj + conv + ssd


def ffn_ops(cfg, b, s):
    """Operations of a block's feed-forward half over ``b`` x ``s`` tokens:
    the gated MLP (the enc-dec's is not gated); for an MoE the router and
    the experts' gated MLP over every slot of the ``(B, E, C)`` capacity
    buffer, as the reference computes it (C = ``moe.capacity``; each
    expert's weights are read whatever the routing)."""
    from repro_torch.models.moe import capacity
    d, ff, t = cfg.d_model, cfg.d_ff, b * s
    if cfg.n_experts:
        e = cfg.n_experts
        c = capacity(s, cfg.top_k, cfg.capacity_factor, e)
        return 2 * t * d * e + 3 * 2 * b * e * c * d * ff
    return (2 if cfg.family == "encdec" else 3) * 2 * t * d * ff


def attn_ops(cfg, b, s, kv_slots):
    """Operations of one attention block (GQA or MLA, then ``ffn_ops``)
    over ``b`` x ``s`` tokens: its products and the causal attention the
    data needs (``kv_slots`` valid slots for one token).  MLA decodes in
    the absorbed form over its latent cache."""
    d, h, t = cfg.d_model, cfg.n_heads, b * s
    pairs = s * (s + 1) // 2 if kv_slots == 0 else kv_slots
    mlp = ffn_ops(cfg, b, s)
    if not cfg.mla:
        kv, hd = cfg.n_kv_heads, cfg.hd
        return (2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d + mlp
                + 2 * 2 * b * h * hd * pairs)
    ql, kl, nope, rope, vd = (cfg.q_lora, cfg.kv_lora, cfg.nope_dim,
                              cfg.rope_dim, cfg.v_dim)
    proj = 2 * t * (d * ql + ql * h * (nope + rope) + d * kl + d * rope
                    + h * nope * kl + h * kl * vd + h * vd * d)
    if s > 1:
        return proj + mlp + 2 * b * h * (nope + rope + vd) * pairs
    return proj + mlp + 2 * b * h * (2 * kl + rope) * pairs


def encdec_ops(cfg, b, s, kv_slots, enc_len):
    """Operations of the enc-dec over ``b`` x ``s`` decoder tokens: for a
    prompt (``s`` > 1 or ``kv_slots`` 0) the encoder over ``enc_len``
    frames (bidirectional attention over every pair) and the cross
    keys/values, then each decoder layer's causal attention block, its
    cross-attention (queries and output projected, every encoder position
    attended) and MLP."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ops = 0
    if kv_slots == 0:
        te = b * enc_len
        enc = (2 * te * d * (h + 2 * kv) * hd + 2 * te * h * hd * d
               + ffn_ops(cfg, b, enc_len) + 2 * 2 * b * h * hd * enc_len ** 2)
        ops += cfg.enc_layers * enc + cfg.n_layers * 2 * te * d * 2 * kv * hd
    cross = (2 * 2 * b * s * d * h * hd + 2 * 2 * b * h * hd * s * enc_len)
    return ops + cfg.n_layers * (attn_ops(cfg, b, s, kv_slots) + cross)


def decode_cache_bytes(cfg, b, kv_slots, enc_len=0):
    """(bytes one decode step reads of the cache, bytes it writes): the
    valid KV (or latent) slots read and one slot written a layer (the
    enc-dec also reads its ``enc_len`` cross slots); a Mamba2 layer's
    float32 ``(H, P, N)`` state and bfloat16 conv tails read and written
    once."""
    L = cfg.n_layers
    read = write = 0
    if cfg.family == "encdec":
        read = L * b * enc_len * 2 * 2 * cfg.n_kv_heads * cfg.hd
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_heads, cfg.ssm_head_p, cfg.ssm_state
        n_mamba = (L if cfg.family == "ssm"
                   else (L // cfg.attn_every) * cfg.attn_every)
        state = n_mamba * b * (4 * h * p * n + 2 * (CONV_K - 1) * (h * p + 2 * n))
        read, write = state, state
    if cfg.family == "ssm":
        return read, write
    n_attn = L // cfg.attn_every if cfg.family == "hybrid" else L
    slot = (2 * (cfg.kv_lora + cfg.rope_dim) if cfg.mla
            else 2 * 2 * cfg.n_kv_heads * cfg.hd)
    return read + n_attn * b * kv_slots * slot, write + n_attn * b * slot


def lm_cost(cfg, b, s, kv_slots, weight_bytes, cache_out_bytes,
            enc_len=0):
    """(operations, bytes) of one prefill (``kv_slots`` 0: ``s`` prompt
    tokens) or one decode step (``s`` = 1, attending ``kv_slots`` valid
    slots) of ``cfg``'s family: every layer's products (``attn_ops``,
    ``mamba_ops``, ``encdec_ops`` over ``enc_len`` frames; a hybrid runs
    its shared blocks once a segment), the last-token unembed; every
    weight read once, the cache read (decode, ``decode_cache_bytes``) and
    ``cache_out_bytes`` written once."""
    L, d = cfg.n_layers, cfg.d_model
    ops = 2 * b * cfg.padded_vocab * d
    if cfg.family == "encdec":
        ops += encdec_ops(cfg, b, s, kv_slots, enc_len)
    elif cfg.family == "ssm":
        ops += L * mamba_ops(cfg, b, s)
    elif cfg.family == "hybrid":
        n_seg = L // cfg.attn_every
        ops += n_seg * (cfg.attn_every * mamba_ops(cfg, b, s)
                        + attn_ops(cfg, b, s, kv_slots))
    else:
        ops += L * attn_ops(cfg, b, s, kv_slots)
    cache_read = (decode_cache_bytes(cfg, b, kv_slots, enc_len)[0]
                  if kv_slots else 0)
    nbytes = (weight_bytes + cache_read + cache_out_bytes + 4 * b * s
              + 4 * b * cfg.padded_vocab)
    if kv_slots == 0 and enc_len:
        nbytes += 4 * b * enc_len * d            # the float32 stub frames
    return ops, nbytes


def attn_slots(cache):
    """Slots of a decode cache's attention entry (0 for an ssm cache)."""
    for name in ("k", "ckv", "k_glob"):
        if name in cache:
            return cache[name].shape[2]
    return 0


def describe(cfg):
    """The shape of ``cfg``'s layers, for the phase's first line."""
    if cfg.family in ("ssm", "hybrid"):
        text = (f"{cfg.n_layers} Mamba2 layers (d_model {cfg.d_model}, "
                f"{cfg.ssm_heads} heads x {cfg.ssm_head_p}, state "
                f"{cfg.ssm_state}, SSD chunk {cfg.ssd_chunk})")
        if cfg.family == "hybrid":
            text += (f", {cfg.n_shared_attn} shared GQA blocks "
                     f"({cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff "
                     f"{cfg.d_ff}) after every {cfg.attn_every}")
        return text
    if cfg.mla:
        return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, MLA "
                f"{cfg.n_heads} heads (q_lora {cfg.q_lora}, kv_lora "
                f"{cfg.kv_lora}, nope/rope/v {cfg.nope_dim}/{cfg.rope_dim}/"
                f"{cfg.v_dim}), d_ff {cfg.d_ff}")
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, window {cfg.window}")


def train_bound_ms(model, b, s, n_stub=0):
    """(step bound ms, its model-FLOP ms, its optimizer ms) of one train
    step of ``model`` (built anywhere, ``meta`` too) over ``b`` sequences
    of ``s`` text tokens: the useful work 6·N·T at the bfloat16 peak
    (remat's second forward is not counted), then AdamW over every
    parameter, which reads p, g, mu and nu and writes p, mu and nu (7
    float32 words, 28 bytes a parameter) at the memory rate; the two run
    one after the other.  N·T is each parameter times the positions it
    meets: an MoE's active parameters (``top_k`` of its experts) the text
    tokens, the vlm's parameters the patches and the text, the enc-dec's
    encoder the ``n_stub`` frames and its decoder (the embedding with it)
    the text (``bound_terms`` says which)."""
    cfg = model.cfg
    n_params = model.param_count()
    if cfg.family == "encdec":
        n_enc = sum(p.numel() for n, p in model.named_parameters()
                    if n.startswith("enc_"))
        weighted = n_enc * b * n_stub + (n_params - n_enc) * b * s
    elif cfg.family == "vlm":
        weighted = n_params * b * (cfg.n_patches + s)
    else:
        weighted = model.active_param_count() * b * s
    flop_ms = 6 * weighted / BF16_OPS_PER_S * 1e3
    opt_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    return flop_ms + opt_ms, flop_ms, opt_ms


def bound_terms(cfg):
    """How ``train_bound_ms`` counts ``cfg``'s model FLOPs."""
    if cfg.family == "encdec":
        return "6(N_enc·T_frames + N_dec·T_text)"
    if cfg.family == "vlm":
        return "6N(T_patches + T_text)"
    return "6·N_active·T" if cfg.n_experts else "6NT"


def lm_bound_ms(ops, nbytes):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lm_profile(torch, fn, reps):
    """``reps`` calls of ``fn`` under torch.profiler: (wall ms a call,
    device-busy ms a call, kernel launches a call, the three kernels with
    the most device time); None when the trace has no device time.  The
    device events are read from the raw trace: ``key_averages`` first
    builds an event tree over the CPU ops too, which took 36 s for one
    44,000-kernel qwen2-vl-2b train step on an H100 80GB HBM3 (PERF.md
    §4)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}                        # kernel name -> [ns, launches]
    for evt in prof.profiler.kineto_results.events():
        if (not str(evt.device_type()).endswith("CUDA")
                or evt.is_user_annotation() or evt.duration_ns() <= 0):
            continue
        acc = by_name.setdefault(evt.name(), [0, 0])
        acc[0] += evt.duration_ns()
        acc[1] += 1
    busy = sum(ns for ns, _ in by_name.values())
    if busy <= 0:
        return None
    top = ", ".join(f"{name[:40]} {ns / 1e6 / reps:.3f} ms"
                    for name, (ns, _) in sorted(
                        by_name.items(), key=lambda kv: -kv[1][0])[:3])
    return (wall * 1e3 / reps, busy / 1e6 / reps,
            sum(n for _, n in by_name.values()) / reps, top)


def lm_serve_phase(torch, dev, card_line, arch=LM_ARCH):
    """The LM serving path on the card for ``arch``: ``build_model`` at
    full width and depth (``SERVE_DEPTH`` cuts the MoEs', gemma2's,
    zamba2's and minicpm3's; 2 layers at
    width 64 in the rehearsal, a hybrid one segment of 6, SSD and latent
    dims cut), float32 masters from a seeded generator cast once to
    bfloat16, a ``Server`` whose router runs on the device backend, 512
    requests (288 for the archs of ``LM_SERVE_REQUESTS`` and in the
    rehearsal) drawn as ``launch/serve.py`` draws them, drained.  Checks: every request answered once with its budget
    of tokens; every admission equal to a numpy-backend twin router fed
    the same submissions; fused_scan launches around the drain > 0 and
    one plan dispatch per admission that met a built index; the first
    wave's prefill + decode logits against a full forward over prompt +
    fed tokens (replayed at float32 activations; an MoE at a capacity
    that drops no pair, ``no_drop``); a reduced-depth full-width prefill
    (2 layers; a hybrid 12) on the card against the CPU, at rtol 0.05 /
    atol 0.08 (an MoE at float32 activations, rtol 1e-4 / atol 2e-4,
    counting the routing choices whose top-2 sets differ).
    ``release_lm`` frees the model after it returns."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_scan
    from repro_torch.launch.train import reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_params, make_generator
    from repro_torch.runtime.router import CoaxRouter
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    t_phase = time.perf_counter()
    cuda = dev != "cpu"
    cfg = get_config(arch)
    if cuda and arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    # a reduced depth that keeps each kind of layer: a hybrid needs two
    # segments of attn_every Mamba2 layers to run both shared blocks
    depth = (cfg.attn_every * cfg.n_shared_attn if cfg.family == "hybrid"
             else 2)
    if not cuda:
        # the rehearsal checks the control flow at a tiny size: one hybrid
        # segment, narrow SSD and latent dims
        depth = cfg.attn_every if cfg.family == "hybrid" else 2
        cfg = reduced(cfg, depth, 64)
        if cfg.mla:
            cfg = dataclasses.replace(cfg, q_lora=32, kv_lora=16, nope_dim=8,
                                      rope_dim=4, v_dim=8)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, ssm_state=8, ssm_head_p=8)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(torch, dev)
    t0 = time.perf_counter()
    model = cast_params(build_model(cfg, device=dev).init(
        make_generator(LM_SEED, dev)))
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_params = model.param_count()
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mem = torch.cuda.memory_allocated() if cuda else 0
    init_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:                    # the serving peak, apart from the masters'
        torch.cuda.reset_peak_memory_stats()
    cut = (f" (cut from {get_config(arch).n_layers} layers: "
           f"{DEPTH_CUT[arch]})" if arch in SERVE_DEPTH and cuda else "")
    say("lm_serve", f"{cfg.name}: {describe(cfg)}{cut}; {n_params:,} "
        f"parameters ({model.active_param_count():,} active a token), "
        f"weights {w_bytes / 1e9:.3f} GB (float32 masters cast once: "
        f"matrices bfloat16, norm scales float32); init "
        f"{init_s:.2f} s (peak {init_peak / 2**30:.2f} GiB); device memory "
        f"{mem / 2**30:.2f} GiB ({card_line})")

    srv = Server(model, ServeConfig(**LM_SERVE), device=dev)
    router, twin = srv.router, CoaxRouter(backend="numpy")
    assert router.backend == "device" and router.device == dev
    rng = np.random.default_rng(LM_SEED)
    budgets = {}
    n_requests = (LM_SERVE_REQUESTS.get(arch, LM_REQUESTS) if cuda
                  else LM_REHEARSE_REQUESTS)
    for _ in range(n_requests):          # as launch/serve.py draws them
        plen = int(rng.choice([16, 32, 64, 128]))
        rid = srv.submit(
            rng.integers(1, cfg.padded_vocab - 1, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, LM_SERVE["max_new_tokens"])),
            priority=float(rng.random()))
        req = router._pool[rid]
        twin.submit(req.prompt, req.max_new_tokens, req.priority,
                    arrival=req.arrival)
        budgets[rid] = req.max_new_tokens

    # admissions: each checked against the twin; a wave's plan dispatches
    waves_per_admit, admits = [], [0]
    hits_fn, admit_fn = router._index_hits, router.admit

    def index_hits(rect):
        plan = router._index._coax_plan
        before = plan.dispatch_count if plan is not None else 0
        out = hits_fn(rect)
        waves_per_admit.append(router._index._coax_plan.dispatch_count
                               - before)
        return out

    def admit(batch_size, **kw):
        got = admit_fn(batch_size, **kw)
        want = twin.admit(batch_size, **kw)
        if [r.rid for r in got] != [r.rid for r in want]:
            raise AssertionError(f"admission {admits[0]} differs from the "
                                 "numpy router's")
        admits[0] += 1
        return got
    router._index_hits, router.admit = index_hits, admit

    # prefill / decode steps timed (synchronised), the first wave recorded
    prefills, decodes, first = [], [], dict(logits=[], fed=[])
    prefill_fn, decode_fn = srv._prefill, srv._decode

    def timed_prefill(batch):
        sync(torch, dev)
        t = time.perf_counter()
        logits, cache = prefill_fn(batch)
        sync(torch, dev)
        ms = (time.perf_counter() - t) * 1e3
        b, s = batch["tokens"].shape
        cache_bytes = sum(c.numel() * c.element_size()
                          for c in cache.values())
        prefills.append((b, s, ms, lm_bound_ms(*lm_cost(
            cfg, b, s, 0, w_bytes, cache_bytes))))
        if srv.waves == 0:
            first["prompts"] = batch["tokens"]
            first["logits"].append(logits.float().cpu())
        return logits, cache

    def timed_decode(cache, tok, step):
        sync(torch, dev)
        t = time.perf_counter()
        logits, cache = decode_fn(cache, tok, step)
        sync(torch, dev)
        ms = (time.perf_counter() - t) * 1e3
        b = tok.shape[0]
        slots = min(step + 1, attn_slots(cache))
        decodes.append((ms, lm_bound_ms(*lm_cost(
            cfg, b, 1, slots, w_bytes,
            decode_cache_bytes(cfg, b, slots)[1]))))
        if srv.waves == 0:
            first["fed"].append(tok)
            first["logits"].append(logits.float().cpu())
        return logits, cache
    srv._prefill, srv._decode = timed_prefill, timed_decode

    fused_scan.launches = 0             # ---- the phase's serving run ----
    sync(torch, dev)
    t0 = time.perf_counter()
    results = srv.run_until_drained(max_waves=10 * n_requests)
    sync(torch, dev)
    drain_s = time.perf_counter() - t0
    launches = fused_scan.launches      # ---- read right after ----

    rids = [r.rid for r in results]
    if sorted(rids) != sorted(budgets) or len(router) or len(twin):
        raise AssertionError(f"{len(rids)} answers for {len(budgets)} "
                             f"requests ({len(router)} left pending)")
    for r in results:
        if r.tokens.size != budgets[r.rid]:
            raise AssertionError(f"request {r.rid}: {r.tokens.size} tokens "
                                 f"for a budget of {budgets[r.rid]}")
    if not waves_per_admit or any(w != 1 for w in waves_per_admit):
        raise AssertionError(f"plan dispatches per indexed admission: "
                             f"{sorted(set(waves_per_admit))}")
    if cuda and launches <= 0:
        raise AssertionError("the serving run launched no fused_scan kernel")

    # the first wave against one forward over prompt + fed tokens, as
    # served (bfloat16) and replayed at float32 activations; an MoE's
    # replay runs at a capacity that drops no pair (its prefill, decode
    # steps and forward keep different pairs at the config's)
    s0 = first["prompts"].shape[1]
    got = torch.cat(first["logits"], dim=1)
    want = first_wave_forward(torch, model, first)
    step_errs = (got - want).abs().amax(dim=(0, 2)).tolist()
    f32_got, f32_want = first_wave_f32(torch, model, first, no_drop(cfg))
    f32_errs = (f32_got - f32_want).abs().amax(dim=(0, 2)).tolist()
    replay = (f" at capacity factor {no_drop(cfg).capacity_factor:g} (no "
              f"pair dropped; served at {cfg.capacity_factor:g})"
              if cfg.n_experts else "")
    say("lm_serve", f"{cfg.name}: first wave, max |prefill/decode - "
        f"forward| by step: bfloat16 "
        f"{', '.join(f'{e:.4f}' for e in step_errs)}; float32 replay"
        f"{replay} {', '.join(f'{e:.2e}' for e in f32_errs)}")
    bf16_holds = bool(np.allclose(got.numpy(), want.numpy(), **LM_TOL))
    if arch in BF16_WAVE_GATED:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_TOL)
    np.testing.assert_allclose(f32_got.numpy(), f32_want.numpy(), **F32_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("the first wave's logits are not finite")
    wave_err, f32_err = max(step_errs), max(f32_errs)
    del want, got, f32_got, f32_want

    # where a step's time goes: the first wave's prefill and its decode
    # steps again, under torch.profiler
    prof = "not measured (no card)"
    if cuda:
        batch = {"tokens": first["prompts"]}
        p_pre = lm_profile(torch, lambda: model.prefill(
            batch, LM_SERVE["cache_len"]), 1)
        _, cache = model.prefill(batch, LM_SERVE["cache_len"])
        steps = iter(range(len(first["fed"])))

        def one_step():
            i = next(steps)
            model.decode_step(cache, first["fed"][i], s0 + i)
        # a few steps: a trace of thousands of kernels a step is slow to read
        p_dec = lm_profile(torch, one_step, min(PROFILED_STEPS,
                                                len(first["fed"])))
        del cache
        prof = "; ".join(
            f"{name}: {p[0]:.3f} ms wall, card busy {p[1]:.3f} ms "
            f"({100 * p[1] / p[0]:.1f}%), {p[2]:.0f} kernels a call; top: "
            f"{p[3]}" if p else f"{name}: no device time in the trace"
            for name, p in (("prefill", p_pre), ("decode step", p_dec)))

    toks = sum(r.tokens.size for r in results)
    st = router.stats()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    by_len = {}
    for b, s, ms, bnd in prefills:
        if b == LM_SERVE["batch_size"]:
            by_len.setdefault(s, []).append((ms, bnd))
    pre = "; ".join(
        f"{s} tokens: {np.median([m for m, _ in v]):.3f} ms (bound "
        f"{v[0][1][0]:.3f} by {v[0][1][1]}, {len(v)} waves)"
        for s, v in sorted(by_len.items()))
    dec_ms = float(np.median([m for m, _ in decodes]))
    dec_bound = float(np.median([bnd[0] for _, bnd in decodes]))
    dec_by = decodes[0][1][1]
    say("lm_serve", f"{cfg.name}: {n_requests} requests in {srv.waves} waves of "
        f"{LM_SERVE['batch_size']}: {toks:,} tokens in {drain_s:.2f} s "
        f"({toks / drain_s:.1f} tokens/s); prefill p50 by padded length "
        f"(batch {LM_SERVE['batch_size']}): {pre}; decode p50 {dec_ms:.3f} "
        f"ms/step over {len(decodes)} steps (bound p50 {dec_bound:.3f} by "
        f"{dec_by}); router admit p50 {st['admit_p50_ms']:.3f} ms, p99 "
        f"{st['admit_p99_ms']:.3f} ms over {admits[0]} admissions, "
        f"{st['rebuilds']:.0f} rebuilds, {len(waves_per_admit)} admissions "
        f"on a built index (one plan dispatch each); fused_scan launches "
        f"{launches}; peak device memory {peak / 2**30:.2f} GiB "
        f"({card_line})")
    say("lm_serve", f"{cfg.name}: profile of the first wave "
        f"(torch.profiler): {prof}")

    # reduced depth at full width: prefill of one 32-token prompt, card vs
    # CPU (an MoE at float32 activations, its routing choices compared)
    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    card, host = card_and_host(torch, cfg2, dev)
    prompt = torch.from_numpy(np.random.default_rng(LM_SEED + 2).integers(
        1, cfg.padded_vocab - 1, (1, 32)).astype(np.int32))
    tol, routes = (F32_TOL if cfg.n_experts else LM_TOL), {}
    with activations(torch.float32 if cfg.n_experts else None), \
            moe_routes(routes if cfg.n_experts else None):
        routes["at"] = "cpu"
        l_host, _ = host.prefill({"tokens": prompt}, LM_SERVE["cache_len"])
        routes["at"] = "card"
        l_card, _ = card.prefill({"tokens": prompt.to(dev)},
                                 LM_SERVE["cache_len"])
    np.testing.assert_allclose(l_card.float().cpu().numpy(),
                               l_host.float().numpy(), **tol)
    two_err = float((l_card.float().cpu() - l_host.float()).abs().max())
    two = (f"{depth}-layer full-width prefill card == CPU (max_abs_err "
           f"{two_err:.4f}); tolerance rtol 0.05 / atol 0.08")
    if cfg.n_experts:
        two = (f"{depth}-layer full-width prefill card == CPU at float32 "
               f"activations (max_abs_err {two_err:.2e}, rtol 1e-4 / atol "
               f"2e-4; top-2 expert sets differ for "
               f"{route_diffs(torch, routes)}); bfloat16 tolerance rtol "
               f"0.05 / atol 0.08")
    say("lm_serve", f"{cfg.name}: checks passed: {len(results)} requests "
        f"answered once with their budgets; {admits[0]} admissions == numpy "
        f"twin router; first wave ({first['prompts'].shape[0]} x {s0} "
        f"prompt, {len(first['logits'])} steps) prefill + decode == forward "
        f"at float32 (max_abs_err {f32_err:.2e}, rtol 1e-4 / atol 2e-4), "
        f"at bfloat16 max_abs_err {wave_err:.4f} ("
        f"{'held' if arch in BF16_WAVE_GATED else 'not held'} at the "
        f"bfloat16 bar, {'inside' if bf16_holds else 'outside'} it); {two}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, admits=admits[0],
                indexed=len(waves_per_admit))


def first_wave_forward(torch, model, first):
    """The logits one forward over the first wave's prompt + fed tokens
    gives at the positions the wave's prefill and decode steps predicted
    (float32, on the CPU)."""
    seq = torch.cat([first["prompts"]] + first["fed"], dim=1)
    s0 = first["prompts"].shape[1]
    with torch.no_grad():
        full, _ = model.forward({"tokens": seq})
    return full[:, s0 - 1:s0 - 1 + len(first["logits"])].float().cpu()


def first_wave_f32(torch, model, first, cfg):
    """The first wave replayed at float32 activations on the served
    (bfloat16) weights, the model reading ``cfg``: (its prefill + decode
    logits, the forward's at the same positions), both on the CPU.  It
    holds the caches, the recurrence and the SSD duality at full width
    and depth without bfloat16's rounding, which compounds over a deep
    stack."""
    keep = model.cfg
    model.cfg = cfg
    try:
        with activations(torch.float32):
            s0 = first["prompts"].shape[1]
            logits, cache = model.prefill({"tokens": first["prompts"]},
                                          LM_SERVE["cache_len"])
            outs = [logits.float().cpu()]
            for i, tok in enumerate(first["fed"]):
                logits, cache = model.decode_step(cache, tok, s0 + i)
                outs.append(logits.float().cpu())
            del cache
            return (torch.cat(outs, dim=1),
                    first_wave_forward(torch, model, first))
    finally:
        model.cfg = keep


def no_drop(cfg):
    """``cfg`` at a capacity that drops no pair (``n_experts / top_k``:
    an expert takes every token of a row); ``cfg`` itself without
    experts."""
    if not cfg.n_experts:
        return cfg
    import dataclasses
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


@contextlib.contextmanager
def activations(dtype):
    """The models' activation dtype set to ``dtype`` (None: unchanged)
    for the block."""
    import repro_torch.models.common as common
    keep = common.DTYPE
    common.DTYPE = keep if dtype is None else dtype
    try:
        yield
    finally:
        common.DTYPE = keep


@contextlib.contextmanager
def moe_routes(routes):
    """With a dict: each MoE routing choice made in the block, its expert
    ids (B, S, k) on the CPU, kept under ``routes[routes["at"]]``."""
    if routes is None:
        yield
        return
    import repro_torch.models.moe as moe
    route = moe.route

    def recording(router, x, top_k):
        out = route(router, x, top_k)
        routes.setdefault(routes["at"], []).append(out[2].cpu())
        return out
    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def route_diffs(torch, routes):
    """"n of m tokens' routing choices" between the card's and the CPU's
    recorded expert ids (each token's top-k as a set)."""
    pairs = list(zip(routes["card"], routes["cpu"]))
    if len(pairs) != len(routes["cpu"]) or not pairs:
        raise AssertionError("the card and the CPU routed a different "
                             "number of times")
    diff = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in pairs)
    return f"{diff} of {sum(a[..., 0].numel() for a, _ in pairs)} choices"


def card_and_host(torch, cfg, dev):
    """(a model of ``cfg`` on ``dev``, the same weights on the CPU), cast
    once to bfloat16: seeded on ``dev``, where init is fast, and copied to
    the host without allocating float32 masters there."""
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_params, make_generator
    card = cast_params(build_model(cfg, device=dev).init(
        make_generator(LM_SEED + 1, dev)))
    host = build_model(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                         assign=True)
    return card, host


def release_lm(torch, phase="lm_serve", limit=1 << 30):
    """After an LM phase returns: collect the model, server and step
    closures it left in reference cycles, return the memory to the card,
    and start the next phase's peak count afresh; fails if more than
    ``limit`` bytes are still allocated (the model was kept)."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left > limit:
        raise AssertionError(f"{left / 2**30:.2f} GiB still allocated after "
                             f"the {phase} phase: the model was not freed")
    torch.cuda.reset_peak_memory_stats()
    say(phase, f"model freed: {left / 2**20:.1f} MiB still allocated")


# the lm_steps phase: the vlm and the enc-dec, which the serve loop cannot
# serve (it hands prefill the tokens alone), driven as the reference's dry
# run drives them, through runtime/steps.py, at full width and depth
LM_STEPS_ARCHS = ("qwen2-vl-2b", "seamless-m4t-large-v2")
LM_STEPS = {
    # the config's 1,024 stub patch embeddings + 128 text tokens; a cache
    # of 1,280 holds the prompt and the 16 decode steps
    "qwen2-vl-2b": dict(batch=8, stub=1024, text=128, cache_len=1280,
                        steps=16),
    # 1,024 stub frames and a 1-token decoder prompt (the reference's
    # prefill ``input_specs``)
    "seamless-m4t-large-v2": dict(batch=8, stub=1024, text=1, cache_len=512,
                                  steps=32),
}
LM_STEPS_REHEARSE = dict(batch=2, stub=16, text=8, cache_len=64, steps=4)
# the vlm runs at an attention chunk of 128: the chunked attention (the
# reference's and the port's) takes a sequence that is a multiple of its
# chunk, and the config's 1,024 does not divide 1,024 + 128 = 1,152
VLM_CHUNK = 128


def lm_steps_phase(torch, dev, card_line, arch):
    """The vlm or the enc-dec on the card through ``runtime.steps``'s
    ``make_prefill_step`` and ``make_serve_step`` (the serve loop passes
    no patches or frames, as in the reference; so this phase runs no COAX
    path): ``build_model`` at full width and depth (2 layers at width 64
    in the rehearsal), float32 masters from a seeded generator cast once
    to bfloat16; seeded stub inputs (``LM_STEPS``); one prefill and greedy
    decode steps, each timed against its ``lm_cost`` bound.  Checks:
    finite logits; the prefill + decode logits replayed at float32
    activations against one forward over the prompt + fed tokens (rtol
    1e-4 / atol 2e-4); a 2-layer (enc-dec 2 + 2) full-width prefill on
    the card against the CPU at rtol 0.05 / atol 0.08.  ``release_lm``
    frees the model after it returns."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_params, make_generator, unembed
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    t_phase = time.perf_counter()
    cuda = dev != "cpu"
    cfg = get_config(arch)
    run = LM_STEPS[arch] if cuda else LM_STEPS_REHEARSE
    vlm = cfg.family == "vlm"
    if not cuda:
        cfg = reduced(cfg, 2, 64)
        if vlm:                 # M-RoPE's sections split a head of 16
            cfg = dataclasses.replace(cfg, head_dim=16,
                                      mrope_sections=(2, 3, 3))
    if vlm:
        cfg = dataclasses.replace(cfg, attn_chunk=VLM_CHUNK)
    b, text, steps, cache_len = (run["batch"], run["text"], run["steps"],
                                 run["cache_len"])
    n_stub = cfg.n_patches if vlm else run["stub"]
    key, enc_len = ("patches", 0) if vlm else ("frames", n_stub)
    s_total = text + (n_stub if vlm else 0)     # the prompt's positions
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(torch, dev)
    t0 = time.perf_counter()
    model = cast_params(build_model(cfg, device=dev).init(
        make_generator(LM_SEED, dev)))
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    # a decode step reads the decoder's weights alone
    dec_w_bytes = w_bytes - sum(
        p.numel() * p.element_size() for n, p in model.named_parameters()
        if n.startswith("enc_"))
    init_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
             f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}")
    shape += (f", M-RoPE sections {cfg.mrope_sections}, attention chunk "
              f"{cfg.attn_chunk}" if vlm else
              f" (decoder) + {cfg.enc_layers} encoder layers")
    say("lm_steps", f"{cfg.name}: {shape}; {model.param_count():,} "
        f"parameters, weights {w_bytes / 1e9:.3f} GB; init {init_s:.2f} s "
        f"(peak {init_peak / 2**30:.2f} GiB); {b} x ({n_stub} stub {key} "
        f"+ {text} tokens), cache {cache_len}, {steps} greedy steps; "
        f"through make_prefill_step / make_serve_step, no COAX path "
        f"({card_line})")

    rng = np.random.default_rng(LM_SEED)
    batch = {key: rng.normal(0, 1, (b, n_stub, cfg.d_model)).astype(
                 np.float32),
             "tokens": rng.integers(1, cfg.padded_vocab - 1, (b, text))
             .astype(np.int32)}
    prefill, serve = make_prefill_step(model, cache_len), make_serve_step(model)
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    sync(torch, dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    pre_bound = lm_bound_ms(*lm_cost(cfg, b, s_total, 0, w_bytes,
                                     cache_bytes, enc_len))
    outs, fed, decodes = [logits.float().cpu()], [], []
    for i in range(steps):
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        step = s_total + i
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache = serve(cache, tok, step)
        sync(torch, dev)
        decodes.append(((time.perf_counter() - t0) * 1e3, lm_bound_ms(
            *lm_cost(cfg, b, 1, step + 1, dec_w_bytes,
                     decode_cache_bytes(cfg, b, step + 1, enc_len)[1],
                     enc_len))))
        fed.append(tok)
        outs.append(logits.float().cpu())
    del cache
    got = torch.cat(outs, dim=1)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: logits are not finite")

    # prefill + decode replayed at float32 activations, against one forward
    # over the prompt and the fed tokens (the vlm's in one attention chunk)
    with activations(torch.float32):
        logits, cache = prefill(batch)
        rep = [logits.float().cpu()]
        for i, tok in enumerate(fed):
            logits, cache = serve(cache, tok, s_total + i)
            rep.append(logits.float().cpu())
        del cache
        full = {key: torch.from_numpy(batch[key]).to(dev),
                "tokens": torch.cat([torch.from_numpy(batch["tokens"]).to(
                    dev)] + fed, dim=1)}
        with torch.no_grad():
            hidden, _ = model.forward(
                full, chunk=s_total + steps if vlm else None,
                logits_slice="hidden")
            want = unembed(model.embed, hidden[:, s_total - 1:],
                           cap=cfg.final_softcap).cpu()   # both tie
        rep = torch.cat(rep, dim=1)
        del hidden
    f32_err = float((rep - want).abs().max())
    bf16_err = float((got - want).abs().max())
    np.testing.assert_allclose(rep.numpy(), want.numpy(), **F32_TOL)
    del rep, want, got

    prof = "not measured (no card)"
    if cuda:
        p_pre = lm_profile(torch, lambda: prefill(batch), 1)
        _, cache = prefill(batch)
        i_step = iter(range(len(fed)))

        def one_step():
            i = next(i_step)
            serve(cache, fed[i], s_total + i)
        p_dec = lm_profile(torch, one_step, min(PROFILED_STEPS, len(fed)))
        del cache
        prof = "; ".join(
            f"{name}: {p[0]:.3f} ms wall, card busy {p[1]:.3f} ms "
            f"({100 * p[1] / p[0]:.1f}%), {p[2]:.0f} kernels a call; top: "
            f"{p[3]}" if p else f"{name}: no device time in the trace"
            for name, p in (("prefill", p_pre), ("decode step", p_dec)))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dec_ms = float(np.median([m for m, _ in decodes]))
    dec_bound = float(np.median([bnd[0] for _, bnd in decodes]))
    dec_s = sum(m for m, _ in decodes) / 1e3
    say("lm_steps", f"{cfg.name}: prefill {pre_ms:.3f} ms (bound "
        f"{pre_bound[0]:.3f} by {pre_bound[1]}); decode p50 {dec_ms:.3f} "
        f"ms/step over {steps} steps (bound p50 {dec_bound:.3f} by "
        f"{decodes[0][1][1]}), {b * steps / dec_s:.1f} tokens/s; peak "
        f"device memory {peak / 2**30:.2f} GiB; profile: {prof} "
        f"({card_line})")

    # 2 layers (the enc-dec 2 + 2) at full width: one prompt, card vs CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2,
                               enc_layers=2 if enc_len else 0)
    card, host = card_and_host(torch, cfg2, dev)
    one = {k: torch.from_numpy(v[:1]) for k, v in batch.items()}
    l_host, _ = host.prefill(one, cache_len)
    l_card, _ = card.prefill({k: v.to(dev) for k, v in one.items()},
                             cache_len)
    np.testing.assert_allclose(l_card.float().cpu().numpy(),
                               l_host.float().numpy(), **LM_TOL)
    two_err = float((l_card.float().cpu() - l_host.float()).abs().max())
    say("lm_steps", f"{cfg.name}: checks passed: logits finite; prefill + "
        f"{steps} decode steps == forward at float32 activations "
        f"(max_abs_err {f32_err:.2e}, rtol 1e-4 / atol 2e-4; as served at "
        f"bfloat16 {bf16_err:.4f}, not held); 2-layer"
        f"{' (+ 2 encoder)' if enc_len else ''} full-width prefill card == "
        f"CPU (max_abs_err {two_err:.4f}, rtol 0.05 / atol 0.08); phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# the lm_train phase: the training launcher's sizes (50,000-doc corpus,
# its curation query, batch 8 x seq 256, lr 1e-3), 8 steps at full width
# and depth; the card-vs-CPU twin's batch; the launchers' round trip
LM_TRAIN = dict(docs=50_000, batch=8, seq=256, steps=8, lr=1e-3)
# the rehearsal's batch: a CPU step over 8 x 256 tokens at width 64 takes
# ~1 s (the softmax over the vocabulary), and the rehearsal trains five
# models and the launcher
LM_TRAIN_REHEARSE = dict(batch=2, seq=64)
# the training launcher's default arch (src/repro/launch/train.py:45)
LAUNCH_ARCH = "mamba2-130m"
# the twin's AdamW eps: the first update g / (|g| + eps) multiplies a
# gradient difference by up to 1 / (4 eps); at the default 1e-8 the two
# devices' float32 GEMM orders (gradients equal to ~1e-6) moved 80 of the
# 122,880,000 embedding entries by up to 1.1e-4 (PERF.md, PR 18);
# 1e-3 bounds the factor at 250
TWIN_BATCH, TWIN_EPS = 2, 1e-3
TWIN_TOL = {"float32": (dict(rtol=1e-4, atol=0.0), dict(rtol=0.0, atol=1e-5)),
            "bfloat16": (LM_TOL, dict(rtol=0.0, atol=LM_TOL["atol"]))}
# the MoE, the vlm and the enc-dec trained at full width beside h2o, on the
# same curated docs and batch (8 x 256 tokens), for NEW_TRAIN_STEPS steps
# (4, not 6, for the smoke's time limit: PERF.md §4)
LM_TRAIN_ARCHS = ("mixtral-8x7b", "qwen2-vl-2b", "seamless-m4t-large-v2")
NEW_TRAIN_STEPS = 4
# archs trained at a cut depth: mixtral-8x7b's tied embeddings and 2 of its
# 32 layers hold 3.03B parameters, 48.5 GB of training state at 16 bytes a
# parameter (float32 masters, gradients, mu, nu); 3 layers' 4.48B (71.8 GB)
# leave no room for the activations on an 80 GB card
TRAIN_DEPTH = {"mixtral-8x7b": 2}
TRAIN_DEPTH_CUT = {"mixtral-8x7b": "the training state of 3 layers, 71.8 GB "
                                   "at 16 bytes a parameter, leaves no room "
                                   "on one card"}
# the enc-dec's stub frames a sequence (the vlm's patches are its config's
# n_patches, 1,024), as lm_steps feeds them
TRAIN_FRAMES = 1024
# the twins also run at bfloat16 activations where the smoke's time limit
# allows: the CPU's bfloat16 steps of qwen2-vl-2b and seamless-m4t-large-v2
# took 21.8 and 16.8 s (both inside the bar), mixtral's would take minutes
# (PERF.md §4); tests/test_torch_cuda.py runs the first two on the card
BF16_TWINS = (LM_ARCH, LAUNCH_ARCH)


def train_config(arch, cuda, layers=None):
    """``arch``'s config as ``lm_train`` runs it: at full width, ``layers``
    deep (default ``TRAIN_DEPTH``'s, else the config's; the enc-dec's
    encoder as deep as its decoder); in the rehearsal 2 layers at width 64
    (the vlm's heads of 16 split by M-RoPE as in ``lm_steps``).  The vlm
    runs at the attention chunk that divides its patches + the loader's
    text (the chunked attention takes a multiple of its chunk: 128 of
    1,024 + 256 on the card)."""
    import dataclasses
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced
    cfg = get_config(arch)
    layers = layers or TRAIN_DEPTH.get(arch)
    if not cuda:
        cfg = reduced(cfg, 2, 64)
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, head_dim=16,
                                      mrope_sections=(2, 3, 3))
    elif layers:
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  enc_layers=layers if cfg.enc_layers else 0)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, attn_chunk=math.gcd(
            VLM_CHUNK, cfg.n_patches + train_size(cuda)[1]))
    return cfg


def train_size(cuda):
    """(batch, text tokens a sequence) of the lm_train phase's runs."""
    size = LM_TRAIN if cuda else LM_TRAIN_REHEARSE
    return size["batch"], size["seq"]


def stub_len(cfg, cuda):
    """Stub positions a sequence of ``cfg``'s batches carries beside its
    text: the vlm's patches, the enc-dec's frames (16 in the rehearsal),
    else 0."""
    if cfg.family == "vlm":
        return cfg.n_patches
    if cfg.family == "encdec":
        return TRAIN_FRAMES if cuda else 16
    return 0


def batch_label(cfg, b, s, n_stub):
    """"b x s", or with ``n_stub`` stub positions "b x (n stub patches +
    s tokens)" (frames for the enc-dec)."""
    if not n_stub:
        return f"{b} x {s}"
    kind = "patches" if cfg.family == "vlm" else "frames"
    return f"{b} x ({n_stub} stub {kind} + {s} tokens)"


def with_stubs(torch, batches, model, n_stub, seed):
    """Each batch of ``batches`` (the loader's ``tokens`` and ``labels``)
    with the stub inputs ``model``'s family reads beside them: the vlm's
    ``patches`` (its ``n_patches``), the enc-dec's ``frames`` (``n_stub``
    a sequence), standard normal draws of a CPU generator seeded with
    ``seed``, in the shape and dtype ``Model.input_specs`` gives a train
    cell (the enc-dec's at ``n_stub`` positions); other families' batches
    pass as they are."""
    from repro_torch.configs.base import ShapeConfig
    cfg = model.cfg
    gen = torch.Generator().manual_seed(seed)
    for batch in batches:
        if cfg.family not in ("vlm", "encdec"):
            yield batch
            continue
        b, s = batch["tokens"].shape
        seq = cfg.n_patches + s if cfg.family == "vlm" else n_stub
        specs = model.input_specs(ShapeConfig("stubs", seq, b, "train"),
                                  device="meta")
        stubs = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                 for k, v in specs.items() if k in ("patches", "frames")}
        yield {**stubs, **batch}


def lm_train_phase(torch, dev, card_line):
    """The LM training path on the card, in four parts.

    1. Curation: ``make_corpus(50_000)`` and a ``CuratedSelector`` on the
       device backend; the launcher's query (``token_len`` in [128,
       32768), quality >= 0.5) is one ``fused_scan`` wave, equal to a
       numpy-backend twin selector and to the full scan; launches counted
       around the select.
    2. ``train()`` of h2o-danube-3-4b at full width and depth (float32
       masters, remat) for 8 steps over a ``ShardedLoader`` of the curated
       docs at 8 x 256, no checkpoints: every loss and grad norm finite,
       grad norms > 0, every parameter moved; step ms, tokens/s, the
       bound (``train_bound_ms``), the model-FLOP share, AdamW ms (CUDA
       events), peak memory against the state reckoning, and one more
       step under torch.profiler (the card's busy share).  Then the same
       for 4 steps (``NEW_TRAIN_STEPS``) of mixtral-8x7b at 2 of its 32
       layers (``TRAIN_DEPTH``; capacity factor 1.25), qwen2-vl-2b and
       seamless-m4t-large-v2 at full width and depth, the vlm's and the
       enc-dec's batches carrying seeded stub patches / frames
       (``with_stubs``); every expert of every MoE layer, and each
       router column, must see a gradient.
    3. One train step of a 2-layer (the enc-dec 2 + 2) full-width model
       (h2o-danube-3-4b, the launcher's default mamba2-130m, and the
       three above; the MoE at a capacity that drops no pair, its routing
       choices on the two devices compared) on the card and on the CPU
       from the same weights and batch (AdamW eps ``TWIN_EPS``): float32
       activations within rtol 1e-4 (loss, grad norm) / atol 1e-5
       (parameters), bfloat16 (``BF16_TWINS``) within rtol 0.05 / atol
       0.08.
    4. The launchers at their defaults (``launchers``): mamba2-130m at
       full size trained with ``--curate`` to step 20 (checkpoints every
       10 under ``build/train_smoke``), again to 30 (resumes at 20), then
       served with ``--reduced-layers 0 --ckpt-dir`` from step 30 (checked
       equal to the checkpoint's arrays); step ms, tokens/s, checkpoint
       save and restore seconds; the directory is removed even on
       failure.

    The rehearsal runs the same at 2 layers and width 64 on the CPU, over
    ``LM_TRAIN_REHEARSE``'s batches of 2 x 64 tokens."""
    from repro_torch.data.curation import CuratedSelector, MetaQuery
    from repro_torch.data.pipeline import ShardedLoader, make_corpus
    from repro_torch.kernels import fused_scan
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cuda = dev != "cpu"
    cfg = train_config(LM_ARCH, cuda)
    s = train_size(cuda)[1]

    # ---- 1. curation on the card ----
    corpus = make_corpus(LM_TRAIN["docs"],
                         vocab_size=min(cfg.padded_vocab, 32_000))
    sel = CuratedSelector(corpus, device=dev)
    twin = CuratedSelector(corpus, backend="numpy")
    query = MetaQuery(token_len=(s // 2, 32768), quality=(0.5, 1.1))
    sel.select(query)                   # the plan's first wave (and build)
    fused_scan.launches = 0             # ---- the curation run ----
    sync(torch, dev)
    t0 = time.perf_counter()
    docs = sel.select(query)
    sync(torch, dev)
    select_ms = (time.perf_counter() - t0) * 1e3
    cur_launches = fused_scan.launches  # ---- read right after ----
    if not (np.array_equal(docs, twin.select(query))
            and np.array_equal(docs, sel.select_reference(query))):
        raise AssertionError("the curated selection differs from the numpy "
                             "selector's or the full scan's")
    if cuda and cur_launches <= 0:
        raise AssertionError("curation launched no fused_scan kernel")
    say("lm_train", f"curation: {docs.size:,} of {LM_TRAIN['docs']:,} docs "
        f"(== numpy twin == full scan); index build {sel.build_time:.2f} s, "
        f"select {select_ms:.3f} ms, fused_scan launches {cur_launches}")
    del sel, twin

    # ---- 2. full width: h2o at full depth, the MoE, vlm and enc-dec ----
    for arch in (LM_ARCH,) + LM_TRAIN_ARCHS:
        steps = LM_TRAIN["steps"] if arch == LM_ARCH else NEW_TRAIN_STEPS
        say("lm_train", train_full(torch, dev, train_config(arch, cuda),
                                   corpus, docs, card_line, steps))
        if cuda:
            release_lm(torch, "lm_train")

    # ---- 3. card against the CPU, 2 layers at full width ----
    loader = ShardedLoader(corpus, batch_size=TWIN_BATCH, seq_len=s,
                           doc_ids=docs, seed=1)
    tokens = next(iter(loader))
    loader.close()
    for arch in (LM_ARCH, LAUNCH_ARCH) + LM_TRAIN_ARCHS:
        t_twin = time.perf_counter()
        cfg2 = no_drop(train_config(arch, cuda, layers=2))
        errs, weights = [], twin_weights(torch, cfg2, dev)
        batch = next(with_stubs(torch, iter([tokens]),
                                build_model(cfg2, device="meta"),
                                stub_len(cfg2, cuda), LM_SEED))
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16" and arch not in BF16_TWINS:
                errs.append("bfloat16: not run (the smoke's time limit)")
                continue
            routes = {} if cfg2.n_experts else None
            with moe_routes(routes):
                if routes is not None:
                    routes["at"] = "card"
                t0 = time.perf_counter()
                got, p_got = train_twin(torch, cfg2, batch, dev, dtype,
                                        weights)
                if routes is not None:
                    routes["at"] = "cpu"
                t1 = time.perf_counter()
                want, p_want = train_twin(torch, cfg2, batch, "cpu", dtype,
                                          weights)
                t2 = time.perf_counter()
            tol, ptol = TWIN_TOL[dtype]
            for k in want:
                np.testing.assert_allclose(got[k], want[k],
                                           err_msg=f"{arch} {k}", **tol)
            err = params_close(torch, p_got, p_want, ptol, arch)
            secs = (f"{t1 - t0:.1f} s on the card, {t2 - t1:.1f} s on the "
                    f"CPU, {time.perf_counter() - t2:.1f} s to compare")
            diff = (f", top-{cfg2.top_k} expert sets differ for "
                    f"{route_diffs(torch, routes)}" if routes else "")
            errs.append(f"{dtype}: loss {got['loss']:.6f} vs "
                        f"{want['loss']:.6f}, grad norm "
                        f"{got['grad_norm']:.6f} vs {want['grad_norm']:.6f}, "
                        f"parameters max_abs_err {err:.3g}{diff} ({secs})")
            del p_got, p_want
        del weights, batch
        inputs = batch_label(cfg2, TWIN_BATCH, s, stub_len(cfg2, cuda))
        layers = (f"{cfg2.n_layers} + {cfg2.enc_layers}-layer"
                  if cfg2.enc_layers else f"{cfg2.n_layers}-layer")
        moe = (f", capacity factor {cfg2.capacity_factor:g} (no pair "
               f"dropped)" if cfg2.n_experts else "")
        say("lm_train", f"{arch}: {layers} train step at d_model "
            f"{cfg2.d_model} ({inputs}, AdamW eps {TWIN_EPS}{moe}), {dev} vs "
            f"CPU ({torch.get_num_threads()} threads): {'; '.join(errs)}; "
            f"{time.perf_counter() - t_twin:.1f} s")

    # ---- 4. the launchers: train, resume, serve ----
    launchers(torch, dev, cuda, card_line)
    say("lm_train", f"phase {time.perf_counter() - t_phase:.1f} s")


def twin_weights(torch, cfg, dev):
    """Seeded float32 weights of ``cfg`` as a CPU state dict, drawn on
    ``dev`` (init on the card is fast; on the host a full-width embedding
    table takes tens of seconds), for every ``train_twin`` of ``cfg``."""
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator
    model = build_model(cfg, device=dev).init(make_generator(LM_SEED, dev))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def params_close(torch, got, want, tol, what):
    """Each parameter of ``got`` (on its device) against ``want``'s (on
    the CPU) as ``np.testing.assert_allclose`` holds them, |got - want|
    <= atol + rtol·|want| element by element (a NaN or an inf fails),
    computed on ``got``'s device (numpy's check over a full-width MoE's
    billions of values takes minutes on the host); returns the largest
    |got - want|."""
    err = 0.0
    for n, w in want.items():
        g = got[n]
        w = w.to(g.device)
        diff = (g - w).abs()
        bad = ~(diff <= tol["atol"] + tol["rtol"] * w.abs())
        if bool(bad.any()):
            raise AssertionError(
                f"{what} {n}: {int(bad.sum())} of {g.numel()} values beyond "
                f"rtol {tol['rtol']} / atol {tol['atol']} (max |diff| "
                f"{float(diff.max()):.3g})")
        err = max(err, float(diff.max()))
    return err


def train_twin(torch, cfg, batch, dev, dtype, weights):
    """One ``make_train_step`` step of ``cfg`` on ``dev`` at activation
    dtype ``dtype``, from ``weights`` (``twin_weights``): (loss and grad
    norm as floats, the updated parameters, on ``dev``: a full-width
    MoE's are too large to copy to the host beside the CPU's step)."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    with activations(getattr(torch, dtype)):
        model = build_model(cfg, device=dev)
        model.load_state_dict(weights)
        state = adamw_init(model)
        m = make_train_step(model, AdamWConfig(lr=LM_TRAIN["lr"],
                                               eps=TWIN_EPS))(state, batch)
        out = {k: float(m[k]) for k in ("loss", "grad_norm")}
        params = {n: p.detach() for n, p in model.named_parameters()}
    return out, params


def train_full(torch, dev, cfg, corpus, docs, card_line, n_steps):
    """``train()`` for ``n_steps`` steps of ``cfg`` at its width and depth
    (the vlm's and the enc-dec's batches with their stubs); returns the
    line to print.  The model, the AdamW state and the loader are gone
    when it returns."""
    import repro_torch.runtime.steps as steps
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, train
    t_run = time.perf_counter()
    cuda = dev != "cpu"
    b, s = train_size(cuda)
    n_stub = stub_len(cfg, cuda)
    model = build_model(cfg, device=dev)
    n_params = model.param_count()
    state_gib = 16 * n_params / 2**30          # masters, grads, mu, nu
    samples, seen = {}, {}
    init = model.init

    def init_and_sample(generator):             # train() inits the model
        init(generator)
        for n, p in model.named_parameters():
            samples[n] = expert_rows(cfg, n, p).clone()
        return model
    model.init = init_and_sample

    opt_events, update = [], steps.adamw_update

    def timed_update(params, grads, *a, **k):
        for n, g in grads.items():          # which experts saw a gradient
            got = grad_seen(torch, cfg, n, g)
            seen[n] = got if n not in seen else seen[n] | got
        if not cuda:
            return update(params, grads, *a, **k)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = update(params, grads, *a, **k)
        e1.record()
        opt_events.append((e0, e1))
        return out
    loader = ShardedLoader(corpus, batch_size=b, seq_len=s, doc_ids=docs)
    it = with_stubs(torch, iter(loader), model, n_stub, LM_SEED)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps.adamw_update = timed_update
    logs = []
    t_train = time.perf_counter()
    try:
        out = train(model, it, AdamWConfig(lr=LM_TRAIN["lr"]),
                    TrainLoopConfig(steps=n_steps, ckpt_dir=None,
                                    log_every=1), log_fn=logs.append)
    finally:
        steps.adamw_update = update
    sync(torch, dev)
    train_s = time.perf_counter() - t_train
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if (len(hist) != n_steps or out["restarts"]
            or not np.isfinite(losses + norms).all() or min(norms) <= 0):
        raise AssertionError(f"training went wrong: {logs}")
    still = [n for n, p in model.named_parameters()
             if (expert_rows(cfg, n, p) == samples[n]).all(-1).any()]
    if still:
        raise AssertionError(f"parameters (or experts) that did not move: "
                             f"{still[:5]}")
    blind = [n for n, v in seen.items() if not bool(v.all())]
    if blind:
        raise AssertionError(f"parameters (or experts, or router columns) "
                             f"that never saw a gradient: {blind[:5]}")
    step_ms = [h["dt"] * 1e3 for h in hist[1:]]
    p50 = float(np.median(step_ms))
    opt_ms = [e0.elapsed_time(e1) for e0, e1 in opt_events]
    tokens = b * s
    bound, flop_ms, adam_ms = train_bound_ms(model, b, s, n_stub)

    prof = "not measured (no card)"
    t_prof = time.perf_counter()
    if cuda:
        step_fn = steps.make_train_step(model, AdamWConfig(lr=LM_TRAIN["lr"]))
        batch = next(it)
        p = lm_profile(torch, lambda: step_fn(out["opt_state"], batch), 1)
        prof = (f"{p[0]:.1f} ms wall, card busy {p[1]:.1f} ms "
                f"({100 * p[1] / p[0]:.1f}%), {p[2]:.0f} kernels; top: {p[3]}"
                if p else "no device time in the trace")
        del step_fn, batch
    prof_s = time.perf_counter() - t_prof
    loader.close()
    del out, model, samples, seen, it
    full = get_config(cfg.name).n_layers
    cut = (f" of {full}, {TRAIN_DEPTH_CUT[cfg.name]}"
           if cuda and cfg.n_layers != full else "")
    shape = f"{cfg.n_layers} layers{cut}"
    if cfg.enc_layers:
        shape += f" + {cfg.enc_layers} encoder layers"
    if cfg.n_experts:
        shape += (f", {cfg.n_experts} experts top-{cfg.top_k} at capacity "
                  f"factor {cfg.capacity_factor:g}")
    inputs = batch_label(cfg, b, s, n_stub)
    if cfg.family == "vlm":
        shape += f", attention chunk {cfg.attn_chunk}"
    return (f"{cfg.name} ({shape}, d_model {cfg.d_model}, {n_params:,} "
            f"parameters, float32 masters, remat {cfg.remat!r}), {n_steps} "
            f"steps of {inputs} on the curated docs: loss {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}, grad norm {norms[0]:.4f} -> "
            f"{norms[-1]:.4f}, every parameter moved and saw a gradient"
            f"{' (each expert and router column too)' if cfg.n_experts else ''}"
            f"; step p50 {p50:.1f} ms, max "
            f"{max(step_ms):.1f} ms (steps 1-{len(hist) - 1}; the first "
            f"{hist[0]['dt'] * 1e3:.1f} ms); {tokens / p50 * 1e3:.0f} text "
            f"tokens/s; bound {bound:.1f} ms ({bound_terms(cfg)} "
            f"{flop_ms:.1f} ms at 989 TFLOP/s + AdamW {adam_ms:.1f} ms at "
            f"3.35 TB/s), model-FLOP share {100 * flop_ms / p50:.1f}%; AdamW "
            f"update "
            + (f"p50 {np.median(opt_ms):.1f} ms, max {max(opt_ms):.1f} ms "
               f"(CUDA events)" if opt_ms else "not measured (no card)")
            + f"; peak device memory {peak / 2**30:.2f} GiB against the "
            f"state's {state_gib:.2f} GiB (16 bytes a parameter); one step "
            f"profiled: {prof}; train() {train_s:.1f} s, the profiled step "
            f"{prof_s:.1f} s, {time.perf_counter() - t_run:.1f} s in all "
            f"({card_line})")


def expert_rows(cfg, name, p):
    """The first 4,096 values of parameter ``p`` as one row, or, for an
    MoE expert stack (E, ., .), the first 4,096 of each expert's matrix, a
    row an expert (detached)."""
    leaf = name.rsplit(".", 1)[-1]
    if cfg.n_experts and leaf in ("w_in", "w_gate", "w_out") and p.ndim == 3:
        return p.detach().flatten(1)[:, :4096]
    return p.detach().flatten()[None, :4096]


def grad_seen(torch, cfg, name, g):
    """Whether gradient ``g`` of parameter ``name`` is non-zero anywhere:
    one flag, or for an MoE one an expert (each expert's matrix of an
    expert stack, each router column)."""
    leaf = name.rsplit(".", 1)[-1]
    inf = float("inf")
    if cfg.n_experts and leaf in ("w_in", "w_gate", "w_out") and g.ndim == 3:
        return torch.linalg.vector_norm(g.flatten(1), inf, dim=1) > 0
    if cfg.n_experts and leaf == "router":
        return torch.linalg.vector_norm(g, inf, dim=0) > 0
    return torch.linalg.vector_norm(g, inf) > 0


def launchers(torch, dev, cuda, card_line):
    """The training launcher at its defaults (mamba2-130m, full size, 8 x
    256, lr 1e-3, ``--curate``) to step 20, resumed to 30, then the
    serving launcher restoring step 30 from the same directory at full
    size (2 layers at width 64 and ``LM_TRAIN_REHEARSE``'s batch in the
    rehearsal).  Checkpoint saves (the
    device-to-host copy, then the npz write on the saver's thread) and
    restores are timed by wrapping ``Checkpointer``'s methods."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.runtime.checkpoint import Checkpointer, latest_step
    directory = ROOT / "build" / "train_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    size = (["--reduced-layers", "0"] if cuda
            else ["--reduced-layers", "2", "--reduced-width", "64"])
    common = ["--arch", LAUNCH_ARCH, "--device", dev]
    b, s = train_size(cuda)
    args = common + ["--curate", "--ckpt-every", "10", "--ckpt-dir",
                     str(directory)] + ([] if cuda else size + [
                         "--batch", str(b), "--seq", str(s)])
    timings = {"_host_flat": [], "_write": [], "restore": []}
    methods = {name: Checkpointer.__dict__[name] for name in timings}

    def timed(name):
        fn = getattr(Checkpointer, name)

        def wrapper(*a, **k):
            sync(torch, dev)
            t = time.perf_counter()
            out = fn(*a, **k)
            sync(torch, dev)
            timings[name].append(time.perf_counter() - t)
            return out
        if isinstance(methods[name], staticmethod):
            return staticmethod(wrapper)
        return wrapper
    try:
        for name in timings:
            setattr(Checkpointer, name, timed(name))
        t0 = time.perf_counter()
        first = train_launch.main(args + ["--steps", "20"])
        second = train_launch.main(args + ["--steps", "30"])
        train_s = time.perf_counter() - t0
        if (first["final_step"] != 20 or second["final_step"] != 30
                or second["history"][0]["step"] != 20
                or latest_step(directory) != 30):
            raise AssertionError("the training launcher did not resume at "
                                 "step 20 and stop at 30")
        hist = first["history"] + second["history"]
        losses = [h["loss"] for h in hist]
        if not np.isfinite(losses).all():
            raise AssertionError(f"launcher losses not finite: {losses}")
        n_params = sum(p.numel() for p in first["params"].values())
        del first["params"], first["opt_state"]
        del second["params"], second["opt_state"]
        ck_bytes = (directory / "step_00000030" / "arrays.npz").stat().st_size
        srv = serve_launch.main(
            ["--arch", LAUNCH_ARCH, "--device", dev, "--ckpt-dir",
             str(directory), "--requests", "16"] + size)
        with np.load(directory / "step_00000030" / "arrays.npz") as z:
            for name, p in srv.model.named_parameters():
                parts = name.split(".")
                if parts[0] in ("layers", "shared"):
                    key = "//".join(["params", parts[0]] + parts[2:])
                    want = z[key][int(parts[1])]
                else:
                    key = "//".join(["params"] + parts)
                    want = z[key]
                want = torch.from_numpy(want).to(p.dtype)
                if not torch.equal(p.detach().cpu(), want):
                    raise AssertionError(f"served {name} is not the "
                                         "checkpoint's")
        served = srv.waves
        del srv
    finally:
        for name, fn in methods.items():
            setattr(Checkpointer, name, fn)
        shutil.rmtree(directory, ignore_errors=True)
    # steps after each run's first (the first builds and warms up)
    step_ms = [h["dt"] * 1e3 for run in (first, second)
               for h in run["history"][1:]]
    p50 = float(np.median(step_ms))
    tokens = b * s                                    # the launcher's

    def secs(xs):
        return ", ".join(f"{x:.2f}" for x in xs) or "none"
    say("lm_train", f"launchers: {LAUNCH_ARCH} ({n_params:,} parameters"
        f"{'' if cuda else ', reduced'}) with --curate, trained to step 20 "
        f"(checkpoints every 10), resumed at 20 to 30, in {train_s:.1f} s "
        f"(loss {losses[0]:.4f} -> {losses[-1]:.4f}); step p50 {p50:.1f} ms, "
        f"max {max(step_ms):.1f} ms (first steps {hist[0]['dt'] * 1e3:.1f} "
        f"and {second['history'][0]['dt'] * 1e3:.1f} ms), "
        f"{tokens / p50 * 1e3:.0f} tokens/s; checkpoint npz of "
        f"{ck_bytes / 1e9:.3f} GB (params, mu, nu): device-to-host copy "
        f"{secs(timings['_host_flat'])} s, npz write "
        f"{secs(timings['_write'])} s, restore {secs(timings['restore'])} s "
        f"(resume, then serve); serve --ckpt-dir restored step 30 (every "
        f"parameter == the checkpoint's, cast) and served {served} waves; "
        f"build/train_smoke removed ({card_line})")


# the mesh phase: the distribution layer (distributed/*, launch/mesh.py) on
# the one card as a 1x1 (data, model) mesh over a one-rank NCCL group:
# h2o-danube-3-4b at full width and depth, a 2-layer full-width twin, and
# gradient compression on mamba2-130m; 2 layers at width 64 on a one-rank
# gloo group in the rehearsal
# (lr 1e-4: the steps repeat one batch at a constant rate, no warmup)
MESH_STEPS = dict(batch=8, seq=256, lr=1e-4)
MESH_REHEARSE = dict(batch=2, seq=32, lr=1e-4)
# the compressed run: the reference's tests/test_distributed.py:220 (12
# Int8 steps over 3 repeated batches, lr 3e-3), at mamba2-130m's full size
COMPRESS = dict(steps=12, batches=3, lr=3e-3)


def mesh_phase(torch, dev, card_line):
    """The distribution layer on a 1x1 mesh, in three parts.

    1. h2o-danube-3-4b at full width and depth (float32 masters, remat):
       three plain train steps of one batch (two timed), then the
       parameters and the plain run's AdamW moments placed on the mesh
       (DTensors over the same storage, the moments in ZeRO-1 placement,
       checked to share every tensor's memory); the loss of one batch
       without the mesh and
       with it under ``use_rules(rules_for_arch(cfg, mesh))`` on the same
       weights (relative 1e-5; 0 expected: the same local kernels run);
       three mesh train steps going on from the plain ones (the first
       warms DTensor's sharding caches, one is profiled): finite losses,
       every parameter moved; step ms,
       card busy share and peak memory beside the plain step's.
    2. 2 layers at full width: one mesh step and one plain step from the
       same weights at float32 activations (AdamW eps ``TWIN_EPS``): the
       losses and every updated parameter within 1e-5.
    3. Compression: mamba2-130m at full size, 12 Int8 error-feedback
       steps (``make_compressed_train_step``) over 3 repeated batches:
       the mean loss of the last 3 below the first 3's; and
       ``compressed_psum`` over the mesh's one-rank data group equal to
       the plain quantise-dequantise bit for bit.

    The group (NCCL on the card, gloo in the rehearsal) meets at a
    ``file://`` store under ``build/`` and is destroyed even on
    failure."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (Int8Compressor,
                                                     compressed_psum,
                                                     make_compressed_train_step)
    from repro_torch.distributed.partitioning import use_rules
    from repro_torch.distributed.sharding import (input_pspecs, place_batch,
                                                  place_for_training,
                                                  place_model, place_tensor,
                                                  rules_for_arch,
                                                  zero1_state_specs)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step

    t_phase = time.perf_counter()
    cuda = dev != "cpu"
    size = MESH_STEPS if cuda else MESH_REHEARSE
    b, s = size["batch"], size["seq"]
    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", world_size=1,
                            rank=0)
    try:
        mesh = make_local_mesh(1, 1, device="cuda" if cuda else "cpu")
        rng = np.random.default_rng(LM_SEED)

        def tokens(cfg):
            v = min(cfg.padded_vocab, 32_000)
            return {"tokens": rng.integers(0, v, (b, s)).astype(np.int32),
                    "labels": rng.integers(0, v, (b, s)).astype(np.int32)}

        def placed(model, batch, rules):
            axes = model.input_logical_axes(ShapeConfig("mesh", s, b,
                                                        "train"))
            t = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            return place_batch(t, mesh, input_pspecs(axes, rules))

        # ---- 1. full width and depth ----
        cfg = get_config(LM_ARCH)
        if not cuda:
            cfg = reduced(cfg, 2, 64)
        model = build_model(cfg, device=dev).init(
            make_generator(LM_SEED, dev))
        n_params = model.param_count()
        batch = tokens(cfg)
        state = adamw_init(model)
        step_fn = make_train_step(model, AdamWConfig(lr=size["lr"]))
        plain = [float(step_fn(state, batch)["loss"])]    # warm
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        plain_ms = []
        for _ in range(2):
            sync(torch, dev)
            t0 = time.perf_counter()
            m = step_fn(state, batch)
            sync(torch, dev)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            plain.append(float(m["loss"]))
        plain_peak = torch.cuda.max_memory_allocated() if cuda else 0
        del step_fn, m
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        with torch.no_grad():
            plain_loss = float(model.loss(
                {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}))
        samples = {n: p.detach().flatten()[:4096].clone()
                   for n, p in model.named_parameters()}
        # the parameters and the plain run's AdamW moments placed in
        # ZeRO-1 placement, over their own storage: the mesh steps go on
        # from the plain steps
        ptrs = [t.data_ptr() for t in [*model.parameters(),
                                       *state["mu"].values(),
                                       *state["nu"].values()]]
        rules = rules_for_arch(cfg, mesh)
        specs = place_model(model, mesh, rules)
        zero1 = zero1_state_specs(specs, model, mesh)
        for part in ("mu", "nu"):
            state[part] = {k: place_tensor(v, mesh, zero1[part][k])
                           for k, v in state[part].items()}
        shared = sum(t.to_local().data_ptr() == ptr for t, ptr in zip(
            [*model.parameters(), *state["mu"].values(),
             *state["nu"].values()], ptrs))
        if shared != len(ptrs):
            raise AssertionError(f"{len(ptrs) - shared} tensors were copied "
                                 f"when placed on the 1x1 mesh")
        step_fn = make_train_step(model, AdamWConfig(lr=size["lr"]))
        with use_rules(rules):
            with torch.no_grad():
                mesh_loss = float(model.loss(placed(model, batch, rules))
                                  .full_tensor())
            rel = abs(mesh_loss - plain_loss) / abs(plain_loss)
            if not rel <= 1e-5:
                raise AssertionError(f"loss {mesh_loss} on the mesh, "
                                     f"{plain_loss} without it")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync(torch, dev)
            t0 = time.perf_counter()
            losses = [float(step_fn(state, batch)["loss"])]
            first_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            losses.append(float(step_fn(state, batch)["loss"]))
            mesh_ms = (time.perf_counter() - t0) * 1e3
            prof = "not measured (no card)"
            if cuda:
                out = {}
                p = lm_profile(torch, lambda: out.update(
                    step_fn(state, batch)), 1)
                losses.append(float(out["loss"]))
                prof = (f"{p[0]:.1f} ms wall, card busy {p[1]:.1f} ms "
                        f"({100 * p[1] / p[0]:.1f}%), {p[2]:.0f} kernels"
                        if p else "no device time in the trace")
        mesh_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if not np.isfinite(losses).all():
            raise AssertionError(f"mesh losses not finite: {losses}")
        still = [n for n, p in model.named_parameters()
                 if torch.equal(p.to_local().detach().flatten()[:4096],
                                samples[n])]
        if still:
            raise AssertionError(f"parameters that did not move: {still[:5]}")
        bound, _, _ = train_bound_ms(model, b, s)
        say("mesh", f"{cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params:,} parameters) on a 1x1 mesh "
            f"({'NCCL' if cuda else 'gloo'}, one rank): {len(plain)} plain "
            f"train steps of one {b} x {s} batch (AdamW lr {size['lr']}), "
            f"loss {plain[0]:.4f} -> {plain[-1]:.4f}; then every parameter "
            f"and the AdamW moments (ZeRO-1 placement) DTensors over their "
            f"own storage; loss without the mesh {plain_loss:.6f}, with it "
            f"{mesh_loss:.6f} (difference {abs(mesh_loss - plain_loss):.3g},"
            f" relative {rel:.3g}); {len(losses)} mesh train steps go on, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, every parameter "
            f"moved; "
            f"mesh step {mesh_ms:.1f} ms (the first {first_ms:.1f} ms) "
            f"against the plain step's {plain_ms[0]:.1f} and "
            f"{plain_ms[1]:.1f} ms in this run; bound {bound:.1f} ms; "
            f"profiled mesh step: {prof}; peak {mesh_peak / 2**30:.2f} GiB "
            f"on the mesh, {plain_peak / 2**30:.2f} GiB plain ({card_line})")
        del model, state, step_fn, samples
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- 2. 2 layers at full width: mesh step == plain step ----
        cfg2 = dataclasses.replace(get_config(LM_ARCH), n_layers=2) \
            if cuda else reduced(get_config(LM_ARCH), 2, 64)
        weights = twin_weights(torch, cfg2, dev)
        batch2 = tokens(cfg2)
        got = {}
        with activations(torch.float32):
            for on_mesh in (False, True):
                model = build_model(cfg2, device=dev)
                model.load_state_dict(weights)
                opt = AdamWConfig(lr=size["lr"], eps=TWIN_EPS)
                if on_mesh:
                    r2 = rules_for_arch(cfg2, mesh)
                    state = place_for_training(model, mesh, r2)
                    with use_rules(r2):
                        m = make_train_step(model, opt)(state, batch2)
                else:
                    state = adamw_init(model)
                    m = make_train_step(model, opt)(state, batch2)
                params = {n: (p.to_local() if on_mesh else p).detach().cpu()
                          for n, p in model.named_parameters()}
                got[on_mesh] = (float(m["loss"]), params)
                del model, state, m
        (l0, p0), (l1, p1) = got[False], got[True]
        leaf = max(float((p1[n] - p0[n]).abs().max()) for n in p0)
        if not (abs(l1 - l0) <= 1e-5 * abs(l0) and leaf <= 1e-5):
            raise AssertionError(f"2-layer mesh step: loss {l1} vs {l0}, "
                                 f"parameters max_abs_err {leaf}")
        say("mesh", f"2-layer {LM_ARCH} at d_model {cfg2.d_model}, float32 "
            f"activations, one step ({b} x {s}, AdamW eps {TWIN_EPS}): mesh "
            f"loss {l1:.6f} vs plain {l0:.6f}, every updated parameter "
            f"max_abs_err {leaf:.3g} (bar 1e-5)")
        del got, p0, p1, weights
        gc.collect()

        # ---- 3. compression ----
        cfg3 = get_config(LAUNCH_ARCH)
        if not cuda:
            cfg3 = reduced(cfg3, 2, 64)
        model = build_model(cfg3, device=dev).init(
            make_generator(LM_SEED, dev))
        comp = Int8Compressor()
        step = make_compressed_train_step(model, AdamWConfig(
            lr=COMPRESS["lr"]), comp)
        opt, ef = adamw_init(model), comp.init(model)
        batches = [tokens(cfg3) for _ in range(COMPRESS["batches"])]
        t0 = time.perf_counter()
        c_losses = [float(step(opt, ef, batches[i % COMPRESS["batches"]])
                          ["loss"]) for i in range(COMPRESS["steps"])]
        c_s = time.perf_counter() - t0
        first, last = np.mean(c_losses[:3]), np.mean(c_losses[-3:])
        if not last < first:
            raise AssertionError(f"compressed training did not learn: "
                                 f"{c_losses}")
        x = torch.randn(1 << 20, generator=make_generator(LM_SEED, dev),
                        device=dev)
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        want = torch.clamp(torch.round(x / scale), -127, 127) \
            .to(torch.int32).float() * scale
        got_psum = compressed_psum(x.clone(), mesh.get_group("data"))
        if not torch.equal(got_psum, want):
            raise AssertionError("compressed_psum over one rank differs "
                                 "from the plain quantise-dequantise")
        say("mesh", f"compression: {LAUNCH_ARCH} ({model.param_count():,} "
            f"parameters), {COMPRESS['steps']} Int8 error-feedback steps "
            f"over {COMPRESS['batches']} repeated {b} x {s} batches in "
            f"{c_s:.1f} s, mean loss of the first 3 {first:.4f} -> last 3 "
            f"{last:.4f}; compressed_psum of 2^20 floats over the one-rank "
            f"data group == the plain quantise-dequantise (bit for bit; "
            f"wire {comp.wire_bytes_ratio():.2f} of float32); phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        del model, step, opt, ef
    finally:
        dist.destroy_process_group()
        if store.exists():
            store.unlink()


# the dryrun phase: the dry run's counter (launch/dryrun.py) on the mesh
# phase's h2o train step, fake and real, and one full dry-run cell; the
# two dry runs are subprocesses started at the top of the run (fake
# tensors on the host, no card), joined here.  The rehearsal counts a
# 2-layer, width-64 step in process and runs no cell.
DRYRUN_STEP = dict(batch=8, seq=256)
DRYRUN_REHEARSE = dict(batch=2, seq=32)
DRYRUN_LIMIT_S = 900            # every subprocess, from the top of the run
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"


# the dry run's cells beside the card, one subprocess each, all started at
# the top of the run: the card's step on one fake rank, the h2o train_4k
# cell on the 256-rank fake mesh, and two cells at probe depth whose
# products need DTensor views that torch 2.11 refuses unless they run as
# local products (``partitioning.matmul``): the cheapest context-parallel
# cell (qwen2-vl-2b, 12 heads over 16 ranks) and the cheapest SSM cell
DRYRUN_CELLS = {
    "card": (LM_ARCH, "train_4k", "local", "card",
             ["--batch", str(DRYRUN_STEP["batch"]), "--seq",
              str(DRYRUN_STEP["seq"]), "--microbatches", "1", "--fsdp", "0",
              "--sp", "0", "--probe", "0"]),
    "cell": (LM_ARCH, "train_4k", "single", "baseline", []),
    "context_parallel": ("qwen2-vl-2b", "prefill_32k", "single", "probe",
                         ["--probe-depth", "1"]),
    "ssm": ("mamba2-130m", "long_500k", "single", "probe",
            ["--probe-depth", "1"]),
}


def start_dryrun():
    """Start the dry run's subprocesses (``DRYRUN_CELLS``); returns
    {name: (process, log path)} and the start time."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = {}
    for name, (arch, shape, mesh, tag, extra) in DRYRUN_CELLS.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--tag", tag,
               "--out", str(DRYRUN_OUT)] + extra
        log = DRYRUN_OUT / f"{name}.log"
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT,
                                            cwd=ROOT, env=env), log)
    return procs, time.perf_counter()


def stop_dryrun(dry):
    """Kill whatever dry-run subprocess is still running."""
    if dry is None:
        return
    for proc, _ in dry[0].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def join_dryrun(dry):
    """Wait for every subprocess (until ``DRYRUN_LIMIT_S`` after their
    start); returns {name: the cell's JSON} and the seconds waited here.
    A subprocess that fails, runs out of time or writes a cell whose
    status is not "ok" fails the phase."""
    procs, t_start = dry
    t0 = time.perf_counter()
    cells = {}
    for name, (proc, log) in procs.items():
        left = DRYRUN_LIMIT_S - (time.perf_counter() - t_start)
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"the dry run's {name} subprocess ran past "
                                 f"{DRYRUN_LIMIT_S} s")
        arch, shape, mesh, tag, _ = DRYRUN_CELLS[name]
        path = DRYRUN_OUT / f"{arch}__{shape}__{mesh}__{tag}.json"
        if rc != 0 or not path.exists():
            raise AssertionError(f"the dry run's {name} subprocess exited "
                                 f"{rc}: {log.read_text()[-2000:]}")
        cells[name] = json.loads(path.read_text())
        if cells[name]["status"] != "ok":
            raise AssertionError(f"dry-run cell {name}: "
                                 f"{cells[name]['status']}")
    return cells, time.perf_counter() - t0


def dryrun_phase(torch, dev, card_line, dry):
    """The dry run beside the card, in two parts.

    (a) The mesh phase's h2o-danube-3-4b train step (8 x 256, full depth,
        float32 masters, remat, AdamW, one microbatch) on a 1x1 mesh,
        counted by ``launch.dryrun.StepCounter`` twice: on fake tensors
        (the subprocess's ``--mesh local`` cell) and on the card's real
        step (one NCCL rank, the model placed by the same rules): the
        FLOPs must be equal (the same program).  Printed beside them, with
        no gate: the predicted peak and ``torch.cuda.max_memory_allocated``
        of the counted step; the roofline bound and the step's ms
        (uncounted) and ``train_bound_ms``.
    (b) ``python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b
        --shape train_4k --mesh single`` (its own fake group of 256
        ranks): status ok; its report row.

    The rehearsal counts a 2-layer width-64 step fake and real in process
    (a fake group, then a gloo group) and runs no cell."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.partitioning import use_rules
    from repro_torch.distributed.sharding import rules_for_arch
    from repro_torch.launch import dryrun, report
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import H100_SXM, roofline
    from repro_torch.launch.train import reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator

    t_phase = time.perf_counter()
    cuda = dev != "cpu"
    size = DRYRUN_STEP if cuda else DRYRUN_REHEARSE
    cfg = get_config(LM_ARCH) if cuda else reduced(get_config(LM_ARCH), 2, 64)
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=size["batch"],
                                seq_len=size["seq"])
    kw = dict(fsdp=False, microbatches=1)
    if cuda:
        cells, waited = join_dryrun(dry)
        fake = cells["card"]
        fake_flops = fake["cost"]["flops_per_device"]
        fake_mem = fake["memory"]["peak_bytes_per_device"]
        fake_s = fake["compile_s"]
    else:
        cells, waited = {}, 0.0
        with dryrun.fake_group(1):
            mesh = make_local_mesh(1, 1, device="cpu")
            got = dryrun.count_cell(cfg, shape, mesh, rules_for_arch(
                cfg, mesh, shape), **kw)
        fake_flops = got["cost"]["flops"]
        fake_mem = got["memory"]["peak_bytes_per_device"]
        fake_s = got["seconds"]
        fake = {"roofline": roofline(got["cost"]["flops"],
                                     got["cost"]["bytes"], 0.0),
                "cost": {"bytes_per_device": got["cost"]["bytes"]}}

    store = ROOT / "build" / "dryrun_store"
    if store.exists():
        store.unlink()
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", world_size=1,
                            rank=0)
    try:
        mesh = make_local_mesh(1, 1, device="cuda" if cuda else "cpu")
        rules = rules_for_arch(cfg, mesh, shape)
        model = build_model(cfg, device=dev).init(
            make_generator(LM_SEED, dev))
        with use_rules(rules):
            run, inputs, updated = dryrun.cell_step(model, cfg, shape, mesh,
                                                    rules, **kw)
            sync(torch, dev)
            t0 = time.perf_counter()
            run()                                      # warm
            sync(torch, dev)
            first_ms = (time.perf_counter() - t0) * 1e3
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            c, memory = dryrun.count_step(run, inputs, updated)
            sync(torch, dev)
            counted_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            step_ms = []
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                sync(torch, dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
        del run, inputs, updated, model
    finally:
        dist.destroy_process_group()
        if store.exists():
            store.unlink()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if c.flops != fake_flops:
        raise AssertionError(f"the dry run counts {fake_flops:.6e} FLOPs on "
                             f"fake tensors, {c.flops:.6e} on the card")
    bound, _, _ = train_bound_ms(build_model(cfg, device="meta"),
                                 size["batch"], size["seq"])
    r = fake["roofline"]
    total = torch.cuda.get_device_properties(0).total_memory if cuda else 0
    say("dryrun", f"{cfg.name} train step ({size['batch']} x {size['seq']},"
        f" {cfg.n_layers} layers, 1x1 mesh, float32 masters, remat "
        f"{cfg.remat}, AdamW) counted on fake tensors in {fake_s:.1f} s and "
        f"on the {'card' if cuda else 'host'}: {fake_flops:.6e} FLOPs "
        f"both (difference {c.flops - fake_flops:.3g}); bytes moved "
        f"{c.bytes:.6e} real vs {fake['cost']['bytes_per_device']:.6e} "
        f"fake; predicted peak {fake_mem / 2**30:.2f} GiB, counted live "
        f"peak on the card {memory['peak_bytes_per_device'] / 2**30:.2f} "
        f"GiB, max_memory_allocated {peak / 2**30:.2f} GiB; roofline "
        f"bound {r['step_time_bound_s'] * 1e3:.1f} ms (compute "
        f"{r['compute_s'] * 1e3:.1f}, memory {r['memory_s'] * 1e3:.1f}, "
        f"{r['dominant']}; H100 SXM {H100_SXM['peak_flops']:.3g} FLOP/s, "
        f"{H100_SXM['hbm_bw']:.3g} B/s) vs the measured step "
        f"{step_ms[0]:.1f} and {step_ms[1]:.1f} ms (first {first_ms:.1f}, "
        f"counted {counted_ms:.1f}) and train_bound_ms {bound:.1f} ms; "
        f"report.HBM {report.HBM} B, the card's total_memory {total} B "
        f"({card_line})")
    if cuda:
        cell = cells["cell"]
        say("dryrun", f"dry-run cell {LM_ARCH} train_4k single (256 fake "
            f"ranks): status {cell['status']}, traced in "
            f"{cell['compile_s']} s, {cell['cost']['method']}; "
            f"{report.fmt_row(cell)}; every subprocess joined "
            f"{waited:.1f} s after the mesh phase")
        for name in ("context_parallel", "ssm"):
            c = cells[name]
            say("dryrun", f"probe-depth cell ({name.replace('_', '-')}) "
                f"{c['arch']} {c['shape']} single: status {c['status']}, "
                f"traced in {c['compile_s']} s, {c['cost']['method']}, "
                f"{c['cost']['flops_per_device']:.6e} FLOPs a device "
                f"(torch {torch.__version__})")
    say("dryrun", f"phase {time.perf_counter() - t_phase:.1f} s")


# the examples phase: each twin as a user runs it (the reference's sizes;
# train_lm's quick preset cut to 20 steps), all at once; its checkpoint
# directory and every temporary file under EXAMPLES_OUT, removed after
EXAMPLES_OUT = ROOT / "build" / "examples_smoke"
EXAMPLE_RUNS = (
    ("quickstart", ["quickstart_torch.py"]),
    ("batch_queries", ["batch_queries_torch.py"]),
    ("coax_curation", ["coax_curation_torch.py"]),
    ("telemetry", ["telemetry_torch.py"]),
    ("serve_requests", ["serve_requests_torch.py"]),
    ("serve_requests --durable", ["serve_requests_torch.py", "--durable"]),
    ("serve_requests --failover", ["serve_requests_torch.py", "--failover"]),
    ("train_lm --steps 20", ["train_lm_torch.py", "--steps", "20",
                             "--ckpt-dir", str(EXAMPLES_OUT / "ckpt")]),
)
EXAMPLES_PARALLEL = 8            # one a CPU core of the card's host
EXAMPLE_LIMIT_S = 300           # one run


def examples_phase(dev, card_line):
    """Run every invocation of ``EXAMPLE_RUNS`` on ``dev`` as a subprocess
    (``EXAMPLES_PARALLEL`` at a time); each must exit 0.  Prints each
    run's wall seconds and its first and last lines of output.  The
    rehearsal runs each twin's ``--help`` instead (the reference's sizes
    are the card's; ``tests/test_torch_examples.py`` runs the twins small
    on the CPU)."""
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    (EXAMPLES_OUT / "tmp").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               TMPDIR=str(EXAMPLES_OUT / "tmp"))
    runs = (EXAMPLE_RUNS if dev != "cpu" else
            [(f"{script} --help", [script, "--help"]) for script in
             dict.fromkeys(argv[0] for _, argv in EXAMPLE_RUNS)])

    def one(argv):
        args = argv if "--help" in argv else argv + ["--device", dev]
        t0 = time.perf_counter()
        try:
            out = subprocess.run([sys.executable, str(ROOT / "examples"
                                                      / args[0])] + args[1:],
                                 cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=EXAMPLE_LIMIT_S)
        except subprocess.TimeoutExpired:
            return None, time.perf_counter() - t0
        return out, time.perf_counter() - t0
    try:
        with ThreadPoolExecutor(EXAMPLES_PARALLEL) as pool:
            done = list(pool.map(one, [argv for _, argv in runs]))
        for (name, _), (out, wall) in zip(runs, done):
            if out is None:
                raise AssertionError(f"examples: {name} ran past "
                                     f"{EXAMPLE_LIMIT_S} s")
            lines = out.stdout.strip().splitlines() or [""]
            say("examples", f"{name}: exit {out.returncode}, {wall:.1f} s "
                f"wall; first: {lines[0]!r}; last: {lines[-1]!r}")
            if out.returncode != 0:
                raise AssertionError(f"examples: {name} exited "
                                     f"{out.returncode}: "
                                     f"{out.stderr[-3000:]}")
    finally:
        shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    say("examples", f"{len(runs)} runs, {EXAMPLES_PARALLEL} at a time, "
        f"every one exit 0; phase {time.perf_counter() - t_phase:.1f} s "
        f"({card_line})")


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
        # one intra-op thread: the rehearsal's tensors are small, and on a
        # shared host (a test runs it beside other test workers) a pool of
        # threads waiting at each product's barrier for threads the host
        # has descheduled slowed its first LM phase from 5 s to 394 s
        torch.set_num_threads(1)
        for arch in LM_SERVE_ARCHS:
            lm_serve_phase(torch, "cpu", "no card", arch)
        for arch in LM_STEPS_ARCHS:
            lm_steps_phase(torch, "cpu", "no card", arch)
        lm_train_phase(torch, "cpu", "no card")
        mesh_phase(torch, "cpu", "no card")
        dryrun_phase(torch, "cpu", "no card", None)
        examples_phase("cpu", "no card")
        run = main_phase(torch, "cpu", REHEARSE)
        segs = segments_phase(torch, run, REHEARSE, "cpu")
        ops_phase(torch, run, segs, REHEARSE, "cpu")
        background_phase(torch, run, REHEARSE, "cpu", "no card")
        cache_phase(torch, run, REHEARSE, "cpu", "no card")
        sharded_phase(torch, run, REHEARSE, "cpu", "no card")
        durable_phase(torch, run, REHEARSE, "cpu", "no card")
        del segs                 # they hold the main plan's images
        replicated_phase(torch, run, REHEARSE, "cpu", "no card")
        print("chip_smoke: rehearsal on the CPU finished; no card, no "
              "result", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card_line, kind, count = card_phase(torch)
    dry = start_dryrun()
    try:
        return card_run(torch, card_line, kind, count, dry, t_start)
    finally:
        stop_dryrun(dry)


def card_run(torch, card_line, kind, count, dry, t_start) -> int:
    """Every phase after ``card`` on the card, then the result lines."""
    cfg = FULL
    marks = [("start", t_start)]

    def mark(phase):
        marks.append((phase, time.perf_counter()))
    build_phase()
    small_errs = kernel_phase(torch, "cuda")
    mark("card, build, kernel")
    for arch in LM_SERVE_ARCHS:
        lm_serve_phase(torch, "cuda", card_line, arch)
        release_lm(torch)
        mark(f"lm_serve {arch}")
    for arch in LM_STEPS_ARCHS:
        lm_steps_phase(torch, "cuda", card_line, arch)
        release_lm(torch, "lm_steps")
        mark(f"lm_steps {arch}")
    lm_train_phase(torch, "cuda", card_line)
    release_lm(torch, "lm_train")
    mark("lm_train")
    mesh_phase(torch, "cuda", card_line)
    release_lm(torch, "mesh")
    mark("mesh")
    dryrun_phase(torch, "cuda", card_line, dry)
    release_lm(torch, "dryrun")
    mark("dryrun")
    examples_phase("cuda", card_line)
    mark("examples")
    run = main_phase(torch, "cuda", cfg)
    mark("main")
    segs = segments_phase(torch, run, cfg, "cuda")
    ops = ops_phase(torch, run, segs, cfg, "cuda")
    entry = times_phase(torch, run, segs, cfg, card_line)
    mark("segments, ops, times")
    background_phase(torch, run, cfg, "cuda", card_line)
    mark("background")
    cache_phase(torch, run, cfg, "cuda", card_line)
    mark("cache")
    sharded_phase(torch, run, cfg, "cuda", card_line)
    mark("sharded")
    durable_phase(torch, run, cfg, "cuda", card_line)
    mark("durable")
    seg_err = max(s["err"] for s in segs.values())
    del segs                     # they hold the main plan's images
    replicated_phase(torch, run, cfg, "cuda", card_line)
    mark("replicated")
    split = ", ".join(f"{name} {t1 - t0:.1f}"
                      for (_, t0), (name, t1) in zip(marks, marks[1:]))
    say("total", f"every phase passed in {time.perf_counter() - t_start:.1f}"
        f" s ({split} s)")
    kernels = [{
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan.py:62",
        "launches": run["launches"],
        "max_abs_err": seg_err,
        "ms": entry["ms"], "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
        "library_ms": None,
    }]
    for name, body in OPS_KERNELS:
        o = ops[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": body, "launches": o["launches"],
            "max_abs_err": max(o["err"], small_errs[name]),
            "ms": o["ms"], "plain_ms": o["plain_ms"],
            "bound_ms": o["bound"][0], "bound_by": o["bound"][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
