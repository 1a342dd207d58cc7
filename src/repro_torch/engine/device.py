"""Device-resident batch query plane (DESIGN.md §4): the fused wave.

Each wave runs ONE group of ``kernels.fused_scan`` launches — one per
segment — on one stream, driven by the per-row candidacy identity
(DESIGN.md §4):

    a row is in the numpy path's refined candidate blocks
      ⟺  its cell coordinate lies in the host-probed [first, last] on every
          grid dim  ∧  its sorted attribute lies in [t_lo, t_hi)

so probe + segment search collapse into a branch-free membership test the
kernel evaluates alongside the exact full-predicate filter and the liveness
mask — ``hit = alive ∧ candidate ∧ inside`` — and the nav⊇filter invariant
makes the result bit-identical to numpy.

Frozen per-grid image (``_GridImage``, uploaded once per epoch), torch
tensors on the plan's device:
  * ``rows_t``  (D, N_pad) f32 records, ``+inf``-padded (see bucketing);
  * ``coords``  (k, N_pad) i32 per-dim cell coordinate of every row (the
    device twin of the directory: mixed-radix decode of each row's cell);
  * ``sv``      (1, N_pad) f32 in-cell sorted attribute;
  * ``alive``   (1, N_pad) i32 liveness (tombstones re-uploaded only when
    the tombstone counters move);
  * host f32 edge images (``f32_ceil``/``f32_floor`` paired rounding) for
    the ONE conservative host directory pass per wave that yields
    [first, last], the ``cells_probed`` stat and, on the CPU route, the
    ``cell_cap`` overflow pre-check.

Per wave, every segment — primary grid, outlier grid, and the fixed-shape
delta/tombstone image of the live append log — is launched by
``_wave_program`` in one Python loop on the current stream, and a CUDA
event recorded after the group marks the wave (``dispatch_count`` counts
one dispatch per wave).  On ``device="cuda"`` each segment runs the
hand-written kernel over its whole ``N_pad``; on ``device="cpu"`` it runs
the kernel's plain torch version, whose grid segments additionally take
per-query candidate gather-index images (and skew-split into thin/fat
sub-segments, still one dispatch) so per-wave work scales with candidate
counts, not table size — DESIGN.md §4 "CPU oracle fast path".  Outputs stay
device-resident and compacted (per-query hit count + first ``hit_cap`` hit
positions); nothing transfers until ``collect`` — the explicit drain point,
which waits on the wave's event — so a submitted wave can overlap the
previous wave's drain (the executor/server double-buffering schedule,
depth 2).

Overflow contracts (both exact):
  * ``cell_cap`` — CPU route only: it bounds the width of the candidate
    gather.  Detected at SUBMIT from the host probe; the whole wave is
    answered by the numpy path (``fallbacks`` stat).  The kernel scans
    every segment whole, so on ``cuda`` no wave falls back.
  * ``hit_cap``  — detected at DRAIN from the exact device counts; only the
    overflowing queries are re-answered on the host FROM CAPTURED STATE
    (frozen grids + the tombstone set and delta log captured at submit), so
    interleaved writes between submit and drain cannot shift the wave's
    snapshot (``hit_overflows`` stat).  Its default follows the device: the
    reference's 1024 on ``cpu``, ``CUDA_HIT_CAP`` on ``cuda``; a segment's
    buffer is never wider than its row count.  The drain copies back only
    the hit columns the wave's counts fill.

Shape bucketing: wave width pads to a pow2 bucket (min ``min_bucket``).
On the CPU route grid images pad to a pow2 row count (min ``tile``) and the
delta image to ``max(128, pow2)`` rows, so steady-state serving — and epoch
swaps via ``_PlanBase.adopt`` — re-enter the same launch shapes.  The CUDA
kernel takes its row count at run time, so on ``cuda`` images pad only to
a tile multiple (no new shape costs a build there).  ``compile_count``
counts the distinct ``(segment config, Bp, N_pad)`` shapes launched; on
``cuda`` no cost stands behind it.

Epoch versioning (DESIGN.md §5): images freeze ONE snapshot epoch;
compaction swaps the grids, which invalidates the plan by identity
(``COAXIndex`` checks ``plan.primary is self.primary``) — in-flight tickets
keep draining against the frozen images they captured.

A plan asked for ``device="cuda"`` with no card present raises: there is
no quiet fallback to the CPU or to numpy.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.gridfile import BatchStats, f32_ceil
from ..core.types import sorted_contains
from ..kernels.fused_scan import fused_scan

__all__ = ["DevicePlan", "CoaxDevicePlan", "f32_floor"]

DELTA_TILE = 128          # delta image tile (and its CPU-route min rows)
CPU_HIT_CAP = 1024        # the reference's per-query hit buffer
CUDA_HIT_CAP = 1 << 19    # per-query hit buffer on the card: 2 MiB a query


def _resolve_device(device) -> torch.device:
    """The torch device a plan lives on; raises when it is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device plan asked for CUDA but no card is present "
                "(pass device='cpu' to run the kernels' plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def f32_floor(x: np.ndarray) -> np.ndarray:
    """Largest float32 <= x, elementwise (the mirror of ``gridfile.f32_ceil``)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(over="ignore"):
        y = x.astype(np.float32)
        rounded_up = y.astype(np.float64) > x
        # nextafter past f32 min overflows to -inf — the correct floor there
        return np.where(rounded_up, np.nextafter(y, np.float32(-np.inf)), y)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def _padded_rows(n: int, tile: int, bucket: bool) -> int:
    """Row count of a segment image: a pow2 bucket (min ``tile``) with
    always >= 1 pad row when ``bucket`` (the CPU route: the gather fast
    path points pad slots at the last, dead, ``+inf`` row), else just the
    next tile multiple."""
    n_pad = max(tile, _next_pow2(n + 1)) if bucket else max(n, 1)
    return n_pad + (-n_pad) % tile


def _multi_arange(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, s + l) for s, l in zip(starts, lens)]``
    without a Python loop (the candidate-block flattening primitive)."""
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    tot = int(lens.sum())
    if not tot:
        return np.empty(0, np.int64)
    step = np.ones(tot, np.int64)
    step[0] = starts[0]
    ends = np.cumsum(lens)[:-1]
    step[ends] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(step)


def _wave_program(segs, config):
    """ONE wave = one group of kernel launches over every segment, enqueued
    in order on the current stream.

    ``segs`` is a tuple of tensor dicts, ``config`` the matching tuple of
    per-segment tuples ``(tile, hit_cap, probe, has_sort, gw)``.  Each
    segment runs ``fused_scan`` (the kernel on CUDA tensors, its plain
    version on CPU tensors; ``gw > 0`` — CPU only — restricts the plain
    version to each query's probe-derived candidate rows via a gather-index
    image) and returns its compacted ``(counts, hits, scanned)``.
    """
    out = []
    for seg, (tile, hit_cap, probe, has_sort, gw) in zip(segs, config):
        kwargs = {}
        if probe:
            kwargs.update(coords=seg["coords"], first=seg["first"],
                          last=seg["last"])
        if has_sort:
            kwargs.update(sv=seg["sv"], tband=seg["tband"])
        if gw:
            kwargs["gidx"] = seg["gidx"]
        out.append(fused_scan(seg["rows"], seg["flo"], seg["fhi"],
                              seg["alive"], tile=tile, hit_cap=hit_cap,
                              **kwargs))
    return tuple(out)


class _GridImage:
    """Frozen device image of one ``GridFile`` epoch (uploaded once) plus
    the host-side conservative f32 directory for the per-wave probe."""

    def __init__(self, grid, tile: int, device: torch.device,
                 bucket: bool):
        n, k = grid.n_rows, len(grid.grid_dims)
        c = grid.cells_per_dim
        self.grid = grid
        self.device = device
        self.tile = int(tile)
        self.n = n
        self.grid_pos = [grid.index_dims.index(d) for d in grid.grid_dims]
        self.sort_pos = (grid.index_dims.index(grid.sort_dim)
                         if grid.sort_dim is not None else None)
        self.has_sort = grid.sort_vals is not None

        edges = (np.stack(grid.inner_edges) if k
                 else np.zeros((0, 0), np.float64))
        self.edges_up_h = f32_ceil(edges).astype(np.float32)
        self.edges_down_h = f32_floor(edges).astype(np.float32)
        # single-cell grids (k == 0 or c == 1) have no probe stage: every
        # live row is a candidate (modulo the sort band)
        self.probe = bool(k and self.edges_up_h.shape[1])
        self.k, self.c = k, c
        self.offsets_h = np.asarray(grid.offsets, np.int64)
        # mixed-radix weights of the row-major cell id, for window bounds
        self._radix = c ** (k - 1 - np.arange(k, dtype=np.int64))

        # CPU route: epoch-over-epoch growth re-enters the same launch
        # shapes instead of minting new ones per compaction (§5.4)
        n_pad = _padded_rows(n, self.tile, bucket)
        self.n_pad = n_pad
        pad = n_pad - n
        rows_t = np.pad(grid.rows.T, ((0, 0), (0, pad)),
                        constant_values=np.inf)
        self.rows_t = _upload(rows_t.astype(np.float32), device)
        self.bytes_resident = rows_t.size * 4
        if self.probe:
            cell_of_row = np.repeat(
                np.arange(grid.n_cells, dtype=np.int64), np.diff(grid.offsets))
            coords = np.full((k, self.n_pad), -1, np.int32)
            for j in range(k):                 # row-major decode, dim j digit
                coords[j, :n] = (cell_of_row // c ** (k - 1 - j)) % c
            self.coords = _upload(coords, device)
            self.bytes_resident += coords.size * 4
        if self.has_sort:
            sv = np.pad(grid.sort_vals, (0, pad), constant_values=np.inf)
            self.sv = _upload(sv.astype(np.float32)[None, :], device)
            self.bytes_resident += sv.size * 4
        self.bytes_resident += self.set_alive(None)

    # ------------------------------------------------------------------ #
    def set_alive(self, dead_ids: Optional[np.ndarray]) -> int:
        """(Re)upload the liveness mask — all-live, or ``row_ids`` minus the
        tombstone set.  Returns bytes uploaded."""
        alive = np.zeros((1, self.n_pad), np.int32)
        if dead_ids is None or not dead_ids.size:
            alive[0, :self.n] = 1
        else:
            # dead_ids is sorted (``COAXIndex._dead_ids``): binary-search
            # membership, no per-upload re-sort of the 50k-id base
            alive[0, :self.n] = ~sorted_contains(dead_ids, self.grid.row_ids)
        self.alive = _upload(alive, self.device)
        return alive.size * 4

    def probe_batch(self, nav_rects: np.ndarray):
        """ONE host directory pass per wave: per-query per-dim [first, last]
        cell coordinates under the conservative f32 rounding, plus the
        candidate-cell counts reused for the ``cell_cap`` pre-check and the
        ``cells_probed`` stat (previously a second pass)."""
        b = nav_rects.shape[0]
        k = len(self.grid_pos)
        if not self.probe:
            return (np.zeros((b, max(k, 1)), np.int64),
                    np.zeros((b, max(k, 1)), np.int64),
                    np.ones(b, np.int64))
        glo = f32_floor(nav_rects[:, self.grid_pos, 0]).astype(np.float32)
        ghi = f32_ceil(nav_rects[:, self.grid_pos, 1]).astype(np.float32)
        first = np.stack(
            [np.searchsorted(self.edges_up_h[i], glo[:, i], side="right")
             for i in range(k)], axis=1)
        last = np.stack(
            [np.searchsorted(self.edges_down_h[i], ghi[:, i], side="left")
             for i in range(k)], axis=1)
        counts = last - first + 1
        n_cells_q = np.where((counts > 0).all(axis=1),
                             np.maximum(counts, 1).prod(axis=1), 0)
        return first, last, n_cells_q

    def candidate_lists(self, first, last, n_cells_q,
                        qmask: Optional[np.ndarray] = None):
        """Per-query ascending candidate row-position lists, derived from
        the SAME probe pass: every cell in the candidate coord box is one
        contiguous cell-major block ``[offsets[cell], offsets[cell + 1])``,
        enumerated in ascending linear cell id — the exact row set the
        numpy path refines, feeding the plain version's gather fast path
        (``fused_scan_ref``'s ``gidx``)."""
        lists = []
        for q in range(first.shape[0]):
            if n_cells_q[q] <= 0 or (qmask is not None and not qmask[q]):
                lists.append(np.empty(0, np.int64))
                continue
            cells = np.zeros(1, np.int64)
            for j in range(self.k):        # C-order box walk == ascending id
                span = np.arange(first[q, j], last[q, j] + 1) * self._radix[j]
                cells = (cells[:, None] + span[None, :]).ravel()
            starts = self.offsets_h[cells]
            lens = self.offsets_h[cells + 1] - starts
            lists.append(_multi_arange(starts, lens))
        return lists

    def gather_bucket(self, lists) -> int:
        """Static gather width for this wave: the max per-query candidate
        row count, pow2-bucketed (min 512) so steady-state waves share
        launch shapes; 0 (= full scan) when gathering wouldn't help."""
        if not self.probe:
            return 0
        w = _next_pow2(max(max(l.size for l in lists), 512))
        return 0 if w * 2 >= self.n_pad else w

    def seg_inputs(self, nav_rects, filter_rects, first, last, bp: int,
                   qmask: Optional[np.ndarray] = None,
                   glists=None, gw: int = 0):
        """Build this wave's padded per-query device inputs for one segment.

        Padding queries (and ``qmask``-suppressed ones, e.g. the §8.2.3
        outlier bbox skip) are inert: empty probe range and an empty filter
        rect, so they contribute no hits.  When ``gw > 0`` the per-query
        candidate lists ``glists`` ship as a ``(bp, gw)`` gather-index
        image for the plain version's candidate-gather scan (pad slots
        point at the dead ``+inf`` pad row).  Returns ``(seg dict, uploaded
        bytes)``, ``n`` in the dict being the real row count; the config
        tuple comes from ``config_for``.
        """
        b = nav_rects.shape[0]
        flo = np.full((bp, filter_rects.shape[1]), np.inf, np.float32)
        fhi = np.full((bp, filter_rects.shape[1]), -np.inf, np.float32)
        flo[:b] = f32_ceil(filter_rects[:, :, 0])
        fhi[:b] = f32_ceil(filter_rects[:, :, 1])
        if qmask is not None:
            flo[:b][~qmask] = np.inf
            fhi[:b][~qmask] = -np.inf
        dev = self.device
        seg = {"rows": self.rows_t, "alive": self.alive, "n": self.n,
               "flo": _upload(flo.T, dev), "fhi": _upload(fhi.T, dev)}
        nbytes = flo.size * 8
        if self.probe:
            k = first.shape[1]
            fa = np.ones((bp, k), np.int32)     # pad: empty range [1, 0]
            la = np.zeros((bp, k), np.int32)
            fa[:b], la[:b] = first, last
            if qmask is not None:
                fa[:b][~qmask], la[:b][~qmask] = 1, 0
            seg["coords"] = self.coords
            seg["first"] = _upload(fa, dev)
            seg["last"] = _upload(la, dev)
            nbytes += fa.size * 8
            if gw:
                gi = np.full((bp, gw), self.n_pad - 1, np.int32)
                for q, lst in enumerate(glists):
                    gi[q, :lst.size] = lst[:gw]
                seg["gidx"] = _upload(gi, dev)
                nbytes += gi.size * 4
        if self.has_sort:
            tb = np.full((bp, 2), np.inf, np.float32)
            tb[:, 1] = -np.inf                   # pad: empty band [inf, -inf)
            if self.sort_pos is not None:
                tb[:b, 0] = f32_ceil(nav_rects[:, self.sort_pos, 0])
                tb[:b, 1] = f32_ceil(nav_rects[:, self.sort_pos, 1])
            seg["sv"] = self.sv
            seg["tband"] = _upload(tb, dev)
            nbytes += tb.size * 4
        return seg, nbytes

    def config_for(self, hit_cap: int, gw: int = 0) -> tuple:
        # the kernel always scans the whole segment (the accelerator
        # design); the gather is the CPU route's candidate-scaling lever.
        # No query holds more hits than the segment has rows.
        return (self.tile, min(hit_cap, self.n_pad), self.probe,
                self.has_sort, int(gw))


_ID_BITS = 40


def _sort_pairs(q: np.ndarray, r: np.ndarray):
    """``(query, row id)`` pairs in ``np.lexsort((r, q))`` order.  Row ids
    in ``[0, 2^40)`` pack with the query under one int64 key, and one sort
    of the keys is about 10x faster than the two-key lexsort at a wave's
    millions of hits; other ids (caller-given ``row_ids``) take lexsort."""
    if r.size and 0 <= r.min() and r.max() < 1 << _ID_BITS:
        key = np.sort((q.astype(np.int64) << _ID_BITS) | r)
        return key >> _ID_BITS, key & ((1 << _ID_BITS) - 1)
    order = np.lexsort((r, q))
    return q[order], r[order]


def _extract_hits(counts: np.ndarray, hits: np.ndarray, cap: int,
                  over: np.ndarray):
    """Unpack one segment's compacted device hits: per-query row positions
    for every non-overflowing query (overflowers are host re-answered).
    ``hits`` holds at least the ``min(count, cap)`` defined columns."""
    take = np.where(over, 0, np.minimum(counts, cap))
    if not take.sum():
        return np.empty(0, np.int64), np.empty(0, np.int64)
    valid = np.arange(hits.shape[1])[None, :] < take[:, None]
    q, c = np.nonzero(valid)
    return q.astype(np.int64), hits[q, c].astype(np.int64)


class _PlanBase:
    """Knobs + counters shared by the grid-level and COAX-level plans."""

    def _init_opts(self, cell_cap, tile, min_bucket, hit_cap, device):
        self.device = _resolve_device(device)
        # the candidate-gather route is the CPU's; the kernel scans full-N
        self._gather = self.device.type == "cpu"
        self.cell_cap = int(cell_cap)
        self.tile = int(tile)
        self.min_bucket = int(min_bucket)
        if hit_cap is None:
            hit_cap = CPU_HIT_CAP if self._gather else CUDA_HIT_CAP
        self.hit_cap = int(hit_cap)
        self._shapes = set()         # distinct (config, Bp, N_pad) launched
        self.dispatch_count = 0      # wave dispatches (1/wave)
        self.bytes_h2d = 0           # resident images + per-wave inputs
        self.bytes_d2h = 0           # drained compacted result buffers

    def adopt(self, other: "_PlanBase") -> None:
        """Carry the previous epoch's shape cache and cumulative counters
        into this fresh plan.  Epoch handoff (§5.4) swaps the grids and
        rebuilds the plan; with pow2-bucketed image shapes the new epoch's
        waves launch the SAME shapes, so adopting the shape set keeps
        ``compile_count`` flat across compactions and the launch/transfer
        accounting monotonic."""
        self._shapes = other._shapes
        self.dispatch_count = other.dispatch_count
        self.bytes_h2d += other.bytes_h2d
        self.bytes_d2h = other.bytes_d2h

    @property
    def compile_count(self) -> int:
        """Distinct ``(segment config, Bp, N_pad)`` launch shapes so far —
        the §4 shape-bucketing metric."""
        return len(self._shapes)

    def bucket(self, b: int) -> int:
        return max(self.min_bucket, _next_pow2(b))

    def _count_h2d(self, nbytes: int) -> None:
        """Fold an upload into the plan counter AND the global registry
        (``coax_device_bytes{direction="h2d"}``, DESIGN.md §10.1).
        ``adopt`` bypasses this: carried bytes were already counted."""
        self.bytes_h2d += nbytes
        obs.get_registry().counter(
            "coax_device_bytes", "bytes moved across the host-device link",
            ("direction",)).inc(nbytes, direction="h2d")

    def _dispatch(self, segs, config):
        """One wave dispatch: the segments' launches on the current stream,
        then an event that marks the wave's end (CUDA only).  Telemetry
        (DESIGN.md §10): the ``device.dispatch`` span covers the enqueue —
        a launch shape seen for the first time stamps ``new_shape=True``.
        Launch count and new shapes fold into the global registry."""
        new = 0
        for seg, cfg in zip(segs, config):
            key = (cfg, int(seg["flo"].shape[1]), int(seg["rows"].shape[1]))
            if key not in self._shapes:
                self._shapes.add(key)
                new += 1
        t0 = time.perf_counter()
        with obs.span("device.dispatch", segs=len(segs)) as sp:
            outs = _wave_program(tuple(segs), tuple(config))
            caps = tuple(cfg[1] for cfg in config)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        if sp is not None and new:
            sp.args["new_shape"] = True
        self.dispatch_count += 1
        g = obs.get_registry()
        g.counter("coax_device_dispatch_total",
                  "wave dispatches").inc()
        if new:
            g.counter("coax_device_compile_total",
                      "new wave launch shapes").inc(new)
        obs.stage_hist().observe(time.perf_counter() - t0,
                                 stage="dispatch", backend="device")
        return outs, event, caps

    def _cell_overflow(self, n_cells_q: np.ndarray) -> bool:
        """The submit-time ``cell_cap`` pre-check — CPU route only (it
        bounds the gather width; the kernel scans whole segments)."""
        return self._gather and int(n_cells_q.max(initial=0)) > self.cell_cap

    def _drain(self, res, bs):
        """Drain point: wait on the wave's event, copy the compacted
        buffers back, count bytes.  ``bs`` is the real (un-padded) query
        count per segment.  Only the hit columns the counts fill come back.
        Returns per-segment ``(counts (b,), hits (b, W), scanned (b,))``
        with ``W = max(min(counts, cap))``.  The ``device.transfer`` span
        covers the wait plus the d2h copies — execute+transfer time,
        distinct from the dispatch span's enqueue (DESIGN.md §10.2)."""
        outs, event, caps = res
        t0 = time.perf_counter()
        d2h = 0
        with obs.span("device.transfer") as sp:
            if event is not None:
                event.synchronize()
            out = []
            for (counts, hits, scanned), b, cap in zip(outs, bs, caps):
                counts = counts[:b, 0].cpu().numpy()
                w = min(int(counts.max(initial=0)), cap)
                hits = hits[:b, :w].cpu().numpy()
                scanned = scanned[:b, 0].cpu().numpy()
                d2h += counts.nbytes + hits.nbytes + scanned.nbytes
                out.append((counts, hits, scanned))
            if sp is not None:
                sp.args["bytes_d2h"] = d2h
        self.bytes_d2h += d2h
        obs.get_registry().counter(
            "coax_device_bytes", "bytes moved across the host-device link",
            ("direction",)).inc(d2h, direction="d2h")
        obs.stage_hist().observe(time.perf_counter() - t0,
                                 stage="transfer", backend="device")
        return out


class DevicePlan(_PlanBase):
    """Frozen device-resident image of one ``GridFile`` plus its fused-scan
    wave program (DESIGN.md §4).

    Parameters
    ----------
    grid : the host ``GridFile`` to freeze (arrays are uploaded once here).
    cell_cap : per-query candidate-cell budget of the CPU route's gather;
        there, waves where any query's directory probe exceeds it return
        ``None`` from ``submit_wave`` so the caller falls back to the numpy
        path (submit-time contract, §4).  Unused on ``cuda``.
    hit_cap : per-query device hit-buffer budget; queries whose exact count
        exceeds it are re-answered on the host at drain time (§4).
        ``None`` picks the device's default (1024 on ``cpu``,
        ``CUDA_HIT_CAP`` on ``cuda``).
    tile : record tile width for the kernel (N pads to a multiple).
    min_bucket : smallest wave bucket; B pads up to ``max(min_bucket,
        next_pow2(B))`` so steady-state widths share launch shapes.
    device : torch device of the images — ``"cuda"`` (default) launches the
        hand-written kernel, ``"cpu"`` runs its plain torch version; raises
        when the device is absent.
    """

    def __init__(self, grid, *, cell_cap: int = 256, tile: int = 512,
                 min_bucket: int = 4, hit_cap: Optional[int] = None,
                 device="cuda"):
        self._init_opts(cell_cap, tile, min_bucket, hit_cap, device)
        self.grid = grid
        self.epoch = int(getattr(grid, "epoch", 0))   # snapshot version (§5)
        self.n_rows = grid.n_rows
        self._img = (_GridImage(grid, self.tile, self.device, self._gather)
                     if grid.n_rows else None)
        if self._img is not None:
            self._count_h2d(self._img.bytes_resident)

    # ------------------------------------------------------------------ #
    def plan_counts(self, nav_rects: np.ndarray,
                    bounds: Optional[tuple] = None) -> np.ndarray:
        """Per-query candidate-cell counts under the device probe (the same
        conservative f32 rounding) — ``probe_batch``'s counts, exposed for
        callers that only need the overflow pre-check / work stat."""
        if self._img is None:
            return np.ones(nav_rects.shape[0], np.int64)
        del bounds                    # probe_batch recomputes; ONE pass total
        return self._img.probe_batch(nav_rects)[2]

    # ------------------------------------------------------------------ #
    def submit_wave(self, nav_rects: np.ndarray, filter_rects: np.ndarray):
        """Launch one wave (ONE dispatch); returns an opaque ticket for
        ``collect``, or ``None`` on ``cell_cap`` overflow (caller falls back
        to numpy).  No results transfer until ``collect``."""
        b = nav_rects.shape[0]
        if b == 0 or self.n_rows == 0:
            return {"b": b, "res": None}
        first, last, n_cells_q = self._img.probe_batch(nav_rects)
        if self._cell_overflow(n_cells_q):
            return None                                # overflow fallback
        bp = self.bucket(b)
        glists, gw = None, 0
        if self._gather:
            glists = self._img.candidate_lists(first, last, n_cells_q)
            gw = self._img.gather_bucket(glists)
        seg, nbytes = self._img.seg_inputs(nav_rects, filter_rects,
                                           first, last, bp,
                                           glists=glists, gw=gw)
        cfg = self._img.config_for(self.hit_cap, gw)
        res = self._dispatch([seg], [cfg])
        self._count_h2d(nbytes)
        return {"b": b, "res": res, "cells": int(n_cells_q.sum()),
                "nav": nav_rects, "filt": filter_rects}

    def collect(self, ticket) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Drain one wave: block, transfer the compacted buffers, unpack,
        and host re-answer any ``hit_cap`` overflowers from the frozen grid."""
        b = ticket["b"]
        if ticket["res"] is None:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    {"cells_probed": 0, "rows_scanned": 0, "hit_overflows": 0})
        ((counts, hits, scanned),) = self._drain(ticket["res"], [b])
        over = counts > self.hit_cap
        q, pos = _extract_hits(counts, hits, self.hit_cap, over)
        out_q, out_r = q, self.grid.row_ids[pos]
        rows_scanned = int(scanned.sum())
        if over.any():                # exact per-query host re-answer (§4)
            qsel = np.nonzero(over)[0]
            qo, ro = self.grid._query_batch_numpy(
                ticket["nav"][qsel], ticket["filt"][qsel])
            rows_scanned += self.grid.last_batch_stats.rows_scanned
            out_q = np.concatenate([out_q, qsel[qo]])
            out_r = np.concatenate([out_r, ro])
        out_q, out_r = _sort_pairs(out_q, out_r)
        stats = {"cells_probed": ticket["cells"],
                 "rows_scanned": rows_scanned,
                 "hit_overflows": int(over.sum())}
        return out_q, out_r, stats

    def run_wave(self, nav_rects: np.ndarray, filter_rects: np.ndarray
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, dict]]:
        """Submit + drain one wave synchronously; ``None`` on ``cell_cap``
        overflow (the ``GridFile.query_batch`` fallback contract)."""
        ticket = self.submit_wave(nav_rects, filter_rects)
        if ticket is None:
            return None
        return self.collect(ticket)


class CoaxDevicePlan(_PlanBase):
    """Device wave plan for a whole ``COAXIndex``: primary grid + outlier
    grid + the live delta/tombstone image, in ONE dispatch per wave
    (DESIGN.md §4).

    The plan freezes the index's CURRENT epoch grids; write-state (liveness
    masks, delta image) refreshes lazily at submit when the delta-plane
    counters move.  Tickets capture every host array a drain-time re-answer
    needs, so collecting after further writes still answers from the wave's
    submit-time snapshot.

    Options are ``DevicePlan``'s.
    """

    def __init__(self, index, *, cell_cap: int = 256, tile: int = 512,
                 min_bucket: int = 4, hit_cap: Optional[int] = None,
                 device="cuda"):
        self._init_opts(cell_cap, tile, min_bucket, hit_cap, device)
        self.index = index
        self.primary = index.primary
        self.outlier = index.outlier
        self.epoch = int(index.epoch)
        self.p_img = (_GridImage(self.primary, self.tile, self.device,
                                 self._gather)
                      if self.primary.n_rows else None)
        self.o_img = (_GridImage(self.outlier, self.tile, self.device,
                                 self._gather)
                      if self.outlier.n_rows else None)
        for img in (self.p_img, self.o_img):
            if img is not None:
                self._count_h2d(img.bytes_resident)
        self._dead_key = None
        self._dead_host = np.empty(0, np.int64)
        self._delta_key = None
        self._delta = None

    # ------------------------------------------------------------------ #
    def _refresh_writes(self) -> None:
        """Re-upload liveness masks / the delta image iff the delta-plane
        counters moved since the last wave (cheap no-op in steady state)."""
        dp, do = self.index.delta_primary, self.index.delta_outlier
        dead_key = (dp.n_tombstones, do.n_tombstones)
        if dead_key != self._dead_key:
            self._dead_host = self.index._dead_ids()
            for img in (self.p_img, self.o_img):
                if img is not None:
                    self._count_h2d(img.set_alive(self._dead_host))
            self._dead_key = dead_key
        delta_key = (dp.n_log, dp.n_log_dead, do.n_log, do.n_log_dead)
        if delta_key != self._delta_key:
            r1, i1 = dp.live_log()
            r2, i2 = do.live_log()
            rows = np.concatenate([r1, r2])
            ids = np.concatenate([i1, i2])
            m = rows.shape[0]
            if m:
                m_pad = (max(DELTA_TILE, _next_pow2(m)) if self._gather
                         else m + (-m) % DELTA_TILE)     # see bucketing
                rows_t = np.full((rows.shape[1], m_pad), np.inf, np.float32)
                rows_t[:, :m] = rows.T
                alive = np.zeros((1, m_pad), np.int32)
                alive[0, :m] = 1
                self._delta = {"rows_t": _upload(rows_t, self.device),
                               "alive": _upload(alive, self.device),
                               "rows": rows, "ids": ids, "m_pad": m_pad}
                self._count_h2d(rows_t.size * 4 + alive.size * 4)
            else:
                self._delta = None
            self._delta_key = delta_key

    # ------------------------------------------------------------------ #
    def _add_grid_segs(self, img, ids, nav, filt, first, last, ncq,
                       bp: int, out: dict, qmask=None) -> int:
        """Append one grid's wave segment(s) to ``out`` (the in-progress
        dispatch lists).  On the CPU route the per-query candidate
        lists feed the gather fast path, and a wave whose width budget
        would be set by a few fat queries is SPLIT: a thin segment at the
        median-sized gather width (fat queries inert) plus a fat segment
        over just those queries at a small batch bucket — still one
        dispatch, each query live in exactly one segment (``qmap`` routes
        fat hits back to wave query ids at collect)."""
        b = nav.shape[0]
        glists, gw = None, 0
        if self._gather:
            glists = img.candidate_lists(first, last, ncq, qmask=qmask)
            gw = img.gather_bucket(glists)
        fat = np.empty(0, np.int64)
        gw_thin = gw
        if gw:
            sizes = np.array([l.size for l in glists])
            gw_thin = _next_pow2(max(512, int(np.median(sizes)) * 2))
            if gw_thin < gw:
                fat = np.nonzero(sizes > gw_thin)[0]
            else:
                gw_thin = gw
        nbytes = 0
        thin_mask = qmask
        thin_lists = glists
        if fat.size:
            thin_mask = np.ones(b, bool) if qmask is None else qmask.copy()
            thin_mask[fat] = False
            thin_lists = [l if m else np.empty(0, np.int64)
                          for l, m in zip(glists, thin_mask)]
        seg, nb = img.seg_inputs(nav, filt, first, last, bp,
                                 qmask=thin_mask, glists=thin_lists,
                                 gw=gw_thin)
        out["segs"].append(seg)
        out["cfgs"].append(img.config_for(self.hit_cap, gw_thin))
        out["ids"].append(ids)
        out["qmaps"].append(None)
        out["bs"].append(b)
        nbytes += nb
        if fat.size:
            bp_f = max(self.min_bucket, _next_pow2(fat.size))
            flists = [glists[q] for q in fat]
            gw_f = img.gather_bucket(flists)
            seg, nb = img.seg_inputs(nav[fat], filt[fat], first[fat],
                                     last[fat], bp_f,
                                     glists=flists, gw=gw_f)
            out["segs"].append(seg)
            out["cfgs"].append(img.config_for(self.hit_cap, gw_f))
            out["ids"].append(ids)
            out["qmaps"].append(fat)
            out["bs"].append(fat.size)
            nbytes += nb
        return nbytes

    def wave_segments(self, nav_rects: np.ndarray, rects: np.ndarray):
        """Build one wave's kernel inputs against the CURRENT write state:
        the primary segment, the outlier segment (§8.2.3 bbox skip:
        non-touch queries go in inert, not sub-batched — same result, fixed
        shape) and the delta segment, plus thin/fat splits of the grid
        segments on the CPU route.  Returns ``None`` on ``cell_cap``
        overflow, else ``(out, cells_probed, upload bytes, touch)`` where
        ``out`` holds the parallel lists ``segs``, ``cfgs``, ``ids``,
        ``qmaps`` and ``bs``."""
        b = rects.shape[0]
        self._refresh_writes()
        bp = self.bucket(b)
        out = {"segs": [], "cfgs": [], "ids": [], "qmaps": [], "bs": []}
        cells_probed = 0
        nbytes = 0

        if self.p_img is not None:
            first, last, ncq = self.p_img.probe_batch(nav_rects)
            if self._cell_overflow(ncq):
                return None
            cells_probed += int(ncq.sum())
            nbytes += self._add_grid_segs(self.p_img, self.primary.row_ids,
                                          nav_rects, rects, first, last,
                                          ncq, bp, out)

        touch = np.zeros(b, bool)
        if self.index._outlier_lo is not None:
            touch = np.all(
                (rects[:, :, 0] <= self.index._outlier_hi)
                & (rects[:, :, 1] > self.index._outlier_lo), axis=1)
        if self.o_img is not None and touch.any():
            # nav == full rect for the full-dim outlier grid
            of, ol, oncq = self.o_img.probe_batch(rects)
            oncq = np.where(touch, oncq, 0)
            if self._cell_overflow(oncq):
                return None
            cells_probed += int(oncq.sum())
            nbytes += self._add_grid_segs(self.o_img, self.outlier.row_ids,
                                          rects, rects, of, ol, oncq, bp,
                                          out, qmask=touch)

        delta = self._delta
        if delta is not None:
            flo = np.full((bp, rects.shape[1]), np.inf, np.float32)
            fhi = np.full((bp, rects.shape[1]), -np.inf, np.float32)
            flo[:b] = f32_ceil(rects[:, :, 0])
            fhi[:b] = f32_ceil(rects[:, :, 1])
            out["segs"].append({"rows": delta["rows_t"],
                                "alive": delta["alive"],
                                "n": delta["rows"].shape[0],
                                "flo": _upload(flo.T, self.device),
                                "fhi": _upload(fhi.T, self.device)})
            out["cfgs"].append((min(DELTA_TILE, delta["m_pad"]),
                                min(self.hit_cap, delta["m_pad"]),
                                False, False, 0))
            out["ids"].append(delta["ids"])
            out["qmaps"].append(None)
            out["bs"].append(b)
            nbytes += flo.size * 8
        return out, cells_probed, nbytes, touch

    def submit_wave(self, nav_rects: np.ndarray, rects: np.ndarray):
        """Launch one COAX wave (ONE dispatch over up to three segments —
        plus thin/fat splits of the grid segments on the CPU route);
        returns a ticket for ``collect`` or ``None`` on ``cell_cap``
        overflow.  All snapshot/write state the drain needs is captured
        here, synchronously — per-wave snapshot semantics (§5)."""
        b = rects.shape[0]
        if b == 0:
            return {"b": 0, "res": None}
        wave = self.wave_segments(nav_rects, rects)
        if wave is None:
            return None
        out, cells_probed, nbytes, touch = wave
        segs = out["segs"]
        res = self._dispatch(segs, out["cfgs"]) if segs else None
        self._count_h2d(nbytes)
        delta = self._delta
        return {"b": b, "res": res, "ids": out["ids"], "cells": cells_probed,
                "qmaps": out["qmaps"], "bs": out["bs"],
                "nav": nav_rects, "rects": rects, "touch": touch,
                "dead": self._dead_host,
                "delta": None if delta is None
                else (delta["rows"], delta["ids"])}

    # ------------------------------------------------------------------ #
    def collect(self, ticket) -> Tuple[np.ndarray, np.ndarray, BatchStats]:
        """Drain one COAX wave at its explicit drain point and assemble the
        exact ``query_batch`` answer (plus ``BatchStats``)."""
        b = ticket["b"]
        if b == 0 or ticket["res"] is None:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    BatchStats(queries=b, backend="device"))
        seg_np = self._drain(ticket["res"], ticket["bs"])
        over = np.zeros(b, bool)
        rows_scanned = 0
        for (counts, _, scanned), qmap in zip(seg_np, ticket["qmaps"]):
            o = counts > self.hit_cap
            if qmap is None:
                over |= o
            else:
                over[qmap[o]] = True
            rows_scanned += int(scanned.sum())
        parts_q, parts_r = [], []
        for (counts, hits, _), ids, qmap in zip(seg_np, ticket["ids"],
                                                ticket["qmaps"]):
            q, pos = _extract_hits(counts, hits, self.hit_cap,
                                   over if qmap is None else over[qmap])
            parts_q.append(q if qmap is None else qmap[q])
            parts_r.append(ids[pos])
        n_over = int(over.sum())
        if n_over:
            qsel = np.nonzero(over)[0]
            qo, ro, extra = self._reanswer(ticket, qsel)
            parts_q.append(qsel[qo])
            parts_r.append(ro)
            rows_scanned += extra
        out_q, out_r = _sort_pairs(np.concatenate(parts_q),
                                   np.concatenate(parts_r))
        stats = BatchStats(queries=b, cells_probed=ticket["cells"],
                           rows_scanned=rows_scanned, backend="device",
                           hit_overflows=n_over)
        return out_q, out_r, stats

    def _reanswer(self, ticket, qsel: np.ndarray):
        """Exact host answer for ``hit_cap``-overflowing queries, replayed
        from the ticket's CAPTURED state (frozen epoch grids + the tombstone
        set and delta log as of submit) — writes applied between submit and
        drain are invisible, preserving per-wave snapshot semantics."""
        nav = ticket["nav"][qsel]
        rects = ticket["rects"][qsel]
        q_p, r_p = self.primary._query_batch_numpy(nav, rects)
        extra = self.primary.last_batch_stats.rows_scanned
        touch = ticket["touch"][qsel]
        if touch.any() and self.outlier.n_rows:
            sub = rects[touch]
            q_o, r_o = self.outlier._query_batch_numpy(sub, sub)
            extra += self.outlier.last_batch_stats.rows_scanned
            if r_o.size:
                q_p = np.concatenate([q_p, np.nonzero(touch)[0][q_o]])
                r_p = np.concatenate([r_p, r_o])
        dead = ticket["dead"]
        if dead.size and r_p.size:
            keep = ~sorted_contains(dead, r_p)
            q_p, r_p = q_p[keep], r_p[keep]
        if ticket["delta"] is not None:
            drows, dids = ticket["delta"]
            rows64 = drows.astype(np.float64)      # exact f64 upcast compare
            hit = np.ones((qsel.size, dids.size), bool)
            for j in range(drows.shape[1]):
                v = rows64[:, j]
                np.logical_and(hit, v[None, :] >= rects[:, j, 0][:, None],
                               out=hit)
                np.logical_and(hit, v[None, :] < rects[:, j, 1][:, None],
                               out=hit)
            qd, pos = np.nonzero(hit)
            q_p = np.concatenate([q_p, qd.astype(np.int64)])
            r_p = np.concatenate([r_p, dids[pos]])
            extra += int(qsel.size) * int(dids.size)
        return q_p, r_p, int(extra)
