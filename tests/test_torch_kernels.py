"""The port's plain ``fused_scan`` against the JAX package's oracle and its
Pallas kernel (interpret mode), on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The bar is exact equality of counts, rows scanned and the defined hit
prefix (every reference engine is exact); beyond the prefix the port and
the jnp oracle both hold -1, while the Pallas kernel leaves it unspecified.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.engine.device import _multi_arange
from repro.kernels import fused_range_scan as ref_fused_range_scan
from repro.kernels import ref as jref
from repro_torch.kernels import fused_range_scan, fused_scan
from repro_torch.kernels import ref as tref

N, D, B, TILE = 700, 3, 5, 256


def _inputs(seed=21):
    rng = np.random.default_rng(seed)
    rows_t = rng.normal(0, 10, (D, N)).astype(np.float32)
    lo = rng.uniform(-15, 0, (B, D)).astype(np.float32)
    hi = lo + rng.uniform(0, 20, (B, D)).astype(np.float32)
    alive = (rng.random(N) > 0.1).astype(np.int32)
    coords = rng.integers(0, 4, (2, N)).astype(np.int32)
    first = rng.integers(0, 2, (B, 2)).astype(np.int32)
    last = first + rng.integers(0, 3, (B, 2)).astype(np.int32)
    sv = rows_t[1]
    tband = np.stack([lo[:, 1], hi[:, 1]], axis=1)
    probe = {"coords": coords, "first": first, "last": last}
    sort = {"sv": sv, "tband": tband}
    stages = {"none": {}, "probe": probe, "sort": sort,
              "probe+sort": {**probe, **sort}}
    return rows_t, lo, hi, alive, stages


STAGES = ["none", "probe", "sort", "probe+sort"]


def _np(out):
    return tuple(np.asarray(x) for x in out)


def _assert_prefix_equal(port, want, cap, tail=True):
    c_p, h_p, s_p = port
    c_w, h_w, s_w = want
    assert np.array_equal(c_p, c_w)
    assert np.array_equal(s_p, s_w)
    take = np.minimum(c_w.reshape(-1), cap)
    for q in range(take.size):
        assert np.array_equal(h_p[q, :take[q]], h_w[q, :take[q]]), q
        if tail:
            assert (h_p[q, take[q]:] == -1).all(), q


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("cap", [64, 4])          # 4: hit_cap overflow
def test_plain_version_equals_jnp_oracle(stage, cap):
    rows_t, lo, hi, alive, stages = _inputs()
    st = stages[stage]
    port = _np(fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                hit_cap=cap, device="cpu"))
    want = _np(ref_fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                    hit_cap=cap, use_pallas=False))
    assert port[1].shape == want[1].shape == (B, cap + TILE)
    _assert_prefix_equal(port, want, cap)
    assert np.array_equal(port[1], want[1])     # -1 tails agree too


@pytest.mark.parametrize("stage", STAGES)
def test_plain_version_equals_pallas_interpret(stage):
    rows_t, lo, hi, alive, stages = _inputs(seed=22)
    st = stages[stage]
    cap = 64
    port = _np(fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                hit_cap=cap, device="cpu"))
    want = _np(ref_fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                    hit_cap=cap, use_pallas=True,
                                    interpret=True))
    _assert_prefix_equal(port, want, cap, tail=False)


def _gather_case(seed=33):
    """Cell-major layout plus per-query candidate-box row lists, as the
    device plane builds them (the reference test's construction)."""
    rng = np.random.default_rng(seed)
    n, d, b, k, c = 2_040, 3, 7, 2, 4
    cell = np.sort(rng.integers(0, c ** k, n))
    coords = np.stack([(cell // c ** (k - 1 - j)) % c for j in range(k)])
    coords = np.pad(coords, ((0, 0), (0, 1)),
                    constant_values=-1).astype(np.int32)
    offsets = np.searchsorted(cell, np.arange(c ** k + 1))
    rows_t = rng.normal(0, 10, (d, n)).astype(np.float32)
    rows_t = np.pad(rows_t, ((0, 0), (0, 1)), constant_values=np.inf)
    alive = np.append((rng.random(n) > 0.1), 0).astype(np.int32)[None]
    lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
    first = rng.integers(0, c - 1, (b, k)).astype(np.int32)
    last = first + rng.integers(0, 2, (b, k)).astype(np.int32)
    radix = c ** (k - 1 - np.arange(k))
    lists = []
    for q in range(b):
        cells = (first[q][None, :] +
                 np.stack(np.meshgrid(*[np.arange(last[q, j] - first[q, j] + 1)
                                        for j in range(k)], indexing="ij"),
                          axis=-1).reshape(-1, k)) @ radix
        cells.sort()
        lists.append(_multi_arange(offsets[cells],
                                   offsets[cells + 1] - offsets[cells]))
    gw = 1 << int(max(max(l.size for l in lists), 1) - 1).bit_length()
    gidx = np.full((b, gw), n, np.int32)
    for q, lst in enumerate(lists):
        gidx[q, :lst.size] = lst
    sv = rows_t[1:2].copy()
    tband = np.stack([lo[:, 1], hi[:, 1]], axis=1)
    return [rows_t, lo.T.copy(), hi.T.copy(), alive, coords, first, last,
            sv, tband], gidx


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("route", ["full", "gidx"])
def test_plain_version_routes_equal_reference(sort, route):
    """Full-scan and candidate-gather routes of the port's plain version
    against the reference oracle's same route (and each other)."""
    args, gidx = _gather_case()
    if not sort:
        args = args[:7]
    kw = dict(tile=256, hit_cap=64)
    g = gidx if route == "gidx" else None
    port = _np(tref.fused_scan_ref(*(torch.from_numpy(a) for a in args),
                                   gidx=None if g is None
                                   else torch.from_numpy(g), **kw))
    want = _np(jref.fused_scan_ref(*args, gidx=g, **kw))
    assert np.array_equal(port[0], want[0])
    assert np.array_equal(port[1], want[1])
    assert np.array_equal(port[2], want[2])
    full = _np(tref.fused_scan_ref(*(torch.from_numpy(a) for a in args),
                                   **kw))
    assert np.array_equal(port[1], full[1])


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor takes the plain version and counts no kernel launch."""
    rows_t, lo, hi, alive, stages = _inputs()
    before = fused_scan.launches
    c, h, s = fused_range_scan(rows_t, lo, hi, alive, tile=TILE, hit_cap=64,
                               device="cpu")
    assert fused_scan.launches == before
    assert c.dtype == h.dtype == s.dtype == torch.int32
    assert c.device.type == "cpu"


# ---- the CUDA kernel's pass structure, modelled in torch ------------------

from repro_torch.kernels.fused_scan import (BLOCK_RESERVED, BLOCKS_PER_SM,
                                            MAX_STAGES, QCHUNK, SCAN_CHUNK,
                                            SM_SMEM, launch_plan)
from repro_torch.kernels._abi import SMEM_LIMIT

fused_scan_module = importlib.import_module("repro_torch.kernels.fused_scan")


def _model_fused_scan(rows_t, flo_t, fhi_t, alive, coords=None, first=None,
                      last=None, sv=None, tband=None, *, tile, hit_cap,
                      seed=0):
    """What ``csrc/fused_scan.cu`` computes, pass by pass: per warp's rows
    the exact activity skip, nonzero hit words into a bitmap that starts as
    garbage, per-tile counts, chunk sums, a scan, a pair list in arbitrary
    order, and the expand with the hit_cap cut."""
    d, n = rows_t.shape
    bp = flo_t.shape[1]
    plan = launch_plan(d, 0 if coords is None else coords.shape[0],
                       sv is not None, tile, n, bp)
    rt, words = plan.tile_rows, plan.tile_rows // 32
    wrows = 32 * (rt // plan.threads)               # rows a warp owns
    gen = torch.Generator().manual_seed(seed)
    bitmap = torch.randint(0, 2 ** 31, (bp, n // 32), generator=gen)
    tile_hits = torch.zeros((plan.num_tiles, bp), dtype=torch.int64)
    tile_cand = torch.zeros_like(tile_hits)
    wmask = torch.zeros_like(tile_hits)
    ok = torch.ones(bp, dtype=torch.bool)
    if coords is not None:
        ok &= (first <= last).all(1)
    if sv is not None:
        ok &= tband[:, 0] < tband[:, 1]
    bit = 2 ** torch.arange(32, dtype=torch.int64)
    for t in range(plan.num_tiles):
        for w0 in range(t * rt, (t + 1) * rt, wrows):
            sl = slice(w0, w0 + wrows)
            live = alive[0, sl] > 0
            if not live.any():
                continue
            act = ok.clone()
            if coords is not None:
                box = coords[:, sl][:, live]
                act &= ((box.max(1).values[None] >= first)
                        & (box.min(1).values[None] <= last)).all(1)
            for q in torch.nonzero(act).flatten().tolist():
                cand = live.clone()
                if coords is not None:
                    cand &= ((coords[:, sl] >= first[q][:, None])
                             & (coords[:, sl] <= last[q][:, None])).all(0)
                if sv is not None:
                    cand &= ((sv[0, sl] >= tband[q, 0])
                             & (sv[0, sl] < tband[q, 1]))
                inside = ((rows_t[:, sl] >= flo_t[:, q:q + 1])
                          & (rows_t[:, sl] < fhi_t[:, q:q + 1])).all(0)
                hit = (cand & inside).reshape(-1, 32)
                hb = (hit.long() * bit).sum(1)
                for r in range(hb.numel()):
                    wi = (w0 - t * rt) // 32 + r
                    if hb[r]:
                        bitmap[q, t * words + wi] = hb[r]
                        wmask[t, q] |= 1 << wi
                tile_hits[t, q] += int(hit.sum())
                tile_cand[t, q] += int(cand.sum())
    chunk = torch.arange(plan.num_tiles) // SCAN_CHUNK
    sums = torch.zeros((plan.chunks, bp), dtype=torch.int64).index_add_(
        0, chunk, tile_hits)
    chunk_off = torch.cumsum(sums, 0) - sums
    counts = tile_hits.sum(0)
    scanned = tile_cand.sum(0)
    hits = torch.full((bp, hit_cap + tile), -1, dtype=torch.int64)
    pairs = torch.nonzero(tile_hits > 0)
    pairs = pairs[torch.randperm(pairs.shape[0], generator=gen)]
    for t, q in pairs.tolist():
        c = t // SCAN_CHUNK
        off = int(chunk_off[c, q] + tile_hits[c * SCAN_CHUNK:t, q].sum())
        for wi in range(words):
            if not (int(wmask[t, q]) >> wi) & 1:
                continue
            word = int(bitmap[q, t * words + wi])
            for b in range(32):
                if (word >> b) & 1:
                    if off < hit_cap:
                        hits[q, off] = t * rt + wi * 32 + b
                    off += 1
    i32 = torch.int32
    return (counts.to(i32)[:, None], hits.to(i32), scanned.to(i32)[:, None])


def _cell_major_case(rng, n, n_pad, b, d=3, k=2, c=6):
    cell = np.sort(rng.integers(0, c ** k, n))
    coords = np.full((k, n_pad), -1, np.int32)
    for j in range(k):
        coords[j, :n] = (cell // c ** (k - 1 - j)) % c
    rows_t = np.full((d, n_pad), np.inf, np.float32)
    rows_t[:, :n] = rng.normal(0, 10, (d, n))
    alive = np.zeros((1, n_pad), np.int32)
    alive[0, :n] = rng.random(n) > 0.1
    alive[0, 700:1_300] = 0                       # a run of dead rows
    sv = np.full((1, n_pad), np.inf, np.float32)
    sv[0, :n] = rows_t[1, :n]
    first = rng.integers(0, c, (b, k)).astype(np.int32)
    last = np.minimum(first + rng.integers(-1, 3, (b, k)), c - 1).astype(
        np.int32)                                 # some empty ranges
    lo = rng.uniform(-20, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (b, d)).astype(np.float32)
    tband = np.stack([lo[:, 1], hi[:, 1]], 1)
    tband[::7] = (np.inf, -np.inf)                # inert, as padded slots
    base = [rows_t, lo.T.copy(), hi.T.copy(), alive]
    probe = dict(coords=coords, first=first, last=last)
    sort = dict(sv=sv, tband=tband)
    return base, {"none": {}, "probe": probe, "sort": sort,
                  "probe+sort": {**probe, **sort}}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("bp,tile,cap", [(5, 256, 64), (70, 512, 37),
                                         (130, 128, 4096)])
def test_kernel_pass_model_equals_plain_version(stage, bp, tile, cap):
    """The kernel's decomposition (activity skip per warp's rows, bitmap
    words, tile counts, chunk scan, pair list, expand with the hit_cap cut)
    gives exactly the plain version's counts, hits with their -1 tails, and
    rows scanned."""
    rng = np.random.default_rng(bp + tile)
    n = 2_000 if tile == 128 else 4_500
    n_pad = n + (-n) % tile
    base, stages = _cell_major_case(rng, n, n_pad, bp)
    args = [torch.from_numpy(a) for a in base]
    kw = {name: torch.from_numpy(a) for name, a in stages[stage].items()}
    want = tref.fused_scan_ref(*args, **kw, tile=tile, hit_cap=cap)
    got = _model_fused_scan(*args, **kw, tile=tile, hit_cap=cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if cap == 37:
        assert int((want[0] > cap).sum()) > 0           # the cap cut
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("d,k,sort,tile,n,bp", [
    (8, 3, True, 512, 18_432_000, 64),     # the airline primary segment
    (8, 8, True, 512, 1_579_008, 64),      # an outlier segment, k = D
    (8, 0, False, 128, 2_048, 64),         # a delta segment
    (8, 3, True, 512, 5_120, 130),         # > QCHUNK queries
    (3, 2, False, 96, 960, 5),             # a tile that is 3 words
    (2, 2, True, 1_024, 4_096, 7),         # a tile above 512 rows
])
def test_launch_plan_fits_the_card(d, k, sort, tile, n, bp):
    plan = launch_plan(d, k, sort, tile, n, bp)
    assert tile % plan.tile_rows == 0 and plan.tile_rows <= 512
    assert plan.tile_rows % plan.threads == 0 and plan.threads % 32 == 0
    assert plan.num_tiles * plan.tile_rows == n
    assert plan.chunks == -(-plan.num_tiles // SCAN_CHUNK)
    assert plan.qchunk == min(bp, QCHUNK)
    assert plan.launches * plan.qchunk >= bp > (plan.launches - 1) * plan.qchunk
    assert 1 <= plan.stages <= MAX_STAGES and plan.smem <= SMEM_LIMIT
    # the ring's planes are bulk-copied: 16-byte multiples
    assert (4 * plan.tile_rows) % 16 == 0
    assert plan.bitmap_words == bp * n // 32
    per_tile, per_chunk = plan.num_tiles * bp, plan.chunks * bp
    assert plan.scratch_words == (4 * per_tile + 2 * per_chunk + 1
                                  + plan.launches + per_chunk + per_tile)


def test_launch_plan_puts_blocks_per_sm_before_ring_depth(monkeypatch):
    """The airline primary segment keeps BLOCKS_PER_SM blocks on an SM
    (one stage each); the delta's small tiles keep them with a full ring;
    the outlier's wider tiles (k = 8) give up blocks, not the last stage."""
    def per_sm(plan):
        return SM_SMEM // (plan.smem + BLOCK_RESERVED)
    primary = launch_plan(8, 3, True, 512, 18_432_000, 64)
    assert per_sm(primary) >= BLOCKS_PER_SM and primary.stages >= 1
    delta = launch_plan(8, 0, False, 128, 2_048, 64)
    assert per_sm(delta) >= BLOCKS_PER_SM and delta.stages == MAX_STAGES
    outlier = launch_plan(8, 8, True, 512, 1_579_008, 64)
    assert 1 <= per_sm(outlier) < BLOCKS_PER_SM and outlier.stages >= 1
    monkeypatch.setattr(fused_scan_module, "BLOCKS_PER_SM", 2)
    deeper = launch_plan(8, 3, True, 512, 18_432_000, 64)
    assert deeper.stages > primary.stages and per_sm(deeper) >= 2


def test_launch_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError):
        launch_plan(200, 0, False, 512, 512, 4)
