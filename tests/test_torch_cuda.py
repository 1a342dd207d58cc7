"""The hand-written CUDA kernels against their plain torch versions, on the
card.

Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Every test skips inside its body when no card is present (the marker is
registered in ``conftest.py``).  The bar is exact equality: the kernel and
its plain version compute the same compares, the same roundings and the
same integer counts.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import COAXIndex
from repro_torch.data import knn_rect_queries, make_airline, make_osm
from repro_torch.engine import QueryServer, split_hits
from repro_torch.engine.device import CUDA_HIT_CAP
from repro_torch.kernels import (fused_range_scan, fused_scan, grid_histogram,
                                 margin_split, range_scan, range_scan_batch,
                                 ref)
from repro_torch.kernels.ops import (_pad_to, histogram_operands,
                                     split_operands)

fused_scan_module = importlib.import_module("repro_torch.kernels.fused_scan")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stage_sets(rng, n, b, d):
    coords = np.sort(rng.integers(0, 6, (2, n)), axis=1).astype(np.int32)
    first = rng.integers(0, 4, (b, 2)).astype(np.int32)
    last = first + rng.integers(0, 3, (b, 2)).astype(np.int32)
    sv = rng.normal(0, 10, n).astype(np.float32)
    lo = rng.uniform(-15, 0, b).astype(np.float32)
    tband = np.stack([lo, lo + rng.uniform(0, 20, b).astype(np.float32)], 1)
    probe = {"coords": coords, "first": first, "last": last}
    sort = {"sv": sv, "tband": tband}
    return [{}, probe, sort, {**probe, **sort}]


def _assert_same(got, want, cap):
    c_g, h_g, s_g = (x.cpu().numpy() for x in got)
    c_w, h_w, s_w = (x.cpu().numpy() for x in want)
    assert np.array_equal(c_g, c_w)
    assert np.array_equal(s_g, s_w)
    assert np.array_equal(h_g, h_w)      # defined prefix AND the -1 tail


@pytest.mark.parametrize("n,b,d,tile,cap", [
    (700, 5, 3, 256, 64),          # ragged N, few queries
    (5_000, 70, 4, 512, 1024),     # > 32 queries: two reduction chunks
    (3_000, 16, 8, 128, 8),        # tiny hit_cap: overflow on most queries
    (5_000, 130, 8, 512, 1024),    # > 128 queries: two count launches
])
def test_kernel_matches_plain_version(cuda, n, b, d, tile, cap):
    rng = np.random.default_rng(n + b)
    rows_t = rng.normal(0, 10, (d, n)).astype(np.float32)
    lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
    alive = (rng.random(n) > 0.1).astype(np.int32)
    before = fused_scan.launches
    for stages in _stage_sets(rng, n, b, d):
        kw = dict(tile=tile, hit_cap=cap)
        got = fused_range_scan(rows_t, lo, hi, alive, **stages, **kw,
                               device=cuda)
        want = fused_range_scan(rows_t, lo, hi, alive, **stages, **kw,
                                device="cpu")
        _assert_same(got, want, cap)
    assert fused_scan.launches == before + 4


def test_kernel_subnormal_and_infinite_bounds(cuda):
    """Exact compares at the edges: subnormal rows, ±inf and huge bounds
    (no flush to zero in the kernel)."""
    tiny = np.float32(1e-45)
    vals = np.array([0.0, -0.0, tiny, -tiny, 2 * tiny, 1e-38, -1e-38,
                     3.4e38, -3.4e38, np.inf, 1.0, -1.0], np.float32)
    rows_t = np.tile(vals, (2, 43))[:, :512]
    lo = np.array([[0.0, -np.inf], [tiny, tiny], [-tiny, -3.4e38],
                   [-np.inf, -np.inf], [3.4e38, 0.0]], np.float32)
    hi = np.array([[tiny, np.inf], [np.inf, 2 * tiny], [0.0, 3.4e38],
                   [np.inf, np.inf], [np.inf, np.inf]], np.float32)
    got = fused_range_scan(rows_t, lo, hi, tile=256, hit_cap=600, device=cuda)
    want = fused_range_scan(rows_t, lo, hi, tile=256, hit_cap=600,
                            device="cpu")
    _assert_same(got, want, 600)


def test_kernel_cell_major_segment(cuda):
    """A grid-shaped segment (rows cell-major, 3 coordinate dims, dead
    padding tail): tiles whose coordinate box misses a query are skipped,
    and the answer stays that of the full plain scan."""
    rng = np.random.default_rng(5)
    n, n_pad, c, k, d, b = 60_000, 65_536, 8, 3, 8, 64
    cell = np.sort(rng.integers(0, c ** k, n))
    coords = np.full((k, n_pad), -1, np.int32)
    for j in range(k):
        coords[j, :n] = (cell // c ** (k - 1 - j)) % c
    rows_t = np.full((d, n_pad), np.inf, np.float32)
    rows_t[:, :n] = rng.normal(0, 10, (d, n))
    alive = np.zeros((1, n_pad), np.int32)
    alive[0, :n] = rng.random(n) > 0.05
    sv = np.full((1, n_pad), np.inf, np.float32)
    sv[0, :n] = rows_t[0, :n]
    first = rng.integers(0, c, (b, k)).astype(np.int32)
    last = np.minimum(first + rng.integers(0, 3, (b, k)), c - 1).astype(np.int32)
    lo = rng.uniform(-20, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (b, d)).astype(np.float32)
    tband = np.stack([lo[:, 0], hi[:, 0]], 1)
    args = [rows_t, lo.T.copy(), hi.T.copy(), alive, coords, first, last, sv,
            tband]
    got = fused_scan(*(torch.from_numpy(a).to(cuda) for a in args),
                     tile=512, hit_cap=1024)
    want = ref.fused_scan_ref(*(torch.from_numpy(a) for a in args),
                              tile=512, hit_cap=1024)
    _assert_same(got, want, 1024)
    assert int(got[2].sum()) > 0              # candidates were scanned


def _cell_major(rng, n, n_pad, b, d=8, k=3, c=8, dead=()):
    """A grid-shaped segment as the device plane lays it out: rows
    cell-major, a dead padding tail, ``dead`` row ranges tombstoned; all
    four operand sets (none, probe, sort, probe+sort) as kernel inputs."""
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
    last = np.minimum(first + rng.integers(0, 3, (b, k)),
                      c - 1).astype(np.int32)
    lo = rng.uniform(-20, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (b, d)).astype(np.float32)
    tband = np.stack([lo[:, 0], hi[:, 0]], 1)
    base = [rows_t, lo.T.copy(), hi.T.copy(), alive]
    probe = dict(coords=coords, first=first, last=last)
    sort = dict(sv=sv, tband=tband)
    return base, [{}, probe, sort, {**probe, **sort}]


@pytest.mark.parametrize("case", ["ring_wraps", "deep_ring_wraps",
                                  "cap_mid_word", "dead_run",
                                  "delta_one_tile", "bp_130"])
def test_redesign_edges_match_plain_version(cuda, case, monkeypatch):
    """The count pass's stage ring wrapping many times (2^20 rows at tile
    512; at the plan's depth and at three stages), a hit_cap of 37 that
    cuts inside a tile and a bitmap word, a run of all-dead tiles, a
    one-tile delta-shaped segment (tile 128), and 130 queries: each equal
    to the plain version, every specialisation."""
    rng = np.random.default_rng(len(case))
    tile, cap = 512, 1024
    if case == "deep_ring_wraps":            # one block an SM, three stages
        monkeypatch.setattr(fused_scan_module, "BLOCKS_PER_SM", 1)
        assert fused_scan_module.launch_plan(
            8, 3, True, 512, 2 ** 20, 64).stages == 3
    if case in ("ring_wraps", "deep_ring_wraps"):
        base, stage_sets = _cell_major(rng, 2 ** 20 - 300, 2 ** 20, 64)
    elif case == "cap_mid_word":
        base, stage_sets = _cell_major(rng, 60_000, 60_416, 64)
        cap = 37
    elif case == "dead_run":
        base, stage_sets = _cell_major(rng, 60_000, 60_416, 64,
                                       dead=[(4_096, 20_480)])
    elif case == "delta_one_tile":
        base, _ = _cell_major(rng, 100, 128, 64)
        stage_sets, tile, cap = [{}], 128, 128
    else:
        base, stage_sets = _cell_major(rng, 60_000, 60_416, 130)
    for stages in stage_sets:
        args = [torch.from_numpy(a) for a in base]
        kw = {name: torch.from_numpy(a) for name, a in stages.items()}
        want = ref.fused_scan_ref(*args, **kw, tile=tile, hit_cap=cap)
        got = fused_scan(*(a.to(cuda) for a in args),
                         **{name: a.to(cuda) for name, a in kw.items()},
                         tile=tile, hit_cap=cap)
        _assert_same(got, want, cap)
        if case == "cap_mid_word":
            assert int((got[0] > cap).sum()) > 0     # the cap did cut
        if case == "dead_run":
            assert int(got[2].sum()) > 0


def test_two_launches_identical_and_counted_once(cuda):
    """Two calls on the same inputs give bit-identical outputs (no atomics
    place hits), and each call counts exactly one launch."""
    base, stage_sets = _cell_major(np.random.default_rng(11), 60_000, 60_416,
                                   64)
    args = [torch.from_numpy(a).to(cuda) for a in base]
    kw = {name: torch.from_numpy(a).to(cuda)
          for name, a in stage_sets[3].items()}
    before = fused_scan.launches
    one = fused_scan(*args, **kw, tile=512, hit_cap=4096)
    assert fused_scan.launches == before + 1
    two = fused_scan(*args, **kw, tile=512, hit_cap=4096)
    assert fused_scan.launches == before + 2
    for x, y in zip(one, two):
        assert torch.equal(x, y)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rows = torch.zeros((2, 512), device=cuda)
    flo = torch.zeros((2, 4), device=cuda)
    alive = torch.ones((1, 512), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fused_scan(rows, flo, flo, alive.float(), tile=256)
    with pytest.raises(ValueError):
        fused_scan(rows, flo, flo, alive, tile=100)
    with pytest.raises(ValueError):
        fused_scan(rows, flo.T.contiguous().T, flo, alive, tile=256)
    with pytest.raises(ValueError):
        fused_scan(rows, flo, flo, alive, tile=256,
                   gidx=torch.zeros((4, 8), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("make", [make_airline, make_osm])
def test_coax_on_cuda_equals_numpy_under_writes(cuda, make):
    """The serving path on the card — pipelined server waves, inserts,
    deletes, a compaction — answers exactly as the numpy host path."""
    ds = make(30_000, seed=2)
    idx = COAXIndex(ds.data, device="cuda")
    rects = knn_rect_queries(ds.data, 48, 64, seed=3)
    srv = QueryServer(idx, max_batch=16, device="cuda")
    rng = np.random.default_rng(4)
    before = fused_scan.launches
    for step in range(3):
        srv.insert(make(500, seed=10 + step).data)
        srv.delete(rng.choice(30_000, 100, replace=False))
        qids = srv.submit_many(rects[16 * step:16 * (step + 1)])
        got = srv.drain()
        idx.backend = "numpy"
        q_n, r_n = idx.query_batch(rects[16 * step:16 * (step + 1)])
        idx.backend = "device"
        want = split_hits(q_n, r_n, 16)
        for i, q in enumerate(qids):
            assert np.array_equal(got[q], want[i]), (step, i)
        if step == 1:
            idx.compact()
    assert fused_scan.launches > before
    s = srv.stats()
    assert s["device_fallbacks"] == 0
    assert idx.device_stats()["dispatches"] == s["waves"]
    plan = idx._coax_plan
    assert plan.hit_cap == CUDA_HIT_CAP
    img = plan.p_img
    assert img.n_pad % img.tile == 0 and img.n_pad - img.n < img.tile


def test_hit_cap_reanswer_on_cuda(cuda):
    """Queries past a small hit buffer are re-answered exactly on the
    host; the rest come from the card."""
    ds = make_airline(20_000, seed=6)
    rects = knn_rect_queries(ds.data, 16, 64, seed=7)
    idx = COAXIndex(ds.data, device="cuda", device_opts={"hit_cap": 16})
    got = idx.query_batch(rects)
    assert idx.last_batch_stats.hit_overflows > 0
    idx.backend = "numpy"
    want = idx.query_batch(rects)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ---- the kernels behind the ops entries ------------------------------------

def _scan_case(rng, n, b, d, tile, dev):
    """Padded rows and (D, B) bounds on ``dev``, windows that cut tiles."""
    rows = rng.normal(0, 10, (d, n)).astype(np.float32)
    lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
    w_lo = rng.integers(0, n // 2, b)
    wins = np.stack([w_lo, w_lo + rng.integers(1, n, b)], 1).astype(np.int32)
    wins[0] = (tile // 3, n - tile // 5)          # cuts the first, last tile
    rows_p = _pad_to(torch.from_numpy(rows).to(dev), tile, float("inf"))
    return (rows_p.contiguous(), torch.from_numpy(lo.T.copy()).to(dev),
            torch.from_numpy(hi.T.copy()).to(dev),
            torch.from_numpy(wins).to(dev))


SCAN_CASES = [
    (5_003, 70, 8, 512),       # ragged N, two shared-memory query chunks
    (3_000, 16, 3, 128),
    (1_000, 5, 2, 100),        # a tile that is not a multiple of 32
]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,b,d,tile", SCAN_CASES)
def test_range_scans_match_plain_versions(cuda, n, b, d, tile):
    rows, lo_t, hi_t, wins = _scan_case(np.random.default_rng(n), n, b, d,
                                        tile, cuda)
    before = (range_scan_batch.launches, range_scan.launches)
    got = range_scan_batch(rows, lo_t, hi_t, wins, tile=tile)
    _equal(got, ref.range_scan_batch_ref(rows, lo_t, hi_t, wins, tile=tile))
    assert int(got[1].sum()) > 0
    for q in range(3):
        lo, hi = lo_t[:, q].contiguous(), hi_t[:, q].contiguous()
        one = range_scan(rows, lo, hi, wins[q].contiguous(), tile=tile)
        _equal(one, ref.range_scan_ref(rows, lo, hi, wins[q], tile=tile))
        _equal(one, (got[0][q], got[1][q]))
    assert (range_scan_batch.launches, range_scan.launches) == (
        before[0] + 1, before[1] + 3)


def test_range_scans_subnormal_and_infinite_bounds(cuda):
    tiny = np.float32(1e-45)
    vals = np.array([0.0, -0.0, tiny, -tiny, 2 * tiny, 1e-38, -1e-38,
                     3.4e38, -3.4e38, np.inf, -np.inf, 1.0], np.float32)
    rows = torch.from_numpy(np.tile(vals, (2, 43))[:, :512].copy()).to(cuda)
    lo = np.array([[0.0, -np.inf], [tiny, tiny], [-tiny, -3.4e38],
                   [-np.inf, -np.inf], [3.4e38, 0.0]], np.float32)
    hi = np.array([[tiny, np.inf], [np.inf, 2 * tiny], [0.0, 3.4e38],
                   [np.inf, np.inf], [np.inf, np.inf]], np.float32)
    lo_t = torch.from_numpy(lo.T.copy()).to(cuda)
    hi_t = torch.from_numpy(hi.T.copy()).to(cuda)
    wins = torch.tensor([[0, 512]] * 5, dtype=torch.int32, device=cuda)
    got = range_scan_batch(rows, lo_t, hi_t, wins, tile=256)
    _equal(got, ref.range_scan_batch_ref(rows, lo_t, hi_t, wins, tile=256))
    for q in range(5):
        args = (rows, lo_t[:, q].contiguous(), hi_t[:, q].contiguous(),
                wins[q].contiguous())
        _equal(range_scan(*args, tile=256),
               ref.range_scan_ref(*args, tile=256))


@pytest.mark.parametrize("buckets", [16, 64, 128])
@pytest.mark.parametrize("n", [999, 100_003])
def test_grid_histogram_matches_plain_version(cuda, buckets, n):
    rng = np.random.default_rng(buckets + n)
    x = rng.normal(0, 3, n).astype(np.float32)
    d = (0.5 * x + rng.gamma(2.0, 0.2, n)).astype(np.float32)   # skewed
    xp, dp, params = histogram_operands(x, d, buckets=buckets, device=cuda)
    before = grid_histogram.launches
    got = grid_histogram(xp, dp, params, buckets=buckets)
    assert grid_histogram.launches == before + 1
    want = ref.grid_histogram_ref(xp, dp, params, buckets=buckets)
    _equal((got,), (want,))
    assert int(got.double().sum()) == n


def _fma_apart_case(rng, n):
    """Columns with many rows whose ``m * x + b`` rounds apart fused and
    unfused, and ``d`` on the unfused value, so such rows sit on the
    margin's edge.  Returns (x, d, m, b, eps, rows rounded apart)."""
    m, b, eps = np.float32(1.7), np.float32(-3.3), np.float32(0.0)
    x = rng.uniform(-100, 100, n).astype(np.float32)
    unfused = m * x + b
    fused = (np.float64(m) * x.astype(np.float64)
             + np.float64(b)).astype(np.float32)
    return x, unfused.copy(), m, b, eps, unfused != fused


def test_margin_split_matches_plain_version_bitwise(cuda):
    rng = np.random.default_rng(3)
    x, d, m, b, eps, apart = _fma_apart_case(rng, 100_003)
    assert apart.sum() > 1_000
    xp, dp, params = split_operands(x, d, m, b, eps, eps, device=cuda)
    before = margin_split.launches
    disp, mask, counts = margin_split(xp, dp, params)
    assert margin_split.launches == before + 1
    w_disp, w_mask, w_counts = ref.margin_split_ref(xp, dp, params)
    assert torch.equal(disp.view(torch.int32), w_disp.view(torch.int32))
    _equal((mask, counts), (w_mask, w_counts))
    # d equals the unfused prediction: disp is exactly 0 on every real row,
    # so every real row is an inlier at eps = 0 (a fused FMA would flip
    # the rows rounded apart)
    assert int(counts.sum()) == 100_003
    # random columns too
    x2 = rng.uniform(-1e3, 1e3, 70_001).astype(np.float32)
    d2 = (2.5 * x2 + 1 + rng.normal(0, 5, 70_001)).astype(np.float32)
    xp, dp, params = split_operands(x2, d2, 2.5, 1.0, 4.0, 6.0, device=cuda)
    got = margin_split(xp, dp, params)
    want = ref.margin_split_ref(xp, dp, params)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    _equal(got[1:], want[1:])


def test_row_id_test_above_2_24_on_the_card(cuda):
    """float32(2^24 + 1) == 2^24: the kernels drop row 2^24 as their plain
    versions and the reference do."""
    n = 2 ** 24 + 1
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1_000, n).astype(np.float32)
    d = (2 * x + 5 + rng.normal(0, 3, n)).astype(np.float32)
    ops_h = histogram_operands(x, d, buckets=64, device=cuda)
    got = grid_histogram(*ops_h, buckets=64)
    _equal((got,), (ref.grid_histogram_ref(*ops_h, buckets=64),))
    assert int(got.double().sum()) == n - 1
    ops_s = split_operands(x, d, 2.0, 5.0, 6.0, 6.0, device=cuda)
    disp, mask, counts = margin_split(*ops_s)
    w = ref.margin_split_ref(*ops_s)
    assert torch.equal(disp.view(torch.int32), w[0].view(torch.int32))
    _equal((mask, counts), w[1:])
    assert int(mask[n - 1]) == 0 and -6.0 <= float(disp[n - 1]) <= 6.0


def _hist_case(cuda, x, d, buckets):
    ops_h = histogram_operands(x, d, buckets=buckets, device=cuda)
    before = grid_histogram.launches
    got = grid_histogram(*ops_h, buckets=buckets)
    assert grid_histogram.launches == before + 1
    want = ref.grid_histogram_ref(*ops_h, buckets=buckets)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got, ops_h


def test_grid_histogram_every_row_in_one_bucket(cuda):
    """The worst skew: every lane of every warp adds to one bin."""
    n = 1_000_003
    x = np.full(n, 7.5, np.float32)
    got, _ = _hist_case(cuda, x, x.copy(), 64)
    assert float(got[0, 0]) == n and int(got.double().sum()) == n


def test_grid_histogram_128_buckets(cuda):
    """64 KiB of bins a histogram: above the 48 KiB default limit."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 3, 300_001).astype(np.float32)
    d = (0.5 * x + rng.gamma(2.0, 0.2, x.size)).astype(np.float32)
    got, _ = _hist_case(cuda, x, d, 128)
    assert int(got.double().sum()) == x.size


def test_grid_histogram_drops_row_2_24(cuda):
    n = 2 ** 24 + 1
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1_000, n).astype(np.float32)
    d = (2 * x + 5 + rng.normal(0, 3, n)).astype(np.float32)
    got, _ = _hist_case(cuda, x, d, 64)
    assert int(got.double().sum()) == n - 1


def test_grid_histogram_unaligned_views_and_repeat_calls(cuda):
    """Operands whose data do not start on a 16-byte boundary are copied
    by the wrapper; two calls give bit-identical output (the scratch is
    left zeroed), one launch counted per call."""
    rng = np.random.default_rng(13)
    n = 65_536
    x = rng.normal(0, 3, n + 1).astype(np.float32)
    d = (x + rng.normal(0, 1, n + 1)).astype(np.float32)
    xs = torch.as_tensor(x, device=cuda)[1:]
    ds = torch.as_tensor(d, device=cuda)[1:]
    assert xs.data_ptr() % 16 and ds.data_ptr() % 16
    _, ops_h = _hist_case(cuda, x[1:], d[1:], 32)
    params = ops_h[2]
    before = grid_histogram.launches
    got = grid_histogram(xs, ds, params, buckets=32)
    again = grid_histogram(xs, ds, params, buckets=32)
    assert grid_histogram.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ref.grid_histogram_ref(xs, ds, params, buckets=32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 3, 999, 1_000_003])
@pytest.mark.parametrize("cut", [0, 2])
def test_grid_histogram_rows_after_the_last_vector(cuda, n, cut):
    """Any N with tile=1: the n % 4 rows after the last whole 4-row vector
    are binned by scalar loads, and ``n_valid`` below n (``cut`` rows
    dropped) reaches into them, as on the CPU route."""
    rng = np.random.default_rng(n + cut)
    x = rng.normal(0, 3, n).astype(np.float32)
    d = (0.5 * x + rng.gamma(2.0, 0.2, n)).astype(np.float32)
    params = histogram_operands(x, d, buckets=16, device=cuda)[2].clone()
    params[4] = float(max(n - cut, 0))
    xt, dt = (torch.as_tensor(a, device=cuda) for a in (x, d))
    before = grid_histogram.launches
    got = grid_histogram(xt, dt, params, buckets=16, tile=1)
    assert grid_histogram.launches == before + 1
    want = grid_histogram(xt.cpu(), dt.cpu(), params.cpu(), buckets=16,
                          tile=1)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert int(got.double().sum()) == max(n - cut, 0)


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rows = torch.zeros((2, 512), device=cuda)
    lo = torch.zeros(2, device=cuda)
    win = torch.tensor([0, 512], dtype=torch.int32, device=cuda)
    col = torch.zeros(512, device=cuda)
    params = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        range_scan(rows, lo, lo, win.float(), tile=256)
    with pytest.raises(ValueError):
        range_scan(rows, lo[:1], lo, win, tile=256)
    with pytest.raises(ValueError):                  # bounds on the CPU
        range_scan(rows, lo.cpu(), lo.cpu(), win, tile=256)
    lo_t = torch.zeros((2, 4), device=cuda)
    wins = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                  # not contiguous
        range_scan_batch(rows, lo_t.T.contiguous().T, lo_t, wins, tile=256)
    with pytest.raises(TypeError):
        range_scan_batch(rows, lo_t, lo_t, wins.long(), tile=256)
    with pytest.raises(ValueError):                  # slab beyond smem
        wide = torch.zeros((200, 512), device=cuda)
        w_t = torch.zeros((200, 4), device=cuda)
        range_scan_batch(wide, w_t, w_t, wins, tile=512)
    with pytest.raises(TypeError):
        grid_histogram(col, col, params.double(), tile=256)
    with pytest.raises(ValueError):
        grid_histogram(col, col[:256], params, tile=256)
    with pytest.raises(ValueError):
        margin_split(col, col, params[:5], tile=256)
    with pytest.raises(TypeError):
        margin_split(col, col.half(), params, tile=256)


# ---- the slice's paths on the card: cache, shards, pins, recovery ----------

def _host_split(idx, rects):
    """The index's numpy host answer at its current write state."""
    bk = idx.backend
    idx.backend = "numpy"
    q, r = idx.query_batch(rects)
    idx.backend = bk
    return split_hits(q, r, rects.shape[0])


def _zipf(data, n, n_hot, seed):
    """The smoke's Zipfian hot-rect stream (``chip_smoke.zipf_rects``, the
    port's copy of ``tests/workloads.py``'s generator, which imports JAX):
    alpha 1.1, a quarter of the draws nested inside their hot rect."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.zipf_rects(data, n, n_hot, 1.1, 0.25, seed, 10_000)


def test_cached_server_on_cuda_equals_host(cuda):
    """Cache misses run ``fused_scan`` on the card, hits launch nothing;
    every answer equals the host path at its write state."""
    ds = make_airline(300_000, seed=2)
    idx = COAXIndex(ds.data, device="cuda")
    rects = _zipf(ds.data, 96, 8, seed=3)
    srv = QueryServer(idx, max_batch=32, cache_bytes=64 << 20, device="cuda")
    launches = []
    for step in range(3):
        if step == 2:
            srv.insert(make_airline(500, seed=11).data)
            srv.delete(np.arange(200))
            srv.flush_writes()
        before = fused_scan.launches
        qids = srv.submit_many(rects)
        got = srv.drain()
        launches.append(fused_scan.launches - before)
        want = _host_split(idx, rects)
        for i, q in enumerate(qids):
            assert np.array_equal(got[q], want[i]), (step, i)
    s = srv.stats()
    assert launches[0] > 0 and launches[1] == 0 and launches[2] > 0
    assert s["cache_hits"] + s["cache_partial"] > 0 and s["cache_bytes"] > 0


def test_sharded_plane_on_cuda_equals_host(cuda):
    """Every shard's waves run on the card; the plane equals a single
    index's host answer through writes and a compaction."""
    ds = make_airline(300_000, seed=4)
    single = COAXIndex(ds.data, backend="numpy", device="cuda")
    srv = QueryServer(COAXIndex(ds.data, device="cuda"), max_batch=32,
                      shards=4, device="cuda")
    plane = srv.executor.index
    assert plane.n_shards == 4 and plane.device == "cuda"
    rects = knn_rect_queries(ds.data, 64, 64, seed=5)
    before = fused_scan.launches
    for step in range(3):
        rows = make_airline(400, seed=20 + step).data
        dead = np.arange(step * 50, step * 50 + 50)
        srv.insert(rows)
        srv.delete(dead)
        single.insert(rows)
        single.delete(dead)
        if step == 1:
            srv.flush_writes()
            plane.compact()
            single.compact()
        qids = srv.submit_many(rects)
        got = srv.drain()
        q, r = single.query_batch(rects)
        want = split_hits(q, r, rects.shape[0])
        for i, qid in enumerate(qids):
            assert np.array_equal(got[qid], want[i]), (step, i)
    assert fused_scan.launches > before
    assert all(s._coax_plan.device.type == "cuda" for s in plane.shards)
    assert sum(p["queries"] for p in srv.stats()["per_shard"]) > 0


def test_pin_across_handoff_on_cuda_frees_the_old_plan(cuda):
    """A pin holds the old epoch's device plan across a background handoff
    and answers through it on the card (``fused_scan``) as the index did at
    pin time; releasing it frees the plan and its device memory."""
    import gc
    import weakref
    from repro_torch.core import CoaxConfig
    ds = make_airline(300_000, seed=6)
    cfg = CoaxConfig(background_compact=True, compact_min_delta=1_000,
                     compact_delta_frac=1e-3)
    idx = COAXIndex(ds.data, cfg, device="cuda")
    rects = knn_rect_queries(ds.data, 32, 64, seed=7)
    live0 = idx.query_batch_split(rects)
    pin = idx.pin_epoch()
    plan = weakref.ref(pin._plan)
    rows = weakref.ref(pin._plan.p_img.rows_t)
    before = fused_scan.launches
    want = pin.query_batch_split(rects)
    assert fused_scan.launches > before         # pinned waves run the kernel
    for i, w in enumerate(want):
        assert np.array_equal(live0[i], w), i
    while idx.background_compactions < 1:
        idx.insert(make_airline(600, seed=30 + idx.trigger_checks).data)
        idx.finish_handoff()
    got = idx.query_batch_split(rects)          # the new epoch's plan
    for i, (g, h) in enumerate(zip(got, _host_split(idx, rects))):
        assert np.array_equal(g, h), i
    assert idx._coax_plan is not plan() and plan() is not None
    assert rows() is not idx._coax_plan.p_img.rows_t
    before = fused_scan.launches
    for i, (p, w) in enumerate(zip(pin.query_batch_split(rects), want)):
        assert np.array_equal(p, w), i
    assert fused_scan.launches > before         # on the old epoch's images
    held = torch.cuda.memory_allocated()
    pin.release()
    gc.collect()
    assert plan() is None and rows() is None and idx.pinned_epochs == []
    assert torch.cuda.memory_allocated() < held


def test_restore_and_recover_build_the_plan_on_cuda(cuda, tmp_path):
    """A journaled index, crashed, restores on the card: the recovered
    index's first wave builds its device plan there and answers as the
    never-crashed index's host path; ``QueryServer.recover`` serves it."""
    from repro_torch.storage import restore
    ds = make_airline(300_000, seed=8)
    live = COAXIndex(ds.data, backend="numpy", device="cuda")
    vic = COAXIndex(ds.data, device="cuda").attach_durability(tmp_path)
    for step in range(3):
        rows = make_airline(500, seed=40 + step).data
        for idx in (live, vic):
            idx.insert(rows)
            idx.delete(np.arange(step * 70, step * 70 + 70))
    vic.durable.sync()
    del vic
    rects = knn_rect_queries(ds.data, 32, 64, seed=9)
    want = live.query_batch_split(rects)
    rec = restore(tmp_path, device="cuda")
    assert rec.backend == "device" and rec._coax_plan is None
    before = fused_scan.launches
    got = rec.query_batch_split(rects)
    assert fused_scan.launches > before
    assert rec._coax_plan.device.type == "cuda"
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    srv = QueryServer.recover(tmp_path, max_batch=16, device="cuda")
    qids = srv.submit_many(rects)
    res = srv.drain()
    for i, q in enumerate(qids):
        assert np.array_equal(res[q], want[i]), i
    srv.close()


def _replicated(tmp_path, backend, dev):
    """A two-replica ``ReplicatedServer`` on ``backend``/``dev``: a torn
    frame to replica-0, four write batches whose last fires the size
    trigger and kills the primary mid-rotation, a promotion, one write
    through the promoted primary.  Returns the replicas' answers after each
    batch, after the promotion and after the last write, and the
    ``fused_scan`` launches of the replicas' waves."""
    from repro_torch.core import CoaxConfig
    from repro_torch.replication import ReplicatedServer
    from repro_torch.runtime import FaultPlan
    ds = make_airline(200_000, seed=12)
    cfg = CoaxConfig(compact_min_delta=1_500, compact_delta_frac=0.0)
    plan = FaultPlan({"ship.replica-0": {2: "tear"},
                      "primary.rotate": {0: "crash"}})
    srv = ReplicatedServer(COAXIndex(ds.data, cfg, backend=backend,
                                     device=dev), tmp_path / backend,
                           n_replicas=2, plan=plan, replica_backend=backend,
                           device=dev)
    rects = knn_rect_queries(ds.data, 32, 64, seed=13)
    answers, launches = [], 0

    def read():
        nonlocal launches
        for _ in range(4):
            srv.tick()
        before = fused_scan.launches
        answers.append(srv.query_batch_split(rects))
        launches += fused_scan.launches - before

    crashed = None
    for step in range(4):
        try:
            srv.insert(make_airline(400, seed=30 + step).data)
            srv.delete(np.arange(step * 100, step * 100 + 100))
        except RuntimeError:
            crashed = step                   # the rotation's injected crash
            break
        read()
    assert crashed is not None and srv.stats()["transport_faults"]["tears"] == 1
    srv.kill_primary()
    promoted = srv.promote()
    assert promoted.frontier >= srv.acked and promoted.index.device == dev
    answers.append(srv.primary.query_batch_split(rects))
    srv.insert(make_airline(300, seed=50).data)
    read()
    assert srv.replicas[0].reseeds == 1
    return answers, launches, crashed


def test_replicated_server_on_cuda_equals_numpy_replicas(cuda, tmp_path):
    """Replicas on the card (each wave ``fused_scan`` launches from the
    replica's own plan) answer as replicas on the host path, through wire
    damage, a primary killed mid-rotation and a promotion."""
    got, launches, crashed = _replicated(tmp_path, "device", "cuda")
    want, _, ref_crashed = _replicated(tmp_path, "numpy", "cpu")
    assert crashed == ref_crashed and len(got) == len(want) >= 3
    assert launches >= 2 * (len(got) - 1)
    for k, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.dtype == np.int64 and np.array_equal(a, b), (k, i)


def test_router_on_cuda_launches_fused_scan_and_admits_as_numpy(cuda):
    """The LM router on the card: 512 submissions (the index builds at 256
    pending), admissions in waves of 8 over several bands; every admission
    equals the numpy router's, and each one against a built index is one
    wave of ``fused_scan`` launches."""
    from repro_torch.runtime.router import CoaxRouter
    dev, host = CoaxRouter(device="cuda"), CoaxRouter(backend="numpy")
    rng = np.random.default_rng(21)
    for i in range(512):
        plen = int(rng.choice([16, 32, 64, 128]))
        args = (rng.integers(1, 255, plen).astype(np.int32),
                int(rng.integers(4, 16)), float(rng.random()))
        for r in (dev, host):
            r.submit(*args, arrival=float(i))
    before = fused_scan.launches
    bands = [(0, 512), (16, 64), (60, 130)]
    k = 0
    while len(host):
        band = bands[k % 3] if k % 4 else (0, np.inf)
        got = [r.rid for r in dev.admit(8, prompt_len_range=band)]
        assert got == [r.rid for r in host.admit(8, prompt_len_range=band)]
        k += 1
        assert k < 1_000
    assert len(dev) == 0 and fused_scan.launches > before
    s_d, s_h = dev.stats(), host.stats()
    for s in (s_d, s_h):
        s.pop("admit_p50_ms"), s.pop("admit_p99_ms")
    assert s_d == s_h


def test_tiny_model_prefill_and_decode_on_cuda_match_the_cpu(cuda):
    """A tiny danube (ring cache that wraps) and a tiny gemma2 (paired
    caches, softcaps, GeGLU) with the same bfloat16 weights on the card
    and on the CPU: prefill and 12 decode steps agree at the bfloat16 bar
    (rtol 0.05 / atol 0.08)."""
    import dataclasses
    from conftest import tiny_config
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_params, make_generator
    for arch, split in (("h2o-danube-3-4b", False), ("gemma2-27b", True)):
        cfg = dataclasses.replace(tiny_config(get_config(arch)),
                                  split_local_cache=split)
        cpu = cast_params(build_model(cfg, device="cpu").init(
            make_generator(0)))
        gpu = build_model(cfg, device="cuda")
        cast_params(gpu).load_state_dict(cpu.state_dict())
        toks = np.random.default_rng(22).integers(0, 200, (2, 24))
        outs = []
        for m in (cpu, gpu):
            t = torch.as_tensor(toks, device=m.device)
            logits, cache = m.prefill({"tokens": t[:, :12]}, 32)
            seq = [logits.float().cpu()]
            for step in range(12, 24):
                logits, cache = m.decode_step(cache, t[:, step:step + 1], step)
                seq.append(logits.float().cpu())
            outs.append(torch.cat(seq, 1))
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                   rtol=0.05, atol=0.08, err_msg=arch)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "minicpm3-4b"])
def test_new_family_forward_prefill_and_decode_on_cuda_match_the_cpu(
        cuda, arch):
    """Each family this port added (ssm, hybrid, MLA), tiny, with the same
    bfloat16 weights on the card and on the CPU: the forward, prefill and
    12 decode steps (conv tails and SSD state, or latent caches, written
    in place) agree at the bfloat16 bar (rtol 0.05 / atol 0.08)."""
    from conftest import tiny_config
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_params, make_generator
    cfg = tiny_config(get_config(arch))
    cpu = cast_params(build_model(cfg, device="cpu").init(make_generator(0)))
    gpu = build_model(cfg, device="cuda")
    cast_params(gpu).load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(24).integers(0, 200, (2, 24))
    outs = []
    for m in (cpu, gpu):
        t = torch.as_tensor(toks, device=m.device)
        with torch.no_grad():
            full, _ = m.forward({"tokens": t[:, :16]})
        logits, cache = m.prefill({"tokens": t[:, :12]}, 32)
        seq = [full.float().cpu(), logits.float().cpu()]
        for step in range(12, 24):
            logits, cache = m.decode_step(cache, t[:, step:step + 1], step)
            seq.append(logits.float().cpu())
        outs.append(torch.cat(seq, 1))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                               rtol=0.05, atol=0.08, err_msg=arch)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_moe_vlm_encdec_prefill_and_decode_on_cuda_match_the_cpu(
        cuda, monkeypatch, arch):
    """Each of the MoE, vlm and enc-dec families, tiny (2 layers; the
    enc-dec 2 + 2), with the same weights on the card and on the CPU at
    float32 activations: the forward, a prefill (with the vlm's patches
    or the enc-dec's frames) and 8 decode steps agree within rtol 1e-4 /
    atol 1e-4, and every MoE routing choice is the same on both (float32
    router logits: no top-2 near-tie at these sizes)."""
    from conftest import tiny_config
    import repro_torch.models.common as p_common
    import repro_torch.models.moe as p_moe
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)
    cfg = tiny_config(get_config(arch))
    cpu = build_model(cfg, device="cpu").init(make_generator(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(25)
    toks = rng.integers(0, 200, (2, 20))
    stub = rng.normal(0, 1, (2, 16 if cfg.family == "encdec" else
                             cfg.n_patches, cfg.d_model)).astype(np.float32)
    s = 1 if cfg.family == "encdec" else 12
    first = s + cfg.n_patches
    routes, route = [], p_moe.route

    def recording(router, x, top_k):
        out = route(router, x, top_k)
        routes.append(out[2].cpu())
        return out
    monkeypatch.setattr(p_moe, "route", recording)
    outs, chosen = [], []
    for m in (cpu, gpu):
        routes.clear()
        t = torch.as_tensor(toks, device=m.device)
        batch = {"tokens": t[:, :s]}
        if cfg.family != "dense" and cfg.family != "moe":
            key = "frames" if cfg.family == "encdec" else "patches"
            batch[key] = torch.as_tensor(stub, device=m.device)
        with torch.no_grad():
            full, _ = m.forward(dict(batch, tokens=t[:, :s + 8]))
        logits, cache = m.prefill(batch, 32)
        seq = [full.cpu(), logits.cpu()]
        for i in range(8):
            logits, cache = m.decode_step(cache, t[:, s + i:s + i + 1],
                                          first + i)
            seq.append(logits.cpu())
        outs.append(torch.cat(seq, 1))
        chosen.append([r.clone() for r in routes])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                               rtol=1e-4, atol=1e-4, err_msg=arch)
    assert len(chosen[0]) == len(chosen[1])
    assert all(torch.equal(a, b) for a, b in zip(*chosen))
    assert bool(chosen[0]) == bool(cfg.n_experts)


def _train_twin(cfg, batch, dev, seed=0):
    """One ``make_train_step`` step of ``cfg`` on ``dev`` from the seeded
    CPU weights: (metrics as floats, the updated parameters on the CPU)."""
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    host = build_model(cfg, device="cpu").init(make_generator(seed))
    model = build_model(cfg, device=dev)
    model.load_state_dict(host.state_dict())
    del host
    state = adamw_init(model)
    m = make_train_step(model, AdamWConfig(lr=1e-3, eps=1e-3))(state, batch)
    out = {k: float(m[k]) for k in ("loss", "grad_norm")}
    return out, {n: p.detach().cpu() for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_layer_full_width_train_step_on_cuda_matches_the_cpu(
        cuda, monkeypatch, dtype):
    """h2o-danube-3-4b cut to 2 layers, full width (d_model 3840, vocab
    32,000): one train step (loss, backward through remat, AdamW) from the
    same weights and batch on the card and on the CPU.  float32
    activations: loss and grad norm within rtol 1e-4, updated parameters
    within atol 1e-5; bfloat16 (the shipped dtype): rtol 0.05 /
    atol 0.08.  AdamW's eps is 1e-3: the first update g / (|g| + eps)
    multiplies a gradient difference by up to 1 / (4 eps), so at the
    default 1e-8 the two devices' float32 GEMM orders move a few of the
    122,880,000 embedding entries by ~1e-4."""
    import dataclasses
    import repro_torch.models.common as p_common
    from repro_torch.configs import get_config
    monkeypatch.setattr(p_common, "DTYPE", getattr(torch, dtype))
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"), n_layers=2)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got, p_got = _train_twin(cfg, batch, "cuda")
    want, p_want = _train_twin(cfg, batch, "cpu")
    tol = (dict(rtol=1e-4, atol=0) if dtype == "float32"
           else dict(rtol=0.05, atol=0.08))
    ptol = dict(rtol=0, atol=1e-5 if dtype == "float32" else 0.08)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    for n in p_want:
        np.testing.assert_allclose(p_got[n].numpy(), p_want[n].numpy(),
                                   err_msg=n, **ptol)


def test_curation_on_cuda_launches_fused_scan_and_selects_as_numpy(cuda):
    """The training launcher's corpus (50,000 docs) on the card: each
    ``select`` is one device wave with ``fused_scan`` launches, equal to
    the numpy backend and to the full scan, as is a 3-stage curriculum."""
    from repro_torch.data.curation import CuratedSelector, MetaQuery
    from repro_torch.data.pipeline import make_corpus
    corpus = make_corpus(50_000, vocab_size=32_000)
    dev, host = CuratedSelector(corpus), CuratedSelector(corpus,
                                                         backend="numpy")
    assert dev.index.device == "cuda"
    queries = [MetaQuery(token_len=(128, 32768), quality=(0.5, 1.1)),
               MetaQuery(token_len=(512, 4096), quality=(0.8, 1.1)),
               MetaQuery(compute_cost=(1000, 5000), domain_id=(0, 8))]
    for q in queries:
        before = fused_scan.launches
        got = dev.select(q)
        assert fused_scan.launches > before
        assert np.array_equal(got, host.select(q))
        assert np.array_equal(got, dev.select_reference(q))
    cur, want = dev.curriculum(queries), host.curriculum(queries)
    assert all(np.array_equal(cur[i], want[i]) for i in want)


def test_mesh_train_step_on_cuda_equals_the_plain_step(cuda, monkeypatch,
                                                       tmp_path):
    """h2o-danube-3-4b cut to 2 layers at a width of 256 on a 1x1 mesh of
    one NCCL rank: the parameters placed as DTensors (the same storage),
    one train step under the arch's rules equals the plain step from the
    same weights (float32 activations: loss and every updated parameter
    within 1e-5)."""
    import torch.distributed as dist
    import repro_torch.models.common as p_common
    from repro_torch.configs import get_config
    from repro_torch.distributed.partitioning import use_rules
    from repro_torch.distributed.sharding import (place_for_training,
                                                  rules_for_arch)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import make_generator
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)
    cfg = reduced(get_config("h2o-danube-3-4b"), 2, 256)
    rng = np.random.default_rng(29)
    toks = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    weights = build_model(cfg, device="cuda").init(
        make_generator(0, "cuda")).state_dict()
    opt = AdamWConfig(lr=1e-3, eps=1e-3)
    plain = build_model(cfg, device="cuda")
    plain.load_state_dict(weights)
    want = float(make_train_step(plain, opt)(adamw_init(plain),
                                             batch)["loss"])
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1)
        rules = rules_for_arch(cfg, mesh)
        model = build_model(cfg, device="cuda")
        model.load_state_dict(weights)
        ptrs = [p.data_ptr() for p in model.parameters()]
        state = place_for_training(model, mesh, rules)
        assert [p.to_local().data_ptr() for p in model.parameters()] == ptrs
        with use_rules(rules):
            got = float(make_train_step(model, opt)(state, batch)["loss"])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        own = dict(plain.named_parameters())
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.to_local().detach().cpu().numpy(),
                                       own[n].detach().cpu().numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)
    finally:
        dist.destroy_process_group()
