"""The hand-written CUDA kernel against its plain torch version, on the card.

Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Every test skips inside its body when no card is present (the marker is
registered in ``conftest.py``).  The bar is exact equality: the kernel and
its plain version compute the same compares and the same integer counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import COAXIndex
from repro_torch.data import knn_rect_queries, make_airline, make_osm
from repro_torch.engine import QueryServer, split_hits
from repro_torch.engine.device import CUDA_HIT_CAP
from repro_torch.kernels import fused_range_scan, fused_scan, ref

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
