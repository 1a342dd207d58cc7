"""Port twins of ``tests/test_device_backend.py`` on ``device="cpu"``.

Each case runs the same workload through the JAX package (the oracle,
``JAX_PLATFORMS=cpu``) and through the port's device plane on the CPU,
where every segment runs the plain torch version of the kernel.  The bar
is bit identity of ``(query_ids, row_ids)`` and of the work counters.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import COAXIndex as RefIndex
from repro.core import GridFile as RefGrid
from repro.engine import QueryServer as RefServer
from repro_torch.core import COAXIndex, GridFile, full_rect, point_rect
from repro_torch.data import make_airline, make_osm
from repro_torch.engine import BatchQueryExecutor, QueryServer, split_hits
from repro_torch.engine.device import CoaxDevicePlan, _sort_pairs
from workloads import engine_workload, engine_workloads, rects_for

CPU = "cpu"


def _same(got, want, tag=""):
    assert np.array_equal(got[0], want[0]), tag
    assert np.array_equal(got[1], want[1]), tag


def _stats(s):
    return (s.queries, s.cells_probed, s.rows_scanned, s.backend,
            s.fallbacks, s.hit_overflows)


@pytest.mark.parametrize("name", [n for n, _ in engine_workloads()])
def test_device_equals_reference(name):
    ds = engine_workload(name)
    rects = rects_for(ds.data)
    ref = RefIndex(ds.data, backend="device")
    want = ref.query_batch(rects)
    port = COAXIndex(ds.data, device=CPU)
    got = port.query_batch(rects)
    _same(got, want, name)
    assert _stats(port.last_batch_stats) == _stats(ref.last_batch_stats)
    assert np.all(np.diff(got[0]) >= 0)
    port.backend = "numpy"
    _same(port.query_batch(rects), want, name)
    per_query = split_hits(got[0], got[1], rects.shape[0])
    for i, r in enumerate(rects):
        assert np.array_equal(per_query[i], port.query(r)), (name, i)


@pytest.mark.parametrize("sort_dim", [None, 0, 2])
def test_gridfile_device_equals_reference(sort_dim):
    rng = np.random.default_rng(4)
    data = rng.normal(0, 10, (6_000, 3)).astype(np.float32)
    kw = dict(index_dims=[0, 1, 2], cells_per_dim=5, sort_dim=sort_dim)
    rects = np.sort(rng.uniform(-20, 20, (40, 3, 2)), axis=-1)
    rects[0] = full_rect(3)
    gf = GridFile(data, device=CPU, **kw)
    got = gf.query_batch(rects, rects)
    want = RefGrid(data, backend="device", **kw).query_batch(rects, rects)
    _same(got, want, sort_dim)
    gf.backend = "numpy"
    _same(gf.query_batch(rects, rects), want, sort_dim)


def test_device_empty_batch_and_empty_index():
    ds = make_airline(5_000, seed=1)
    idx = COAXIndex(ds.data, device=CPU)
    q, r = idx.query_batch(np.zeros((0, ds.data.shape[1], 2)))
    assert q.size == 0 and r.size == 0
    gf = GridFile(np.empty((0, 2), np.float32), index_dims=[0, 1],
                  cells_per_dim=3, device=CPU)
    q, r = gf.query_batch(full_rect(2)[None], full_rect(2)[None])
    assert q.size == 0 and r.size == 0


def test_device_all_outlier_queries():
    ds = engine_workload("generic_fd")
    ref = RefIndex(ds.data)
    assert ref.outlier.n_rows > 0
    o_rows = ds.data[ref.outlier.row_ids[:12]]
    rects = np.stack([point_rect(p) for p in o_rows])
    want = ref.query_batch(rects)
    assert want[1].size >= rects.shape[0]
    _same(COAXIndex(ds.data, device=CPU).query_batch(rects), want)


def test_device_f32_range_bounds():
    ds = make_airline(8_000, seed=2)
    d = ds.data.shape[1]
    rects = np.stack([
        np.stack([np.full(d, -1e39), np.full(d, 1e39)], axis=-1),   # ~full
        np.stack([np.full(d, 1e38), np.full(d, 1e39)], axis=-1),    # empty
        np.stack([np.full(d, -1e39), ds.data[0].astype(np.float64)], axis=-1),
        point_rect(ds.data[3]),
    ])
    want = RefIndex(ds.data, backend="device").query_batch(rects)
    assert split_hits(*want, 4)[0].size == ds.data.shape[0]
    _same(COAXIndex(ds.data, device=CPU).query_batch(rects), want)


def test_cell_cap_fallback_matches_reference():
    rng = np.random.default_rng(9)
    data = rng.normal(0, 10, (4_000, 3)).astype(np.float32)
    rects = np.sort(rng.uniform(-20, 20, (16, 3, 2)), axis=-1)
    kw = dict(index_dims=[0, 1, 2], cells_per_dim=5, sort_dim=1)
    gf = GridFile(data, device=CPU, device_opts={"cell_cap": 1}, **kw)
    got = gf.query_batch(rects, rects)
    assert gf.last_batch_stats.fallbacks == 1
    assert gf.last_batch_stats.backend == "numpy"
    _same(got, RefGrid(data, **kw).query_batch(rects, rects))


class _FullScanPlan(CoaxDevicePlan):
    """The plan's CUDA route (full-segment scans, tile-multiple images, no
    ``cell_cap`` pre-check) driven on CPU tensors through the plain
    version — the same host logic the card runs."""

    def _init_opts(self, cell_cap, tile, min_bucket, hit_cap, device):
        super()._init_opts(cell_cap, tile, min_bucket, hit_cap, device)
        self._gather = False


@pytest.mark.parametrize("hit_cap", [16, 1 << 16])
def test_full_scan_route_matches_reference(hit_cap):
    ds = make_airline(6_000, seed=14)
    rects = rects_for(ds.data, n=12, seed=15)
    ref = RefIndex(ds.data, backend="device")
    idx = COAXIndex(ds.data, device=CPU)
    idx._coax_plan = plan = _FullScanPlan(idx, device=CPU, cell_cap=1,
                                          hit_cap=hit_cap)
    for img in (plan.p_img, plan.o_img):
        assert img.n_pad % img.tile == 0 and img.n_pad - img.n < img.tile
    rng = np.random.default_rng(3)
    for step in range(3):
        _same(idx.query_batch(rects), ref.query_batch(rects), step)
        st = idx.last_batch_stats
        assert st.backend == "device" and st.fallbacks == 0
        assert (st.hit_overflows > 0) == (hit_cap == 16)
        extra = rng.normal(0, 5, (40, ds.data.shape[1])).astype(np.float32)
        for i in (idx, ref):
            i.insert(extra)
            i.delete(np.arange(step * 9, step * 9 + 6))
    assert plan._delta["m_pad"] % 128 == 0 and plan._delta["m_pad"] < 256
    assert idx._coax_plan is plan and plan.dispatch_count == 3


@pytest.mark.parametrize("lo,hi", [(0, 1 << 40), (-5, 50),
                                   ((1 << 40) - 3, (1 << 40) + 3)])
def test_sort_pairs_equals_lexsort(lo, hi):
    rng = np.random.default_rng(hi % 97)
    q = rng.integers(0, 70, 5_000).astype(np.int64)
    r = rng.integers(lo, hi, 5_000).astype(np.int64)
    order = np.lexsort((r, q))
    got = _sort_pairs(q, r)
    assert np.array_equal(got[0], q[order])
    assert np.array_equal(got[1], r[order])


def gf_wrap(gf):
    """A raw GridFile with the (rects,)-shaped query_batch the executor
    drives (nav == filter), plus backend passthrough."""
    class _W:
        backend = property(lambda s: gf.backend,
                           lambda s, v: setattr(gf, "backend", v))

        def query_batch(self, rects):
            return gf.query_batch(rects, rects)

        @property
        def last_batch_stats(self):
            return gf.last_batch_stats
    return _W()


def test_bucketed_launch_shapes():
    """Steady-state serving launches at most one shape per (bucket_B,
    N_pad): repeated same-width waves reuse one shape; one execute() over
    two wave widths (8 + 4) adds exactly one more."""
    rng = np.random.default_rng(11)
    data = rng.normal(0, 10, (6_000, 3)).astype(np.float32)
    gf = GridFile(data, index_dims=[0, 1, 2], cells_per_dim=4, sort_dim=2,
                  device=CPU)
    rects = np.sort(rng.uniform(-20, 20, (12, 3, 2)), axis=-1)
    ex = BatchQueryExecutor(gf_wrap(gf), max_batch=8, backend="device",
                            device=CPU)
    plan = gf.device_plan
    for _ in range(3):
        ex.execute(rects[:8])
    assert plan.compile_count == 1
    got = ex.execute(rects)
    assert plan.compile_count == 2
    for _ in range(2):
        ex.execute(rects)
    assert plan.compile_count == 2
    ref = RefGrid(data, index_dims=[0, 1, 2], cells_per_dim=4, sort_dim=2)
    for i, r in enumerate(rects):
        assert np.array_equal(got[i], ref.query(r, r)), i


def test_executor_and_server_plumbing():
    ds = make_osm(8_000, seed=5)
    rects = rects_for(ds.data, n=10, seed=3)[:10]
    idx = COAXIndex(ds.data)
    ex = BatchQueryExecutor(idx, max_batch=4, backend="device", device=CPU)
    assert idx.backend == "device" and ex.backend == "device"
    assert idx.device == CPU
    got = ex.execute(rects)
    s = ex.stats()
    assert s["backend"] == "device"
    assert s["rows_scanned"] > 0 and s["cells_probed"] > 0
    assert any(w.backend == "device" for w in ex.wave_stats)
    srv = QueryServer(COAXIndex(ds.data), max_batch=4, backend="device",
                      device=CPU)
    qids = srv.submit_many(rects)
    results = srv.drain()
    ref = RefIndex(ds.data)
    for qid, r, g in zip(qids, rects, got):
        assert np.array_equal(results[qid], g)
        assert np.array_equal(g, ref.query(r))


def test_executor_backend_validation():
    class _Plain:                      # no backend attribute, query only
        def query(self, rect):
            return np.empty(0, np.int64)
    with pytest.raises(ValueError):
        BatchQueryExecutor(_Plain(), backend="device", device=CPU)
    assert BatchQueryExecutor(_Plain(), backend="numpy").backend == "numpy"


def test_hit_cap_overflow_reanswer_matches_reference():
    ds = make_airline(6_000, seed=4)
    rects = rects_for(ds.data, n=10, seed=5)
    ref = RefIndex(ds.data, backend="device", device_opts={"hit_cap": 16})
    want = ref.query_batch(rects)
    idx = COAXIndex(ds.data, device=CPU, device_opts={"hit_cap": 16})
    _same(idx.query_batch(rects), want)
    assert idx.last_batch_stats.backend == "device"
    assert idx.last_batch_stats.hit_overflows > 0
    assert _stats(idx.last_batch_stats) == _stats(ref.last_batch_stats)


def test_one_dispatch_per_wave_and_device_stats():
    ds = make_osm(6_000, seed=8)
    idx = COAXIndex(ds.data, device=CPU)
    rects = rects_for(ds.data, n=12, seed=9)
    ex = BatchQueryExecutor(idx, max_batch=4, backend="device", device=CPU)
    n_waves = -(-rects.shape[0] // 4)
    ex.execute(rects)
    s = ex.stats()
    assert s["device_fallbacks"] == 0 and s["fallback_waves"] == 0
    st = idx.device_stats()
    assert st["dispatches"] == s["waves"] == n_waves
    assert st["bytes_h2d"] > 0 and st["bytes_d2h"] > 0
    assert s["wave_p50_ms"] > 0 and s["wave_p99_ms"] >= s["wave_p50_ms"]
    idx.insert(ds.data[:40] + 0.25)
    ex.execute(rects[:4])
    assert idx.device_stats()["dispatches"] == n_waves + 1


def test_resident_drain_with_interleaved_writes_and_compaction():
    """In-flight waves with inserts/deletes/a compaction between submit and
    drain answer from their submit-time state — the reference's answers."""
    ds = make_airline(6_000, seed=6)
    rects = rects_for(ds.data, n=12, seed=11)
    waves = [rects[0:4], rects[4:8], rects[8:12]]

    def run(idx, submit, collect):
        rng = np.random.default_rng(31)
        handles = []
        for i, w in enumerate(waves):
            handles.append(submit(idx, w))
            idx.insert(rng.normal(0, 5, (30, ds.data.shape[1]))
                       .astype(np.float32))
            idx.delete(np.arange(i * 7, i * 7 + 5))
            if i == 1:
                idx.compact()
        out = [collect(idx, h) for h in handles]
        out.append(idx.query_batch(rects[:6]))
        return out, idx.epoch

    def submit(idx, w):
        return idx.query_batch_submit(w)

    def collect(idx, h):
        return idx.query_batch_collect(h)

    want, e_ref = run(RefIndex(ds.data, backend="device",
                               device_opts={"hit_cap": 64}), submit, collect)
    got, e_port = run(COAXIndex(ds.data, device=CPU,
                                device_opts={"hit_cap": 64}), submit, collect)
    assert e_port == e_ref > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, i)


def test_server_pipelined_drain_equals_reference():
    ds = make_airline(5_000, seed=12)
    rng = np.random.default_rng(41)
    rects = rects_for(ds.data, n=12, seed=13)
    extra = rng.normal(0, 5, (20, ds.data.shape[1])).astype(np.float32)

    def run(srv):
        qids = srv.submit_many(rects[:8])
        srv.insert(extra)
        qids += srv.submit_many(rects[8:])
        srv.delete(np.arange(10))
        res = srv.drain()
        return [res[q] for q in qids]

    srv = QueryServer(COAXIndex(ds.data), max_batch=4, backend="device",
                      device=CPU)
    got = run(srv)
    want = run(RefServer(RefIndex(ds.data), max_batch=4, backend="device"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    s = srv.stats()
    assert s["backend"] == "device" and s["waves_drained"] >= 3
    assert s["device_fallbacks"] == 0
    assert srv.executor.index.device_stats()["dispatches"] == s["waves"]
