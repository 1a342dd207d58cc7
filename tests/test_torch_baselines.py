"""The paper's baseline engines (§8.1.3) in the port against the JAX
package's ``repro`` on the CPU: twins of the baseline tests of
``test_coax_core.py`` and of the executor's per-rect path over an engine
without ``query_batch``.

The same seeded numpy data goes through both packages; every engine's
hits, its ``memory_footprint`` and the grid baselines' per-query stats
must be equal, and equal to the full scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
from repro.data import knn_rect_queries, make_airline, make_osm
from repro.engine import BatchQueryExecutor as RefExecutor
from repro_torch.core import (COAXIndex, CoaxConfig, ColumnFiles, FullScan,
                              STRTree, UniformGrid, full_rect, point_rect)
from repro_torch.engine import BatchQueryExecutor, QueryServer

CPU = "cpu"
ENGINES = {"full_scan": (FullScan, ref_core.FullScan),
           "uniform_grid": (UniformGrid, ref_core.UniformGrid),
           "column_files": (ColumnFiles, ref_core.ColumnFiles),
           "r_tree": (STRTree, ref_core.STRTree)}


@pytest.fixture(scope="module")
def data():
    return {"airline": make_airline(30_000, seed=3).data,
            "osm": make_osm(30_000, seed=3).data}


def _rects(data, n=15, k=150):
    return knn_rect_queries(data, n, k, seed=1, sample_cap=10_000)


@pytest.mark.parametrize("ds_name", ["airline", "osm"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_equals_reference_and_full_scan(data, ds_name, engine):
    d = data[ds_name]
    port_cls, ref_cls = ENGINES[engine]
    eng, ref = port_cls(d), ref_cls(d)
    assert eng.name == ref.name == engine
    assert eng.memory_footprint() == ref.memory_footprint()
    truth = FullScan(d)
    for r in _rects(d):
        got = eng.query(r)
        want = ref.query(r)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert np.array_equal(got, truth.query(r))
        if hasattr(ref, "last_query_stats"):
            assert vars(eng.last_query_stats) == vars(ref.last_query_stats)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_point_and_unconstrained_queries(data, engine):
    d = data["airline"]
    port_cls, ref_cls = ENGINES[engine]
    eng, ref = port_cls(d), ref_cls(d)
    rng = np.random.default_rng(0)
    for i in rng.choice(d.shape[0], 10, replace=False):
        got = eng.query(point_rect(d[i]))
        assert i in got and np.array_equal(got, ref.query(point_rect(d[i])))
    assert eng.query(full_rect(d.shape[1])).size == d.shape[0]


@pytest.mark.parametrize("kw", [dict(cells_per_dim=3), dict(rows_per_cell=64)])
def test_grid_baselines_sizing_equals_reference(data, kw):
    d = data["osm"]
    for port_cls, ref_cls in (ENGINES["uniform_grid"], ENGINES["column_files"]):
        eng, ref = port_cls(d, **kw), ref_cls(d, **kw)
        assert eng.grid.cells_per_dim == ref.grid.cells_per_dim
        assert eng.grid.backend == "numpy"
        assert np.array_equal(eng.grid.offsets, ref.grid.offsets)
        assert np.array_equal(eng.grid.row_ids, ref.grid.row_ids)


@pytest.mark.parametrize("caps", [(10, 10), (4, 3), (64, 12)])
def test_str_tree_levels_equal_reference(data, caps):
    d = data["airline"][:5_000]
    eng = STRTree(d, leaf_cap=caps[0], node_cap=caps[1])
    ref = ref_core.STRTree(d, leaf_cap=caps[0], node_cap=caps[1])
    assert np.array_equal(eng.row_ids, ref.row_ids)
    assert len(eng.levels) == len(ref.levels)
    for a, b in zip(eng.levels, ref.levels):
        for f in ("mbr_lo", "mbr_hi", "child_lo", "child_hi"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    for r in _rects(d, n=6):
        assert np.array_equal(eng.query(r), ref.query(r))


def test_empty_str_tree():
    empty = np.empty((0, 3), np.float32)
    eng, ref = STRTree(empty), ref_core.STRTree(empty)
    assert eng.levels == [] and eng.memory_footprint() == 0
    assert np.array_equal(eng.query(full_rect(3)), ref.query(full_rect(3)))


def test_memory_footprint_reduction(data):
    """At equal per-dim resolution the COAX directory is orders of
    magnitude below the full grid's (§8.2.4), in both packages."""
    d = data["airline"]
    c = 8
    cfg = CoaxConfig(primary_cells_per_dim=c, outlier_cells_per_dim=2)
    cx = COAXIndex(d, cfg, backend="numpy", device=CPU)
    ref_cx = ref_core.COAXIndex(d, ref_core.CoaxConfig(
        primary_cells_per_dim=c, outlier_cells_per_dim=2))
    ug = UniformGrid(d, cells_per_dim=c)
    assert ug.memory_footprint() == ref_core.UniformGrid(
        d, cells_per_dim=c).memory_footprint()
    assert cx.memory_footprint() == ref_cx.memory_footprint()
    assert ug.memory_footprint() / cx.memory_footprint() > 1e3


@pytest.mark.parametrize("engine", ["r_tree", "full_scan"])
def test_executor_serves_an_engine_rect_by_rect(data, engine):
    """``BatchQueryExecutor`` over an engine without ``query_batch`` (its
    per-rect path), against the reference's executor over the same
    engine: the same answers, waves and per-rect fallbacks."""
    d = data["osm"]
    port_cls, ref_cls = ENGINES[engine]
    ex = BatchQueryExecutor(port_cls(d), max_batch=4, device="cuda")
    ref = RefExecutor(ref_cls(d), max_batch=4)
    rects = _rects(d, n=10)
    got, want = ex.execute(rects), ref.execute(rects)
    assert len(got) == len(want) == len(rects)
    for g, w, r in zip(got, want, rects):
        assert np.array_equal(g, w) and np.array_equal(g, FullScan(d).query(r))
    st, ref_st = ex.stats(), ref.stats()
    for k in ("waves", "queries", "batched", "device_fallbacks"):
        assert st[k] == ref_st[k], k
    assert not st["batched"] and st["waves"] == 3


def test_engine_without_a_device_backend_is_refused(data):
    d = data["osm"][:2_000]
    with pytest.raises(ValueError):
        BatchQueryExecutor(FullScan(d), backend="device")
    ex = BatchQueryExecutor(STRTree(d), backend="numpy")
    assert ex.backend == "numpy"
    assert ex.execute(full_rect(d.shape[1])[None])[0].size == d.shape[0]
    with pytest.raises(ValueError):
        BatchQueryExecutor(STRTree(d), shards=2)


def test_query_server_over_a_baseline_takes_no_writes(data):
    d = data["airline"][:3_000]
    srv = QueryServer(UniformGrid(d), max_batch=8, device=CPU)
    rects = _rects(d, n=5)
    qids = srv.submit_many(rects)
    got = srv.drain()
    ref = ref_core.UniformGrid(d)
    for q, r in zip(qids, rects):
        assert np.array_equal(got[q], ref.query(r))
    with pytest.raises(TypeError):
        srv.insert(d[:2])
    with pytest.raises(TypeError):
        srv.delete([0])
