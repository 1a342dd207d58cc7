"""The sharded scatter-gather plane (DESIGN.md §6): the port against the
JAX package's ``repro`` on the CPU, twins of ``test_sharded.py`` and of
``test_lsm.py::test_sharded_background_compaction_exact``.

The same seeded workloads and insert/delete schedules run through
``repro.engine.ShardedCOAX`` and ``repro_torch.engine.ShardedCOAX``
(``device="cpu"``; on the device backend every shard's wave runs the plain
version of ``fused_scan``).  The bar is equality: partition boundaries,
per-shard row counts and learned FD groups, the flat ``(query_id,
row_id)`` hits, and the per-shard wave stats equal the reference's, and
the hits also equal a single index over the union of rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefConfig
from repro.engine import BatchQueryExecutor as RefExecutor
from repro.engine import QueryServer as RefServer
from repro.engine import ShardedCOAX as RefSharded
from repro.engine import partition_rows as ref_partition_rows
from repro_torch.core import COAXIndex, CoaxConfig, full_rect, point_rect
from repro_torch.data import make_generic_fd
from repro_torch.engine import (BatchQueryExecutor, QueryServer, ShardedCOAX,
                                partition_rows)

from workloads import (assert_equiv, fullscan_expected, mutable_workloads,
                       rects_for, violate_fd)

CPU = "cpu"
NOAUTO = CoaxConfig(auto_compact=False)
REF_NOAUTO = RefConfig(auto_compact=False)
K_VALUES = (1, 2, 4)


def _rects(data, n=6, seed=0):
    return rects_for(data, n=n, seed=seed, extremes=False, sample_cap=6_000)


def _groups(idx):
    return [(g.predictor, tuple(g.dependents),
             tuple(sorted((d, m.m, m.b, m.eps_lb, m.eps_ub)
                          for d, m in g.models.items())))
            for g in idx.groups]


def _shard_stats(pl):
    return [(s.queries, s.cells_probed, s.rows_scanned, s.fallbacks,
             s.hit_overflows) for s in pl.last_shard_stats]


def _same_plane(port, ref, rects, tag=""):
    """Layout, hits and per-shard wave stats equal the reference's."""
    assert port.shard_sizes() == ref.shard_sizes(), tag
    assert [_groups(s) for s in port.shards] == [_groups(s) for s in ref.shards], tag
    assert [s.epoch for s in port.shards] == [s.epoch for s in ref.shards], tag
    q, r = port.query_batch(rects)
    q_r, r_r = ref.query_batch(rects)
    assert np.array_equal(q, q_r) and np.array_equal(r, r_r), (tag, "hits")
    assert _shard_stats(port) == _shard_stats(ref), (tag, "shard stats")
    return q, r


def _apply_schedule(idx, ds, more):
    """The deterministic insert/delete schedule of ``test_sharded.py``:
    base deletes, in-pattern inserts, FD-violating inserts, delta-log
    deletes."""
    rng = np.random.default_rng(2)
    idx.delete(rng.choice(ds.data.shape[0], 300, replace=False))
    fresh = more(201, 400)
    ids_a = idx.insert(fresh[:200])                  # in-pattern
    ids_b = idx.insert(violate_fd(ds, fresh[200:]))  # FD-violating
    idx.delete(ids_a[:40])
    idx.delete(ids_b[:40])


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("k", K_VALUES)
@pytest.mark.parametrize("name,ds,more", mutable_workloads(6_000),
                         ids=lambda w: w if isinstance(w, str) else "")
def test_sharded_matrix_equals_reference_and_single(name, ds, more, k,
                                                    backend):
    """One matrix cell: build → mutate → compact; at every stage the port's
    plane equals the reference's plane (layout, hits, shard stats) and a
    single port index over the same rows."""
    rects = _rects(ds.data)
    port = ShardedCOAX(ds.data, NOAUTO, n_shards=k, partition="range",
                       backend=backend, device=CPU)
    ref = RefSharded(ds.data, REF_NOAUTO, n_shards=k, partition="range",
                     backend=backend)
    single = COAXIndex(ds.data, NOAUTO, backend=backend, device=CPU)
    bounds, ref_bounds = port._boundaries, ref._boundaries
    assert (bounds is None) == (ref_bounds is None)
    if bounds is not None:
        assert np.array_equal(bounds, ref_bounds)
    for stage in ("build", "mut", "post"):
        if stage == "mut":
            for idx in (port, ref, single):
                _apply_schedule(idx, ds, more)
        elif stage == "post":
            for idx in (port, ref, single):
                idx.compact()
            assert all(s.epoch >= 1 for s in port.shards)
            assert port.delta_rows == 0 and port.tombstone_count == 0
        q, r = _same_plane(port, ref, rects, (name, k, backend, stage))
        q_s, r_s = single.query_batch(rects)
        assert np.array_equal(q, q_s) and np.array_equal(r, r_s), stage
        assert port.n_rows == single.n_rows == ref.n_rows
    assert_equiv(port, rects, scratch=True, tag=(name, k, backend))


def test_hash_partition_equals_range_and_single():
    """Both partitioning strategies answer identically (routing only moves
    rows between shards; results are routing-invariant)."""
    name, ds, more = mutable_workloads(6_000)[0]
    rects = _rects(ds.data)
    single = COAXIndex(ds.data, NOAUTO, device=CPU)
    want = single.query_batch(rects)
    for part in ("hash", "range"):
        sh = ShardedCOAX(ds.data, NOAUTO, n_shards=3, partition=part,
                         partition_dim=2, device=CPU)
        ref = RefSharded(ds.data, REF_NOAUTO, n_shards=3, partition=part,
                         partition_dim=2, backend="device")
        q, r = _same_plane(sh, ref, rects, part)
        assert np.array_equal(q, want[0]) and np.array_equal(r, want[1]), part
        for rect in rects[:3]:
            assert np.array_equal(sh.query(rect), single.query(rect)), part


def test_partition_rows_routing_equals_reference():
    """Insert routing agrees with build routing and with the reference's
    router, bit for bit (hash of the float32 bits; range quantiles)."""
    rng = np.random.default_rng(3)
    data = rng.normal(0, 100, (4_000, 3)).astype(np.float32)
    for part in ("hash", "range"):
        shard_of, bounds = partition_rows(data, 4, part, 1)
        ref_of, ref_bounds = ref_partition_rows(data, 4, part, 1)
        assert np.array_equal(shard_of, ref_of), part
        assert (bounds is None and ref_bounds is None
                or np.array_equal(bounds, ref_bounds)), part
        again, _ = partition_rows(data, 4, part, 1, boundaries=bounds)
        assert np.array_equal(shard_of, again), part
        assert shard_of.min() >= 0 and shard_of.max() < 4
    with pytest.raises(ValueError):
        partition_rows(data, 4, "round_robin", 0)


# --------------------------------------------------------------------- #
# Empty-shard and single-row-shard edges
# --------------------------------------------------------------------- #
def test_rect_pruning_to_zero_shards(rng):
    """A rect beyond every shard's bbox launches on no shard and returns
    empty — identical to the single index's answer."""
    data = rng.uniform(0, 100, (3_000, 3)).astype(np.float32)
    sh = ShardedCOAX(data, NOAUTO, n_shards=4, partition="range", device=CPU)
    ref = RefSharded(data, REF_NOAUTO, n_shards=4, partition="range",
                     backend="device")
    far = np.stack([np.full(3, 1e6), np.full(3, 1e6 + 1)], axis=-1)
    rects = np.stack([far, full_rect(3)])
    assert not sh._touch_mask(far[None]).any()     # pruned everywhere
    assert sh.query(far).size == 0
    _same_plane(sh, ref, rects, "prune")
    q, r = sh.query_batch(far[None])
    assert q.size == 0 and r.size == 0
    assert all(s.queries == 0 for s in sh.last_shard_stats)
    assert sh.shards[0]._coax_plan is not None      # full_rect launched
    before = [s._coax_plan.dispatch_count for s in sh.shards]
    sh.query_batch(far[None])
    assert [s._coax_plan.dispatch_count for s in sh.shards] == before


def test_all_outlier_shard():
    """FD groups forced onto every shard, one range shard aimed at rows
    that all violate them: its primary grid is empty and every one of its
    hits flows through its outlier sub-index."""
    name, ds, _ = mutable_workloads(6_000)[2]      # generic_fd, FDs on (0,1)
    groups = COAXIndex(ds.data, NOAUTO, device=CPU).groups
    assert len(groups) > 0
    data = ds.data.copy()
    col = data[:, 0]
    cut = np.quantile(col.astype(np.float64), 0.75)
    data[col >= cut, ds.correlated_groups[0][1]] = 1e7
    sh = ShardedCOAX(data, NOAUTO, n_shards=4, partition="range",
                     groups=groups, device=CPU)
    ref = RefSharded(data, REF_NOAUTO, n_shards=4, partition="range",
                     groups=RefIndex(ds.data, REF_NOAUTO).groups,
                     backend="device")
    top = sh.shards[-1]
    assert top.n_rows > 0 and top.primary.n_rows == 0
    rects = _rects(data)
    _same_plane(sh, ref, rects, "all-outlier-shard")
    want = fullscan_expected(data, np.arange(data.shape[0]), rects)
    got = sh.query_batch_split(rects)
    for i in range(rects.shape[0]):
        assert np.array_equal(got[i], want[i]), i


def test_more_shards_than_rows(rng):
    """K > n_rows: most shards are empty (bbox None, always pruned), some
    hold one row; writes into empty shards set their bbox; ids continue
    the global sequence as the reference's do."""
    data = rng.uniform(0, 10, (5, 4)).astype(np.float32)
    sh = ShardedCOAX(data, NOAUTO, n_shards=8, partition="hash", device=CPU)
    ref = RefSharded(data, REF_NOAUTO, n_shards=8, partition="hash")
    sh.backend = ref.backend = "numpy"
    assert sum(n == 0 for n in sh.shard_sizes()) >= 3
    rects = np.stack([full_rect(4), point_rect(data[0]),
                      np.stack([data[1], np.nextafter(data[1], np.inf)], axis=-1)])
    _same_plane(sh, ref, rects, "K>n")
    assert sh.delete(np.arange(5)) == ref.delete(np.arange(5)) == 5
    assert sh.n_rows == 0
    q, r = sh.query_batch(rects)
    assert q.size == 0 and r.size == 0
    new_rows = rng.uniform(0, 10, (16, 4)).astype(np.float32)
    ids = sh.insert(new_rows)
    assert ids.tolist() == list(range(5, 21)) == ref.insert(new_rows).tolist()
    _same_plane(sh, ref, rects, "K>n-after-writes")
    assert_equiv(sh, rects, scratch=True, tag="K>n-after-writes")


def test_shard_local_compaction_independence():
    """Writes aimed at ONE range shard compact only that shard: other
    shards' epochs (and device plans) stay untouched, results stay exact."""
    name, ds, more = mutable_workloads(6_000)[0]
    kw = dict(auto_compact=True, compact_min_delta=64,
              compact_delta_frac=0.01, drift_min_delta=10**9)
    sh = ShardedCOAX(ds.data, CoaxConfig(**kw), n_shards=4,
                     partition="range", device=CPU)
    ref = RefSharded(ds.data, RefConfig(**kw), n_shards=4, partition="range")
    rects = _rects(ds.data)
    sh.query_batch(rects)                       # every shard builds a plan
    plans = [s._coax_plan for s in sh.shards]
    col = ds.data[:, 0]
    low_rows = ds.data[col < np.quantile(col.astype(np.float64), 0.1)][:600]
    sh.insert(low_rows)
    ref.insert(low_rows)
    assert sh.shards[0].compactions >= 1
    assert all(s.compactions == 0 for s in sh.shards[1:])
    assert [s.compactions for s in sh.shards] == [s.compactions
                                                  for s in ref.shards]
    ref.backend = "device"
    _same_plane(sh, ref, rects, "shard-local-compact")
    assert sh.shards[0]._coax_plan is not plans[0]
    assert all(s._coax_plan is p for s, p in zip(sh.shards[1:], plans[1:]))
    assert_equiv(sh, rects, scratch=True, tag="shard-local-compact")


# --------------------------------------------------------------------- #
# Engine plumbing: executor/server shards=K mode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_executor_shards_mode_and_rollups(backend):
    name, ds, more = mutable_workloads(6_000)[0]
    rects = _rects(ds.data)
    single = COAXIndex(ds.data, NOAUTO, backend=backend, device=CPU)
    ref_single = RefIndex(ds.data, REF_NOAUTO, backend=backend)
    _apply_schedule(single, ds, more)
    _apply_schedule(ref_single, ds, more)
    want = fullscan_expected(*single.live_rows(), rects)

    # shards=K re-partitions a mutated single index over its live rows,
    # and the executor's device reaches every shard
    ex = BatchQueryExecutor(single, max_batch=4, shards=4, device=CPU)
    ref_ex = RefExecutor(ref_single, max_batch=4, shards=4)
    assert isinstance(ex.index, ShardedCOAX) and ex.index.n_shards == 4
    assert ex.index.device == CPU and ex.index.backend == backend
    assert all(s.device == CPU for s in ex.index.shards)
    got = ex.execute(rects)
    ref_ex.execute(rects)
    for i in range(rects.shape[0]):
        assert np.array_equal(got[i], want[i]), i
    s, s_r = ex.stats(), ref_ex.stats()
    assert s["shards"] == 4 and s["per_shard"] == s_r["per_shard"]
    assert s["rows_scanned"] == s_r["rows_scanned"]
    scattered = sum(p["queries"] for p in s["per_shard"])
    assert 0 < scattered < s["queries"] * 4
    assert sum(p["rows_scanned"] for p in s["per_shard"]) == s["rows_scanned"]
    assert [(w.shards_hit, w.shard_stats) for w in ex.wave_stats] == \
        [(w.shards_hit, w.shard_stats) for w in ref_ex.wave_stats]
    assert all(0 < w.shards_hit <= 4 for w in ex.wave_stats)

    # an index that is already sharded passes through; mismatched K raises
    ex2 = BatchQueryExecutor(ex.index, shards=4, device=CPU)
    assert ex2.index is ex.index
    with pytest.raises(ValueError):
        BatchQueryExecutor(ex.index, shards=2, device=CPU)
    with pytest.raises(ValueError):
        BatchQueryExecutor(object(), shards=2, device=CPU)


def test_from_index_preserves_id_high_water_mark():
    """Re-sharding after the highest-id rows were deleted must NOT reuse
    their ids."""
    name, ds, more = mutable_workloads(6_000)[2]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    new_ids = idx.insert(more(31, 10))
    idx.delete(new_ids)                            # high-water ids all dead
    sh = ShardedCOAX.from_index(idx, 2)
    assert sh.device == CPU and sh.backend == idx.backend
    got = sh.insert(more(32, 3))
    assert got.tolist() == idx.insert(more(32, 3)).tolist()
    assert int(got.min()) > int(new_ids.max())


def test_server_sharded_writes_and_stats():
    """The server's write admission and per-wave snapshot semantics hold
    over the sharded plane, as on the reference's server."""
    name, ds, more = mutable_workloads(6_000)[0]
    rects = _rects(ds.data, n=5)
    srv = QueryServer(ShardedCOAX(ds.data, NOAUTO, n_shards=2, device=CPU),
                      max_batch=4, device=CPU)
    ref = RefServer(RefSharded(ds.data, REF_NOAUTO, n_shards=2,
                               backend="device"), max_batch=4)
    out = []
    for s in (srv, ref):
        qids = s.submit_many(rects)
        w1 = s.insert(more(11, 60))
        w2 = s.delete(np.arange(30))
        res = s.drain()
        assert s.write_results[w1].size == 60 and s.write_results[w2] == 30
        out.append([res[q] for q in qids])
    idx = srv.executor.index
    want = fullscan_expected(*idx.live_rows(), rects)
    for a, b, w in zip(*out, want):
        assert np.array_equal(a, w) and np.array_equal(b, w)
    st, st_r = srv.stats(), ref.stats()
    for key in ("shards", "per_shard", "rows_inserted", "delta_rows",
                "queries", "hits", "waves"):
        assert st[key] == st_r[key], key


def test_sharded_describe_and_footprint():
    name, ds, _ = mutable_workloads(6_000)[0]
    sh = ShardedCOAX(ds.data, NOAUTO, n_shards=3, partition="range",
                     device=CPU)
    ref = RefSharded(ds.data, REF_NOAUTO, n_shards=3, partition="range")
    d, d_r = sh.describe(), ref.describe()
    for key in ("n_shards", "partition", "shard_sizes", "shard_groups",
                "memory_footprint_bytes", "epoch", "trigger_checks"):
        assert d[key] == d_r[key], key
    assert d["memory_footprint_bytes"] >= sum(
        s.memory_footprint() for s in sh.shards) > 0
    with pytest.raises(ValueError):
        ShardedCOAX(ds.data, n_shards=0, device=CPU)


def test_device_setter_reaches_every_shard():
    name, ds, _ = mutable_workloads(6_000)[0]
    sh = ShardedCOAX(ds.data, NOAUTO, n_shards=3, device=CPU)
    sh.query_batch(_rects(ds.data))
    assert all(s._coax_plan is not None for s in sh.shards)
    sh.device = "cuda"               # drops every shard's plan; no upload
    assert sh.device == "cuda" and all(s.device == "cuda" for s in sh.shards)
    assert all(s._coax_plan is None for s in sh.shards)
    sh.device = CPU
    sh.backend = "numpy"
    assert_equiv(sh, _rects(ds.data), scratch=False, tag="moved back")


# --------------------------------------------------------------------- #
# Background compaction on a plane (twin of test_lsm.py's)
# --------------------------------------------------------------------- #
_LSM_DS = make_generic_fd(9_000, 5, ((0, 1), (2, 3)), seed=7)
_LSM_KW = dict(compact_min_delta=300, compact_delta_frac=0.01,
               drift_min_delta=200, compact_check_rows=64, delta_l0_spill=64)


def _lsm_more(seed, m):
    return make_generic_fd(m, 5, ((0, 1), (2, 3)), seed=seed).data


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_sharded_background_compaction_exact(backend):
    """Each shard's compactor runs on its own; the twins join every build
    at the same op (``finish_handoff``), so both planes walk the same
    epochs and answer identically, mid-stream and at the end."""
    sh = ShardedCOAX(_LSM_DS.data, CoaxConfig(**_LSM_KW, background_compact=True),
                     n_shards=3, partition="range", partition_dim=0,
                     backend=backend, device=CPU)
    ref = RefSharded(_LSM_DS.data, RefConfig(**_LSM_KW, background_compact=True),
                     n_shards=3, partition="range", partition_dim=0,
                     backend=backend)
    rects = rects_for(_LSM_DS.data, n=8)
    for j in range(12):
        rows = _lsm_more(700 + j, 150)
        if j % 4 == 3:
            rows = violate_fd(_LSM_DS, rows)
        for p in (sh, ref):
            p.insert(rows)
            p.delete(np.arange(j * 29, j * 29 + 11))
            p.finish_handoff()
        assert ([s.epoch for s in sh.shards]
                == [s.epoch for s in ref.shards]), j
        if j % 3 == 2:
            _same_plane(sh, ref, rects, ("mid", j))
            assert_equiv(sh, rects, scratch=False, tag=("mid", j))
    sh.finish_handoff()
    ref.finish_handoff()
    assert sh.background_compactions >= 1
    assert sh.background_compactions == ref.background_compactions
    d = sh.describe()
    assert d["background"]["completed"] == sh.background_compactions
    assert d["background"]["in_flight"] == 0
    assert d["trigger_checks"] == ref.describe()["trigger_checks"] > 0
    assert len(d["delta_runs"]) == 3
    _same_plane(sh, ref, rects, "final")
    assert_equiv(sh, rects, tag="sharded-final")
