"""The semantic result cache and pinned-epoch reads (DESIGN.md §9): the
port against the JAX package's ``repro`` on the CPU, twins of
``test_cache.py``.

The same seeded workloads, rect streams and write schedules run through
``repro`` and ``repro_torch`` (``device="cpu"``, where the device route's
waves run the plain version of the ``fused_scan`` kernel).  The bar is
equality: every cached answer equals the cache-disabled answer and the
reference's, and every cache counter (hits, partials, misses, admissions,
evictions, invalidations, rejections, resident bytes) equals the
reference's.  Background handoffs are made deterministic as in
``test_torch_lsm.py``: the build is joined with ``finish_handoff``,
never waited on with a sleep.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefConfig
from repro.engine import QueryServer as RefServer
from repro.engine import SemanticCache as RefCache
from repro.engine import ShardedCOAX as RefSharded
from repro_torch.core import COAXIndex, CoaxConfig
from repro_torch.data import make_airline, make_generic_fd, make_osm
from repro_torch.engine import (QueryServer, SemanticCache, ShardedCOAX,
                                split_hits)

from _hypothesis_compat import given, settings, st
from workloads import rects_for, zipf_rects

CPU = "cpu"
NOAUTO = CoaxConfig(auto_compact=False)
REF_NOAUTO = RefConfig(auto_compact=False)
_BG = dict(background_compact=True, compact_min_delta=256,
           compact_delta_frac=0.01, compact_check_rows=32)
BG = CoaxConfig(**_BG)
REF_BG = RefConfig(**_BG)

_DS = {
    "airline": lambda: make_airline(6_000, seed=3),
    "osm": lambda: make_osm(6_000, seed=3),
    "generic_fd": lambda: make_generic_fd(5_000, 5, ((0, 1), (2, 3)), seed=7),
}


def _mix(data, seed=0):
    """Zipfian hot-rect stream (repeats + nested subsets) plus the standard
    mix (full-range, ±inf, empty) — hits, partials and misses in one wave."""
    return np.concatenate([zipf_rects(data, n=48, n_hot=8, seed=seed),
                           rects_for(data, n=8, seed=seed)])


def _split_equal(got, want, tag=""):
    assert len(got) == len(want), tag
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), (tag, i)


def _lookup(cs):
    return None if cs is None else dataclasses.astuple(cs)


def _same_cache(port, ref, tag=""):
    """Per-wave lookup stats and lifetime counters equal the reference's
    (one cache per index, or one per shard)."""
    assert _lookup(port.last_cache_stats) == _lookup(ref.last_cache_stats), tag
    pairs = (zip(port.shards, ref.shards) if hasattr(port, "shards")
             else [(port, ref)])
    for k, (p, r) in enumerate(pairs):
        assert p.cache.describe() == r.cache.describe(), (tag, k)


def _pair(wl_data, backend, shards=None, cfg=NOAUTO, ref_cfg=REF_NOAUTO):
    if shards is None:
        return (COAXIndex(wl_data, cfg, backend=backend, device=CPU),
                RefIndex(wl_data, ref_cfg, backend=backend))
    return (ShardedCOAX(wl_data, cfg, n_shards=shards, backend=backend,
                        device=CPU),
            RefSharded(wl_data, ref_cfg, n_shards=shards, backend=backend))


# --------------------------------------------------------------------- #
# §9.1 bit-identity matrix: (workload × backend × shards)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wl", sorted(_DS))
@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("shards", [None, 4])
def test_cached_answers_bit_identical(wl, backend, shards):
    ds = _DS[wl]()
    rects = _mix(ds.data)
    port, ref = _pair(ds.data, backend, shards)
    want = port.query_batch_split(rects)        # cache-disabled oracle
    _split_equal(want, ref.query_batch_split(rects), (wl, backend, "plain"))
    port.attach_cache(byte_budget=8 << 20)
    ref.attach_cache(byte_budget=8 << 20)
    for phase in ("cold", "warm"):
        got = port.query_batch_split(rects)
        _split_equal(got, want, (wl, backend, shards, phase))
        _split_equal(ref.query_batch_split(rects), want,
                     (wl, backend, shards, phase, "ref"))
        _same_cache(port, ref, (wl, backend, shards, phase))
    cs = port.last_cache_stats
    assert cs is not None and cs.hits + cs.partial > 0, (wl, backend, shards)
    assert port.backend == backend


def test_cache_partial_hits_filter_supersets():
    """Nested rects must answer from containing entries (the §9.1 filter),
    not just byte-identical repeats."""
    ds = _DS["airline"]()
    port, ref = _pair(ds.data, "device")
    port.attach_cache()
    ref.attach_cache()
    rects = np.asarray(zipf_rects(ds.data, n=16, n_hot=16, nest_frac=0.0,
                                  seed=5), np.float64)
    port.query_batch(rects)                     # populate with the supersets
    ref.query_batch(rects)
    inner = rects.copy()
    width = inner[:, :, 1] - inner[:, :, 0]
    inner[:, :, 0] += 0.25 * width
    inner[:, :, 1] = np.maximum(inner[:, :, 1] - 0.25 * width, inner[:, :, 0])
    want = COAXIndex(ds.data, NOAUTO, device=CPU).query_batch_split(inner)
    _split_equal(port.query_batch_split(inner), want, "nested")
    _split_equal(ref.query_batch_split(inner), want, "nested-ref")
    assert port.last_cache_stats.partial == inner.shape[0]
    _same_cache(port, ref, "nested")


@pytest.mark.parametrize("seed", range(4))
def test_merge_cached_equals_the_reference_merge(seed):
    """The port lays cached and missed answers out in query order without
    a sort; the reference lexsorts them.  Same flat (query, row) arrays on
    seeded waves of exact hits, filtered partials, misses and empties."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 40))
    answers = [None if rng.random() < 0.4 else
               np.unique(rng.integers(0, 10_000, int(rng.integers(0, 50))))
               for _ in range(b)]
    miss = np.array([i for i, a in enumerate(answers) if a is None],
                    dtype=np.int64)
    per = [np.unique(rng.integers(0, 10_000, int(rng.integers(0, 30))))
           for _ in miss]
    q_m = np.repeat(np.arange(miss.size, dtype=np.int64),
                    [p.size for p in per])
    r_m = np.concatenate(per) if per else np.empty(0, np.int64)
    got = COAXIndex._merge_cached(answers, miss, q_m, r_m)
    want = RefIndex._merge_cached(answers, miss, q_m, r_m)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)


def test_rows_for_ids_equals_reference():
    """The cache-admission gather resolves snapshot, delta and outlier ids
    exactly as the reference does, and refuses dead or unknown ids."""
    ds = _DS["generic_fd"]()
    port, ref = _pair(ds.data, "numpy")
    for idx in (port, ref):
        idx.insert(ds.data[:40] + 1.0)
        idx.insert(ds.data[40:60] * 3.0 + 1000.0)   # FD violators
        idx.delete(np.arange(10, 30))
    rows, ids = port.live_rows()
    pick = np.random.default_rng(1).choice(ids, 200, replace=False)
    assert np.array_equal(port.rows_for_ids(pick), ref.rows_for_ids(pick))
    with pytest.raises(KeyError):
        port.rows_for_ids(np.array([10_000_000]))


# --------------------------------------------------------------------- #
# §9.2 invalidation: every write moves the version key
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_write_invalidates_cache_entries(backend):
    ds = _DS["airline"]()
    row = ds.data[42]
    rect = np.stack([row.astype(np.float64) - 1e-3,
                     row.astype(np.float64) + 1e-3], axis=-1)[None]
    port, ref = _pair(ds.data, backend)
    for idx in (port, ref):
        idx.attach_cache()

    def q(idx):
        return idx.query_batch_split(rect)[0]

    before = q(port)
    assert np.array_equal(q(port), before)                 # cached repeat
    assert port.cache.hits == 1
    new_id = port.insert(row[None])[0]
    after = q(port)                                        # sees the insert
    assert new_id in after and np.array_equal(
        np.sort(np.append(before, new_id)), after)
    assert port.cache.invalidations > 0                    # old entry purged
    port.delete([new_id])
    assert np.array_equal(q(port), before)                 # and the delete
    # the reference, driven through the same ops, agrees step by step
    assert np.array_equal(q(ref), before) and np.array_equal(q(ref), before)
    assert ref.insert(row[None])[0] == new_id
    assert np.array_equal(q(ref), after)
    ref.delete([new_id])
    assert np.array_equal(q(ref), before)
    _same_cache(port, ref, backend)


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_handoff_install_invalidates_cache(backend):
    """A background-compaction epoch install is a version bump like any
    other write: post-handoff answers come from the new epoch, never a
    pre-handoff cache entry."""
    ds = _DS["airline"]()
    port, ref = _pair(ds.data, backend, cfg=BG, ref_cfg=REF_BG)
    rects = _mix(ds.data)
    for idx in (port, ref):
        idx.attach_cache()
        idx.query_batch(rects)                           # populate
    rng = np.random.default_rng(9)
    while port.background_compactions < 1:
        rows = ds.data[rng.integers(0, ds.data.shape[0], 64)]
        for idx in (port, ref):
            idx.insert(rows)
            idx.finish_handoff()                         # join, no sleep
    assert ref.background_compactions == 1 and port.epoch == ref.epoch
    rows, ids = port.live_rows()
    want = COAXIndex(rows, NOAUTO, row_ids=ids,
                     device=CPU).query_batch_split(rects)
    _split_equal(port.query_batch_split(rects), want, "post-handoff")
    _split_equal(ref.query_batch_split(rects), want, "post-handoff-ref")
    assert port.cache.invalidations > 0
    _same_cache(port, ref, "post-handoff")


def test_stale_admission_gate_on_a_pipelined_wave():
    """A device wave submitted before a write and collected after it answers
    for its submit-time state, and is NOT admitted under the new version."""
    ds = _DS["airline"]()
    port = COAXIndex(ds.data, NOAUTO, device=CPU).attach_cache()
    rects = rects_for(ds.data, n=6, extremes=False)
    want = port.query_batch_split(rects)
    port.cache.clear()
    admitted = port.cache.admissions
    handle = port.query_batch_submit(rects)
    assert handle[0] == "cache"
    port.insert(ds.data[:5])                              # version moves
    q, r = port.query_batch_collect(handle)
    _split_equal(split_hits(q, r, rects.shape[0]), want, "submit-time state")
    assert len(port.cache) == 0 and port.cache.admissions == admitted


def test_sharded_cache_keys_on_own_shard_version():
    """Compacting shard 0 must strand ONLY shard 0's entries: shard 1's
    keep hitting (its version never moved), and no key ever contains the
    plane's aggregate epoch sum."""
    ds = _DS["airline"]()
    pl = ShardedCOAX(ds.data, NOAUTO, n_shards=2, partition="range",
                     device=CPU)
    ref = RefSharded(ds.data, REF_NOAUTO, n_shards=2, partition="range")
    rects = np.asarray(zipf_rects(ds.data, n=32, n_hot=8, nest_frac=0.0,
                                  seed=2), np.float64)
    for p in (pl, ref):
        p.attach_cache()
        p.query_batch(rects)
    hits0 = [pl.shards[k].cache.hits for k in range(2)]
    for p in (pl, ref):
        p.shards[0].compact()                   # moves shard 0's version only
        p.query_batch(rects)                    # re-keys shard 0, hits shard 1
    assert pl.shards[1].cache.hits > hits0[1]   # shard 1 entries survived
    assert pl.shards[0].cache.invalidations > 0  # shard 0's were purged
    assert pl.epoch == 1                        # aggregate moved ...
    for k in (0, 1):
        assert len(pl.shards[k].cache) > 0
        for vkey, _rect_bytes in pl.shards[k].cache._entries:
            assert vkey[0] == k                           # (shard_id, ...)
            assert vkey[1] == pl.shards[k].epoch          # shard's OWN epoch
        assert (list(pl.shards[k].cache._entries)
                == list(ref.shards[k].cache._entries)), k
    # ... but shard 1's entries still key on ITS epoch 0, not the sum:
    assert all(vkey[1] == 0 for vkey, _ in pl.shards[1].cache._entries)
    rows, ids = pl.live_rows()
    want = COAXIndex(rows, NOAUTO, row_ids=ids,
                     device=CPU).query_batch_split(rects)
    _split_equal(pl.query_batch_split(rects), want, "sharded-post-compact")
    _split_equal(ref.query_batch_split(rects), want, "sharded-post-compact-ref")
    _same_cache(pl, ref, "sharded-post-compact")


# --------------------------------------------------------------------- #
# §9.3 MVCC pins
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_pin_epoch_exact_across_background_handoff(backend):
    ds = _DS["airline"]()
    port, ref = _pair(ds.data, backend, cfg=BG, ref_cfg=REF_BG)
    rects = _mix(ds.data)
    pin, ref_pin = port.pin_epoch(), ref.pin_epoch()
    assert port.pinned_epochs == [pin.epoch] == ref.pinned_epochs
    want = pin.query_batch_split(rects)
    _split_equal(port.query_batch_split(rects), want, "pin == live at pin time")
    _split_equal(ref_pin.query_batch_split(rects), want, "ref pin")
    old_primary = weakref.ref(port.primary)
    old_plan = weakref.ref(pin._plan) if pin._plan is not None else None
    assert (old_plan is not None) == (backend == "device")
    if old_plan is not None:                    # pinned waves: one dispatch each
        assert pin._plan.dispatch_count == 1 and pin._plan.index is None
        old_rows = weakref.ref(pin._plan.p_img.rows_t)
        assert old_rows() is port._coax_plan.p_img.rows_t   # shared, not copied
    rng = np.random.default_rng(11)
    while port.background_compactions < 1:
        rows = ds.data[rng.integers(0, ds.data.shape[0], 64)]
        for idx in (port, ref):
            idx.insert(rows)
            idx.finish_handoff()
    assert port.epoch > pin.epoch and port.epoch == ref.epoch
    live = port.query_batch_split(rects)        # device: the new epoch's plan
    _split_equal(live, ref.query_batch_split(rects), "live after handoff")
    assert any(not np.array_equal(a, b) for a, b in zip(live, want))
    _split_equal(pin.query_batch_split(rects), want, "pin across handoff")
    _split_equal(ref_pin.query_batch_split(rects), want, "ref pin across")
    assert old_primary() is not None            # pin keeps the old epoch alive
    if old_plan is not None:
        assert old_plan() is not None and old_plan() is not port._coax_plan
        assert old_plan().dispatch_count == 2   # the old epoch's images
        assert old_rows() is not None
        assert old_rows() is not port._coax_plan.p_img.rows_t
    pin.release()
    gc.collect()
    assert old_primary() is None                # ... and releasing frees it
    if old_plan is not None:
        assert old_plan() is None               # the old device plan too
        assert old_rows() is None               # and its row image
    assert port.pinned_epochs == []
    with pytest.raises(RuntimeError):
        pin.query(rects[0])
    pin.release()                               # idempotent
    ref_pin.release()


def test_pin_epoch_refcount_and_context_manager():
    ds = _DS["generic_fd"]()
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    rects = rects_for(ds.data, n=6)
    p1 = idx.pin_epoch()
    with idx.pin_epoch() as p2:
        assert idx._pins[idx.epoch] == 2
        want = p1.query_batch_split(rects)
        _split_equal(p2.query_batch_split(rects), want, "two pins agree")
        _split_equal(RefIndex(ds.data, REF_NOAUTO).query_batch_split(rects),
                     want, "ref")
    assert idx._pins[idx.epoch] == 1            # p2 released at exit
    p1.release()
    assert idx.pinned_epochs == []


def test_sharded_pin_exact_across_writes():
    ds = _DS["osm"]()
    pl = ShardedCOAX(ds.data, NOAUTO, n_shards=4, device=CPU)
    ref = RefSharded(ds.data, REF_NOAUTO, n_shards=4)
    rects = _mix(ds.data)
    pin, ref_pin = pl.pin_epoch(), ref.pin_epoch()
    assert len(pin.shard_epochs) == 4
    want = pin.query_batch_split(rects)
    _split_equal(pl.query_batch_split(rects), want, "sharded pin at pin time")
    _split_equal(ref_pin.query_batch_split(rects), want, "ref pin")
    for p in (pl, ref):
        p.insert(ds.data[:128])
        p.compact()
    assert pl.pinned_epochs == [[0]] * 4 == ref.pinned_epochs
    _split_equal(pin.query_batch_split(rects), want, "sharded pin after writes")
    live = pl.query_batch_split(rects)
    _split_equal(live, ref.query_batch_split(rects), "live")
    assert any(not np.array_equal(a, b) for a, b in zip(live, want))
    pin.release()
    assert pl.pinned_epochs == [[]] * 4
    with pytest.raises(RuntimeError):
        pin.query(rects[0])
    ref_pin.release()


def test_server_pin_flushes_queued_writes_first():
    ds = _DS["airline"]()
    srv = QueryServer(COAXIndex(ds.data, NOAUTO, device=CPU), max_batch=16,
                      device=CPU)
    rect = np.stack([ds.data[7].astype(np.float64) - 1e-3,
                     ds.data[7].astype(np.float64) + 1e-3], axis=-1)
    srv.insert(ds.data[7][None])                # queued, not yet applied
    pin = srv.pin_epoch()                       # must flush, then freeze
    assert srv.executor.index.delta_rows > 0
    want = pin.query(rect)
    assert want.size == srv.executor.index.query(rect).size
    srv.insert(ds.data[7][None])
    srv.drain()                                 # applies the second insert
    assert np.array_equal(pin.query(rect), want)
    assert srv.executor.index.query(rect).size == want.size + 1
    pin.release()


# --------------------------------------------------------------------- #
# Eviction under a tiny byte budget
# --------------------------------------------------------------------- #
def test_eviction_respects_byte_budget():
    ds = _DS["airline"]()
    port, ref = _pair(ds.data, "device")
    twin = COAXIndex(ds.data, NOAUTO, device=CPU)
    for idx in (port, ref):
        idx.attach_cache(byte_budget=16 << 10)  # ~a handful of entries
    rects = rects_for(ds.data, n=40, seed=1, extremes=False)
    for wave in (rects[:20], rects[20:], rects[:20]):
        got = port.query_batch_split(wave)
        _split_equal(got, twin.query_batch_split(wave), "evicting")
        ref.query_batch_split(wave)
        assert port.cache.nbytes <= port.cache.byte_budget
        _same_cache(port, ref, "evicting")
    assert port.cache.evictions > 0
    assert len(port.cache) <= port.cache.max_entries


def test_cache_rejects_entry_larger_than_budget():
    cache = SemanticCache(byte_budget=256, max_entries=8)
    ref = RefCache(byte_budget=256, max_entries=8)
    rect = np.array([[0.0, 1.0], [0.0, 1.0]])
    ids = np.arange(1000, dtype=np.int64)
    rows = np.zeros((1000, 2), np.float32)
    assert not cache.admit((0, 0, 0, 0, 0), rect, ids, rows)
    assert not ref.admit((0, 0, 0, 0, 0), rect, ids, rows)
    assert cache.rejections == 1 and len(cache) == 0
    assert cache.describe() == ref.describe()
    with pytest.raises(ValueError):
        SemanticCache(byte_budget=0)


# --------------------------------------------------------------------- #
# Executor/server stats plumbing
# --------------------------------------------------------------------- #
_CACHE_WAVE = ("n_queries", "n_hits", "cache_hits", "cache_partial",
               "cache_bytes", "epoch", "delta_rows", "tombstones")
_CACHE_STATS = ("queries", "hits", "cache_hits", "cache_partial",
                "cache_hit_rate", "cache_bytes", "waves")


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_server_reports_cache_stats(backend):
    """Wave rows and ``stats()`` carry the same cache numbers as the
    reference's server; on the device backend the waves are pipelined, so
    each wave's numbers are the ones read at its submit."""
    ds = _DS["airline"]()
    srv = QueryServer(COAXIndex(ds.data, NOAUTO, device=CPU), max_batch=16,
                      cache_bytes=8 << 20, backend=backend, device=CPU)
    ref = RefServer(RefIndex(ds.data, REF_NOAUTO), max_batch=16,
                    cache_bytes=8 << 20, backend=backend)
    rects = zipf_rects(ds.data, n=48, n_hot=6, seed=4)
    for s in (srv, ref):
        for _ in range(2):
            s.submit_many(rects)
            s.drain()
        s.insert(ds.data[:10])
        s.submit_many(rects)
        s.drain()
    st_p, st_r = srv.stats(), ref.stats()
    assert {k: st_p[k] for k in _CACHE_STATS} == {k: st_r[k] for k in _CACHE_STATS}
    assert st_p["cache_hits"] + st_p["cache_partial"] > 0
    assert 0.0 < st_p["cache_hit_rate"] <= 1.0 and st_p["cache_bytes"] > 0
    rows = [tuple(getattr(w, f) for f in _CACHE_WAVE)
            for w in srv.executor.wave_stats]
    assert rows == [tuple(getattr(w, f) for f in _CACHE_WAVE)
                    for w in ref.executor.wave_stats]
    assert any(w.cache_hits + w.cache_partial > 0
               for w in srv.executor.wave_stats)


# --------------------------------------------------------------------- #
# Arbitrary query/write interleavings, cached == plain == the reference
# --------------------------------------------------------------------- #
_H_DS = make_airline(2_000, seed=13)
_H_RECTS = np.concatenate([
    zipf_rects(_H_DS.data, n=12, n_hot=4, seed=21),
    rects_for(_H_DS.data, n=4, seed=21, extremes=False)])


def _interleave_twin(ops, backend):
    """Drive a cached port index, an uncached port twin and a cached
    reference through ``ops``; every query answers identically on all
    three (ids align by construction)."""
    cached = COAXIndex(_H_DS.data, NOAUTO, backend=backend,
                       device=CPU).attach_cache(byte_budget=1 << 20)
    plain = COAXIndex(_H_DS.data, NOAUTO, backend=backend, device=CPU)
    ref = RefIndex(_H_DS.data, REF_NOAUTO).attach_cache(byte_budget=1 << 20)
    inserted = []
    for op, k in ops:
        if op == "q":
            rects = _H_RECTS[k % _H_RECTS.shape[0]:][:4]
            want = plain.query_batch_split(rects)
            _split_equal(cached.query_batch_split(rects), want, ("q", k))
            _split_equal(ref.query_batch_split(rects), want, ("q-ref", k))
        elif op == "i":
            rows = _H_DS.data[k * 7 % _H_DS.data.shape[0]][None]
            inserted.append((cached.insert(rows)[0], plain.insert(rows)[0]))
            assert inserted[-1][0] == inserted[-1][1] == ref.insert(rows)[0]
        elif op == "d" and inserted:
            ca, pa = inserted.pop(k % len(inserted))
            assert cached.delete([ca]) == plain.delete([pa]) == 1
            assert ref.delete([ca]) == 1
        elif op == "c":
            cached.cache.clear()
            ref.cache.clear()
    want = plain.query_batch_split(_H_RECTS)
    _split_equal(cached.query_batch_split(_H_RECTS), want, "final")
    _split_equal(ref.query_batch_split(_H_RECTS), want, "final-ref")
    assert cached.cache.describe() == ref.cache.describe()


@settings(max_examples=10, deadline=None)
@given(st.lists(st.tuples(st.sampled_from("qidc"),
                          st.integers(min_value=0, max_value=15)),
                min_size=1, max_size=12))
def test_cached_equals_plain_under_interleavings(ops):
    """Property: under ANY interleaving of queries, inserts, deletes and
    cache-clears, the cached port answers as its uncached twin and the
    cached reference do, with the reference's cache counters."""
    _interleave_twin(ops, "numpy")


@pytest.mark.parametrize("seed", range(6))
def test_cached_equals_plain_seeded_interleavings(seed):
    """The property's fixed-seed cases: they run where hypothesis is
    absent (each draws 12 ops from the same alphabet)."""
    rng = np.random.default_rng(100 + seed)
    ops = [("qidc"[int(rng.integers(4))], int(rng.integers(16)))
           for _ in range(12)]
    _interleave_twin(ops, backend="numpy" if seed % 2 else "device")
