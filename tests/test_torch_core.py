"""The port's host core against the JAX package's, on the CPU.

The host modules are numpy in both packages, so the bar is bit identity:
the f32 rounding pair, Eq. 2 translation, grid-file answers, the learned
soft-FD groups (repr-exact floats), and an index fitted by the reference
and served by the port through ``COAXIndex.from_state``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import COAXIndex as RefIndex
from repro.core import GridFile as RefGrid
from repro.core import batched_searchsorted as ref_bss
from repro.core import learn_soft_fds as ref_learn
from repro.core import translate_rects as ref_translate
from repro.core.gridfile import f32_ceil as ref_ceil
from repro.engine.device import f32_floor as ref_floor
from repro_torch.core import COAXIndex, GridFile, batched_searchsorted
from repro_torch.core import learn_soft_fds, translate_rects
from repro_torch.core.gridfile import f32_ceil
from repro_torch.engine.device import f32_floor
from repro_torch.engine import split_hits
from workloads import NOAUTO, engine_workload, engine_workloads, rects_for

WORKLOADS = [name for name, _ in engine_workloads()]


def _edge_values():
    tiny = np.float64(np.finfo(np.float32).smallest_subnormal)
    big = np.float64(np.finfo(np.float32).max)
    vals = [0.0, -0.0, np.inf, -np.inf, 1e39, -1e39, 1e38, -1e38, big,
            -big, np.nextafter(big, np.inf), tiny, -tiny, tiny / 2,
            -tiny / 2, tiny * 1.5, 1e-40, -1e-40, 1e-45, 1 / 3, -1 / 3,
            np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0)]
    rng = np.random.default_rng(7)
    return np.concatenate([vals, rng.normal(0, 1e3, 200),
                           rng.normal(0, 1e-39, 50)])


@pytest.mark.parametrize("fn,ref", [(f32_ceil, ref_ceil),
                                    (f32_floor, ref_floor)],
                         ids=["f32_ceil", "f32_floor"])
def test_f32_rounding_pair_bit_identical(fn, ref):
    x = _edge_values()
    got, want = fn(x), ref(x)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_batched_searchsorted_identical():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.normal(0, 5, 4_000)).astype(np.float32)
    blk_lo = rng.integers(0, 3_000, 300)
    blk_hi = blk_lo + rng.integers(0, 900, 300)
    target = rng.normal(0, 5, 300)
    for side in ("left", "right"):
        assert np.array_equal(
            batched_searchsorted(vals, blk_lo, blk_hi, target, side),
            ref_bss(vals, blk_lo, blk_hi, target, side))


@pytest.mark.parametrize("name", WORKLOADS)
def test_learned_groups_and_translation_identical(name):
    ds = engine_workload(name)
    port = learn_soft_fds(ds.data)
    want = ref_learn(ds.data)
    assert len(port) == len(want)
    for g, w in zip(port, want):
        assert g.predictor == w.predictor
        assert tuple(g.dependents) == tuple(w.dependents)
        for dep in w.dependents:
            assert repr(dataclasses.astuple(g.models[dep])) == \
                repr(dataclasses.astuple(w.models[dep]))
    keep = [d for d in range(ds.data.shape[1])
            if d not in {x for g in want for x in g.dependents}]
    rects = rects_for(ds.data)
    got = translate_rects(rects, port, keep)
    exp = ref_translate(rects, want, keep)
    assert np.array_equal(got, exp, equal_nan=True)


@pytest.mark.parametrize("sort_dim", [None, 1])
def test_gridfile_answers_identical(sort_dim):
    rng = np.random.default_rng(4)
    data = rng.normal(0, 10, (6_000, 3)).astype(np.float32)
    kw = dict(index_dims=[0, 1, 2], cells_per_dim=5, sort_dim=sort_dim)
    port = GridFile(data, backend="numpy", **kw)
    ref = RefGrid(data, **kw)
    rects = np.sort(rng.uniform(-20, 20, (40, 3, 2)), axis=-1)
    assert np.array_equal(port.offsets, ref.offsets)
    assert np.array_equal(port.row_ids, ref.row_ids)
    for a, b in zip(port.plan_batch(rects), ref.plan_batch(rects)):
        assert np.array_equal(a, b)
    for a, b in zip(port.query_batch(rects, rects),
                    ref.query_batch(rects, rects)):
        assert np.array_equal(a, b)
    for r in rects[:8]:
        assert np.array_equal(port.query(r, r), ref.query(r, r))
    back = GridFile.from_state(ref.state_dict(), backend="numpy")
    for a, b in zip(back.query_batch(rects, rects),
                    ref.query_batch(rects, rects)):
        assert np.array_equal(a, b)


def plain_state(idx) -> dict:
    """A reference index's ``_snapshot_state`` as the plain data the port's
    ``from_state`` takes (config and groups as dicts, no reference types)."""
    st = dict(idx._snapshot_state())
    st["config"] = dataclasses.asdict(st["config"])
    st["groups"] = [
        {"predictor": g.predictor, "dependents": list(g.dependents),
         "models": {d: dataclasses.astuple(m) for d, m in g.models.items()}}
        for g in st["groups"]]
    return st


@pytest.mark.parametrize("name", ["airline", "generic_fd"])
def test_from_state_serves_reference_state(name):
    """An index fitted (and written to) by the reference, handed over as
    plain data: the port answers bit-identically on both backends without
    refitting, and takes the same further writes to the same state."""
    ds = engine_workload(name)
    ref = RefIndex(ds.data[:12_000], NOAUTO)
    rng = np.random.default_rng(5)
    more = ds.data[12_000:12_600]
    ref.insert(more)
    ref.delete(rng.choice(12_000, 300, replace=False))
    port = COAXIndex.from_state(plain_state(ref), device="cpu")
    rects = rects_for(ds.data)
    want = ref.query_batch(rects)
    for backend in ("numpy", "device"):
        port.backend = backend
        got = port.query_batch(rects)
        assert np.array_equal(got[0], want[0]), backend
        assert np.array_equal(got[1], want[1]), backend
    for r in rects[:6]:
        assert np.array_equal(port.query(r), ref.query(r))
    # same further writes, same compaction: same state and answers
    for idx in (ref, port):
        idx.insert(ds.data[12_600:13_000])
        idx.delete(np.arange(50, 90))
        idx.compact()
    assert port.epoch == ref.epoch
    assert np.array_equal(port.row_ids, ref.row_ids)
    assert port.describe()["groups"] == ref.describe()["groups"]
    q_p, r_p = port.query_batch(rects)
    q_r, r_r = ref.query_batch(rects)
    assert np.array_equal(q_p, q_r) and np.array_equal(r_p, r_r)
    assert port.drift_predictability() == ref.drift_predictability()


def test_auto_compaction_schedule_identical():
    """The amortized trigger schedule (checks, spills, size trigger) under
    the same write sequence lands both packages on the same epochs."""
    ds = engine_workload("osm")
    cfg_kw = dict(compact_min_delta=300, compact_delta_frac=0.05,
                  compact_check_rows=32, delta_l0_spill=64)
    from repro.core import CoaxConfig as RefCfg
    from repro_torch.core import CoaxConfig
    ref = RefIndex(ds.data[:8_000], RefCfg(**cfg_kw))
    port = COAXIndex(ds.data[:8_000], CoaxConfig(**cfg_kw), device="cpu")
    rng = np.random.default_rng(9)
    rects = rects_for(ds.data, n=8)
    for step in range(12):
        rows = ds.data[8_000 + 40 * step: 8_040 + 40 * step]
        dels = rng.choice(8_000, 7, replace=False)
        for idx in (ref, port):
            idx.insert(rows)
            idx.delete(dels)
        assert (port.epoch, port.trigger_checks) == \
            (ref.epoch, ref.trigger_checks), step
    assert port.epoch > 0
    got = split_hits(*port.query_batch(rects), rects.shape[0])
    want = split_hits(*ref.query_batch(rects), rects.shape[0])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
