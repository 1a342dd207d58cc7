"""The durability plane (DESIGN.md §7): the port against the JAX package's
``repro`` on the CPU, twins of ``test_storage.py`` and of
``test_lsm.py::test_crash_mid_handoff_recovers_bit_identical``.

The on-disk format is the reference's (npz arrays plus a JSON manifest,
the same framed WAL records), so snapshots and WALs written by either
package restore in the other: the cross-restore cases write with one and
recover with the other, single and sharded, and hold hits, epochs,
``compactions``, ``_next_id``, ``trigger_checks``, ``_write_units`` and
the drift trackers' ``xtx``/``xty``/``lam`` bitwise equal.  The
kill-and-recover matrix crashes a journaled port index at points of a
seeded schedule, recovers it onto the device route (``device="cpu"``, the
plain ``fused_scan``) and resumes, and must land on the never-crashed
index and the reference's.  Crash windows are injected, never timed: no
test waits on a sleep, and background builds are joined with
``finish_handoff``.
"""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.storage as ref_storage
from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefConfig
from repro.engine import ShardedCOAX as RefSharded
from repro.storage import WriteAheadLog as RefWAL
from repro_torch.core import COAXIndex, CoaxConfig
from repro_torch.data import make_airline, make_generic_fd
from repro_torch.engine import BatchQueryExecutor, QueryServer, ShardedCOAX
from repro_torch.storage import (WriteAheadLog, atomic, latest_snapshot,
                                 read_manifest, read_wal, restore, wal_path,
                                 write_snapshot)
from repro_torch.storage import durability as dmod

from _hypothesis_compat import given, settings, st
from workloads import fullscan_expected, mutable_workloads, rects_for, violate_fd

CPU = "cpu"
NOAUTO = CoaxConfig(auto_compact=False)
REF_NOAUTO = RefConfig(auto_compact=False)
_TRIG = dict(compact_min_delta=400, compact_delta_frac=0.01,
             drift_min_delta=200)
TRIG = CoaxConfig(**_TRIG)
REF_TRIG = RefConfig(**_TRIG)


def _schedule(ds, more, n_ops=16, violate_every=4, delete_every=3):
    """Deterministic op list of ``test_storage.py``: insert bursts (every
    ``violate_every``-th FD-violating) interleaved with deletes."""
    ops = []
    for i in range(n_ops):
        rows = more(100 + i, 120)
        if i % violate_every == violate_every - 1:
            rows = violate_fd(ds, rows)
        ops.append(("insert", rows))
        if i % delete_every == delete_every - 1:
            ops.append(("delete", np.arange(i * 37, i * 37 + 25)))
    return ops


def _apply(idx, op):
    (idx.insert if op[0] == "insert" else idx.delete)(op[1])


def _same_hits(a, b, rects, tag=""):
    q, r = a.query_batch(rects)
    q2, r2 = b.query_batch(rects)
    assert np.array_equal(q, q2) and np.array_equal(r, r2), (tag, "hits")


def _assert_state_equal(live, rec, rects, tag=""):
    """Every behavioural dimension of bit-identity (DESIGN.md §7.4)."""
    _same_hits(live, rec, rects, tag)
    assert rec.epoch == live.epoch, (tag, "epoch")
    assert rec.compactions == live.compactions, (tag, "compactions")
    assert rec._next_id == live._next_id, (tag, "next_id")
    assert rec.n_rows == live.n_rows, (tag, "n_rows")
    assert rec.trigger_checks == live.trigger_checks, (tag, "trigger_checks")


def _assert_trackers_equal(live, rec, tag=""):
    """Recovered Bayesian sufficient statistics BIT equal to the live
    tracker's, and the drift score exactly equal."""
    if hasattr(live, "shards"):
        for k, (ls, rs) in enumerate(zip(live.shards, rec.shards)):
            _assert_trackers_equal(ls, rs, (tag, k))
        return
    keys = live._tracker_keys()
    assert rec._tracker_keys() == keys, (tag, "tracker keys")
    for k in keys:
        for f in ("xtx", "xty"):
            assert np.array_equal(getattr(live._fd_trackers[k], f),
                                  getattr(rec._fd_trackers[k], f)), (tag, k, f)
        assert live._fd_trackers[k].lam == rec._fd_trackers[k].lam, (tag, k)
    assert live._x_scale == rec._x_scale, (tag, "x_scale")
    assert live._write_units == rec._write_units, (tag, "write_units")
    assert live.drift_predictability() == rec.drift_predictability(), tag


# --------------------------------------------------------------------- #
# atomic.py: the staged-write idiom
# --------------------------------------------------------------------- #
def test_atomic_stage_rename_and_completeness(tmp_path):
    def good(tmp):
        (tmp / "payload.bin").write_bytes(b"x" * 64)
        (tmp / "MANIFEST.json").write_text("{}")

    atomic.stage_and_rename(tmp_path / "epoch_00000001_000000000000", good)
    (tmp_path / ".tmp.deadbeef.epoch_00000002_000000000000").mkdir()
    torn = tmp_path / "epoch_00000003_000000000000"
    torn.mkdir()
    (torn / "payload.bin").write_bytes(b"partial")
    latest = atomic.latest_complete(tmp_path, "epoch_")
    assert latest is not None and latest.name == "epoch_00000001_000000000000"
    assert atomic.parse_key(latest.name, "epoch_") == (1, 0)
    assert atomic.sweep_stale_tmp(tmp_path) == 1


def test_atomic_retention_and_failed_stage(tmp_path):
    def writer(tmp):
        (tmp / "MANIFEST.json").write_text('{"v": 1}')

    for step in range(5):
        atomic.stage_and_rename(tmp_path / f"step_{step:08d}", writer)
    assert atomic.retain(tmp_path, "step_", keep=2) == 3
    keys = [k for k, _ in atomic.complete_entries(tmp_path, "step_")]
    assert keys == [(3,), (4,)]

    def boom(tmp):
        (tmp / "junk").write_bytes(b"j")
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError):
        atomic.stage_and_rename(tmp_path / "step_00000004", boom)
    assert (tmp_path / "step_00000004" / "MANIFEST.json").read_text() == '{"v": 1}'
    assert not list(tmp_path.glob(".tmp.*"))


# --------------------------------------------------------------------- #
# wal.py: the reference's framing byte for byte, torn tails
# --------------------------------------------------------------------- #
def test_wal_bytes_equal_reference_and_roundtrip(tmp_path):
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    paths = []
    for cls, sub in ((WriteAheadLog, "port"), (RefWAL, "ref")):
        p = wal_path(tmp_path / sub, 3)
        wal = cls(p, epoch=3)
        wal.append_insert(rows, np.array([7, 8, 9], np.int64))
        wal.append_delete(np.array([1, 2], np.int64))
        assert wal.pending_records == 2 and wal.pending_bytes > 0
        wal.sync()
        assert wal.pending_bytes == 0
        wal.close()
        wal.close()                                 # idempotent
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for reader in (read_wal, ref_storage.read_wal):
        records, next_seq, intact = reader(paths[1], expect_epoch=3)
        assert next_seq == 2 and intact == paths[1].stat().st_size
        assert np.array_equal(records[0].rows, rows)
        assert np.array_equal(records[0].ids, [7, 8, 9])
        assert records[1].rows is None
        assert np.array_equal(records[1].ids, [1, 2])
    with pytest.raises(ValueError):
        read_wal(paths[0], expect_epoch=4)


@pytest.mark.parametrize("cut", [1, 10, 21, 30])
def test_wal_torn_tail_recovers_prefix(tmp_path, cut):
    """Truncating the WAL mid-record (any byte of the last frame) yields
    exactly the complete-prefix records, as the reference's reader does."""
    p = wal_path(tmp_path, 0)
    wal = WriteAheadLog(p, epoch=0)
    for i in range(3):
        wal.append_insert(np.full((2, 2), i, np.float32),
                          np.array([2 * i, 2 * i + 1], np.int64))
    wal.close()
    full = p.stat().st_size
    os.truncate(p, full - cut)              # torn write: lose tail bytes
    records, next_seq, intact = read_wal(p)
    assert len(records) == 2 and next_seq == 2 and intact <= full - cut
    assert ref_storage.read_wal(p)[1:] == (next_seq, intact)
    with open(p, "ab") as f:                # garbage tail stops there too
        f.write(b"\xff" * 40)
    records, next_seq, _ = read_wal(p)
    assert len(records) == 2 and next_seq == 2


# --------------------------------------------------------------------- #
# Snapshots: the reference's format, cross-restore both ways
# --------------------------------------------------------------------- #
def _mutated_pair(ds, more, cfg=NOAUTO, ref_cfg=REF_NOAUTO):
    port = COAXIndex(ds.data, cfg, backend="numpy", device=CPU)
    ref = RefIndex(ds.data, ref_cfg)
    for idx in (port, ref):
        idx.insert(more(100, 300))
        idx.insert(violate_fd(ds, more(101, 80)))
        idx.delete(np.arange(50, 120))
    return port, ref


def test_snapshot_arrays_and_manifest_equal_reference(tmp_path):
    """The same state packs into the same npz array names, dtypes and
    values and the same manifest (but its wall-clock stamp)."""
    name, ds, more = mutable_workloads(4000)[0]
    port, ref = _mutated_pair(ds, more)
    p = write_snapshot(port, tmp_path / "port", wal_seq=3)
    r = ref_storage.write_snapshot(ref, tmp_path / "ref", wal_seq=3)
    assert p.name == r.name
    with np.load(p / "arrays.npz") as zp, np.load(r / "arrays.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype, k
            assert np.array_equal(zp[k], zr[k]), k
    mp, mr = read_manifest(p), read_manifest(r)
    mp.pop("time"), mr.pop("time")
    assert mp == mr


def test_snapshot_roundtrip_midepoch(tmp_path):
    """A full-state save with live deltas, tombstones and dragged trackers
    restores bit-identically — no WAL involved."""
    name, ds, more = mutable_workloads(4000)[0]
    idx, _ = _mutated_pair(ds, more)
    path = idx.save(tmp_path)
    man = read_manifest(path)
    assert man["kind"] == "coax" and man["wal_seq"] == 0
    rects = rects_for(ds.data, n=8)
    rec = COAXIndex.restore(tmp_path, device=CPU)
    assert rec.backend == "device" and rec.device == CPU
    _assert_state_equal(idx, rec, rects, "roundtrip")
    _assert_trackers_equal(idx, rec, "roundtrip")
    rec.insert(more(102, 60))
    idx.insert(more(102, 60))
    want = fullscan_expected(*idx.live_rows(), rects)
    got = rec.query_batch_split(rects)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_restore_both_ways(tmp_path, writer, shards):
    """A journaled index of one package, crashed mid-epoch (snapshot + WAL
    tail, a compaction crossed), restores in the other bit-identically;
    the restored plane keeps journaling, and the first package restores
    what the second appended."""
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=8)
    ops = _schedule(ds, more)

    def build(pkg):
        if pkg == "ref":
            return (RefSharded(ds.data, REF_TRIG, n_shards=shards)
                    if shards else RefIndex(ds.data, REF_TRIG))
        return (ShardedCOAX(ds.data, TRIG, n_shards=shards, device=CPU)
                if shards else COAXIndex(ds.data, TRIG, device=CPU))

    reader = "port" if writer == "ref" else "ref"
    live, vic = build(writer), build(writer)
    d = tmp_path / "dur"
    vic.attach_durability(d)
    for op in ops[:-3]:
        _apply(live, op)
        _apply(vic, op)
    assert live.compactions > 0
    vic.durable.checkpoint()                        # a mid-epoch snapshot
    for op in ops[-3:-1]:
        _apply(live, op)
        _apply(vic, op)
    vic.durable.sync()
    del vic                                         # crash

    def load(pkg):
        if pkg == "port":
            return restore(d, durable=True, device=CPU)
        return ref_storage.restore(d, durable=True)

    rec = load(reader)
    assert type(rec).__module__.startswith(
        "repro_torch" if reader == "port" else "repro.")
    _assert_state_equal(live, rec, rects, (writer, shards, "cross"))
    _assert_trackers_equal(live, rec, (writer, shards, "cross"))
    _apply(live, ops[-1])
    _apply(rec, ops[-1])                           # journaled by the reader
    rec.durable.sync()
    del rec
    back = load(writer)                            # ... and read back
    _assert_state_equal(live, back, rects, (writer, shards, "back"))
    _assert_trackers_equal(live, back, (writer, shards, "back"))


def test_snapshot_newest_complete_wins(tmp_path):
    ds = make_airline(3000, seed=3)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    write_snapshot(idx, tmp_path, wal_seq=0)
    idx.insert(make_airline(100, seed=9).data)
    newer = write_snapshot(idx, tmp_path, wal_seq=5)
    assert latest_snapshot(tmp_path) == newer
    # a staged-but-never-renamed snapshot must not shadow it
    (tmp_path / ".tmp.cafef00d.epoch_00000009_000000000000").mkdir()
    bogus = tmp_path / "epoch_00000009_000000000000"
    bogus.mkdir()
    (bogus / "arrays.npz").write_bytes(b"not an npz")
    assert latest_snapshot(tmp_path) == newer
    assert restore(tmp_path, device=CPU).n_rows == idx.n_rows


# --------------------------------------------------------------------- #
# kill-and-recover differential matrix
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wname", ["airline", "osm", "generic_fd"])
@pytest.mark.parametrize("shards", [None, 4])
def test_kill_and_recover_matrix(tmp_path, wname, shards):
    """Crash at points of a seeded schedule; recover onto the device route;
    resume the remaining ops: hits bit-identical to the uninterrupted port
    index AND the reference's, pre- and post-compaction."""
    name, ds, more = next(w for w in mutable_workloads(5000) if w[0] == wname)
    rects = rects_for(ds.data, n=8)
    ops = _schedule(ds, more)

    def build():
        if shards:
            return ShardedCOAX(ds.data, TRIG, n_shards=shards,
                               backend="numpy", device=CPU)
        return COAXIndex(ds.data, TRIG, backend="numpy", device=CPU)

    live = build()
    ref = (RefSharded(ds.data, REF_TRIG, n_shards=shards) if shards
           else RefIndex(ds.data, REF_TRIG))
    compact_ops = []
    for i, op in enumerate(ops):
        before = live.compactions
        _apply(live, op)
        _apply(ref, op)
        if live.compactions != before:
            compact_ops.append(i)
    assert compact_ops, "schedule must cross the compaction trigger"
    _assert_state_equal(ref, live, rects, (wname, shards, "ref"))
    points = sorted({0, max(compact_ops[0] - 1, 0), compact_ops[0] + 1,
                     len(ops)})
    for crash_at in points:
        d = tmp_path / f"crash_{crash_at}"
        vic = build()
        vic.attach_durability(d)
        for op in ops[:crash_at]:
            _apply(vic, op)
        vic.durable.sync()
        del vic                            # the crash: memory is gone
        rec = restore(d, durable=True, device=CPU)
        assert type(rec) is type(live) and rec.backend == "device"
        for op in ops[crash_at:]:
            _apply(rec, op)
        _assert_state_equal(live, rec, rects, (wname, shards, crash_at))
        _assert_trackers_equal(live, rec, (wname, shards, crash_at))


def test_recover_preserves_compaction_schedule(tmp_path):
    """After recovery the triggers fire at the SAME op as the never-crashed
    index."""
    name, ds, more = mutable_workloads(5000)[0]
    ops = _schedule(ds, more, n_ops=20)
    live = COAXIndex(ds.data, TRIG, backend="numpy", device=CPU)
    d = Path(tmp_path) / "dur"
    vic = COAXIndex(ds.data, TRIG, backend="numpy",
                    device=CPU).attach_durability(d)
    for op in ops[:6]:
        _apply(live, op)
        _apply(vic, op)
    vic.durable.sync()
    del vic
    rec = restore(d, durable=True, backend="numpy", device=CPU)
    live_epochs, rec_epochs = [], []
    for op in ops[6:]:
        _apply(live, op)
        live_epochs.append(live.epoch)
        _apply(rec, op)
        rec_epochs.append(rec.epoch)
    assert live_epochs == rec_epochs
    assert live.compactions == rec.compactions > 0


# --------------------------------------------------------------------- #
# crash injection
# --------------------------------------------------------------------- #
def test_truncated_wal_recovers_to_durable_prefix(tmp_path):
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=6)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx.insert(more(100, 200))
    idx.delete(np.arange(40))
    idx.durable.sync()
    oracle_rows, oracle_ids = idx.live_rows()
    idx.insert(more(101, 150))            # will be torn mid-record
    idx.durable.close()
    p = wal_path(tmp_path, 0)
    os.truncate(p, p.stat().st_size - 17)
    rec = restore(tmp_path, durable=True, device=CPU)
    want = fullscan_expected(oracle_rows, oracle_ids, rects)
    got = rec.query_batch_split(rects)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    rec.insert(more(102, 50))             # appending resumes at the right seq
    rec.durable.sync()
    records, next_seq, intact = read_wal(p, expect_epoch=0)
    assert next_seq == 3 and intact == p.stat().st_size
    assert restore(tmp_path, device=CPU).n_rows == rec.n_rows
    assert ref_storage.restore(tmp_path).n_rows == rec.n_rows


def test_crash_between_stage_and_rename(tmp_path):
    """A checkpoint staged but never renamed is invisible; recovery uses the
    previous snapshot + the full WAL and sweeps the litter."""
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=6)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx.insert(more(100, 300))
    idx.delete(np.arange(60))
    idx.durable.sync()
    lq, lr = idx.query_batch(rects)
    litter = tmp_path / ".tmp.00c0ffee.epoch_00000000_000000000002"
    litter.mkdir()
    (litter / "arrays.npz").write_bytes(b"half-written")
    (litter / "manifest.json").write_text("{}")
    del idx
    rec = restore(tmp_path, durable=True, device=CPU)
    q, r = rec.query_batch(rects)
    assert np.array_equal(q, lq) and np.array_equal(r, lr)
    assert not list(tmp_path.glob(".tmp.*"))
    assert read_manifest(latest_snapshot(tmp_path))["wal_seq"] == 0


def test_rotation_crash_window_snapshot_published_wal_not_cut(tmp_path):
    """Killed between the rotation's snapshot rename and the old-WAL delete:
    the newest snapshot wins and the stale WAL is ignored AND cleaned."""
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=6)
    idx = COAXIndex(ds.data, TRIG, device=CPU).attach_durability(tmp_path)
    while idx.compactions == 0:
        idx.insert(more(103, 120))
    idx.durable.sync()
    lq, lr = idx.query_batch(rects)
    assert idx.epoch >= 1
    stale = wal_path(tmp_path, idx.epoch - 1)
    WriteAheadLog(stale, idx.epoch - 1).close()
    del idx
    rec = restore(tmp_path, durable=True, device=CPU)
    q, r = rec.query_batch(rects)
    assert np.array_equal(q, lq) and np.array_equal(r, lr)
    assert not stale.exists()


def test_midreplay_compaction_defers_rotation(tmp_path):
    """Crash between the WAL append of a trigger-tripping op and the
    rotation's disk work: replay re-fires the compaction, the deferred
    rotation leaves a crash-safe pair, a second recovery lands on the
    identical state."""
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=6)
    live = COAXIndex(ds.data, TRIG, device=CPU)
    d = tmp_path / "dur"
    vic = COAXIndex(ds.data, TRIG, device=CPU).attach_durability(d)
    burst = 0
    while True:                            # stop just before the trigger
        rows = more(200 + burst, 120)
        load = vic.delta_rows + vic.tombstone_count + rows.shape[0]
        if load >= max(TRIG.compact_min_delta,
                       int(TRIG.compact_delta_frac * vic.data.shape[0])):
            break
        live.insert(rows)
        vic.insert(rows)
        burst += 1
    assert vic.compactions == 0
    vic.durable.on_compact = lambda index: None   # dies before the disk work
    live.insert(rows)
    vic.insert(rows)
    assert vic.compactions == 1
    vic.durable.sync()
    del vic
    assert wal_path(d, 0).exists() and not wal_path(d, 1).exists()
    rec = restore(d, durable=True, device=CPU)
    _assert_state_equal(live, rec, rects, "midreplay")
    _assert_trackers_equal(live, rec, "midreplay")
    assert not wal_path(d, 0).exists() and wal_path(d, rec.epoch).exists()
    del rec
    rec2 = restore(d, durable=True, device=CPU)
    _assert_state_equal(live, rec2, rects, "midreplay-again")
    _assert_trackers_equal(live, rec2, "midreplay-again")


def test_attach_truncates_recordless_torn_tail(tmp_path):
    ds = make_airline(2000, seed=3)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx.insert(make_airline(40, seed=9).data)
    idx.durable.close()
    p = wal_path(tmp_path, 0)
    os.truncate(p, p.stat().st_size - 11)  # tear the ONLY record
    assert read_wal(p)[1] == 0
    idx2 = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx2.insert(make_airline(30, seed=10).data)
    idx2.durable.sync()
    records, next_seq, intact = read_wal(p, expect_epoch=0)
    assert next_seq == 1 and intact == p.stat().st_size
    assert records[0].rows.shape[0] == 30


def test_attach_refusals(tmp_path):
    """Attaching over live history, under a newer snapshot, or
    re-partitioning a journaled donor is refused."""
    ds = make_airline(2000, seed=3)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx.insert(make_airline(50, seed=9).data)
    idx.durable.sync()
    fresh = COAXIndex(ds.data, NOAUTO, device=CPU)
    with pytest.raises(ValueError, match="journal records"):
        fresh.attach_durability(tmp_path)
    with pytest.raises(ValueError, match="journaled"):
        ShardedCOAX.from_index(idx, 2)
    with pytest.raises(ValueError, match="journaled"):
        BatchQueryExecutor(idx, shards=2, device=CPU)
    idx.durable.checkpoint()
    os.unlink(wal_path(tmp_path, 0))
    with pytest.raises(ValueError, match="newer"):
        fresh.attach_durability(tmp_path)


def test_republish_crash_window_repairable(tmp_path):
    ds = make_airline(2000, seed=3)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    snap = write_snapshot(idx, tmp_path, wal_seq=0)
    backup = tmp_path / f".old.deadbeef.{snap.name}"
    os.rename(snap, backup)
    assert latest_snapshot(tmp_path) is None
    assert atomic.sweep_stale_tmp(tmp_path) == 1
    assert latest_snapshot(tmp_path) is not None
    assert restore(tmp_path, device=CPU).n_rows == idx.n_rows


def test_stale_shard_snapshot_recovers_from_wal(tmp_path):
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=6)
    live = ShardedCOAX(ds.data, NOAUTO, n_shards=3, device=CPU)
    vic = ShardedCOAX(ds.data, NOAUTO, n_shards=3,
                      device=CPU).attach_durability(tmp_path)
    ops = _schedule(ds, more, n_ops=6)
    for op in ops[:3]:
        _apply(live, op)
        _apply(vic, op)
    vic.durable.checkpoint()
    for op in ops[3:]:
        _apply(live, op)
        _apply(vic, op)
    vic.durable.checkpoint()
    vic.durable.sync()
    del vic
    sdir = tmp_path / "shard_01"
    entries = atomic.complete_entries(sdir, "epoch_", "manifest.json")
    assert len(entries) >= 2
    for _, p in entries[1:]:
        shutil.rmtree(p)
    (sdir / ".tmp.0badc0de.epoch_00000000_000000000009").mkdir()
    rec = restore(tmp_path, durable=True, device=CPU)
    _assert_state_equal(live, rec, rects, "stale-shard")
    _assert_trackers_equal(live, rec, "stale-shard")
    assert not list(sdir.glob(".tmp.*"))


# --------------------------------------------------------------------- #
# server + stats surfacing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_server_wave_sync_checkpoint_and_recover(tmp_path, backend):
    name, ds, more = mutable_workloads(4000)[0]
    rects = rects_for(ds.data, n=10)
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    srv = QueryServer(idx, max_batch=4, checkpoint_every=2, backend=backend,
                      device=CPU)
    srv.insert(more(100, 80))
    srv.delete(np.arange(30))
    for r in rects:
        srv.submit(r)
    res = srv.drain()
    s = srv.stats()
    assert s["wal_records"] == 2
    assert s["wal_pending_bytes"] == 0          # synced at wave boundaries
    assert s["checkpoints_written"] >= 1
    assert s["last_snapshot_bytes"] > 0
    assert read_manifest(latest_snapshot(tmp_path))["wal_seq"] == 2
    del srv, idx
    srv2 = QueryServer.recover(tmp_path, max_batch=4, backend=backend,
                               device=CPU)
    assert srv2.executor.index.durable is not None
    for r in rects:
        srv2.submit(r)
    res2 = srv2.drain()
    assert all(np.array_equal(a, b)
               for a, b in zip(res.values(), res2.values()))
    srv2.insert(more(101, 10))
    srv2.close()
    srv2.close()                                 # idempotent
    assert srv2.executor.index.durable.closed
    assert restore(tmp_path, device=CPU).n_rows == srv2.executor.index.n_rows


def test_describe_and_footprint_surface_durability(tmp_path):
    name, ds, more = mutable_workloads(3000)[0]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    base_fp = idx.memory_footprint()
    assert idx.describe()["durability"] is None
    idx.attach_durability(tmp_path)
    idx.insert(more(100, 64))
    d = idx.describe()["durability"]
    assert d["wal_records"] == 1 and d["wal_pending_bytes"] > 0
    assert d["last_snapshot_bytes"] > 0 and d["snapshots"] == 1
    assert idx.memory_footprint() >= base_fp + d["wal_pending_bytes"]
    idx.durable.sync()
    assert idx.describe()["durability"]["wal_pending_bytes"] == 0
    sh = ShardedCOAX(ds.data, NOAUTO, n_shards=2, device=CPU)
    sh.attach_durability(tmp_path / "sharded")
    sh.insert(more(101, 32))
    sd = sh.describe()["durability"]
    assert len(sd["per_shard"]) == 2 and sd["wal_records"] >= 1


def test_restore_readonly_leaves_directory_untouched(tmp_path):
    """durable=False is the cold-start-replica path: no directory mutation,
    and the loaded index does not journal."""
    name, ds, more = mutable_workloads(3000)[0]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU).attach_durability(tmp_path)
    idx.insert(more(100, 100))
    idx.durable.sync()

    def listing():
        return sorted((str(p.relative_to(tmp_path)), p.stat().st_size)
                      for p in tmp_path.rglob("*") if p.is_file())

    before = listing()
    rec = restore(tmp_path, device=CPU)
    assert rec.durable is None
    rec.insert(more(101, 10))
    assert listing() == before


# --------------------------------------------------------------------- #
# property: arbitrary op sequences, crash point mid-sequence
# --------------------------------------------------------------------- #
_PROP_CFG = CoaxConfig(compact_min_delta=150, compact_delta_frac=0.01,
                       drift_min_delta=100)


def _crash_twin(ops, crash_at, d):
    name, ds, more = mutable_workloads(2500)[0]
    rects = rects_for(ds.data, n=4, seed=1)
    live = COAXIndex(ds.data, _PROP_CFG, backend="numpy", device=CPU)
    for op in ops:
        _apply(live, op)
    vic = COAXIndex(ds.data, _PROP_CFG, device=CPU).attach_durability(d)
    for op in ops[:crash_at]:
        _apply(vic, op)
    vic.durable.sync()
    del vic
    rec = restore(d, durable=True, device=CPU)
    for op in ops[crash_at:]:
        _apply(rec, op)
    _assert_state_equal(live, rec, rects, ("prop", crash_at))
    _assert_trackers_equal(live, rec, ("prop", crash_at))


def _draw_ops(kinds, seeds, los, more, ds):
    ops = []
    for kind, seed, lo in zip(kinds, seeds, los):
        if kind == "del":
            ops.append(("delete", np.arange(lo, lo + 40)))
        else:
            rows = more(seed, 60)
            ops.append(("insert", violate_fd(ds, rows)
                        if kind == "ins_bad" else rows))
    return ops


@given(st.data())
@settings(max_examples=10, deadline=None)
def test_recovery_equals_uninterrupted_property(tmp_path_factory, data):
    name, ds, more = mutable_workloads(2500)[0]
    n_ops = data.draw(st.integers(min_value=1, max_value=8), label="n_ops")
    kinds = [data.draw(st.sampled_from(["ins", "ins_bad", "del"]))
             for _ in range(n_ops)]
    seeds = [data.draw(st.integers(min_value=50, max_value=80))
             for _ in range(n_ops)]
    los = [data.draw(st.integers(min_value=0, max_value=2400))
           for _ in range(n_ops)]
    crash_at = data.draw(st.integers(min_value=0, max_value=n_ops))
    _crash_twin(_draw_ops(kinds, seeds, los, more, ds), crash_at,
                tmp_path_factory.mktemp("wal_prop"))


@pytest.mark.parametrize("seed", range(5))
def test_recovery_equals_uninterrupted_seeded(tmp_path, seed):
    """The property's fixed-seed cases, run whether or not hypothesis is
    installed."""
    name, ds, more = mutable_workloads(2500)[0]
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(1, 9))
    ops = _draw_ops(rng.choice(["ins", "ins_bad", "del"], n_ops),
                    rng.integers(50, 80, n_ops), rng.integers(0, 2400, n_ops),
                    more, ds)
    _crash_twin(ops, int(rng.integers(0, n_ops + 1)), tmp_path)


# --------------------------------------------------------------------- #
# Crash inside the background handoff's WAL rotation (§5.4 + §7.5)
# --------------------------------------------------------------------- #
_LSM_DS = make_generic_fd(9_000, 5, ((0, 1), (2, 3)), seed=7)
_LSM_KW = dict(compact_min_delta=300, compact_delta_frac=0.01,
               drift_min_delta=200, compact_check_rows=64, delta_l0_spill=64)
BG = CoaxConfig(**_LSM_KW, background_compact=True)
SYNC = CoaxConfig(**_LSM_KW, background_compact=False)


def _lsm_more(seed, m):
    return make_generic_fd(m, 5, ((0, 1), (2, 3)), seed=seed).data


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("seed", range(20))
def test_crash_mid_handoff_recovers_bit_identical(tmp_path, monkeypatch,
                                                  seed):
    """The primary dies inside ``Durability.handoff_rotate``: the tail is
    re-journaled and fsynced into the new WAL, the new snapshot never
    publishes.  Recovery replays the old pair, re-fires the compaction
    synchronously and lands bit-identical to the port's never-crashed
    SYNC twin.  Deterministic: the window is held open by shadowing
    ``poll_handoff``, every build is joined with ``finish_handoff``, and
    the recovered (background-mode) index is joined after each resumed
    write, so no outcome depends on when the compactor thread finishes.
    Twenty seeded write schedules."""
    idx = COAXIndex(_LSM_DS.data, BG, backend="numpy", device=CPU)
    idx.attach_durability(tmp_path)
    oracle = COAXIndex(_LSM_DS.data.copy(), SYNC, backend="numpy", device=CPU)
    base = 500 + 37 * seed

    def both(op, *args):
        getattr(idx, op)(*args)
        getattr(oracle, op)(*args)

    i = 0
    while idx._handoff_thread is None:          # identical journaled history
        rows = _lsm_more(base + i, 120)
        if i % 3 == 2:
            rows = violate_fd(_LSM_DS, rows)
        both("insert", rows)
        i += 1
        assert i < 60
    idx.poll_handoff = lambda wait=False: False  # hold the window open
    for j in range(3):                          # the tail the handoff owes
        both("insert", _lsm_more(base + 400 + j, 50))
        both("delete", np.arange(j * 11 + seed, j * 11 + seed + 7))
    del idx.poll_handoff

    monkeypatch.setattr(dmod, "write_snapshot",
                        lambda *a, **k: (_ for _ in ()).throw(_Boom()))
    with pytest.raises(_Boom):
        idx.finish_handoff()
    monkeypatch.undo()
    assert wal_path(tmp_path, idx.epoch).exists()   # the new WAL, no snapshot
    assert read_manifest(latest_snapshot(tmp_path))["epoch"] == idx.epoch - 1
    del idx                                     # the crash: memory is gone

    rec = restore(tmp_path, durable=True, device=CPU)
    rects = rects_for(_LSM_DS.data, n=8)
    assert rec.backend == "device"
    _assert_state_equal(oracle, rec, rects, ("recovered", seed))
    assert rec.epoch >= 1                       # replay re-fired the build
    assert rec._write_units == oracle._write_units
    _assert_trackers_equal(oracle, rec, ("recovered", seed))
    for j in range(4):                          # resume: same trigger timing
        rows = _lsm_more(base + 2_000 + j, 120)
        rec.insert(rows)
        rec.finish_handoff()
        oracle.insert(rows)
        assert rec.epoch == oracle.epoch, (seed, j)
        assert rec.trigger_checks == oracle.trigger_checks, (seed, j)
    _assert_state_equal(oracle, rec, rects, ("resumed", seed))
    rec.durable.close()


def test_snapshot_written_during_the_tail_replay(tmp_path, monkeypatch):
    """A tail big enough to trip the trigger again makes the handoff's tail
    replay compact synchronously, and that compaction's rotation writes a
    snapshot from INSIDE ``poll_handoff``: ``state()``'s join is a no-op
    there (the build is already cleared), nothing deadlocks, and both the
    live index and its recovery equal the never-crashed SYNC twin."""
    idx = COAXIndex(_LSM_DS.data, BG, backend="numpy", device=CPU)
    idx.attach_durability(tmp_path)
    oracle = COAXIndex(_LSM_DS.data.copy(), SYNC, backend="numpy", device=CPU)
    i = 0
    while idx._handoff_thread is None:
        rows = _lsm_more(500 + i, 120)
        idx.insert(rows)
        oracle.insert(rows)
        i += 1
        assert i < 60
    idx.poll_handoff = lambda wait=False: False
    for j in range(4):                          # 480 rows: past the trigger
        rows = _lsm_more(1_500 + j, 120)
        idx.insert(rows)
        oracle.insert(rows)
    del idx.poll_handoff
    during = []
    orig = dmod.write_snapshot

    def spy(index, *a, **k):
        during.append(bool(index._in_handoff_replay))
        return orig(index, *a, **k)

    monkeypatch.setattr(dmod, "write_snapshot", spy)
    assert idx.finish_handoff()
    monkeypatch.undo()
    assert during[0] is True and during[-1] is False   # replay's, then the
    assert idx.epoch == oracle.epoch >= 2               # handoff's own
    rects = rects_for(_LSM_DS.data, n=8)
    _assert_state_equal(oracle, idx, rects, "live")
    idx.durable.close()
    rec = restore(tmp_path, durable=True, device=CPU)
    _assert_state_equal(oracle, rec, rects, "recovered")
    _assert_trackers_equal(oracle, rec, "recovered")
    rec.durable.close()
