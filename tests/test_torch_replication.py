"""The replication plane (DESIGN.md §8) and its failure utilities: the port
against the JAX package's ``repro`` on the CPU, twins of
``test_replication.py`` and of the failure tests of ``test_runtime.py``.

Every scenario runs twice, once through ``repro`` (replicas on its numpy
backend) and once through ``repro_torch``, with the same seeded data, the
same op schedule and the same ``FaultPlan`` schedule.  The port's replicas
run on ``backend="numpy"`` and on ``backend="device", device="cpu"`` (the
plain ``fused_scan``).  The bar is equality: every byte each hub pushed
onto the wire (heartbeats compared by frontier, since they carry the wall
clock), the WAL bytes on disk, every hub, replica, transport and plan
counter, frontiers, acknowledgements, ``live_rows`` and the
``query_batch_split`` hits of every replica and primary.  No test waits on
a sleep.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.replication as R
import repro.runtime.failure as RF
from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefConfig
from repro.engine import QueryServer as RefServer
from repro.storage import WriteAheadLog as RefWAL
from repro_torch.core import COAXIndex, CoaxConfig
from repro_torch.engine import QueryServer, ShardedCOAX
from repro_torch.replication import (F_HEARTBEAT, FaultyTransport, Frame,
                                     FrameError, InProcTransport,
                                     ReplicatedServer, ReplicationError,
                                     TransportError, decode_frame,
                                     encode_frame, frame_nbytes,
                                     heartbeat_frame, rotate_frame,
                                     seed_state, unpack_heartbeat,
                                     unpack_rotate, unpack_write, write_frame)
from repro_torch.runtime.failure import (FailureInjector, FaultPlan,
                                         GracefulShutdown, StragglerDetector,
                                         retry)
from repro_torch.storage import (WalFrameCursor, WriteAheadLog, read_wal,
                                 restore, wal_path)
from repro_torch.storage import durability as dmod
from repro_torch.storage.wal import _FILE_HDR, _REC_HDR, OP_INSERT

from _hypothesis_compat import given, settings, st
from workloads import fullscan_expected, mutable_workloads, rects_for, violate_fd

CPU = "cpu"
_TRIG = dict(compact_min_delta=300, compact_delta_frac=0.01,
             drift_min_delta=200)
TRIG, REF_TRIG = CoaxConfig(**_TRIG), RefConfig(**_TRIG)
NOAUTO, REF_NOAUTO = CoaxConfig(auto_compact=False), RefConfig(auto_compact=False)

WORKLOADS = {name: (ds, more) for name, ds, more in mutable_workloads(2_500)}

# the reference suite's fault schedules (tests/test_replication.py)
WIRE = {
    "ship.replica-0": {1: "drop", 3: "tear", 5: "dup", 8: "reorder",
                       11: ("tear", 7)},
    "ship.replica-1": {2: ("delay", 2), 4: ("error", 2), 7: "drop",
                       10: "dup"},
}
REPLICA_CRASH = {
    "replica-0.apply": {4: "crash"},
    "ship.replica-1": {3: "tear", 6: "drop"},
}
KILL_ROTATE = {"primary.rotate": {0: "crash"},
               "ship.replica-0": {2: "tear"}}
SCHEDULES = {"clean": {}, "wire": WIRE, "replica_crash": REPLICA_CRASH}


@pytest.fixture(params=["numpy", "device"])
def backend(request):
    """The port's replica backend; ``device`` runs the plain ``fused_scan``
    on the CPU."""
    return request.param


def _ops(name, n=12, batch=90):
    """``test_replication.py``'s op stream: insert bursts (every 4th
    FD-violating) interleaved with deletes of known original ids."""
    ds, more = WORKLOADS[name]
    ops = []
    for i in range(n):
        rows = more(50 + i, batch)
        if i % 4 == 3:
            rows = violate_fd(ds, rows)
        ops.append(("insert", rows))
        if i % 3 == 2:
            ops.append(("delete", np.arange(i * 41, i * 41 + 30)))
    return ops


def _apply(target, op):
    return (target.insert if op[0] == "insert" else target.delete)(op[1])


class _Recording:
    """Wraps an ``InProcTransport`` of either package and keeps every
    ``(dest, bytes)`` pushed through it: what the wire carried after the
    ``FaultyTransport`` did its damage."""

    def __init__(self, inner):
        self.inner = inner
        self.sent = []

    def send(self, dest, data):
        self.sent.append((dest, bytes(data)))
        self.inner.send(dest, data)

    def recv(self, dest, max_messages=None):
        return self.inner.recv(dest, max_messages)

    def pending(self, dest):
        return self.inner.pending(dest)


def _wire(sent):
    """The recorded stream with each whole heartbeat replaced by its kind
    and frontier (its payload is the sender's wall clock); torn heartbeats
    keep their bytes, which end before the clock."""
    out = []
    for dest, data in sent:
        try:
            f = decode_frame(data)
        except FrameError:
            out.append((dest, data))
            continue
        out.append((dest, ("hb", f.epoch, f.seq) if f.kind == F_HEARTBEAT
                    else data))
    return out


class _Pair:
    """The same replicated deployment in both packages: a primary, N
    replicas, one ``FaultPlan`` schedule each, recording transports."""

    def __init__(self, tmp_path, data, cfg, ref_cfg, schedule, backend,
                 n_replicas=2, **kw):
        self.ref_wire = _Recording(R.InProcTransport())
        self.wire = _Recording(InProcTransport())
        self.ref_plan = (RF.FaultPlan({k: dict(v) for k, v in schedule.items()})
                         if schedule is not None else None)
        self.plan = (FaultPlan({k: dict(v) for k, v in schedule.items()})
                     if schedule is not None else None)
        self.ref = R.ReplicatedServer(
            RefIndex(data.copy(), ref_cfg), tmp_path / "ref", n_replicas,
            plan=self.ref_plan, transport=self.ref_wire, **kw)
        self.srv = ReplicatedServer(
            COAXIndex(data.copy(), cfg, backend=backend, device=CPU),
            tmp_path / "port", n_replicas, plan=self.plan,
            transport=self.wire, replica_backend=backend, device=CPU, **kw)

    def both(self, fn):
        """``fn(server)`` on both; the same outcome, raised or returned."""
        outs = []
        for s in (self.ref, self.srv):
            try:
                outs.append(("ok", fn(s)))
            except RuntimeError as e:
                outs.append(("raised", type(e).__name__))
        if outs[0][0] == "ok" and outs[1][0] == "ok":
            a, b = outs[0][1], outs[1][1]
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
        else:
            assert outs[0] == outs[1], outs
        return outs[1][0] == "ok"


def _stats(srv):
    s = srv.stats()
    s["primary_dir"] = os.path.basename(s["primary_dir"])
    for r in s["replicas"]:
        assert r.pop("heartbeat_age") < 60.0
    return s


def _same_index(a, b, rects, tag):
    ra, ia = a.live_rows()
    rb, ib = b.live_rows()
    assert np.array_equal(ra, rb) and np.array_equal(ia, ib), (tag, "rows")
    assert (a.epoch, a.compactions, a._next_id) == \
        (b.epoch, b.compactions, b._next_id), (tag, "epoch")
    ha, hb = a.query_batch_split(rects), b.query_batch_split(rects)
    assert len(ha) == len(hb) == len(rects)
    for i, (x, y) in enumerate(zip(ha, hb)):
        assert y.dtype == np.int64 and np.array_equal(x, y), (tag, i)


def _wal_bytes(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("wal_*.log"))}


def _assert_twins(p, rects, tag):
    """Every observable of the two deployments equal."""
    assert _stats(p.ref) == _stats(p.srv), tag
    assert _wire(p.ref_wire.sent) == _wire(p.wire.sent), (tag, "wire")
    if p.plan is not None:
        assert p.ref_plan.log == p.plan.log, (tag, "plan log")
        assert p.ref_plan.counters == p.plan.counters, (tag, "plan events")
    assert p.ref.acked == p.srv.acked and \
        p.ref.hub.frontier == p.srv.hub.frontier, tag
    assert p.ref.hub.rotations == p.srv.hub.rotations, tag
    if p.ref.primary_alive:
        assert _wal_bytes(p.ref.primary_dir) == _wal_bytes(p.srv.primary_dir)
    _same_index(p.ref.primary, p.srv.primary, rects, (tag, "primary"))
    for rr, rp in zip(p.ref.replicas, p.srv.replicas):
        assert rr.name == rp.name and rr.frontier == rp.frontier, tag
        assert sorted(rr._future) == sorted(rp._future), (tag, rr.name)
        _same_index(rr.index, rp.index, rects, (tag, rr.name))


def _settle(srv, limit=8):
    for _ in range(limit):
        srv.tick()
        if all(not r.alive or r.frontier == srv.hub.frontier
               for r in srv.replicas):
            return
    raise AssertionError("replicas failed to converge: "
                         + str([r.describe() for r in srv.replicas]))


# ---------------------------------------------------------------------- #
# Convergence matrix: wire damage + replica crashes, no promotion
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_replicas_bit_identical_under_faults(tmp_path, workload, schedule,
                                             backend):
    ds, _ = WORKLOADS[workload]
    p = _Pair(tmp_path, ds.data, TRIG, REF_TRIG, SCHEDULES[schedule], backend)
    oracle = COAXIndex(ds.data.copy(), TRIG, backend="numpy", device=CPU)
    rects = rects_for(ds.data, n=10, seed=2)
    for i, op in enumerate(_ops(workload)):
        assert p.both(lambda s: _apply(s, op))
        _apply(oracle, op)
        if i % 2 == 1:
            assert p.both(lambda s: s.tick())
    assert p.both(lambda s: s.compact())          # ships F_ROTATE
    oracle.compact()
    _assert_twins(p, rects, (workload, schedule, "before revive"))
    dead = [r for r in p.srv.replicas if not r.alive]
    for s in (p.ref, p.srv):
        for r in s.replicas:
            if not r.alive:
                r.revive()
    _settle(p.ref)
    _settle(p.srv)
    _assert_twins(p, rects, (workload, schedule))

    srv = p.srv
    assert srv.primary.epoch == oracle.epoch >= 1
    for rep in srv.replicas:
        assert rep.frontier == srv.hub.frontier
        assert rep.lag_frames() == 0 and rep.lag_bytes() == 0
        _same_index(rep.index, oracle, rects, (workload, rep.name))
        if backend == "device":           # the replica's reads were waves
            assert rep.index.device_stats()["dispatches"] >= 2
    assert len(p.wire.sent) > 20
    if schedule == "wire":
        t = srv.transport
        assert t.tears >= 2 and t.drops >= 2 and t.dups >= 2
        assert sum(r.frames_corrupt for r in srv.replicas) >= 2
        assert srv.hub.send_retries >= 1
    if schedule == "replica_crash":
        assert sum(r.crashes for r in dead) == 1


# ---------------------------------------------------------------------- #
# Failover matrix: primary kills, incl. mid-compaction-rotation
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("kill", ["midstream", "mid_rotation_auto",
                                  "mid_rotation_manual"])
def test_failover_no_data_loss(tmp_path, workload, kill, backend):
    ds, more = WORKLOADS[workload]
    auto = kill == "mid_rotation_auto"
    cfg, ref_cfg = (TRIG, REF_TRIG) if auto else (NOAUTO, REF_NOAUTO)
    sched = (dict(KILL_ROTATE) if kill != "midstream"
             else {"ship.replica-0": {2: "tear"}})
    p = _Pair(tmp_path, ds.data, cfg, ref_cfg, sched, backend)
    rects = rects_for(ds.data, n=10, seed=2)
    ops = _ops(workload)
    survived = []
    died = False
    for i, op in enumerate(ops):
        if not p.both(lambda s: _apply(s, op)):
            died = True                   # the injected rotation crash
            break
        survived.append(op)
        if i % 3 == 1:
            assert p.both(lambda s: s.tick())
    if kill == "mid_rotation_manual":
        assert not p.both(lambda s: s.compact())
        died = True
    if auto:
        assert died, "schedule never crossed the compaction trigger"
    acked = p.srv.acked
    assert p.ref.acked == acked

    for s in (p.ref, p.srv):
        s.kill_primary()
    promoted = p.srv.promote()
    ref_promoted = p.ref.promote()
    assert promoted.name == ref_promoted.name
    assert promoted.frontier == ref_promoted.frontier >= acked
    assert p.srv.promotions == 1 and p.srv.primary is promoted.index
    assert promoted.reseeds == ref_promoted.reseeds
    assert promoted.index.backend == backend and promoted.index.device == CPU
    _assert_twins(p, rects, (workload, kill, "promoted"))

    # a never-crashed oracle replayed to the promoted frontier
    oracle = COAXIndex(ds.data.copy(), cfg, backend="numpy", device=CPU)
    for op in survived:
        _apply(oracle, op)
    if died:
        if auto:
            _apply(oracle, ops[len(survived)])
        else:
            oracle.compact()
    assert promoted.index.epoch == oracle.epoch
    _same_index(promoted.index, oracle, rects, (workload, kill))

    # the promoted primary serves writes; survivors re-seed and track it
    rows = more(99, 80)
    assert p.both(lambda s: s.insert(rows))
    _apply(oracle, ("insert", rows))
    _settle(p.ref)
    _settle(p.srv)
    _assert_twins(p, rects, (workload, kill, "after"))
    for rep in p.srv.replicas:
        assert rep.lag_frames() == 0 and rep.reseeds >= 1
        _same_index(rep.index, oracle, rects, (workload, kill, rep.name))


# ---------------------------------------------------------------------- #
# Shipped-frame codec + transport faults
# ---------------------------------------------------------------------- #
def test_frame_codec_rejects_damage():
    frame = write_frame(3, 7, OP_INSERT, b"\x01\x02\x03\x04")
    data = encode_frame(frame)
    assert data == R.encode_frame(R.write_frame(3, 7, OP_INSERT,
                                                b"\x01\x02\x03\x04"))
    back = decode_frame(data)
    assert back == frame and back.key == (3, 7)
    assert frame_nbytes(frame) == len(data)
    assert unpack_write(frame) == (OP_INSERT, b"\x01\x02\x03\x04")
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(FrameError):
            decode_frame(data[:cut])              # torn in transit
    with pytest.raises(FrameError):
        decode_frame(b"XXXX" + data[4:])          # bad magic
    corrupt = bytearray(data)
    corrupt[-1] ^= 0xFF
    with pytest.raises(FrameError):
        decode_frame(bytes(corrupt))              # payload CRC
    with pytest.raises(FrameError):
        decode_frame(data + b"junk")              # trailing garbage


@pytest.mark.parametrize("relearned", [False, True])
def test_control_frames_byte_equal_the_reference(relearned):
    rot = rotate_frame(4, 17, 5, relearned)
    data = encode_frame(rot)
    assert data == R.encode_frame(R.rotate_frame(4, 17, 5, relearned))
    assert unpack_rotate(decode_frame(data)) == (5, relearned)
    hb = heartbeat_frame(2, 9, 1234.5)
    assert encode_frame(hb) == R.encode_frame(R.heartbeat_frame(2, 9, 1234.5))
    assert unpack_heartbeat(decode_frame(encode_frame(hb))) == 1234.5
    assert isinstance(hb, Frame) and hb.key == (2, 9)
    # the reference decodes the port's frames and back
    assert R.decode_frame(data).payload == rot.payload


def test_faulty_transport_actions():
    # m7's successful third attempt consumes event 8, so the tear sits at
    # event 9 and lands on m8
    sched = {"ship.r": {0: "drop", 1: "dup", 2: "reorder", 4: ("delay", 2),
                        7: ("error", 2), 9: "tear"}}
    runs = []
    for fp, ft, fi, te, rt in (
            (FaultPlan, FaultyTransport, InProcTransport, TransportError,
             retry),
            (RF.FaultPlan, R.FaultyTransport, R.InProcTransport,
             R.TransportError, RF.retry)):
        plan = fp({k: dict(v) for k, v in sched.items()})
        t = ft(fi(), plan)
        sent = [f"m{i}".encode() for i in range(10)]
        got = []
        for i in range(10):
            rt(lambda: t.send("r", sent[i]), retries=3, backoff=0.0,
               retryable=(te,))
            got.extend(t.recv("r"))
        runs.append((got, t.counts(), plan.counts(), plan.log, sent))
    (got, counts, plan_counts, log, sent), ref = runs
    assert (got, counts, plan_counts, log) == ref[:4]
    assert sent[0] not in got
    assert got.count(sent[1]) == 2
    assert got.index(sent[3]) < got.index(sent[2])
    assert got.index(sent[5]) < got.index(sent[4])
    assert sent[7] in got
    assert any(m == sent[8][:len(m)] and len(m) < len(sent[8]) for m in got)
    assert counts == {"drops": 1, "dups": 1, "tears": 1, "reorders": 1,
                      "delays": 1, "errors": 2}
    assert plan_counts == {"drop": 1, "dup": 1, "reorder": 1, "delay": 1,
                           "error": 1, "tear": 1}


def test_flush_held_releases_reordered_and_delayed_frames():
    for fp, ft, fi in ((FaultPlan, FaultyTransport, InProcTransport),
                       (RF.FaultPlan, R.FaultyTransport, R.InProcTransport)):
        t = ft(fi(), fp({"ship.a": {0: "reorder"}, "ship.b": {0: ("delay", 5)}}))
        t.send("a", b"x")
        t.send("b", b"y")
        assert t.pending("a") == 1 and t.pending("b") == 1
        assert t.recv("a") == [] and t.recv("b") == []
        t.flush_held()
        assert t.recv("a") == [b"x"] and t.recv("b") == [b"y"]
        assert t.pending("a") == t.pending("b") == 0


def test_seed_state_does_not_alias_the_primary():
    ds, more = WORKLOADS["generic_fd"]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    ref = RefIndex(ds.data, REF_NOAUTO)
    for target in (idx, ref):
        target.insert(more(1, 60))
    rep = COAXIndex.from_state(seed_state(idx), backend="numpy", device=CPU)
    ref_rep = RefIndex._restore_state(R.seed_state(ref))
    before = rep.live_rows()
    assert all(np.array_equal(a, b)
               for a, b in zip(before, ref_rep.live_rows()))
    idx.insert(more(2, 60))               # must not leak into the copy
    idx.delete(np.arange(40))
    after = rep.live_rows()
    assert np.array_equal(before[0], after[0])
    assert np.array_equal(before[1], after[1])
    assert rep.n_rows != idx.n_rows
    assert not np.shares_memory(seed_state(idx)["data"], idx.state()["data"])


# ---------------------------------------------------------------------- #
# WalFrameCursor: torn tails, resumability
# ---------------------------------------------------------------------- #
def _journal(tmp_path, n_ops=6):
    """A port journal + the records its shipping hook saw, and the
    reference's journal of the same ops + its records."""
    ds, more = WORKLOADS["generic_fd"]
    out = []
    for make, cfg, name in ((COAXIndex, NOAUTO, "j"),
                            (RefIndex, REF_NOAUTO, "ref")):
        idx = (make(ds.data, cfg, device=CPU) if make is COAXIndex
               else make(ds.data, cfg))
        idx.attach_durability(tmp_path / name)
        shipped = []
        idx.durable.frame_observer = \
            lambda e, s, k, p, shipped=shipped: shipped.append((s, k, p))
        for i in range(n_ops):
            if i % 3 == 2:
                idx.delete(np.arange(i * 20, i * 20 + 10))
            else:
                idx.insert(more(10 + i, 40))
        idx.durable.sync()
        out.append((idx, wal_path(tmp_path / name, idx.epoch), shipped))
    return out


def test_frame_cursor_reads_and_resumes(tmp_path):
    (idx, path, shipped), (_, ref_path, ref_shipped) = _journal(tmp_path)
    assert shipped == ref_shipped
    assert path.read_bytes() == ref_path.read_bytes()
    cur = WalFrameCursor(path, expect_epoch=0)
    out = cur.read()
    assert [(s, k, p) for s, k, p in out] == shipped
    assert cur.read() == []               # fully drained
    n0 = len(shipped)                     # the observer keeps appending
    idx.insert(np.zeros((3, idx.n_dims), np.float32))   # live appender
    assert len(shipped) == n0 + 1
    more_frames = cur.read()
    assert len(more_frames) == 1 and more_frames[0][0] == n0
    assert cur.next_seq == n0 + 1
    late = WalFrameCursor(path, expect_epoch=0, start_seq=4)
    assert [s for s, _, _ in late.read()] == list(range(4, n0 + 1))
    # the port's cursor reads the reference's journal the same way
    assert [(s, k, p) for s, k, p in
            WalFrameCursor(ref_path, expect_epoch=0).read()] == ref_shipped


def test_frame_cursor_pauses_on_torn_tail(tmp_path):
    (_, path, shipped), _ = _journal(tmp_path)
    blob = path.read_bytes()
    torn = tmp_path / "torn.log"
    torn.write_bytes(blob[:-11])          # last record torn mid-payload
    cur = WalFrameCursor(torn, expect_epoch=0)
    out = cur.read()
    assert [s for s, _, _ in out] == list(range(len(shipped) - 1))
    assert cur.read() == []               # parked at the torn record
    torn.write_bytes(blob)                # ... the bytes were in flight
    assert [s for s, _, _ in cur.read()] == [len(shipped) - 1]
    bad = bytearray(blob)
    bad[-3] ^= 0xFF
    forever = tmp_path / "bad.log"
    forever.write_bytes(bytes(bad))
    cur2 = WalFrameCursor(forever, expect_epoch=0)
    assert [s for s, _, _ in cur2.read()] == list(range(len(shipped) - 1))
    assert cur2.read() == []


def test_frame_cursor_header_cases(tmp_path):
    assert WalFrameCursor(tmp_path / "nope.log").read() == []
    stub = tmp_path / "stub.log"
    stub.write_bytes(b"CW")               # header still in flight
    assert WalFrameCursor(stub).read() == []
    WriteAheadLog(tmp_path / "w.log", epoch=5).close()
    RefWAL(tmp_path / "r.log", epoch=5).close()
    assert (tmp_path / "w.log").read_bytes() == (tmp_path / "r.log").read_bytes()
    with pytest.raises(ValueError):
        WalFrameCursor(tmp_path / "w.log", expect_epoch=3).read()


def test_replayed_and_handoff_tail_records_are_not_shipped(tmp_path):
    """Records a restore replays are never shipped, and neither is the
    background handoff's re-journaled tail; live appends are."""
    ds, more = WORKLOADS["generic_fd"]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    idx.attach_durability(tmp_path / "d")
    for i in range(3):
        idx.insert(more(30 + i, 20))
    idx.durable.sync()
    rec = restore(tmp_path / "d", backend="numpy", durable=True, device=CPU)
    shipped = []
    rec.durable.frame_observer = lambda e, s, k, p: shipped.append(s)
    rec.insert(more(40, 20))
    assert shipped == [3]
    dur = rec.durable
    dur._suppress_ship = True
    rec.insert(more(41, 20))
    dur._suppress_ship = False
    dur._replaying = True
    dur._frame_appended(0, 9, OP_INSERT, b"")
    dur._replaying = False
    assert shipped == [3] and dur.wal.next_seq == 5


# ---------------------------------------------------------------------- #
# Prefix closure: ANY frame-aligned WAL prefix is a valid state
# ---------------------------------------------------------------------- #
_PREFIX_CACHE = {}


def _prefix_fixture():
    if "j" not in _PREFIX_CACHE:
        import tempfile
        from pathlib import Path
        root = Path(tempfile.mkdtemp(prefix="coax_torch_prefix_"))
        ds, _ = WORKLOADS["airline"]
        idx = COAXIndex(ds.data, NOAUTO, device=CPU)
        idx.attach_durability(root / "j")
        ops = _ops("airline", n=8, batch=60)
        for op in ops:
            _apply(idx, op)
        idx.durable.sync()
        path = wal_path(root / "j", 0)
        blob = path.read_bytes()
        records, n, intact = read_wal(path, expect_epoch=0)
        assert intact == len(blob) and n == len(ops)
        bounds = [_FILE_HDR.size]
        off = _FILE_HDR.size
        for _ in records:
            _, _, _, plen, _ = _REC_HDR.unpack_from(blob, off)
            off += _REC_HDR.size + plen
            bounds.append(off)
        rects = rects_for(ds.data, n=8, seed=4)
        _PREFIX_CACHE["j"] = (root, ds, ops, bounds, rects)
    return _PREFIX_CACHE["j"]


def _check_prefix(k):
    root, ds, ops, bounds, rects = _prefix_fixture()
    prefix_dir = root / f"prefix_{k}"
    if not (prefix_dir / "wal_00000000.log").exists():
        import shutil
        shutil.copytree(root / "j", prefix_dir)
        os.truncate(prefix_dir / "wal_00000000.log", bounds[k])
    rec = restore(prefix_dir, backend="numpy", device=CPU)
    oracle = RefIndex(ds.data, REF_NOAUTO)
    for op in ops[:k]:
        _apply(oracle, op)
    rows, ids = rec.live_rows()
    orows, oids = oracle.live_rows()
    assert np.array_equal(rows, orows) and np.array_equal(ids, oids)
    want = fullscan_expected(rows, ids, rects)
    got = rec.query_batch_split(rects)
    for i in range(len(rects)):
        assert np.array_equal(got[i], want[i])
    assert rec._next_id == oracle._next_id


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_wal_prefix_closure(data):
    """Restoring any frame-aligned prefix of the port's journal gives the
    reference's state after that many ops."""
    _, _, ops, _, _ = _prefix_fixture()
    _check_prefix(data.draw(st.integers(min_value=0, max_value=len(ops)),
                            label="k"))


def test_wal_prefix_closure_exhaustive():
    _, _, ops, bounds, _ = _prefix_fixture()
    assert len(bounds) == len(ops) + 1
    for k in range(len(ops) + 1):
        _check_prefix(k)


# ---------------------------------------------------------------------- #
# Idempotent close + fsync-on-close
# ---------------------------------------------------------------------- #
def test_durability_close_is_idempotent(tmp_path):
    ds, more = WORKLOADS["generic_fd"]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    idx.attach_durability(tmp_path / "d")
    idx.insert(more(3, 50))
    dur = idx.durable
    assert dur.wal.pending_bytes > 0 and not dur.closed
    dur.close()
    assert dur.closed and dur.wal.pending_bytes == 0
    dur.close()
    dur.sync()
    assert dur.wal.nbytes() == (tmp_path / "d" /
                                dur.wal.path.name).stat().st_size
    rec = restore(tmp_path / "d", backend="numpy", device=CPU)
    assert rec.n_rows == idx.n_rows


def test_close_after_failed_rotation(tmp_path, monkeypatch):
    ds, more = WORKLOADS["generic_fd"]
    idx = COAXIndex(ds.data, NOAUTO, device=CPU)
    idx.attach_durability(tmp_path / "d")
    idx.insert(more(3, 50))

    def boom(*a, **k):
        raise OSError("disk full mid-rotation")
    monkeypatch.setattr(dmod, "write_snapshot", boom)
    with pytest.raises(OSError):
        idx.compact()
    monkeypatch.undo()
    dur = idx.durable
    dur.close()
    dur.close()
    assert dur.closed
    rec = restore(tmp_path / "d", backend="numpy", durable=True, device=CPU)
    assert rec.n_rows == idx.n_rows


def test_sharded_close_idempotent(tmp_path):
    ds, more = WORKLOADS["generic_fd"]
    sh = ShardedCOAX(ds.data, n_shards=2, config=NOAUTO, device=CPU)
    sh.attach_durability(tmp_path / "s")
    sh.insert(more(5, 40))
    sh.durable.close()
    assert sh.durable.closed
    sh.durable.close()
    sh.durable.sync()


def test_wal_close_guards(tmp_path):
    wal = WriteAheadLog(tmp_path / "w.log", epoch=0)
    wal.append_delete(np.arange(4))
    wal.close()
    assert wal.closed
    wal.close()
    wal.pending_bytes = 99                # the failed-rotation zombie state
    wal.sync()
    assert wal.nbytes() == (tmp_path / "w.log").stat().st_size


# ---------------------------------------------------------------------- #
# Graceful shutdown wiring
# ---------------------------------------------------------------------- #
def test_query_server_graceful_shutdown(tmp_path, backend):
    ds, more = WORKLOADS["airline"]
    rects = rects_for(ds.data, n=12, seed=1)
    runs = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            idx = RefIndex(ds.data, REF_NOAUTO)
            shut, make = RF.GracefulShutdown, RefServer
            kw = {}
        else:
            idx = COAXIndex(ds.data, NOAUTO, backend=backend, device=CPU)
            shut, make = GracefulShutdown, QueryServer
            kw = dict(device=CPU)
        idx.attach_durability(tmp_path / pkg)
        with shut(signals=(signal.SIGTERM,)) as stop:
            srv = make(idx, max_batch=4, shutdown=stop, **kw)
            for r in rects:
                srv.submit(r)
            srv.insert(more(7, 50))
            first = srv.drain(max_waves=1)
            assert len(first) == 4 and not srv.shutdown_requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert srv.shutdown_requested
            srv.insert(more(8, 30))
            assert srv.drain() == {}
            assert len(srv) == len(rects) - 4
            srv.close()
        assert srv.closed and len(srv._write_queue) == 0
        assert idx.durable.closed and idx.durable.wal_pending_bytes == 0
        srv.close()
        st_ = srv.stats()
        assert st_["shutdown_requested"] and st_["closed"]
        runs.append((first, idx.n_rows,
                     _wal_bytes(tmp_path / pkg)))
    (ref_first, ref_rows, ref_wal), (first, rows, wal) = runs
    assert sorted(first) == sorted(ref_first)
    for q in first:
        assert np.array_equal(first[q], ref_first[q])
    assert rows == ref_rows and wal == ref_wal
    rec = restore(tmp_path / "port", backend="numpy", device=CPU)
    assert rec.n_rows == rows


# ---------------------------------------------------------------------- #
# Observability
# ---------------------------------------------------------------------- #
def test_replication_stats_surface(tmp_path, backend):
    ds, more = WORKLOADS["generic_fd"]
    sched = {"ship.replica-0": {1: "drop", 3: "dup", 5: "tear"},
             "ship.replica-1": {2: ("error", 1)}}
    p = _Pair(tmp_path, ds.data, NOAUTO, REF_NOAUTO, sched, backend)
    for i in range(6):
        rows = more(20 + i, 40)
        assert p.both(lambda s: s.insert(rows))
        for s in (p.ref, p.srv):
            for rep in s.replicas:        # pump without heartbeats so the
                rep.pump()                # plan's event indices stay on the
                                          # write frames alone
    rects = rects_for(ds.data, n=4, seed=0)
    for _ in range(3):
        for s in (p.ref, p.srv):
            s.query_batch_split(rects)
    _assert_twins(p, rects, "stats")
    s = p.srv.stats()
    assert s["frontier"] == {"epoch": 0, "seq": 6}
    assert s["acked"] == {"epoch": 0, "seq": 6}
    assert s["ship"]["shipped_frames"] == 6
    assert s["ship"]["shipped_bytes"] > 0
    assert s["ship"]["send_retries"] >= 1
    assert s["transport_faults"]["drops"] == 1
    assert s["transport_faults"]["dups"] == 1
    assert s["transport_faults"]["tears"] == 1
    assert s["fault_plan"] == {"drop": 1, "dup": 1, "tear": 1, "error": 1}
    assert s["reads"]["replica"] == 3 and s["reads"]["degraded"] == 0
    for r in s["replicas"]:
        assert r["alive"] and r["lag_frames"] == 0 and r["lag_bytes"] == 0
        assert (r["epoch"], r["next_seq"]) == (0, 6)
        assert r["heartbeat_age"] < 5.0
        assert r["frames_applied"] >= 6
    r0 = next(r for r in s["replicas"] if r["name"] == "replica-0")
    assert r0["frames_corrupt"] == 1
    assert r0["frames_duplicate"] >= 1
    assert r0["catchup_fetches"] >= 1
    for srv in (p.ref, p.srv):
        for rep in srv.replicas:
            rep.alive = False
        srv.query_batch_split(rects)
    assert _stats(p.ref) == _stats(p.srv)
    s2 = p.srv.stats()
    assert s2["reads"]["degraded"] == 1 and s2["reads"]["primary"] == 1


def test_promotion_requires_live_replica(tmp_path, backend):
    ds, _ = WORKLOADS["generic_fd"]
    idx = COAXIndex(ds.data, NOAUTO, backend=backend, device=CPU)
    srv = ReplicatedServer(idx, tmp_path, n_replicas=1,
                           replica_backend=backend, device=CPU)
    srv.replicas[0].alive = False
    srv.kill_primary()
    with pytest.raises(ReplicationError):
        srv.promote()
    with pytest.raises(ReplicationError):
        srv.insert(np.zeros((1, ds.data.shape[1]), np.float32))
    with pytest.raises(ReplicationError):
        srv.query_batch_split(rects_for(ds.data, n=2, seed=0))


def test_replica_reseed_frees_its_old_device_plan(tmp_path):
    """A re-bootstrapping replica drops the cycle between its old index and
    that index's device plan, so the plan goes with the index."""
    import weakref
    ds, more = WORKLOADS["generic_fd"]
    srv = ReplicatedServer(COAXIndex(ds.data, NOAUTO, device=CPU), tmp_path,
                           n_replicas=1, device=CPU)
    rep = srv.replicas[0]
    rects = rects_for(ds.data, n=4, seed=0)
    rep.index.query_batch_split(rects)
    old_plan = weakref.ref(rep.index._coax_plan)
    old_index = weakref.ref(rep.index)
    assert old_plan() is not None
    rep.reseed()
    assert old_plan() is None and old_index() is None
    assert rep.reseeds == 1 and rep.index.device == CPU
    srv.insert(more(3, 20))
    _settle(srv)
    _same_index(rep.index, srv.primary, rects, "reseeded")


# ---------------------------------------------------------------------- #
# Failure utilities (twins of tests/test_runtime.py)
# ---------------------------------------------------------------------- #
def test_retry_recovers():
    seen = []
    for fn in (retry, RF.retry):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("boom")
            return "ok"

        errs = []
        assert fn(flaky, retries=5, backoff=0.0,
                  on_error=lambda a, e: errs.append(a)) == "ok"
        seen.append((calls["n"], errs))
    assert seen[0] == seen[1] == (3, [1, 2])


def test_retry_exhausts():
    for fn in (retry, RF.retry):
        calls = []

        def always():
            calls.append(1)
            raise RuntimeError("x")
        with pytest.raises(RuntimeError):
            fn(always, retries=1, backoff=0.0)
        assert len(calls) == 2
        with pytest.raises(KeyError):     # not retryable: raised at once
            fn(lambda: {}["k"], retries=3, backoff=0.0)


def test_straggler_detector_flags_slow_step():
    out = []
    for cls in (StragglerDetector, RF.StragglerDetector):
        det = cls(warmup=5, z_thresh=3.0, trip_count=2)
        for s in range(20):
            det.record(s, 0.1 + 0.001 * (s % 3))
        rep = det.record(20, 5.0)
        assert rep is not None and rep.z > 3
        assert not det.hot
        det.record(21, 5.0)
        assert det.hot
        out.append(([(f.step, f.duration, f.mean, f.std, f.z)
                     for f in det.flags], det.mean, det.var, det.n))
    assert out[0] == out[1]


def test_graceful_shutdown_flag():
    for cls in (GracefulShutdown, RF.GracefulShutdown):
        prev = signal.getsignal(signal.SIGTERM)
        with cls() as g:
            assert not g.requested
            g.request()
            assert g.requested
        assert signal.getsignal(signal.SIGTERM) == prev


def test_fault_plan_and_injector_equal_the_reference():
    sched = {"a": {0: "crash", 2: ("tear", 3)}, "b": {1: "drop"}}
    logs = []
    for fp, fi in ((FaultPlan, FailureInjector),
                   (RF.FaultPlan, RF.FailureInjector)):
        plan = fp({k: dict(v) for k, v in sched.items()})
        with pytest.raises(RuntimeError, match="injected crash on a"):
            plan.crash_if("a")
        acts = [plan.action(c) for c in ("a", "b", "b", "a", "c")]
        inj = fi(fail_at_steps=(2,))
        inj.maybe_fail(1)
        with pytest.raises(RuntimeError):
            inj.maybe_fail(2)
        inj.maybe_fail(2)                 # fires once
        logs.append((acts, plan.log, plan.counts(), plan.counters,
                     sorted(plan.fired, key=str), sorted(inj.fired)))
    assert logs[0] == logs[1]
