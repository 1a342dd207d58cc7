"""Background compaction and its epoch handoff (DESIGN.md §5.4): the port
against the JAX package's ``repro`` on the CPU, twins of ``test_lsm.py``.

The same op schedule runs through ``repro`` and ``repro_torch`` (on
``device="cpu"``) with the same configs and ``make_generic_fd`` data.
The handoff window is held open deterministically, as the reference's own
tests hold it: ``poll_handoff`` is shadowed by a no-op, so a finished
build cannot install and the old epoch ∪ its delta must keep serving;
``finish_handoff`` closes it.  No test waits on a sleep.  At every step
the epochs, ``compactions``, ``trigger_checks``, ``_write_units`` and the
``(query_id, row_id)`` hits are bit-identical to the reference's.

Durability (the handoff's WAL rotation and the crash twin) and the sharded
twin wait for the slices that port those planes.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefConfig
from repro.data import make_generic_fd
from repro_torch.core import COAXIndex, CoaxConfig
from repro_torch.engine import QueryServer, split_hits

from _hypothesis_compat import given, settings, st
from workloads import fullscan_expected, rects_for, violate_fd

_DS = make_generic_fd(9_000, 5, ((0, 1), (2, 3)), seed=7)

# triggers low enough that short schedules cross them; checks amortized
# (the reference's BG / SYNC, tests/test_lsm.py)
_KW = dict(compact_min_delta=300, compact_delta_frac=0.01,
           drift_min_delta=200, compact_check_rows=64, delta_l0_spill=64)
BG = CoaxConfig(**_KW, background_compact=True)
SYNC = CoaxConfig(**_KW, background_compact=False)
REF_BG = RefConfig(**_KW, background_compact=True)
REF_SYNC = RefConfig(**_KW, background_compact=False)


def _more(seed, m):
    return make_generic_fd(m, 5, ((0, 1), (2, 3)), seed=seed).data


def _hold_window_open(idx):
    """Freeze the handoff window: shadow ``poll_handoff`` with a no-op so
    the finished build cannot install (the reference tests' device)."""
    idx.poll_handoff = lambda wait=False: False


def _release_window(idx):
    del idx.poll_handoff               # uncover the real method


def _counters(idx):
    return (idx.epoch, idx.compactions, idx.trigger_checks,
            idx._write_units, idx.background_compactions)


def _same(port, ref, rects, tag):
    """Counters and batched hits bit-identical to the reference's."""
    assert _counters(port) == _counters(ref), tag
    q, r = port.query_batch(rects)
    q_r, r_r = ref.query_batch(rects)
    assert np.array_equal(q, q_r) and np.array_equal(r, r_r), tag


def _exact_scalar(idx, rects, tag):
    """Scalar answers equal a full scan of the index's own live rows."""
    rows, ids = idx.live_rows()
    for i, (rect, want) in enumerate(zip(rects,
                                         fullscan_expected(rows, ids, rects))):
        assert np.array_equal(idx.query(rect), want), (tag, i)


def _write_until_build_starts(pair, rects, seed0=500, batch=120):
    """The same inserts into every index of ``pair`` until one starts a
    background build; all start it on the same op, and the window is
    held open on all before anything can poll."""
    i = 0
    while True:
        rows = _more(seed0 + i, batch)
        if i % 3 == 2:
            rows = violate_fd(_DS, rows)
        for idx in pair:
            idx.insert(rows)
        started = [idx._handoff_thread is not None for idx in pair]
        if any(started):
            assert all(started), "the twins started their builds apart"
            for idx in pair:
                _hold_window_open(idx)
            return
        _same(*pair, rects, ("before", i))
        i += 1
        assert i < 60, "background build never triggered"


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_queries_exact_during_background_build(backend):
    ref = RefIndex(_DS.data, REF_BG)
    port = COAXIndex(_DS.data, BG, backend=backend, device="cpu")
    rects = rects_for(_DS.data, n=8)
    _write_until_build_starts((port, ref), rects)
    assert port.epoch == 0 and port.describe()["background"]["in_flight"]
    _same(port, ref, rects, "window opened")
    for j in range(4):                 # writes + queries inside the window
        for idx in (port, ref):
            idx.insert(_more(900 + j, 50))
            idx.delete(np.arange(j * 11, j * 11 + 7))
        _same(port, ref, rects, ("window", j))
        _exact_scalar(port, rects[:4], ("window", j))
    assert port.epoch == 0, "held-open window must keep serving the old epoch"
    assert len(port._handoff_ops) == len(ref._handoff_ops) == 8
    for idx in (port, ref):
        _release_window(idx)
        assert idx.finish_handoff()
    assert port.epoch >= 1 and port.background_compactions == 1
    assert port.compactions == port.epoch
    d = port.describe()
    assert d["background"] == {"enabled": True, "in_flight": False,
                               "completed": 1,
                               "last_handoff_s": port.last_handoff_s}
    assert port.last_handoff_s > 0
    assert port.backend == backend
    _same(port, ref, rects, "after handoff")
    _exact_scalar(port, rects, "after handoff")


def _interleaved_twin(seed0, ops, backend):
    """Any short interleaving of inserts and deletes inside a held-open
    window answers bit-identically to the reference at every step, and
    still does after the handoff installs."""
    ref = RefIndex(_DS.data[:4_000], REF_BG)
    port = COAXIndex(_DS.data[:4_000], BG, backend=backend, device="cpu")
    rects = rects_for(_DS.data[:4_000], n=5, extremes=False)
    _write_until_build_starts((port, ref), rects, seed0=seed0)
    for j, (kind, a, b) in enumerate(ops):
        for idx in (port, ref):
            if kind == "del":
                idx.delete(np.arange(a, a + 40))
            else:
                rows = _more(a, b)
                idx.insert(violate_fd(_DS, rows) if kind == "ins_viol"
                           else rows)
        _same(port, ref, rects, ("window", j))
    for idx in (port, ref):
        _release_window(idx)
        idx.finish_handoff()
    assert port.epoch >= 1
    _same(port, ref, rects, "after")
    _exact_scalar(port, rects, "after")


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_prop_interleaved_ops_during_handoff(data):
    seed0 = data.draw(st.integers(min_value=0, max_value=10**4),
                      label="seed0")
    ops = []
    for j in range(data.draw(st.integers(min_value=1, max_value=4),
                             label="n_ops")):
        kind = data.draw(st.sampled_from(["ins", "ins_viol", "del"]),
                         label=f"op{j}")
        if kind == "del":
            ops.append((kind, data.draw(st.integers(0, 3_000),
                                        label=f"del_lo{j}"), 0))
        else:
            ops.append((kind, data.draw(st.integers(0, 10**4),
                                        label=f"seed{j}"),
                        data.draw(st.integers(1, 80), label=f"m{j}")))
    _interleaved_twin(seed0, ops, "numpy")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_interleaved_ops_during_handoff(seed):
    """Seeded draws of the property test above (which skips where
    hypothesis is absent), on the device backend's CPU route."""
    rng = np.random.default_rng(seed)
    ops = []
    for j in range(int(rng.integers(1, 5))):
        kind = ("ins", "ins_viol", "del")[int(rng.integers(3))]
        if kind == "del":
            ops.append((kind, int(rng.integers(0, 3_001)), 0))
        else:
            ops.append((kind, int(rng.integers(0, 10**4 + 1)),
                        int(rng.integers(1, 81))))
    _interleaved_twin(int(rng.integers(0, 10**4 + 1)), ops, "device")


@pytest.mark.parametrize("timing", ["free", "early", "late"])
def test_background_world_converges_with_sync_world(timing):
    """Same op stream, background vs synchronous compaction: however the
    build races the writes, epochs, trigger phase and answers converge once
    the handoff lands — with the port's own sync twin and with the
    reference's sync world.  ``free`` lets the build race the writes;
    ``early`` installs each build before the next op (the shortest tail),
    ``late`` holds the window open to the end (the longest)."""
    bg = COAXIndex(_DS.data, BG, device="cpu")
    sy = COAXIndex(_DS.data.copy(), SYNC, device="cpu")
    ref = RefIndex(_DS.data.copy(), REF_SYNC)
    if timing == "late":
        _hold_window_open(bg)
    for i in range(14):
        rows = _more(500 + i, 120)
        if i % 3 == 2:
            rows = violate_fd(_DS, rows)
        for idx in (bg, sy, ref):
            idx.insert(rows)
        if i % 2 == 1:
            dead = np.arange(i * 13, i * 13 + 9)
            for idx in (bg, sy, ref):
                idx.delete(dead)
        if timing == "early":
            bg.finish_handoff()
    if timing == "late":
        assert bg.epoch == 0 and len(bg._handoff_ops) > 2
        _release_window(bg)
    bg.finish_handoff()
    assert sy.compactions >= 1 and bg.background_compactions >= 1
    for twin in (sy, ref):
        assert (bg.epoch, bg.compactions, bg._write_units,
                bg.trigger_checks) == (twin.epoch, twin.compactions,
                                       twin._write_units, twin.trigger_checks)
    rects = rects_for(_DS.data, n=8)
    for backend in ("numpy", "device"):
        bg.backend = backend
        q, r = bg.query_batch(rects)
        for twin in (sy, ref):
            tq, tr = twin.query_batch(rects)
            assert np.array_equal(q, tq) and np.array_equal(r, tr), backend


def test_build_thread_touches_no_torch():
    """The builder thread runs numpy only: no torch call, so no tensor on
    a device and no CUDA call, while the serving thread answers device
    waves through torch.  The guard is a profile hook on every thread the
    threading module starts; it must see the build (``_fit_state``)."""
    torch_dir = os.path.dirname(torch.__file__)
    seen = []

    def hook(frame, event, arg):
        if threading.current_thread().name != "coax-compactor":
            return
        if event == "call":
            seen.append((frame.f_code.co_filename, frame.f_code.co_name))
        elif event == "c_call":
            owner = getattr(arg, "__self__", None)
            seen.append((getattr(arg, "__module__", None)
                         or type(owner).__module__ or "",
                         getattr(arg, "__qualname__", repr(arg))))

    idx = COAXIndex(_DS.data, BG, device="cpu")
    rects = rects_for(_DS.data, n=4)
    threading.setprofile(hook)
    try:
        i = 0
        while idx._handoff_thread is None:
            idx.insert(_more(500 + i, 120))
            idx.query_batch(rects)            # torch on the serving thread
            i += 1
            assert i < 60, "background build never triggered"
        idx.query_batch(rects)
        idx.finish_handoff()
    finally:
        threading.setprofile(None)
    assert idx.background_compactions == 1
    assert any(name == "_fit_state" for _, name in seen)
    touched = [s for s in seen if s[0].startswith(torch_dir)
               or s[0].split(".")[0] == "torch"]
    assert not touched, touched[:5]


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_executor_installs_a_finished_build_at_the_wave_boundary(backend):
    """The executor's wave-boundary poll installs a finished build on its
    own: with the index's entry polls shadowed, wave 1 is served from the
    old epoch (window held open), the build is joined, and wave 2's
    boundary installs the new epoch before its snapshot.  On the device
    backend wave 1 is still in flight (pipelined) across the install.
    Both waves equal the synchronous world's answers."""
    bg = COAXIndex(_DS.data, BG, backend=backend, device="cpu")
    sy = COAXIndex(_DS.data.copy(), SYNC, device="cpu")
    srv = QueryServer(bg, max_batch=4, device="cpu")
    ex = srv.executor
    i = 0
    while bg._handoff_thread is None:
        rows = _more(500 + i, 120)
        srv.insert(rows)
        srv.flush_writes()
        sy.insert(rows)
        i += 1
        assert i < 60, "background build never triggered"
    assert sy.compactions == 1 and bg.epoch == 0
    rects = rects_for(_DS.data, n=8)
    _hold_window_open(bg)
    first = ex.execute_submit(rects[:4])
    assert (first is None) == (backend == "numpy")
    got = [] if first else ex.execute(rects[:4])
    _release_window(bg)
    bg._poll_entry = lambda: None       # only the executor may install
    bg._handoff_thread.join()           # built, not installed
    assert bg.epoch == 0 and bg.background_compactions == 0
    if first:
        second = ex.execute_submit(rects[4:])
        got = ex.execute_collect(first) + ex.execute_collect(second)
    else:
        got += ex.execute(rects[4:])
    assert bg.background_compactions == 1 and bg.epoch == sy.epoch == 1
    epochs = [w.epoch for w in ex.wave_stats]      # wave 1, then wave 2
    assert epochs[0] == 0 and set(epochs[1:]) == {1}, epochs
    q, r = sy.query_batch(rects)
    want = split_hits(q, r, len(rects))
    assert all(np.array_equal(a, w) for a, w in zip(got, want))
    del bg._poll_entry
    srv.close()
    assert _counters(bg)[:4] == _counters(sy)[:4]


def test_server_close_joins_the_build_and_failures_surface():
    """``QueryServer.close`` installs an in-flight build (the graceful-
    shutdown join); a build that raised surfaces at the next poll."""
    idx = COAXIndex(_DS.data, BG, device="cpu")
    srv = QueryServer(idx, max_batch=8, device="cpu")
    i = 0
    while idx._handoff_thread is None:
        srv.insert(_more(500 + i, 120))
        srv.flush_writes()
        i += 1
        assert i < 60, "background build never triggered"
    srv.close()
    assert idx._handoff_thread is None and idx.background_compactions == 1
    assert srv.stats()["epoch"] == idx.epoch >= 1

    bad = COAXIndex(_DS.data, BG, device="cpu")
    bad._fit_state = lambda *a, **k: 1 / 0
    with pytest.raises(RuntimeError, match="background compaction failed"):
        i = 0
        while True:
            bad.insert(_more(500 + i, 120))
            bad.finish_handoff()
            i += 1
            assert i < 60, "background build never triggered"
    assert bad.epoch == 0 and bad._handoff_thread is None


def test_state_round_trip_keeps_the_background_config():
    """``state`` hands out what ``from_state`` takes: the rebuilt index
    answers identically and fires its background build on the same op."""
    a = COAXIndex(_DS.data, BG, device="cpu")
    a.insert(_more(77, 100))
    b = COAXIndex.from_state(a.state(), device="cpu")
    assert b.config == a.config and dataclasses.asdict(b.config)[
        "background_compact"]
    rects = rects_for(_DS.data, n=6)
    for backend in ("numpy", "device"):
        a.backend = b.backend = backend
        q_a, r_a = a.query_batch(rects)
        q_b, r_b = b.query_batch(rects)
        assert np.array_equal(q_a, q_b) and np.array_equal(r_a, r_b)
    i = 0
    while a._handoff_thread is None:
        for idx in (a, b):
            idx.insert(_more(600 + i, 120))
        assert b._handoff_thread is not None or a._handoff_thread is None
        i += 1
        assert i < 60, "background build never triggered"
    assert b._handoff_thread is not None
    for idx in (a, b):
        idx.finish_handoff()
    assert _counters(a) == _counters(b)
