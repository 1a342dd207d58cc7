"""The port's LM serving path (``repro_torch.runtime.{router,serve_loop}``
and ``repro_torch.launch.serve``) against the reference on the CPU.

The router is exact: every admission's rid list and ``stats()`` (outside
the latency fields) equal the reference's, on the port's device backend
(``device="cpu"``: the plan's waves run ``fused_scan``'s plain version)
and on its numpy backend.  The server twin runs both packages at float32
(``DTYPE`` patched as in ``test_torch_models.py``): each wave's rids are
equal, and so are the greedy tokens, except after a step where the
reference's two best logits lie closer than ``TIE`` (either package may
then pick either token).  Such steps are counted and must stay rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.model as r_model
import repro.models.transformer as r_tf
from conftest import tiny_config
from repro.configs import get_config
from repro.models import build_model as r_build
from repro.runtime.router import CoaxRouter as RefRouter
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer

import repro_torch.models.common as p_common
from repro_torch.kernels import ref as kref
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params
from repro_torch.runtime.router import COLS, CoaxRouter
from repro_torch.runtime.serve_loop import ServeConfig, ServeResult, Server

TIE = 1e-4          # float32 logits agree to ~1e-6 (test_torch_models.py)
BACKENDS = [("device", "cpu"), ("numpy", "cpu")]
LATENCY = ("admit_p50_ms", "admit_p99_ms")


def _router(backend, device, **kw):
    return CoaxRouter(backend=backend, device=device, **kw)


@pytest.fixture
def plain_scans(monkeypatch):
    """Counts the calls of ``fused_scan``'s plain version (the CPU route)."""
    calls = []
    orig = kref.fused_scan_ref

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(kref, "fused_scan_ref", counted)
    return calls


# ----------------------------- twins of the reference's tests ------------ #

@pytest.mark.parametrize("backend,device", BACKENDS)
def test_router_admission_matches_naive_filter(backend, device):
    rng = np.random.default_rng(0)
    router = _router(backend, device, rebuild_threshold=64)
    pool = []
    for i in range(400):
        n = int(rng.integers(8, 512))
        prio = float(rng.random())
        router.submit(np.ones(n, np.int32), max_new_tokens=64,
                      priority=prio, arrival=float(i))
        pool.append((i, n, prio))
    batch = router.admit(16, prompt_len_range=(64, 256))
    assert 0 < len(batch) <= 16
    for r in batch:
        assert 64 <= r.prompt_len < 256
    # admitted requests leave the pool
    assert len(router) == 400 - len(batch)
    # priority-then-FIFO ordering
    ps = [r.priority for r in batch]
    assert ps == sorted(ps, reverse=True)
    # the naive filter over the whole pool picks the same batch
    naive = sorted((p for p in pool if 64 <= p[1] < 256),
                   key=lambda p: (-p[2], p[0]))[:16]
    assert [r.rid for r in batch] == [p[0] for p in naive]
    assert len(COLS) == 4


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_router_stats_expose_index(backend, device):
    router = _router(backend, device, rebuild_threshold=64)
    rng = np.random.default_rng(1)
    for i in range(128):
        router.submit(np.ones(int(rng.integers(8, 400)), np.int32), 32,
                      arrival=float(i))
    s = router.stats()
    assert s["indexed"] > 0
    assert s["pending"] == 128


def test_server_end_to_end():
    cfg = tiny_config(get_config("h2o-danube-3-4b"))
    model = build_model(cfg, device="cpu").init(p_common.make_generator(0))
    srv = Server(model, ServeConfig(batch_size=4, max_new_tokens=8,
                                    cache_len=64, eos_token=0), device="cpu")
    assert srv.router.backend == "device" and srv.router.device == "cpu"
    rng = np.random.default_rng(2)
    rids = [srv.submit(rng.integers(1, 200, rng.integers(4, 24)).astype(np.int32))
            for _ in range(10)]
    results = srv.run_until_drained()
    assert len(results) == 10
    assert {r.rid for r in results} == set(rids)
    for r in results:
        assert isinstance(r, ServeResult) and r.tokens.shape[0] <= 8
    assert srv.waves >= 2


# ----------------------------- router against the reference -------------- #

def _drive(routers, rng, n_submit, admit_every, bands):
    """Submit ``n_submit`` requests with explicit arrivals to every router,
    admitting every ``admit_every`` submits, then admit until a full-range
    admission finds nothing; every admission's rid list must be equal
    across the routers.  Returns the first router's admissions."""
    admitted = []

    def admit(band, min_p=-np.inf):
        outs = [[r.rid for r in rt.admit(8, prompt_len_range=band,
                                         min_priority=min_p)]
                for rt in routers]
        for o in outs[1:]:
            assert o == outs[0]
        admitted.append(outs[0])
        return outs[0]

    for i in range(n_submit):
        plen = int(rng.choice([16, 32, 64, 128]))
        prompt = rng.integers(1, 255, plen).astype(np.int32)
        max_new, prio = int(rng.integers(4, 16)), float(rng.random())
        for rt in routers:
            rt.submit(prompt, max_new, prio, arrival=1_000.0 + 0.5 * i)
        if admit_every and i % admit_every == admit_every - 1:
            admit(bands[i % len(bands)])
    for k in range(4 * n_submit):
        admit(bands[k % len(bands)], 0.25 if k % 5 == 4 else -np.inf)
        if not admit((0, np.inf)):
            break
    return admitted


def _stats(router):
    s = router.stats()
    for k in LATENCY:
        s.pop(k)
    return s


# (submissions, admit every k submits): bulk is the smoke's traffic (the
# index builds at 256 pending); a trickle keeps the pool below 64 rows
SCHEDULES = {"bulk": (512, 0), "interleaved": (600, 6), "trickle": (600, 3)}


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_router_twin_admits_as_the_reference(backend, schedule, plain_scans):
    """Every admission equal, the pending pool and stats equal at the end,
    and on the device backend ONE wave per admission that met a built
    index."""
    ref = RefRouter()
    port = _router(backend, "cpu")
    waves = []
    orig = port._index_hits

    def hits(rect):
        plan = port._index._coax_plan
        before = plan.dispatch_count if plan is not None else 0
        out = orig(rect)
        plan = port._index._coax_plan
        waves.append(plan.dispatch_count - before if plan is not None else 0)
        return out
    port._index_hits = hits
    rng = np.random.default_rng(11)
    bands = [(0, 512), (16, 64), (60, 130), (0, 40)]
    n, every = SCHEDULES[schedule]
    admitted = _drive([ref, port], rng, n, every, bands)
    assert sum(len(a) for a in admitted) + len(port) == n
    # a rebuild that finds fewer than 64 pending builds no index and
    # empties the overflow list, so those requests wait for the next
    # rebuild; with no more arrivals they are never admitted (ROADMAP
    # queue 3): the port strands the same ones
    assert sorted(port._pool) == sorted(ref._pool)
    assert len(port) > 0 if schedule == "trickle" else len(port) == 0
    assert _stats(port) == _stats(ref)
    assert port.stats()["rebuilds"] >= 2
    assert bool(waves) != (schedule == "trickle")
    if backend == "device":
        assert waves == [1] * len(waves)
        assert len(plain_scans) >= len(waves)
    else:
        assert waves == [0] * len(waves) and not plain_scans


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_router_stats_equal_with_a_built_index(backend):
    """``index_groups`` and ``index_memory`` of a live index, with a soft FD
    to learn: prompt_len -> predicted_decode (budgets above 16 + len/4)."""
    ref = RefRouter(rebuild_threshold=128)
    port = _router(backend, "cpu", rebuild_threshold=128)
    rng = np.random.default_rng(12)
    for i in range(300):
        plen, prio = int(rng.integers(8, 400)), float(rng.random())
        for rt in (ref, port):
            rt.submit(np.ones(plen, np.int32), 512, prio, arrival=float(i))
    s_p, s_r = _stats(port), _stats(ref)
    assert s_p == s_r
    assert s_p["index_groups"], "no soft FD learned"
    assert s_p["index_memory"] > 0 and s_p["indexed"] == 256
    for band in [(0, 100), (50, 300), (390, 400)]:
        assert ([r.rid for r in port.admit(8, prompt_len_range=band)]
                == [r.rid for r in ref.admit(8, prompt_len_range=band)])


def test_router_rebuild_frees_the_old_plan(plain_scans):
    """A rebuild releases the old index's device plan (``release_plan``), so
    the plan and the index go at once, not at the cyclic GC's next pass."""
    import gc
    import weakref
    port = _router("device", "cpu", rebuild_threshold=128)
    for i in range(300):
        port.submit(np.ones(8 + i % 64, np.int32), 8, 0.5, arrival=float(i))
    assert port.admit(8) and plain_scans
    old_plan = weakref.ref(port._index._coax_plan)
    old_index = weakref.ref(port._index)
    gc.disable()
    try:
        for i in range(128):
            port.submit(np.ones(16, np.int32), 8, 0.5, arrival=300.0 + i)
        assert port.stats()["rebuilds"] == 3
        assert old_plan() is None and old_index() is None
    finally:
        gc.enable()


def test_router_device_backend_checks_the_device():
    with pytest.raises(ValueError):
        CoaxRouter(backend="device", device="meta")


# ----------------------------- the server against the reference ---------- #

@pytest.fixture
def f32(monkeypatch):
    for mod in (r_common, r_attn, r_tf, r_model):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


def _recorder(fn, waves, to_np, first):
    """Wrap a prefill (``first``: opens a wave) or decode step so that each
    wave's last-position logits land in ``waves[-1]``, step by step."""
    def wrapped(*a):
        logits, cache = fn(*a)
        if first:
            waves.append([])
        waves[-1].append(to_np(logits)[:, -1])
        return logits, cache
    return wrapped


def test_server_twin_at_float32(f32):
    cfg = tiny_config(get_config("h2o-danube-3-4b"))
    ref_model = r_build(cfg)
    params, _ = ref_model.init(jax.random.key(5))
    port_model = build_model(cfg, device="cpu")
    load_reference_params(port_model, jax.tree.map(np.asarray, params))
    scfg = dict(batch_size=4, max_new_tokens=10, cache_len=48, eos_token=0,
                max_prompt_len=40)
    ref = RefServer(ref_model, params, RefServeConfig(**scfg),
                    router=RefRouter(rebuild_threshold=16))
    port = Server(port_model, ServeConfig(**scfg),
                  router=_router("device", "cpu", rebuild_threshold=16),
                  device="cpu")
    ref_logits, port_logits = [], []
    ref._prefill = _recorder(ref._prefill, ref_logits, np.asarray, True)
    ref._decode = _recorder(ref._decode, ref_logits, np.asarray, False)
    port._prefill = _recorder(port._prefill, port_logits,
                              lambda t: t.numpy(), True)
    port._decode = _recorder(port._decode, port_logits,
                             lambda t: t.numpy(), False)

    rng = np.random.default_rng(6)
    for i in range(40):
        prompt = rng.integers(1, 250, int(rng.integers(4, 36))).astype(np.int32)
        max_new, prio = int(rng.integers(2, 11)), float(rng.random())
        for srv in (ref, port):
            srv.router.submit(prompt, max_new, prio, arrival=float(i))
    res_r = ref.run_until_drained()
    res_p = port.run_until_drained()
    assert ref.waves == port.waves >= 10
    assert [(r.rid, r.wave, r.prompt_len) for r in res_p] == \
        [(r.rid, r.wave, r.prompt_len) for r in res_r]

    # logits of every step of every wave, in order: the same steps in both
    assert [len(w) for w in port_logits] == [len(w) for w in ref_logits]
    for wp, wr in zip(port_logits, ref_logits):
        for a, b in zip(wp, wr):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    # tokens: equal up to the first near-tie step of each row
    by_wave = {}
    for r in res_r:
        by_wave.setdefault(r.wave, []).append(r)
    got = {r.rid: r.tokens for r in res_p}
    ties = compared = 0
    for w, reqs in sorted(by_wave.items()):
        for i, r in enumerate(reqs):
            stop = r.tokens.size
            for t, step_logits in enumerate(ref_logits[w - 1][:stop]):
                top2 = np.sort(step_logits[i])[-2:]
                if top2[1] - top2[0] < TIE:
                    ties, stop = ties + 1, t
                    break
            assert np.array_equal(got[r.rid][:stop], r.tokens[:stop]), r.rid
            compared += stop
    assert compared > 100
    assert ties <= 2, f"{ties} near-tie steps"


# ----------------------------- the launcher ------------------------------ #

def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "12", "--reduced-layers",
                "2", "--reduced-width", "64", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "12 requests queued" in out and "12 responses" in out


def test_serve_launcher_refuses_a_checkpoint_until_training_lands(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--ckpt-dir", "somewhere"])
    assert "--ckpt-dir" in capsys.readouterr().err


def test_server_refuses_a_model_on_another_device():
    cfg = tiny_config(get_config("minitron-4b"))
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        Server(model, ServeConfig(), device="meta")
