"""What the port must never do: import JAX or the JAX package, or serve
from the CPU when the card it was asked for is absent."""
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch.core import COAXIndex, GridFile, full_rect
from repro_torch.data import make_airline
from repro_torch.engine import CoaxDevicePlan, DevicePlan
from repro_torch.kernels import fused_scan

SRC = str(Path(__file__).resolve().parents[1] / "src")
EXAMPLES = Path(SRC).parent / "examples"
TWINS = ("quickstart_torch", "batch_queries_torch", "coax_curation_torch",
         "telemetry_torch", "serve_requests_torch", "train_lm_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("engine.device", "kernels.fused_scan", "engine.cache",
              "engine.sharded", "storage", "storage.atomic", "storage.wal",
              "storage.snapshot", "storage.durability", "runtime",
              "runtime.failure", "replication", "replication.frames",
              "replication.transport", "replication.ship",
              "replication.replica", "replication.failover",
              "core.baselines", "configs", "models.common",
              "models.attention", "models.ssm", "models.moe",
              "models.encdec", "models.transformer", "models.model",
              "models.convert", "runtime.router", "runtime.serve_loop",
              "launch.serve", "optim", "optim.adamw", "runtime.steps",
              "runtime.checkpoint", "runtime.train_loop", "data.pipeline",
              "data.curation", "launch.train", "distributed",
              "distributed.partitioning", "distributed.sharding",
              "distributed.compression", "distributed.pipeline",
              "launch.mesh", "launch.roofline", "launch.collectives",
              "launch.dryrun", "launch.report"):
        assert f"repro_torch.{m}" in mods, m
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {SRC!r})
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        from repro_torch.kernels import build
        print(bad, len(build._LIBS))        # imports load no kernel
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0", out.stdout


def test_example_twins_import_neither_jax_nor_repro():
    """Every import statement of the six ``examples/*_torch.py`` (those
    inside functions too) names neither JAX nor the JAX package, and
    importing each twin loads neither."""
    import ast
    for name in TWINS:
        tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert "repro_torch" in roots, name
        assert not roots & {"jax", "jaxlib", "repro"}, (name, roots)
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in {TWINS!r}:
            spec = importlib.util.spec_from_file_location(
                name, {str(EXAMPLES)!r} + "/" + name + ".py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("name,entry", [
    ("quickstart_torch", "main"), ("batch_queries_torch", "main"),
    ("coax_curation_torch", "main"), ("telemetry_torch", "main"),
    ("serve_requests_torch", "main"), ("serve_requests_torch", "main_durable"),
    ("serve_requests_torch", "main_failover"), ("train_lm_torch", "main")])
def test_example_twins_raise_without_a_card(name, entry, tmp_path):
    """Each twin, asked for ``cuda`` (its default) with no card, raises
    before it builds, writes or trains anything."""
    _no_card()
    import importlib.util
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kw = {"ckpt_dir": str(tmp_path / "ck")} if name == "train_lm_torch" \
        else {}
    with pytest.raises(RuntimeError, match="no card"):
        getattr(mod, entry)(**kw)
    with pytest.raises(RuntimeError, match="no card"):
        getattr(mod, entry)("cuda", **kw)
    assert not (tmp_path / "ck").exists()


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    if build._target("fused_scan").exists():
        pytest.skip("the kernel is already built here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("fused_scan")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", ["range_scan_batch", "range_scan",
                                  "grid_histogram", "margin_split"])
def test_new_kernel_build_without_nvcc_raises_and_writes_nothing(
        monkeypatch, tmp_path, name):
    """The kernels behind the ``ops`` entries build as ``fused_scan`` does:
    without ``nvcc`` the first load raises and leaves no build behind."""
    from repro_torch.kernels import build
    assert name in build.SOURCES
    if build._target(name).exists():
        pytest.skip("the kernel is already built here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(name)
    assert not (tmp_path / "build").exists()
    assert name not in build._LIBS


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_default_device_raises_without_a_card():
    _no_card()
    ds = make_airline(3_000, seed=0)
    idx = COAXIndex(ds.data)
    assert idx.backend == "device" and idx.device == "cuda"
    with pytest.raises(RuntimeError, match="no card"):
        CoaxDevicePlan(idx)
    rect = full_rect(ds.data.shape[1])[None]
    with pytest.raises(RuntimeError, match="no card"):
        idx.query_batch(rect)
    gf = GridFile(ds.data, index_dims=[0, 1], cells_per_dim=3)
    with pytest.raises(RuntimeError, match="no card"):
        DevicePlan(gf)
    with pytest.raises(RuntimeError, match="no card"):
        gf.query_batch(full_rect(2)[None], rect)
    # the host paths stay available
    idx.backend = "numpy"
    assert idx.query_batch(rect)[1].size == ds.data.shape[0]
    assert idx.query(rect[0]).size == ds.data.shape[0]


def test_wrapper_refuses_other_devices():
    rows = torch.zeros((2, 512), device="meta")
    flo = torch.zeros((2, 4), device="meta")
    alive = torch.ones((1, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fused_scan(rows, flo, flo, alive, tile=256)


def test_chip_smoke_rehearsal_and_no_card_exit():
    """``chip_smoke.py --rehearse`` drives the main path on the CPU and
    prints no result; without a card the plain run exits non-zero with no
    result either."""
    root = Path(SRC).parent
    reh = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert reh.returncode == 3, reh.stderr
    assert "[main]" in reh.stdout and "[segments]" in reh.stdout
    assert "[ops]" in reh.stdout and "[background]" in reh.stdout
    for phase in ("[cache]", "[sharded]", "[durable]", "[replicated]",
                  "[lm_serve]", "[lm_steps]", "[lm_train]", "[mesh]",
                  "[examples]"):
        assert phase in reh.stdout, phase
    assert "pinned epoch" in reh.stdout
    lines = reh.stdout.splitlines()
    for phase, archs in (
            ("[lm_serve]", ("gemma2-27b", "minitron-4b",
                            "phi3.5-moe-42b-a6.6b")),
            ("[lm_train]", ("mixtral-8x7b", "qwen2-vl-2b",
                            "seamless-m4t-large-v2"))):
        for arch in archs:
            mine = [l for l in lines if l.startswith(f"{phase} {arch}")]
            if phase == "[lm_serve]":
                assert any(": checks passed:" in l for l in mine), arch
            else:           # its train() run, then its card-vs-CPU twin
                assert any("every parameter moved" in l for l in mine), arch
                assert any("train step at d_model" in l for l in mine), arch
    assert '"ok"' not in reh.stdout
    if torch.cuda.is_available():
        return
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout


def test_background_compaction_not_ported():
    """Background compaction is ported (its twins are in
    ``test_torch_lsm.py``), and so now is its durable handoff (WAL
    rotation and crash recovery, twins in ``test_torch_storage.py``): an
    index carries the durability entry points and starts unjournaled."""
    from repro_torch.core import CoaxConfig
    idx = COAXIndex(np.zeros((10, 2), np.float32),
                    CoaxConfig(background_compact=True), device="cpu")
    assert idx.describe()["background"]["enabled"]
    for name in ("attach_durability", "save", "restore", "pin_epoch",
                 "attach_cache"):
        assert callable(getattr(idx, name)), name
    assert idx.durable is None and idx.describe()["durability"] is None


def test_restore_and_sharded_plane_raise_without_a_card(tmp_path):
    """The new entry points keep the no-fallback rule: asked for the device
    backend on ``cuda`` with no card, ``restore``, ``QueryServer.recover``
    and a sharded plane raise (before reading or building anything), and
    their host routes stay available."""
    _no_card()
    from repro_torch.engine import QueryServer, ShardedCOAX
    from repro_torch.storage import load_snapshot, restore
    ds = make_airline(3_000, seed=0)
    idx = COAXIndex(ds.data, device="cpu")
    snap = idx.save(tmp_path)
    for call in (lambda: restore(tmp_path),
                 lambda: restore(tmp_path, device="cuda"),
                 lambda: load_snapshot(snap),
                 lambda: COAXIndex.restore(tmp_path),
                 lambda: QueryServer.recover(tmp_path, durable=False),
                 lambda: ShardedCOAX(ds.data, n_shards=2),
                 lambda: QueryServer(COAXIndex(ds.data), shards=2)):
        with pytest.raises(RuntimeError, match="no card"):
            call()
    rec = restore(tmp_path, backend="numpy")
    assert rec.device == "cuda" and rec.n_rows == ds.data.shape[0]
    rect = full_rect(ds.data.shape[1])[None]
    assert rec.query_batch(rect)[1].size == ds.data.shape[0]
    plane = ShardedCOAX(ds.data, n_shards=2, backend="numpy")
    assert plane.query_batch(rect)[1].size == ds.data.shape[0]
    rec.backend = "device"
    with pytest.raises(RuntimeError, match="no card"):
        rec.query_batch(rect)


def test_replication_raises_without_a_card(tmp_path):
    """``Replica`` and ``ReplicatedServer`` with their defaults (device
    backend on ``cuda``) raise before they attach a journal, register a
    destination or seed a replica; their ``backend="numpy"`` routes work."""
    _no_card()
    from repro_torch.replication import (InProcTransport, Replica,
                                         ReplicatedServer, ReplicationHub)
    from repro_torch.storage import Durability
    ds = make_airline(3_000, seed=0)
    idx = COAXIndex(ds.data, backend="numpy")
    with pytest.raises(RuntimeError, match="no card"):
        ReplicatedServer(idx, tmp_path / "srv")
    assert idx.durable is None and not (tmp_path / "srv").exists()
    dur = Durability.attach(idx, tmp_path / "dur")
    hub = ReplicationHub(dur, InProcTransport())
    with pytest.raises(RuntimeError, match="no card"):
        Replica("r", hub)
    with pytest.raises(RuntimeError, match="no card"):
        Replica("r", hub, backend="device", device="cuda")
    assert hub.destinations == [] and hub.total_writes == 0
    rep = Replica("r", hub, backend="numpy")
    assert rep.index.backend == "numpy" and hub.destinations == ["r"]
    srv = ReplicatedServer(COAXIndex(ds.data, backend="numpy"),
                           tmp_path / "ok", n_replicas=1,
                           replica_backend="numpy")
    srv.insert(ds.data[:5])
    srv.tick()
    rect = full_rect(ds.data.shape[1])[None]
    assert srv.query_batch(rect)[1].size == ds.data.shape[0] + 5
    assert srv.stats()["reads"]["replica"] == 1


def test_lm_serving_raises_without_a_card():
    """The LM serving path keeps the no-fallback rule: ``CoaxRouter()``,
    ``Server(...)`` and ``build_model(cfg)`` with their default device
    (``cuda``) raise at construction; their ``cpu`` routes work."""
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.router import CoaxRouter
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    cfg = get_config("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="no card"):
        CoaxRouter()
    with pytest.raises(RuntimeError, match="no card"):
        build_model(cfg)
    model = build_model(cfg, device="meta")
    with pytest.raises(RuntimeError, match="no card"):
        Server(model, ServeConfig())
    assert CoaxRouter(backend="numpy").backend == "numpy"
    assert CoaxRouter(device="cpu").device == "cpu"


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_new_families_raise_without_a_card(arch):
    """The MoE, vlm and enc-dec families keep the no-fallback rule: on
    ``cuda`` (the default) with no card ``build_model`` raises, at full
    size and tiny, before it allocates; ``meta`` and ``cpu`` build."""
    _no_card()
    from conftest import tiny_config
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    tiny = tiny_config(cfg)
    for c in (cfg, tiny):
        with pytest.raises(RuntimeError, match="no card"):
            build_model(c)
        with pytest.raises(RuntimeError, match="no card"):
            build_model(c, device="cuda")
    assert build_model(cfg, device="meta").param_count() > 1e9
    assert build_model(tiny, device="cpu").device.type == "cpu"


def test_lm_training_raises_without_a_card(tmp_path):
    """The training path keeps the no-fallback rule: ``CuratedSelector``
    and the training launcher with their default device (``cuda``) raise
    before they build an index, a model or a checkpoint; their ``cpu``
    and numpy routes work."""
    _no_card()
    from repro_torch.data.curation import CuratedSelector, MetaQuery
    from repro_torch.data.pipeline import make_corpus
    from repro_torch.launch import train
    corpus = make_corpus(500, vocab_size=64)
    with pytest.raises(RuntimeError, match="no card"):
        CuratedSelector(corpus)
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="no card"):
        train.main(["--arch", "h2o-danube-3-4b", "--reduced-layers", "2",
                    "--reduced-width", "64", "--curate", "--steps", "1",
                    "--ckpt-dir", str(ck)])
    assert not ck.exists()
    q = MetaQuery(token_len=(128, 32768))
    assert np.array_equal(CuratedSelector(corpus, device="cpu").select(q),
                          CuratedSelector(corpus, backend="numpy").select(q))
