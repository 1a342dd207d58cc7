"""The six example twins (``examples/*_torch.py``) against ``repro`` on
the CPU.

Each twin runs with ``device="cpu"`` at a small size through its
function's keyword arguments, and what it prints and returns is held
against the reference's calls at the same size and seed:

- quickstart, batch_queries: FD groups, indexed dims, every hit array
  (the device wave's too), waves, the write path's delta, tombstones and
  epochs, the compaction, all equal;
- coax_curation: the corpus's groups and the selected doc ids of every
  stage, equal;
- telemetry: queries, waves, epoch, background compactions, the stage
  series and their counts, the span names and counts, equal (the
  reference on its device backend, which the port's examples use by
  default, through its jnp oracle);
- serve_requests (default mode): both packages at float32 activations
  (``DTYPE`` patched, as in ``test_torch_serving.py``), the port's model
  carrying the reference's ``model.init(jax.random.key(0))`` weights
  (``models.convert``): every request's id, wave, prompt length and
  greedy tokens, equal;
- serve_requests ``--durable`` and ``--failover``: the reference's own
  functions (fixed sizes) and the twin's print the same lines, times and
  temporary paths aside;
- train_lm (quick preset): both packages at float32 from one step-0
  checkpoint the reference writes (the port's ``train`` draws its own
  init): the curated doc ids equal, ``final_step`` and ``restarts``
  equal, the loss and grad-norm history within rtol 1e-4 over 3 steps.
"""
import dataclasses
import importlib.util
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.model as r_model
import repro.models.transformer as r_tf
from repro import obs as r_obs
from repro.configs import get_config as r_get_config
from repro.core import COAXIndex as RefIndex
from repro.core import CoaxConfig as RefCoaxConfig
from repro.data import knn_rect_queries as r_knn
from repro.data import make_airline as r_airline
from repro.data.curation import CuratedSelector as RefSelector
from repro.data.curation import MetaQuery as RefMetaQuery
from repro.data.pipeline import ShardedLoader as RefLoader
from repro.data.pipeline import make_corpus as r_make_corpus
from repro.engine import QueryServer as RefQueryServer
from repro.models import build_model as r_build
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.runtime.checkpoint import Checkpointer as RefCheckpointer
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig
from repro.runtime.train_loop import train as r_train

import repro_torch.models.common as p_common
from repro_torch import obs as p_obs
from repro_torch.models.convert import load_reference_params

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# the reference's device plan on its jnp oracle: the twins serve from the
# port's device plan (its default backend), on the CPU its plain versions
PLAIN = {"use_pallas": False}
# a printed time: "2.02s", "3.31 ms", "917504.0us", "(1x)", "(0.04x)", a
# rate, or a temporary directory
_TIMES = re.compile(r"-?[\d.]+ ?(ms|s|us|QPS)\b|\([\d.]+x\)|[\d.]+ tok/s"
                    r"|/\S*coax_(durable|failover)_\w+")


def _load(name: str):
    """``examples/<name>.py`` as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(f"ex_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _untimed(text: str):
    return [_TIMES.sub("<t>", line) for line in text.splitlines()]


@pytest.fixture
def f32(monkeypatch):
    """Both packages at float32 activations."""
    for mod in (r_common, r_attn, r_tf, r_model):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


def test_quickstart_twin(capsys):
    rows, queries, k = 20_000, 6, 100
    got = _load("quickstart_torch").main("cpu", rows=rows, queries=queries,
                                         k=k)
    out = capsys.readouterr().out
    ds = r_airline(rows, seed=0)
    idx = RefIndex(ds.data)
    d = idx.describe()
    groups = [(g["predictor"], g["dependents"]) for g in d["groups"]]
    assert got["groups"] == groups and len(groups) >= 2
    assert got["indexed_dims"] == d["indexed_dims"]
    assert got["primary_ratio"] == d["primary_ratio"]
    rects = r_knn(ds.data, queries, k, seed=1, sample_cap=50_000)
    for hits, wave, r in zip(got["hits"], got["wave"], rects):
        want = idx.query(r)
        assert np.array_equal(hits, want) and np.array_equal(wave, want)
    for p, deps in groups:
        assert f"soft FD: attr {p} -> {deps}" in out
    assert f"indexed dims: {d['indexed_dims']} (of 8)" in out


def test_batch_queries_twin():
    rows, queries, k, ins, dels = 6_000, 96, 32, 300, 60
    got = _load("batch_queries_torch").main("cpu", rows=rows,
                                            queries=queries, k=k,
                                            inserts=ins, deletes=dels)
    ds = r_airline(rows, seed=0)
    idx = RefIndex(ds.data)
    assert got["groups"] == len(idx.groups)
    rects = r_knn(ds.data, queries, k, seed=1, sample_cap=50_000)
    srv = RefQueryServer(idx, max_batch=64)
    rng = np.random.default_rng(2)
    qids = [srv.submit(r, priority=float(rng.integers(0, 3))) for r in rects]
    results = srv.drain()
    assert got["waves"] == srv.stats()["waves_drained"] == 2
    assert len(got["hits"]) == len(qids)
    for h, q in zip(got["hits"], qids):
        assert np.array_equal(h, results[q])
    assert got["total_hits"] == sum(r.size for r in results.values())

    w_ins = srv.insert(r_airline(ins, seed=7).data)
    w_del = srv.delete(rng.choice(rows, dels, replace=False))
    qid = srv.submit(rects[0])
    res = srv.drain()
    live = got["live"]
    assert srv.write_results[w_ins].size == ins
    assert live["deleted"] == srv.write_results[w_del]
    assert (live["delta"], live["tombstones"], live["epoch"]) == \
        (idx.delta_rows, idx.tombstone_count, idx.epoch)
    assert np.array_equal(live["after_writes"], res[qid])
    idx.compact()
    assert (got["epoch"], got["n_rows"]) == (idx.epoch, idx.n_rows)
    assert got["drift"] == idx.drift_predictability()


def test_coax_curation_twin(capsys):
    docs = 6_000
    got = _load("coax_curation_torch").main("cpu", docs=docs)
    out = capsys.readouterr().out
    sel = RefSelector(r_make_corpus(docs, seed=0))
    d = sel.describe()
    groups = [(g["predictor"], g["dependents"]) for g in d["groups"]]
    assert got["groups"] == groups
    assert got["indexed_dims"] == d["indexed_dims"]
    stages = [RefMetaQuery(token_len=(64, 512), quality=(0.6, 1.1)),
              RefMetaQuery(token_len=(512, 4096), quality=(0.6, 1.1)),
              RefMetaQuery(token_len=(4096, 32768), quality=(0.7, 1.1))]
    assert len(got["stages"]) == len(stages)
    for i, (ids, q) in enumerate(zip(got["stages"], stages)):
        want = sel.select(q)
        assert np.array_equal(ids, want), i
        assert f"stage {i}: {want.size:,} docs" in out
    assert f"COAX detected groups: {groups}" in out


def _stage_counts(obs_mod):
    """{(stage, backend): observations} of the stage histogram so far."""
    hist = obs_mod.stage_hist()
    return {(s["labels"]["stage"], s["labels"]["backend"]):
            hist.summary(**s["labels"])["count"]
            for s in obs_mod.get_registry().snapshot()[
                "coax_stage_seconds"]["series"]}


def test_telemetry_twin():
    rows, queries, rounds, ins = 3_000, 128, 3, 256
    before = _stage_counts(p_obs)
    got = _load("telemetry_torch").main("cpu", rows=rows, queries=queries,
                                        rounds=rounds, inserts=ins)
    assert p_obs.tracer() is None
    got_series = {(s, b): n - before.get((s, b), 0)
                  for s, b, n in got["series"] if n > before.get((s, b), 0)}

    r_before = _stage_counts(r_obs)
    ds = r_airline(rows, seed=0)
    rects = r_knn(ds.data, queries, 64, seed=1, sample_cap=50_000)
    tracer = r_obs.enable_tracing(capacity=16384)
    try:
        idx = RefIndex(ds.data, RefCoaxConfig(background_compact=True,
                                              compact_min_delta=512,
                                              compact_delta_frac=0.01,
                                              compact_check_rows=64),
                       backend="device", device_opts=PLAIN)
        srv = RefQueryServer(idx, max_batch=64)
        rng = np.random.default_rng(7)
        for _ in range(rounds):
            for start in range(0, len(rects), 64):
                srv.insert(ds.data[rng.integers(0, len(ds.data), ins)])
                for r in rects[start:start + 64]:
                    srv.submit(r)
                srv.drain()
        idx.finish_handoff()
        evs = tracer.events()
        ok, _ = tracer.validate()
    finally:
        r_obs.disable_tracing()
    s = srv.stats()
    assert (got["queries"], got["waves"], got["epoch"], got["compactions"]) \
        == (s["queries"], s["waves_drained"], idx.epoch,
            idx.background_compactions)
    assert got["compactions"] >= 1
    want_series = {k: n - r_before.get(k, 0)
                   for k, n in _stage_counts(r_obs).items()}
    assert got_series == {k: n for k, n in want_series.items() if n}
    spans = {}
    for e in evs:
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    assert got["spans"] == spans
    assert got["valid"] and ok


def test_serve_requests_twin_at_float32(f32):
    n_requests = 10
    tw = _load("serve_requests_torch")
    cfg = dataclasses.replace(
        r_get_config("h2o-danube-3-4b"),
        n_layers=4, d_model=256, d_ff=768, vocab_size=8192,
        n_heads=8, n_kv_heads=4, head_dim=32, window=256)
    ref_model = r_build(cfg)
    params, _ = ref_model.init(jax.random.key(0))
    port_model = tw.make_model("cpu")
    assert port_model.cfg.n_layers == 4 and port_model.cfg.d_model == 256
    load_reference_params(port_model, jax.tree.map(np.asarray, params))
    got = tw.main("cpu", n_requests=n_requests, model=port_model)

    srv = RefServer(ref_model, params,
                    RefServeConfig(batch_size=8, max_new_tokens=24,
                                   cache_len=512, eos_token=0))
    rng = np.random.default_rng(7)
    for _ in range(n_requests):
        plen = int(rng.choice([16, 24, 48, 96, 192]))
        srv.submit(rng.integers(1, 8000, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(8, 24)),
                   priority=float(rng.random()))
    want = srv.run_until_drained()
    assert got["waves"] == srv.waves >= 2
    assert [(r.rid, r.wave, r.prompt_len) for r in got["results"]] == \
        [(r.rid, r.wave, r.prompt_len) for r in want]
    for g, w in zip(got["results"], want):
        assert np.array_equal(g.tokens, w.tokens), g.rid


@pytest.mark.parametrize("mode", ["main_durable", "main_failover"])
def test_serve_requests_recovery_twins_print_the_references_facts(mode,
                                                                   capsys):
    """The reference's own ``--durable``/``--failover`` functions and the
    twin's: the same lines (recovered snapshot epoch, WAL sequence, rows,
    re-answered queries, shipped frames and bytes, faults, promotions,
    the bit-identical verdicts), times and temporary paths aside."""
    getattr(_load("serve_requests"), mode)()
    want = capsys.readouterr().out
    facts = getattr(_load("serve_requests_torch"), mode)("cpu")
    got = capsys.readouterr().out
    assert _untimed(got) == _untimed(want)
    assert "MISMATCH" not in got
    if mode == "main_durable":
        assert facts["left"] > 0 and facts["answered"] > 0
    else:
        assert facts["promotions"] == 1 and facts["frontier"] >= facts["acked"]


def test_train_lm_twin_quick_at_float32(f32, tmp_path):
    steps, batch, seq, docs = 3, 2, 64, 3_000
    ref_ex = _load("train_lm")
    ref = ref_ex.make_model("quick")
    params, _ = ref.init(jax.random.key(0))
    RefCheckpointer(tmp_path / "seed").save(
        0, {"params": params, "opt": r_adamw_init(params)})
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / name)

    got = _load("train_lm_torch").main(
        "cpu", steps=steps, batch=batch, seq=seq, docs=docs,
        ckpt_dir=str(tmp_path / "port"))

    vocab = ref.cfg.padded_vocab
    corpus = r_make_corpus(docs, vocab_size=min(vocab, 32_000), seed=0)
    ids = RefSelector(corpus).select(
        RefMetaQuery(token_len=(256, 8192), quality=(0.5, 1.1)))
    assert np.array_equal(got["selected"], ids)
    loader = RefLoader(corpus, batch_size=batch, seq_len=seq, doc_ids=ids,
                       seed=1)
    try:
        want = r_train(ref, iter(loader), RefAdamWConfig(lr=1e-3),
                       RefLoopConfig(steps=steps, ckpt_dir=str(tmp_path / "ref"),
                                     ckpt_every=50, log_every=10, warmup=20),
                       log_fn=lambda s: None)
    finally:
        loader.close()
    assert got["final_step"] == want["final_step"] == steps
    assert got["restarts"] == want["restarts"] == 0
    hg, hw = got["history"], want["history"]
    assert [h["step"] for h in hg] == [h["step"] for h in hw] == [0, 1, 2]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hg], [h[key] for h in hw],
                                   rtol=1e-4, err_msg=key)
