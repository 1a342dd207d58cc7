"""The port's data plane of training (``repro_torch.data.{pipeline,
curation}``) against the reference on the CPU, and the end-to-end
system twin (curate -> load -> train -> checkpoint -> serve).

Every comparison is exact: ``make_corpus`` metadata and token streams,
every loader batch (across epoch boundaries, host shards and a resume
through ``load_state``) and every curated doc-id set are bit-equal to the
reference's.  The selector's device route runs on ``device="cpu"``
(``fused_scan``'s plain version) and its numpy route calls ``query``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_config
from repro.configs import get_config as r_get_config
from repro.data.curation import CuratedSelector as RefSelector
from repro.data.curation import MetaQuery as RefQuery
from repro.data.pipeline import ShardedLoader as RefLoader
from repro.data.pipeline import make_corpus as r_make_corpus

from repro_torch.configs import get_config
from repro_torch.data.curation import CuratedSelector, MetaQuery
from repro_torch.data.pipeline import ShardedLoader, make_corpus
from repro_torch.kernels import ref as kref
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.train_loop import TrainLoopConfig, train

ROUTES = [("device", "cpu"), ("numpy", "cpu")]


@pytest.fixture(scope="module")
def corpora():
    return make_corpus(8_000, vocab_size=512, seed=1), \
        r_make_corpus(8_000, vocab_size=512, seed=1)


@pytest.fixture
def plain_scans(monkeypatch):
    """Counts the calls of ``fused_scan``'s plain version (the CPU route
    of the device backend)."""
    calls = []
    orig = kref.fused_scan_ref

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(kref, "fused_scan_ref", counted)
    return calls


# ----------------------------- pipeline ---------------------------------- #

@pytest.mark.parametrize("seed,n_docs,vocab", [(0, 3_000, 32_000),
                                               (7, 50_000, 256)])
def test_make_corpus_is_the_references(seed, n_docs, vocab):
    got, want = make_corpus(n_docs, vocab, seed), r_make_corpus(n_docs, vocab,
                                                                seed)
    assert got.meta.dtype == want.meta.dtype == np.float32
    assert np.array_equal(got.meta, want.meta)
    assert (got.seed, got.vocab_size) == (want.seed, want.vocab_size)
    assert got.META_COLS == want.META_COLS
    for d in (0, 1, n_docs // 2, n_docs - 1):
        assert np.array_equal(got.tokens_for(d), want.tokens_for(d))


def _batches(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    state = loader.state_dict()
    loader.close()
    return out, state


@pytest.mark.parametrize("hosts", [1, 3])
def test_loader_batches_are_the_references_over_three_epochs(corpora, hosts):
    """Every batch of 3 epochs (over a 70-doc curated subset, batch 4,
    per host shard), then a resume from ``load_state`` mid-epoch."""
    port, ref = corpora
    docs = np.arange(5, 5 + 70 * 7, 7)
    for pi in range(hosts):
        kw = dict(batch_size=4, seq_len=24, doc_ids=docs, seed=3,
                  process_index=pi, process_count=hosts)
        per_epoch = len(docs[pi::hosts]) // 4
        n = 3 * per_epoch
        got, s_got = _batches(ShardedLoader(port, **kw), n)
        want, s_want = _batches(RefLoader(ref, **kw), n)
        assert s_got == s_want and s_got["epoch"] == 2
        for i, (g, w) in enumerate(zip(got, want)):
            assert sorted(g) == sorted(w) == ["labels", "tokens"]
            for k in w:
                assert g[k].dtype == w[k].dtype == np.int32
                assert np.array_equal(g[k], w[k]), (pi, i, k)
        mid = {"epoch": 1, "cursor": per_epoch // 2}
        resumed = []
        for cls, corpus in ((ShardedLoader, port), (RefLoader, ref)):
            loader = cls(corpus, **kw)
            loader.load_state(mid)
            resumed.append(_batches(loader, per_epoch + 1))
        (g_b, g_s), (w_b, w_s) = resumed
        assert g_s == w_s
        for g, w in zip(g_b, w_b):
            assert all(np.array_equal(g[k], w[k]) for k in w)
        assert np.array_equal(g_b[0]["tokens"],
                              got[per_epoch + per_epoch // 2]["tokens"])


def test_loader_determinism_and_resume(corpora):
    corpus, _ = corpora
    batches, _ = _batches(ShardedLoader(corpus, batch_size=4, seq_len=32,
                                        seed=3), 5)
    l2 = ShardedLoader(corpus, batch_size=4, seq_len=32, seed=3)
    _, state = _batches(l2, 3)
    l3 = ShardedLoader(corpus, batch_size=4, seq_len=32, seed=3)
    l3.load_state(state)
    (nxt,), _ = _batches(l3, 1)
    assert np.array_equal(nxt["tokens"], batches[3]["tokens"])
    assert np.array_equal(nxt["labels"], batches[3]["labels"])


def test_loader_host_shards_disjoint(corpora):
    corpus, _ = corpora
    a = ShardedLoader(corpus, batch_size=2, seq_len=8, process_index=0,
                      process_count=2, seed=5)
    b = ShardedLoader(corpus, batch_size=2, seq_len=8, process_index=1,
                      process_count=2, seed=5)
    da, db = a._epoch_order(0), b._epoch_order(0)
    assert len(np.intersect1d(da, db)) == 0
    assert len(da) + len(db) == corpus.meta.shape[0]


def test_labels_are_shifted_tokens(corpora):
    corpus, _ = corpora
    (b,), _ = _batches(ShardedLoader(corpus, batch_size=2, seq_len=16,
                                     seed=7), 1)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ----------------------------- curation ---------------------------------- #

QUERIES = [
    dict(token_len=(128, 32768), quality=(0.5, 1.1)),     # the launcher's
    dict(token_len=(256, 2048)),
    dict(token_len=(512, 4096), quality=(0.8, 1.1)),
    dict(compute_cost=(1000, 5000), domain_id=(0, 8)),
    dict(timestamp=(1.6e9, 1.6e9 + 1e6)),
]


@pytest.mark.parametrize("backend,device", ROUTES)
def test_curation_matches_reference(corpora, backend, device, plain_scans):
    port, ref = corpora
    sel = CuratedSelector(port, backend=backend, device=device)
    r_sel = RefSelector(ref)
    for q in QUERIES:
        got = sel.select(MetaQuery(**q))
        want = r_sel.select(RefQuery(**q))
        assert got.dtype == want.dtype and np.array_equal(got, want), q
        assert np.array_equal(sel.select_reference(MetaQuery(**q)), want)
    assert (len(plain_scans) > 0) == (backend == "device")
    d, r_d = sel.describe(), r_sel.describe()
    assert d["n_rows"] == r_d["n_rows"] == port.meta.shape[0]
    assert d["meta_cols"] == r_d["meta_cols"]
    assert len(d["groups"]) == len(r_d["groups"]) >= 1


@pytest.mark.parametrize("backend,device", ROUTES)
def test_launcher_selection_matches_reference(backend, device):
    """The training launcher's corpus (50,000 docs, vocab 32,000) and
    query (``token_len`` in [seq/2, 32768) at seq 256, quality >= 0.5)."""
    q = dict(token_len=(128, 32768), quality=(0.5, 1.1))
    got = CuratedSelector(make_corpus(50_000, vocab_size=32_000),
                          backend=backend, device=device).select(
        MetaQuery(**q))
    want = RefSelector(r_make_corpus(50_000, vocab_size=32_000)).select(
        RefQuery(**q))
    assert got.size > 10_000 and np.array_equal(got, want)


@pytest.mark.parametrize("backend,device", ROUTES)
def test_curriculum_stages(corpora, backend, device):
    port, ref = corpora
    stages = [dict(token_len=(0, 512)), dict(token_len=(512, 4096)),
              dict(token_len=(4096, 32768), quality=(0.6, 1.1))]
    cur = CuratedSelector(port, backend=backend, device=device).curriculum(
        [MetaQuery(**q) for q in stages])
    want = RefSelector(ref).curriculum([RefQuery(**q) for q in stages])
    assert set(cur) == set(want) == {0, 1, 2}
    for i in want:
        assert np.array_equal(cur[i], want[i]), i
    assert len(np.intersect1d(cur[0], cur[1])) == 0


# ----------------------------- the system twin --------------------------- #

def test_end_to_end_curate_train_serve(tmp_path):
    """The port's twin of ``tests/test_system.py``: COAX selects mid-length
    docs (the same ids as the reference's), the sharded loader over the
    curated subset feeds the train loop, the trained float32 masters
    serve with COAX-routed admission."""
    corpus = make_corpus(4_000, vocab_size=256, seed=0)
    sel = CuratedSelector(corpus, device="cpu")
    docs = sel.select(MetaQuery(token_len=(128, 2048)))
    assert docs.size > 100
    assert np.array_equal(docs, sel.select_reference(
        MetaQuery(token_len=(128, 2048))))
    assert np.array_equal(docs, RefSelector(r_make_corpus(
        4_000, vocab_size=256, seed=0)).select(RefQuery(token_len=(128, 2048))))

    cfg = tiny_config(get_config("h2o-danube-3-4b"))
    assert (dataclasses.asdict(cfg)
            == dataclasses.asdict(tiny_config(r_get_config("h2o-danube-3-4b"))))
    model = build_model(cfg, device="cpu")
    loader = ShardedLoader(corpus, batch_size=2, seq_len=16, doc_ids=docs[:6],
                           seed=1)
    out = train(model, iter(loader), AdamWConfig(lr=3e-3),
                TrainLoopConfig(steps=30, ckpt_dir=str(tmp_path),
                                ckpt_every=10, log_every=1000, warmup=2),
                log_fn=lambda s: None)
    loader.close()
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

    srv = Server(model, ServeConfig(batch_size=4, max_new_tokens=4,
                                    cache_len=64, eos_token=0), device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(6):
        srv.submit(rng.integers(1, 200, int(rng.integers(4, 16))).astype(
            np.int32))
    results = srv.run_until_drained()
    assert len(results) == 6
