"""The port's training path (``repro_torch.{optim,runtime.steps,
runtime.checkpoint,runtime.train_loop,launch.train}`` and ``Model.loss``)
against the reference on the CPU.

The same seeded numpy inputs and the same weights (the reference's
``model.init``, carried over by ``repro_torch.models.convert``) go
through both packages, with the activation dtype ``DTYPE`` patched to
float32 in both (as ``tests/test_torch_models.py`` does; the reference's
jitted steps trace after the patch).  Bars:

- the cross-entropy functions, value and gradient: rtol 1e-5 / atol 1e-6
  (float32 sums in another order);
- ``Model.loss``, every parameter's gradient and one train step (params,
  ``mu``, ``nu``, loss, grad norm): rtol 1e-4 / atol 1e-5;
- train-loop histories (loss, grad norm): rtol 1e-4; ``restarts`` and
  ``final_step`` equal;
- checkpoints: every array bit for bit, npz keys, shapes and dtypes and
  the manifest's ``leaves`` equal, both ways.

Histories compared across an injected failure use ``async_ckpt=False``:
the reference's restore does not wait for an in-flight save.
"""
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.encdec as r_ed
import repro.models.model as r_model
import repro.models.transformer as r_tf
from conftest import make_batch, tiny_config
from repro.configs import get_config
from repro.models import build_model as r_build
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.runtime.checkpoint import Checkpointer as RefCheckpointer
from repro.runtime.failure import FailureInjector as RefInjector
from repro.runtime.steps import make_train_step as r_make_train_step
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig
from repro.runtime.train_loop import train as r_train

import repro_torch.models.common as p_common
from repro_torch.models import build_model
from repro_torch.models.convert import (Stacked, load_reference_opt,
                                        load_reference_params, reference_tree)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.checkpoint import Checkpointer, latest_step
from repro_torch.runtime.failure import FailureInjector
from repro_torch.runtime.steps import (make_eval_step, make_prefill_step,
                                       make_serve_step, make_train_step)
from repro_torch.runtime.train_loop import (TrainLoopConfig, restore_state,
                                            state_tree, train)

CE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
ARCH = "h2o-danube-3-4b"


@pytest.fixture
def f32(monkeypatch):
    """Both packages at float32 activations."""
    for mod in (r_common, r_attn, r_tf, r_model, r_ed):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


def _np_tree(tree):
    """A reference-layout tree (``Stacked`` leaves stacked) as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, Stacked):
        return np.stack([t.detach().numpy() for t in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees(got, want, tol=None, what=""):
    got, want = _np_tree(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        name = f"{what}{jax.tree_util.keystr(path)}"
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if tol is None:
            assert np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _twins(arch=ARCH, seed=0, **over):
    import dataclasses
    cfg = dataclasses.replace(tiny_config(get_config(arch)), **over)
    ref = r_build(cfg)
    params, _ = ref.init(jax.random.key(seed))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


def _np_batch(batch):
    return {k: np.array(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("s,seq_chunk", [(16, 512), (1024, 512)],
                         ids=["whole", "chunked"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_cross_entropy_value_and_grad(s, seq_chunk, cap):
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 64
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 0.5, (v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)

    def r_loss(x, w):
        return r_common.chunked_softmax_cross_entropy(
            x, w, jnp.asarray(labels), cap=cap, seq_chunk=seq_chunk)
    r_val, (r_gx, r_gw) = jax.value_and_grad(r_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    val = p_common.chunked_softmax_cross_entropy(
        xt, wt, torch.from_numpy(labels), cap=cap, seq_chunk=seq_chunk)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(r_val), **CE)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(r_gx), **CE)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(r_gw), **CE)

    logits = rng.normal(0, 3, (b, s, v)).astype(np.float32)
    r_val, r_g = jax.value_and_grad(
        lambda l: r_common.softmax_cross_entropy(l, jnp.asarray(labels)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    val = p_common.softmax_cross_entropy(lt, torch.from_numpy(labels))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(r_val), **CE)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(r_g), **CE)


# the ssm, hybrid and MLA archs, held at the same bars
NEW = ["mamba2-130m", "zamba2-2.7b", "minicpm3-4b"]


@pytest.mark.parametrize("arch", [ARCH, "gemma2-27b"] + NEW)
def test_model_loss_and_every_gradient(f32, arch):
    cfg, ref, params, port = _twins(arch)
    batch = _np_batch(make_batch(cfg, batch=2, seq=16, seed=3))
    r_val, r_grads = jax.value_and_grad(ref.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    val = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    val.backward()
    assert val.dtype == torch.float32 and val.ndim == 0
    np.testing.assert_allclose(float(val.detach()), float(r_val), **GRAD)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())
    _assert_trees(reference_tree(grads), r_grads, GRAD, "grad")


def test_remat_full_and_none_give_the_same_gradients(monkeypatch):
    """``remat="full"`` runs each layer's forward again in the backward
    pass (2 calls a layer, 1 without) and gives the same gradients."""
    import repro_torch.models.transformer as p_tf
    calls, layer_fwd = [], p_tf._attn_layer_fwd

    def counted(*a, **k):
        calls.append(1)
        return layer_fwd(*a, **k)
    monkeypatch.setattr(p_tf, "_attn_layer_fwd", counted)
    out = []
    for remat, per_layer in (("full", 2), ("none", 1)):
        cfg, _, _, port = _twins(remat=remat)
        batch = _np_batch(make_batch(cfg, batch=2, seq=16, seed=4))
        calls.clear()
        port.loss({k: torch.from_numpy(v) for k, v in batch.items()}
                  ).backward()
        assert len(calls) == per_layer * cfg.n_layers, remat
        out.append({n: p.grad.clone() for n, p in port.named_parameters()})
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_remat_recomputes_only_the_mamba_layers(monkeypatch, arch):
    """Under ``remat="full"`` each Mamba2 layer's forward runs again in the
    backward pass (2 calls a layer, 1 without), the hybrid's shared blocks
    never (the reference's ``jax.checkpoint`` covers the Mamba2 body
    alone); the gradients are the same either way."""
    import repro_torch.models.transformer as p_tf
    calls, fns = {"mamba": 0, "attn": 0}, {}
    for key, name in (("mamba", "_mamba_layer_fwd"),
                      ("attn", "_attn_layer_fwd")):
        fns[key] = getattr(p_tf, name)

        def counted(*a, _key=key, **k):
            calls[_key] += 1
            return fns[_key](*a, **k)
        monkeypatch.setattr(p_tf, name, counted)
    out = []
    for remat, per_layer in (("full", 2), ("none", 1)):
        cfg, _, _, port = _twins(arch, remat=remat)
        n_seg = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                 else 0)
        batch = _np_batch(make_batch(cfg, batch=2, seq=16, seed=4))
        calls.update(mamba=0, attn=0)
        port.loss({k: torch.from_numpy(v) for k, v in batch.items()}
                  ).backward()
        assert calls == {"mamba": per_layer * cfg.n_layers,
                         "attn": n_seg}, remat
        out.append({n: p.grad.clone() for n, p in port.named_parameters()})
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name


# --------------------------------------------------------------------------- #
# train steps
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("microbatches,transform", [(1, False), (2, False),
                                                    (1, True)])
def test_train_step_matches_reference(f32, microbatches, transform):
    """One step of both packages' ``make_train_step`` (the reference's
    jitted).  ``eps=1e-3``: Adam's first update ``g / (|g| + eps)`` turns
    a gradient difference inside the bar into an update difference of up
    to ``eps``/(|g| + eps)^2 times it, unbounded as |g| nears the default
    eps of 1e-8 (one element in 8192 then moves by 7e-5); eps 1e-3 keeps
    the amplification under 250, so the parameters hold at the bar."""
    cfg, ref, params, port = _twins()
    batch = _np_batch(make_batch(cfg, batch=4, seq=16, seed=5))
    sched = lambda step: 2e-3 * step           # noqa: E731
    r_tf_ = (lambda g: jax.tree.map(lambda x: x * 0.5, g)) if transform else None
    p_tf = (lambda g: {k: v * 0.5 for k, v in g.items()}) if transform else None
    r_step = jax.jit(r_make_train_step(
        ref, RefAdamWConfig(lr=1e-3, eps=1e-3), sched, r_tf_,
        microbatches))
    r_state = r_adamw_init(params)
    r_params, r_state, r_m = r_step(params, r_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    state = adamw_init(port)
    step = make_train_step(port, AdamWConfig(lr=1e-3, eps=1e-3), sched, p_tf,
                           microbatches)
    m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]), **GRAD)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(r_m["grad_norm"]), **GRAD)
    np.testing.assert_allclose(m["lr"], float(r_m["lr"]), rtol=1e-6)
    assert state["step"] == int(r_state["step"]) == 1
    _assert_trees(reference_tree(port), r_params, GRAD, "params")
    _assert_trees(reference_tree(state["mu"]), r_state["mu"], GRAD, "mu")
    _assert_trees(reference_tree(state["nu"]), r_state["nu"], GRAD, "nu")
    assert all(p.grad is None for p in port.parameters())


# the MoE, vlm and enc-dec families and the dense archs the card serves
# since they were added to the smoke, held at the same bars
CARD = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
        "seamless-m4t-large-v2", "gemma2-27b", "minitron-4b"]


@pytest.mark.parametrize("arch", NEW + CARD)
def test_train_step_of_the_new_families_matches_reference(f32, arch):
    """One jitted reference step against one port step (AdamW eps 1e-3,
    see above) for the ssm, hybrid and MLA archs, the MoEs (tiny: 4
    experts, top-2, capacity factor 8), the vlm (4 stub patches), the
    enc-dec (16 stub frames) and the two dense archs new to the card:
    loss, grad norm, parameters, ``mu`` and ``nu``.  The stubs reach the
    reference as ``make_batch`` gives them (bfloat16) and the port as the
    same values in float32; each package casts them to float32."""
    cfg, ref, params, port = _twins(arch)
    r_batch = make_batch(cfg, batch=2, seq=16, seed=9)
    batch = {k: np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                         else v) for k, v in r_batch.items()}
    r_step = jax.jit(r_make_train_step(ref, RefAdamWConfig(lr=1e-3,
                                                           eps=1e-3)))
    r_state = r_adamw_init(params)
    r_params, r_state, r_m = r_step(params, r_state, r_batch)
    state = adamw_init(port)
    m = make_train_step(port, AdamWConfig(lr=1e-3, eps=1e-3))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]), **GRAD)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(r_m["grad_norm"]), **GRAD)
    _assert_trees(reference_tree(port), r_params, GRAD, "params")
    _assert_trees(reference_tree(state["mu"]), r_state["mu"], GRAD, "mu")
    _assert_trees(reference_tree(state["nu"]), r_state["nu"], GRAD, "nu")


def _smoke():
    """``chip_smoke.py`` loaded as a module (it imports no torch or
    package code until a phase runs)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _specs(tree):
    """{key: (shape, dtype name)} of a batch or of ``input_specs``."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2",
                                  "mixtral-8x7b"])
def test_smoke_stub_batches_are_seeded_and_shaped_as_the_reference_specs(
        arch):
    """``chip_smoke.with_stubs`` adds the vlm's patches and the enc-dec's
    frames to the loader's batches: the same seed gives the same batches,
    another seed other stubs, each batch fresh draws; keys, shapes and
    dtypes are the reference's ``Model.input_specs`` of a train cell (the
    enc-dec's frames at their own length); an MoE's batches pass as they
    are."""
    from repro.configs.base import ShapeConfig as RefShape
    smoke = _smoke()
    cfg = tiny_config(get_config(arch))
    port = build_model(cfg, device="meta")
    rng = np.random.default_rng(0)
    b, s = 2, 12
    loader = []
    for _ in range(2):
        toks = rng.integers(0, 200, (b, s + 1)).astype(np.int32)
        loader.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    for n_stub in (s, 20):
        runs = [list(smoke.with_stubs(torch, iter(loader), port, n_stub,
                                      seed)) for seed in (3, 3, 4)]
        stubs = [k for k in runs[0][0] if k not in ("tokens", "labels")]
        assert stubs == {"vlm": ["patches"], "encdec": ["frames"]}.get(
            cfg.family, [])
        for got, again, other, src in zip(*runs, loader):
            assert got.keys() == again.keys() == other.keys()
            for k in ("tokens", "labels"):
                assert got[k] is src[k]
            for k in stubs:
                assert torch.equal(got[k], again[k])
                assert not torch.equal(got[k], other[k])
        for k in stubs:
            assert not torch.equal(runs[0][0][k], runs[0][1][k])
        seq = cfg.n_patches + s if cfg.family == "vlm" else s
        want = _specs(r_build(cfg).input_specs(RefShape("t", seq, b,
                                                        "train")))
        got = _specs(runs[0][0])
        if cfg.family == "encdec":
            shape, dt = want["frames"]
            want["frames"] = ((b, n_stub, shape[2]), dt)
        assert got == want, (n_stub, got, want)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_smoke_train_bound_counts_the_work_of_each_family(arch):
    """``chip_smoke.train_bound_ms`` at full size (the port's model on
    ``meta``, the reference's counts from its parameter shapes): the
    model-FLOP term is 6 x the parameters x the positions they meet (an
    MoE's active parameters the text tokens, the vlm's parameters the
    patches and the text, the enc-dec's encoder the frames and the rest
    the text), over the bfloat16 peak; AdamW's term reads and writes 28
    bytes of every parameter at the memory rate; the bound is their
    sum."""
    smoke = _smoke()
    cfg = get_config(arch)
    ref = r_build(cfg)
    b, s, frames = 8, 256, 1024
    n = ref.param_count()
    if cfg.family == "encdec":
        shapes = jax.eval_shape(lambda k: ref.init(k)[0], jax.random.key(0))
        n_enc = sum(int(np.prod(x.shape)) for key in ("enc_layers",
                                                      "enc_norm")
                    for x in jax.tree.leaves(shapes[key]))
        assert 0 < n_enc < n
        work = n_enc * b * frames + (n - n_enc) * b * s
    elif cfg.family == "vlm":
        work = n * b * (cfg.n_patches + s)
    else:
        work = ref.active_param_count() * b * s
        assert (work < n * b * s) == bool(cfg.n_experts)
    bound, flop_ms, opt_ms = smoke.train_bound_ms(
        build_model(cfg, device="meta"), b, s, frames)
    assert flop_ms == pytest.approx(6 * work / 989e12 * 1e3, rel=1e-12)
    assert opt_ms == pytest.approx(28 * n / 3.35e12 * 1e3, rel=1e-12)
    assert bound == pytest.approx(flop_ms + opt_ms, rel=1e-12)


def test_a_step_that_raises_changes_nothing():
    cfg, _, _, port = _twins()
    batch = _np_batch(make_batch(cfg, batch=2, seq=16, seed=6))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    state = adamw_init(port)

    def boom(grads):
        raise RuntimeError("transform failed")
    step = make_train_step(port, AdamWConfig(), grad_transform=boom)
    with pytest.raises(RuntimeError, match="transform failed"):
        step(state, batch)
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]) and p.grad is None, n
    assert state["step"] == 0
    assert all(not t.any() for t in state["mu"].values())


def test_eval_prefill_and_serve_steps(f32):
    cfg, ref, params, port = _twins()
    batch = _np_batch(make_batch(cfg, batch=2, seq=16, seed=7))
    loss = make_eval_step(port)(batch)
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(ref.loss(
        params, {k: jnp.asarray(v) for k, v in batch.items()})), **GRAD)
    logits, cache = make_prefill_step(port, 32)({"tokens": batch["tokens"]})
    logits2, _ = make_serve_step(port)(cache, torch.from_numpy(
        batch["tokens"][:, :1]), 16)
    assert logits.shape == logits2.shape == (2, 1, cfg.padded_vocab)


# --------------------------------------------------------------------------- #
# checkpoints: twins of the reference's tests
# --------------------------------------------------------------------------- #

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck.save(7, tree)
    into = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
    out = ck.restore(into)
    assert out["a"] is into["a"] and out["b"]["c"] is into["b"]["c"]
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert latest_step(tmp_path) == 7
    assert ck.manifest()["step"] == 7
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
        assert z["b//c"].dtype == np.dtype("V2")
    assert ck.manifest()["leaves"]["b//c"] == {"shape": [4],
                                               "dtype": "bfloat16"}


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(tmp_path)
    x = torch.arange(3, dtype=torch.int32)
    ck.save_async(5, {"x": x})
    x.fill_(9)                      # the host copy was taken at the call
    ck.wait()
    assert latest_step(tmp_path) == 5
    out = ck.restore({"x": torch.zeros(3, dtype=torch.int32)})
    assert out["x"].tolist() == [0, 1, 2]


def test_checkpoint_atomicity(tmp_path):
    """A leftover temp dir must never be picked up as a checkpoint."""
    ck = Checkpointer(tmp_path)
    (tmp_path / ".tmp.step_00000009").mkdir()
    ck.save(3, {"x": torch.zeros(1)})
    assert latest_step(tmp_path) == 3


def test_restore_checks_every_leaf_before_writing(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.ones(2), "b": torch.ones(3)})
    a = torch.zeros(2)
    with pytest.raises(KeyError, match="missing leaf 'c'"):
        ck.restore({"a": a, "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="'b'"):
        ck.restore({"a": a, "b": torch.zeros(4)})
    assert not a.any()


# --------------------------------------------------------------------------- #
# checkpoints across the packages
# --------------------------------------------------------------------------- #

def _ref_state(cfg, ref, params):
    """The reference's params and AdamW state after one train step."""
    step = jax.jit(r_make_train_step(ref, RefAdamWConfig(lr=1e-3)))
    batch = make_batch(cfg, batch=2, seq=16, seed=8)
    params, opt, _ = step(params, r_adamw_init(params), batch)
    return params, opt


def _npz(path):
    with np.load(path / "arrays.npz") as z:
        return {k: (z[k].shape, z[k].dtype) for k in z.files}


def _cross_both_ways(tmp_path, arch):
    cfg, ref, params, port = _twins(arch)
    params, opt = _ref_state(cfg, ref, params)
    RefCheckpointer(tmp_path / "ref").save(3, {"params": params, "opt": opt})

    state = adamw_init(port)
    restore_state(Checkpointer(tmp_path / "ref"), port, state)
    _assert_trees(reference_tree(port), params, None, "params")
    _assert_trees(reference_tree(state["mu"]), opt["mu"], None, "mu")
    _assert_trees(reference_tree(state["nu"]), opt["nu"], None, "nu")
    assert state["step"] == 1

    Checkpointer(tmp_path / "port").save(3, state_tree(port, state))
    template = jax.tree.map(jnp.zeros_like, {"params": params, "opt": opt})
    back = RefCheckpointer(tmp_path / "port").restore(template)
    _assert_trees(reference_tree(port), back["params"], None, "params")
    _assert_trees(reference_tree(state["mu"]), back["opt"]["mu"], None)
    assert int(back["opt"]["step"]) == 1

    assert (_npz(tmp_path / "ref" / "step_00000003")
            == _npz(tmp_path / "port" / "step_00000003"))
    man = [c.manifest() for c in (RefCheckpointer(tmp_path / "ref"),
                                  Checkpointer(tmp_path / "port"))]
    assert man[0]["leaves"] == man[1]["leaves"] and man[0]["step"] == 3
    return cfg, man[1]["leaves"]


def test_checkpoints_cross_the_packages_both_ways(tmp_path):
    _, leaves = _cross_both_ways(tmp_path, ARCH)
    assert leaves["params//layers//attn//wq"]["shape"][0] == 2


@pytest.mark.parametrize("arch", NEW)
def test_new_family_checkpoints_cross_the_packages_both_ways(tmp_path, arch):
    """The ssm, hybrid and MLA trees, optimizer state included, both ways:
    zamba2's ``shared`` stack of ``n_shared_attn`` blocks beside its
    ``layers``, the Mamba2 leaves under ``layers//mamba``."""
    cfg, leaves = _cross_both_ways(tmp_path, arch)
    if cfg.family in ("ssm", "hybrid"):
        assert leaves["params//layers//mamba//norm"] == {
            "shape": [cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_p],
            "dtype": "float32"}
    if cfg.family == "hybrid":
        assert leaves["params//shared//attn//wq"]["shape"][0] == 2
        assert leaves["opt//mu//shared//mlp//w_in"]["shape"][0] == 2


def _as_cast(params):
    """The reference tree cast as ``cast_params`` casts: every leaf of two
    or more dims a layer, but a Mamba2 ``norm``, to bfloat16."""
    def cast(path, x):
        per_layer = x.ndim - (path[0].key in ("layers", "shared"))
        if per_layer < 2 or path[-1].key == "norm":
            return x
        return x.astype(jnp.bfloat16)
    return jax.tree_util.tree_map_with_path(cast, params)


def test_bfloat16_checkpoints_cross_the_packages(tmp_path):
    """A cast (serving) model's bfloat16 matrices travel as 2-byte void in
    both directions, norm scales as float32."""
    _bf16_both_ways(tmp_path, ARCH)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_bfloat16_new_family_checkpoints_cross_the_packages(tmp_path, arch):
    """As above for the ssm and hybrid trees: conv taps and projections
    bfloat16; ``A_log``, ``dt_bias``, ``D`` and the gated norm's
    ``(H, P)`` scale float32, as ``cast_params`` keeps them."""
    leaves = _bf16_both_ways(tmp_path, arch)
    assert leaves["params//layers//mamba//norm"]["dtype"] == "float32"
    assert leaves["params//layers//mamba//conv_x"]["dtype"] == "bfloat16"


def _bf16_both_ways(tmp_path, arch):
    cfg, ref, params, port = _twins(arch)
    p_common.cast_params(port)
    r_bf = _as_cast(params)
    RefCheckpointer(tmp_path / "ref").save(1, {"params": r_bf})
    Checkpointer(tmp_path / "port").save(1, {"params": reference_tree(port)})
    assert (_npz(tmp_path / "ref" / "step_00000001")
            == _npz(tmp_path / "port" / "step_00000001"))
    assert (RefCheckpointer(tmp_path / "ref").manifest()["leaves"]
            == Checkpointer(tmp_path / "port").manifest()["leaves"])
    _, _, _, other = _twins(arch, seed=1)
    p_common.cast_params(other)
    Checkpointer(tmp_path / "ref").restore({"params": reference_tree(other)})
    for (n, a), b in zip(port.named_parameters(), other.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    back = RefCheckpointer(tmp_path / "port").restore({"params": r_bf})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(r_bf)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32))
    return Checkpointer(tmp_path / "port").manifest()["leaves"]


def test_load_reference_opt_fills_the_state_in_place():
    cfg, ref, params, port = _twins()
    params, opt = _ref_state(cfg, ref, params)
    state = adamw_init(port)
    mu = state["mu"]["layers.1.mlp.w_in"]
    load_reference_opt(state, jax.tree.map(np.asarray, opt))
    assert state["mu"]["layers.1.mlp.w_in"] is mu and mu.any()
    _assert_trees(reference_tree(state["nu"]), opt["nu"], None, "nu")
    assert state["step"] == 1
    bad = jax.tree.map(np.asarray, opt)
    bad["mu"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_reference_opt(state, bad)


# --------------------------------------------------------------------------- #
# the train loop: twins of the reference's tests, histories held
# --------------------------------------------------------------------------- #

def _data(cfg, seed=0, jnp_arrays=False):
    i = 0
    while True:
        b = make_batch(cfg, batch=2, seq=16, seed=seed + i)
        yield b if jnp_arrays else _np_batch(b)
        i += 1


def _seeded(tmp_path, cfg, ref):
    """Two checkpoint directories holding the reference's step-0 state."""
    params, _ = ref.init(jax.random.key(0))
    RefCheckpointer(tmp_path / "seed").save(
        0, {"params": params, "opt": r_adamw_init(params)})
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
    return str(tmp_path / "ref"), str(tmp_path / "port")


def _both(tmp_path, steps, opt_lr, seed_dirs=True, injector=None, **loop):
    cfg, ref, _, port = _twins()
    d_ref, d_port = (_seeded(tmp_path, cfg, ref) if seed_dirs
                     else (str(tmp_path / "ref"), str(tmp_path / "port")))
    quiet = lambda s: None                   # noqa: E731
    r_out = r_train(ref, _data(cfg, jnp_arrays=True), RefAdamWConfig(lr=opt_lr),
                    RefLoopConfig(steps=steps, ckpt_dir=d_ref, log_every=1000,
                                  **loop),
                    failure_injector=injector and RefInjector(injector),
                    log_fn=quiet)
    p_out = train(port, _data(cfg), AdamWConfig(lr=opt_lr),
                  TrainLoopConfig(steps=steps, ckpt_dir=d_port,
                                  log_every=1000, **loop),
                  failure_injector=injector and FailureInjector(injector),
                  log_fn=quiet)
    return r_out, p_out, (d_ref, d_port), port


def _same_history(r_out, p_out):
    hr, hp = r_out["history"], p_out["history"]
    assert [h["step"] for h in hp] == [h["step"] for h in hr]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hp], [h[key] for h in hr],
                                   rtol=1e-4, err_msg=key)
    assert p_out["restarts"] == r_out["restarts"]
    assert p_out["final_step"] == r_out["final_step"]


def test_train_loop_loss_decreases(tmp_path, f32):
    r_out, p_out, (_, d_port), _ = _both(tmp_path, 30, 3e-3, ckpt_every=10,
                                         warmup=2)
    _same_history(r_out, p_out)
    losses = [h["loss"] for h in p_out["history"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert latest_step(d_port) == 30


def test_train_loop_resume_continues(tmp_path, f32):
    _, _, dirs, _ = _both(tmp_path, 10, 1e-3, ckpt_every=5)
    cfg, ref, _, port = _twins()
    quiet = lambda s: None                   # noqa: E731
    r_out = r_train(ref, _data(cfg, jnp_arrays=True), RefAdamWConfig(lr=1e-3),
                    RefLoopConfig(steps=15, ckpt_dir=dirs[0], ckpt_every=5,
                                  log_every=1000), log_fn=quiet)
    p_out = train(port, _data(cfg), AdamWConfig(lr=1e-3),
                  TrainLoopConfig(steps=15, ckpt_dir=dirs[1], ckpt_every=5,
                                  log_every=1000), log_fn=quiet)
    # resumed from 10, ran to 15
    assert p_out["history"][0]["step"] >= 10
    assert p_out["final_step"] == 15
    _same_history(r_out, p_out)


def test_train_loop_failure_injection_recovers(tmp_path, f32):
    r_out, p_out, _, port = _both(tmp_path, 12, 1e-3, injector=(7,),
                                  ckpt_every=5, async_ckpt=False)
    assert p_out["restarts"] == 1
    assert p_out["final_step"] == 12
    _same_history(r_out, p_out)
    assert p_out["params"]["embed"] is port.embed


def test_train_loop_without_checkpoints_inits_from_the_seed():
    cfg, _, _, port = _twins()
    out = train(port, _data(cfg), AdamWConfig(lr=1e-3),
                TrainLoopConfig(steps=3, seed=5), log_fn=lambda s: None)
    assert out["final_step"] == 3 and len(out["history"]) == 3
    assert out["opt_state"]["step"] == 3
    _, _, _, again = _twins()
    train(again, _data(cfg), AdamWConfig(lr=1e-3),
          TrainLoopConfig(steps=3, seed=5), log_fn=lambda s: None)
    for a, b in zip(port.parameters(), again.parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------------- #

SMALL = ["--arch", ARCH, "--reduced-layers", "2", "--reduced-width", "64",
         "--device", "cpu"]


def test_train_launcher_then_serve_restores_it(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch
    ck = str(tmp_path / "ck")
    args = SMALL + ["--curate", "--batch", "2", "--seq", "32",
                    "--ckpt-every", "3", "--ckpt-dir", ck]
    out = launch.main(args + ["--steps", "6"])
    assert out["final_step"] == 6 and latest_step(ck) == 6
    out = launch.main(args + ["--steps", "8"])
    assert out["history"][0]["step"] == 6 and out["final_step"] == 8
    text = capsys.readouterr().out
    assert "COAX curation" in text and "resumed from step 6" in text
    srv = serve.main(SMALL + ["--ckpt-dir", ck, "--requests", "4",
                              "--max-new", "5"])
    assert "restored step 8" in capsys.readouterr().out
    with np.load(tmp_path / "ck" / "step_00000008" / "arrays.npz") as z:
        want = torch.from_numpy(z["params//layers//attn//wq"][1])
        norm = torch.from_numpy(z["params//final_norm"])
    model = srv.model
    assert torch.equal(model.layers[1].attn["wq"],
                       want.to(model.layers[1].attn["wq"].dtype))
    assert torch.equal(model.final_norm, norm)


def test_train_launcher_refuses_a_mesh(capsys):
    """A mesh outside a job of as many ranks (here one process) is
    refused with the torchrun command that runs it."""
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit):
        launch.main(SMALL + ["--mesh-data", "2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err


def test_train_launcher_default_arch_is_not_ported(tmp_path, monkeypatch,
                                                  capsys):
    """The launcher's default arch, mamba2-130m (the ssm family), once
    refused, now trains: ``--device cpu --reduced-layers 2 --steps 2``
    with no ``--arch`` (its checkpoints under the default directory, here
    a fresh temporary one) runs to step 2 with a finite loss."""
    import tempfile
    from repro_torch.launch import train as launch
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = launch.main(["--device", "cpu", "--reduced-layers", "2",
                       "--steps", "2"])
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "mamba2-130m" in capsys.readouterr().out
    assert latest_step(tmp_path / "repro_launch_ckpt") == 2
