"""The port's enc-dec family (seamless-m4t-large-v2: a bidirectional
encoder over stub frame embeddings, a decoder with cross-attention)
against the reference on the CPU, and ``convert`` both ways on the new
parameter trees (``enc_layers``, ``dec_layers``, an MoE layer's ``moe``).

Same inputs, weights and bars as ``test_torch_vlm.py`` (whose helpers
this file uses): float32 activations rtol 1e-5 / atol 1e-5, loss and
gradients rtol 1e-4 / atol 1e-5, bfloat16 rtol 0.05 / atol 0.08.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs
import repro.models.attention as r_attn
import repro.models.encdec as r_ed
from repro.models import build_model as r_build
from test_torch_train import _assert_trees, _cross_both_ways, _np_tree
from test_torch_vlm import (GRAD, _batches, _close, _inputs, _twins,
                            dtype, f32)  # noqa: F401  (fixtures)

import repro_torch.models.attention as p_attn
import repro_torch.models.encdec as p_ed
from repro_torch.models import build_model
from repro_torch.models.convert import (Stacked, load_reference_params,
                                        reference_tree)

ARCH = "seamless-m4t-large-v2"


def _gqa_params(seed, d=32, h=4, kv=4, hd=8):
    params, _ = r_attn.gqa_init(jax.random.key(seed), d, h, kv, hd)
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


@pytest.mark.parametrize("chunk", [4, 1024])
def test_cross_kv_and_cross_attention(dtype, chunk):
    """The encoder's (k, v) from ``wk``/``wv`` and the decoder's
    non-causal, RoPE-free attention over them, in KV chunks of
    ``min(chunk, Se)``: equal."""
    jdt, tdt, tol = dtype
    rp, pp = _gqa_params(1)
    rng = np.random.default_rng(2)
    ej, et = _inputs(rng, (2, 12, 32), jdt, tdt)
    xj, xt = _inputs(rng, (2, 5, 32), jdt, tdt)
    kw = dict(n_kv=4, head_dim=8)
    k_p, v_p = p_attn.cross_kv(pp, et, **kw)
    k_r, v_r = r_attn.cross_kv(rp, ej, **kw)
    _close(k_p, k_r, tol, "k")
    _close(v_p, v_r, tol, "v")
    out_p = p_attn.cross_attn_forward(pp, xt, (k_p, v_p), n_heads=4,
                                      chunk=chunk, **kw)
    out_r = r_attn.cross_attn_forward(rp, xj, (k_r, v_r), n_heads=4,
                                      chunk=chunk, **kw)
    assert out_p.dtype == tdt and tuple(out_p.shape) == (2, 5, 32)
    _close(out_p, out_r, tol, "out")


def test_encode(dtype):
    """The bidirectional encoder (RoPE on the frames, GELU MLP, final
    norm) over 16 stub frames."""
    jdt, tdt, tol = dtype
    cfg, _, params, port = _twins(ARCH)
    rng = np.random.default_rng(3)
    fj, ft = _inputs(rng, (2, 16, cfg.d_model), jdt, tdt)
    with torch.no_grad():
        got = p_ed.encode(port, cfg, ft, chunk=8)
    want = jax.jit(lambda p, f: r_ed.encode(p, cfg, f, chunk=8))(params, fj)
    assert got.dtype == tdt
    _close(got, want, tol)


def test_encdec_forward_prefill_decode(dtype):
    """Forward over 16 frames and 16 target tokens; prefill of the frames
    and a 1-token prompt (the reference's ``input_specs``) into a cache of
    24, its self and cross caches equal; 10 decode steps, logits and the
    in-place self cache equal, the cross caches unchanged."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(ARCH)
    rb, pb = _batches(cfg, seq=16, labels=False)
    with torch.no_grad():
        lp, aux = port.forward(pb)
    lr, _ = jax.jit(lambda p, b: ref.forward(p, b))(params, rb)
    assert tuple(lp.shape) == lr.shape and float(aux) == 0.0
    _close(lp, lr, tol, "forward")

    rb, pb = dict(rb, tokens=rb["tokens"][:, :1]), dict(
        pb, tokens=pb["tokens"][:, :1])
    lp, cache_p = port.prefill(pb, 24)
    lr, cache_r = jax.jit(lambda p, b: ref.prefill(p, b, 24))(params, rb)
    _close(lp, lr, tol, "prefill")
    assert sorted(cache_p) == sorted(cache_r) == ["ck", "cv", "k", "v"]
    for k in cache_r:
        assert tuple(cache_p[k].shape) == cache_r[k].shape, k
        assert cache_p[k].dtype == tdt, k
        _close(cache_p[k], cache_r[k], tol, k)
    cross = {k: cache_p[k].clone() for k in ("ck", "cv")}
    decode = jax.jit(lambda p, c, t, i: ref.decode_step(p, c, t, i))
    toks = np.random.default_rng(4).integers(0, 200, (2, 10)).astype(np.int32)
    for i in range(10):
        tok = toks[:, i:i + 1]
        lp, cache_p = port.decode_step(cache_p, torch.from_numpy(tok), 1 + i)
        lr, cache_r = decode(params, cache_r, jnp.asarray(tok),
                             jnp.int32(1 + i))
        _close(lp, lr, tol, f"decode step {1 + i}")
    for k in cache_r:
        _close(cache_p[k], cache_r[k], tol, k)
    assert all(torch.equal(cache_p[k], cross[k]) for k in cross)


def test_encdec_cache_spec_and_logits_slices(dtype):
    """``init_cache(..., enc_len=...)`` has the reference's entries and
    shapes (zeros; ``enc_len`` defaults to ``cache_len``), and the
    forward's "last" and "hidden" slices equal the reference's."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(ARCH, seed=1)
    for enc_len in (None, 7):
        want = ref.init_cache(3, 20, enc_len=enc_len)
        got = port.init_cache(3, 20, enc_len=enc_len)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == tdt and not got[k].any(), k
    rb, pb = _batches(cfg, seq=12, seed=1, labels=False)
    for sl in ("last", "hidden"):
        with torch.no_grad():
            lp, _ = port.forward(pb, logits_slice=sl)
        lr, _ = jax.jit(lambda p, b: ref.forward(p, b, logits_slice=sl))(
            params, rb)
        assert tuple(lp.shape) == lr.shape, sl
        _close(lp, lr, tol, sl)


def test_encdec_loss_and_every_gradient(f32):
    """``Model.loss`` (the decoder's CE through the tied ``embed``) and the
    gradient of every parameter of both stacks."""
    cfg, ref, params, port = _twins(ARCH, seed=2)
    rb, pb = _batches(cfg, seq=16, seed=3)
    r_val, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b)))(params, rb)
    val = port.loss(pb)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(r_val), **GRAD)
    _assert_trees(reference_tree({n: p.grad for n, p in
                                  port.named_parameters()}),
                  r_grads, GRAD, "grad")
    assert np.abs(np.asarray(r_grads["enc_layers"]["attn"]["wq"])).max() > 0


def test_encdec_layout_and_full_size():
    """The enc-dec holds its two stacks and norms, unembeds with ``embed``
    (no ``unembed``, no ``layers``), counts the reference's parameters at
    full size on ``meta``, and its decoder layer's names are the
    reference's."""
    cfg = r_configs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    assert model.param_count() == r_build(cfg).param_count() == 1_369_827_328
    assert len(model.enc_layers) == cfg.enc_layers == 24
    assert len(model.dec_layers) == cfg.n_layers == 24
    assert not hasattr(model, "layers") and not hasattr(model, "unembed")
    assert sorted(n for n, _ in model.dec_layers[0].named_parameters()) == [
        "attn.wk", "attn.wo", "attn.wq", "attn.wv", "ln1", "ln2", "lnx",
        "mlp.w_in", "mlp.w_out", "xattn.wk", "xattn.wo", "xattn.wq",
        "xattn.wv"]


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "qwen2-vl-2b"])
def test_convert_carries_the_new_trees_both_ways(arch):
    """``reference_tree`` of a loaded port model is the reference's tree,
    every leaf bit for bit (the enc-dec's two stacks, the MoE's expert
    stacks (L, E, ...)); a stack of the wrong length is refused."""
    cfg, _, params, port = _twins(arch)
    want = jax.tree.map(np.asarray, params)
    got = _np_tree(reference_tree(port))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    stack = "enc_layers" if cfg.family == "encdec" else "layers"
    assert isinstance(reference_tree(port)[stack]["ln1"], Stacked)
    if cfg.n_experts:
        assert got["layers"]["moe"]["w_in"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    bad = dict(want, **{stack: jax.tree.map(lambda a: a[:1], want[stack])})
    with pytest.raises(ValueError, match=f"'{stack}'"):
        load_reference_params(build_model(cfg, device="cpu"), bad)


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "qwen2-vl-2b"])
def test_moe_vlm_encdec_checkpoints_cross_the_packages_both_ways(tmp_path,
                                                                 arch):
    """The enc-dec, MoE and vlm trees, AdamW state included (one reference
    train step on ``make_batch``'s frames or patches), both ways: npz
    keys, shapes and dtypes and the manifest's leaves equal, every array
    bit for bit (``_cross_both_ways``)."""
    cfg, leaves = _cross_both_ways(tmp_path, arch)
    if cfg.family == "encdec":
        assert leaves["params//enc_layers//attn//wq"]["shape"][0] == \
            cfg.enc_layers
        assert leaves["opt//nu//dec_layers//xattn//wk"]["shape"][0] == \
            cfg.n_layers
    if cfg.n_experts:
        assert leaves["opt//mu//layers//moe//w_in"]["shape"] == [
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff]
