"""The port's vlm family (qwen2-vl-2b: M-RoPE over stub patch embeddings)
against the reference on the CPU, module by module and model by model,
and the reference's prefill/decode consistency check run on the port for
the four MoE, vlm and enc-dec archs (mixtral-8x7b, phi3.5-moe-42b-a6.6b,
qwen2-vl-2b, seamless-m4t-large-v2).

The same seeded numpy inputs and weights (the reference's ``init``,
carried over by ``repro_torch.models.convert``) go through both
packages.  Bars as in ``test_torch_models.py``: float32 activations
rtol 1e-5 / atol 1e-5 (``DTYPE`` patched in both packages), loss and
gradients rtol 1e-4 / atol 1e-5, bfloat16 rtol 0.05 / atol 0.08.  The
reference's model calls are jitted, traced after the patch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs
import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.encdec as r_ed
import repro.models.model as r_model
import repro.models.transformer as r_tf
from conftest import make_batch, tiny_config
from repro.models import build_model as r_build
from test_torch_train import _assert_trees

import repro_torch.models.attention as p_attn
import repro_torch.models.common as p_common
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params, reference_tree
from repro_torch.models.model import _vlm_positions3

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.08)
ARCH = "qwen2-vl-2b"
MOE_VLM_ENCDEC = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", ARCH,
         "seamless-m4t-large-v2"]
SECTIONS = (2, 3, 3)                # tiny_config's: hd 16, 8 bands


def _patch_f32(monkeypatch):
    for mod in (r_common, r_attn, r_tf, r_model, r_ed):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


@pytest.fixture(params=["f32", "bf16"])
def dtype(request, monkeypatch):
    """The activation dtype of both packages, and the bar it is held to."""
    if request.param == "f32":
        _patch_f32(monkeypatch)
        return jnp.float32, torch.float32, F32
    return jnp.bfloat16, torch.bfloat16, BF16


@pytest.fixture
def f32(monkeypatch):
    _patch_f32(monkeypatch)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), err_msg=what, **tol)


def _inputs(rng, shape, jdt, tdt, scale=1.0):
    a = rng.normal(0, scale, shape).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _twins(arch, seed=0):
    """(cfg, reference model, its params, the port's model), tiny."""
    cfg = tiny_config(r_configs.get_config(arch))
    ref = r_build(cfg)
    params = jax.jit(lambda key: ref.init(key)[0])(jax.random.key(seed))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


def _batches(cfg, *, batch=2, seq=16, seed=0, labels=True):
    """``make_batch``'s batch for the reference and the same values as
    torch tensors for the port (bfloat16 stubs carried exactly in
    float32; each package casts them to its ``DTYPE``)."""
    rb = make_batch(cfg, batch=batch, seq=seq, seed=seed, with_labels=labels)
    pb = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                       if v.dtype == jnp.bfloat16 else v))
          for k, v in rb.items()}
    return rb, pb


# --------------------------------------------------------------------------- #
# M-RoPE
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_mrope(dtype, theta):
    """Each frequency band turns by the id of its stream: t, h, w ids drawn
    apart (up to 500) give the reference's rotation."""
    jdt, tdt, tol = dtype
    rng = np.random.default_rng(0)
    xj, xt = _inputs(rng, (2, 6, 4, 16), jdt, tdt, 3.0)
    pos3 = rng.integers(0, 500, (2, 6, 3)).astype(np.int32)
    got = p_common.apply_mrope(xt, torch.from_numpy(pos3), SECTIONS, theta)
    assert got.dtype == tdt
    _close(got, r_common.apply_mrope(xj, jnp.asarray(pos3), SECTIONS, theta),
           tol)


def test_mrope_on_equal_streams_is_rope():
    """With the three ids equal, M-RoPE is plain RoPE, bit for bit, in the
    port as in the reference (qwen2-vl's text and its decode steps)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    for sections in (SECTIONS, (8, 0, 0), (0, 4, 4)):
        got = p_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                                   sections)
        want = p_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   1_000_000.0)
        assert torch.equal(got, want), sections
    np.testing.assert_array_equal(
        np.asarray(r_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                        SECTIONS)),
        np.asarray(r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       1_000_000.0)))


def test_mrope_sections_must_split_half_the_head():
    x, pos3 = torch.zeros((1, 2, 1, 16)), torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="sections"):
        p_common.apply_mrope(x, pos3, (2, 3, 4))


@pytest.mark.parametrize("n_patches,seq", [(4, 10), (16, 20), (1024, 1152)])
def test_vlm_positions3(n_patches, seq):
    """Patches at (0, h, w) on the sqrt(n) grid, then the text at grid + i
    on all three streams."""
    grid = int(np.sqrt(n_patches))
    got = _vlm_positions3(3, n_patches, seq, grid)
    want = r_model._vlm_positions3(3, n_patches, seq, grid)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, n_patches, 0] == grid


def _gqa_params(seed=4, d=32, h=4, kv=2, hd=16):
    params, _ = r_attn.gqa_init(jax.random.key(seed), d, h, kv, hd)
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


def test_gqa_forward_with_mrope(dtype):
    """Prefill attention rotated by M-RoPE ids: output and the cached
    (rotated) k, v equal; q and k share one table."""
    jdt, tdt, tol = dtype
    rp, pp = _gqa_params()
    rng = np.random.default_rng(5)
    xj, xt = _inputs(rng, (2, 12, 32), jdt, tdt)
    pos3 = _vlm_positions3(2, 4, 12, 2)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1_000_000.0,
              mrope_sections=SECTIONS, chunk=4)
    out_p, (k_p, v_p) = p_attn.gqa_forward(pp, xt, positions3=pos3, **kw)
    out_r, (k_r, v_r) = r_attn.gqa_forward(rp, xj, positions3=jnp.asarray(
        pos3.numpy()), **kw)
    for got, want, what in ((out_p, out_r, "out"), (k_p, k_r, "k"),
                            (v_p, v_r, "v")):
        _close(got, want, tol, what)


def test_gqa_decode_at_rope_pos(dtype):
    """Decode steps rotated to ``rope_pos`` (the decoder's tables built at
    that position, not the cache slot's): outputs and every written slot
    equal the reference's ``gqa_decode(..., rope_pos=...)``; at the slot's
    position the output moves."""
    jdt, tdt, tol = dtype
    rp, pp = _gqa_params(seed=6)
    rng = np.random.default_rng(7)
    ck_r, cv_r = jnp.zeros((2, 16, 2, 16), jdt), jnp.zeros((2, 16, 2, 16), jdt)
    ck_p, cv_p = (torch.zeros((2, 16, 2, 16), dtype=tdt) for _ in range(2))
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1_000_000.0)
    for step in range(10):
        xj, xt = _inputs(rng, (2, 1, 32), jdt, tdt)
        pos = step - 4 + 2               # step - n_patches + grid
        out_r, ck_r, cv_r = r_attn.gqa_decode(rp, xj, ck_r, cv_r,
                                              jnp.int32(step),
                                              rope_pos=jnp.int32(pos), **kw)
        tables = p_attn.decode_rope_tables(2, pos, 16, 1_000_000.0, "cpu")
        out_p, _, _ = p_attn.gqa_decode(pp, xt, ck_p, cv_p, step,
                                        tables=tables, **kw)
        _close(out_p, out_r, tol, f"step {step}")
        _close(ck_p, ck_r, tol, f"k, step {step}")
    moved, _, _ = p_attn.gqa_decode(pp, xt, ck_p.clone(), cv_p.clone(), step,
                                    **kw)
    assert not torch.allclose(moved, out_p)


# --------------------------------------------------------------------------- #
# qwen2-vl
# --------------------------------------------------------------------------- #

def test_vlm_forward_prefill_decode(dtype):
    """Forward over 4 patches + 12 text tokens, prefill of that prompt and
    10 decode steps at ``step = n_patches + 12 + i`` (RoPE position
    ``step - n_patches + grid``): logits and every cache entry equal."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(ARCH)
    rb, pb = _batches(cfg, seq=16, labels=False)
    with torch.no_grad():
        lp, aux = port.forward(pb)
    lr, _ = jax.jit(lambda p, b: ref.forward(p, b))(params, rb)
    assert tuple(lp.shape) == lr.shape == (2, 16, cfg.padded_vocab)
    assert float(aux) == 0.0
    _close(lp, lr, tol, "forward")

    lp, cache_p = port.prefill(pb, 32)
    lr, cache_r = jax.jit(lambda p, b: ref.prefill(p, b, 32))(params, rb)
    _close(lp, lr, tol, "prefill")
    assert sorted(cache_p) == sorted(cache_r) == ["k", "v"]
    for k in cache_r:
        assert tuple(cache_p[k].shape) == cache_r[k].shape
        _close(cache_p[k], cache_r[k], tol, k)
    decode = jax.jit(lambda p, c, t, i: ref.decode_step(p, c, t, i))
    toks = np.random.default_rng(8).integers(0, 200, (2, 10)).astype(np.int32)
    for i in range(10):
        step = 16 + i
        tok = toks[:, i:i + 1]
        lp, cache_p = port.decode_step(cache_p, torch.from_numpy(tok), step)
        lr, cache_r = decode(params, cache_r, jnp.asarray(tok),
                             jnp.int32(step))
        _close(lp, lr, tol, f"decode step {step}")
    for k in cache_r:
        _close(cache_p[k], cache_r[k], tol, k)


def test_vlm_logits_slices_and_cache(dtype):
    """``forward``'s "last" and "hidden" slices and ``init_cache`` match
    the reference's."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(ARCH, seed=1)
    rb, pb = _batches(cfg, seq=12, seed=1, labels=False)
    for sl in ("last", "hidden"):
        with torch.no_grad():
            lp, _ = port.forward(pb, logits_slice=sl)
        lr, _ = jax.jit(lambda p, b: ref.forward(p, b, logits_slice=sl))(
            params, rb)
        assert tuple(lp.shape) == lr.shape, sl
        _close(lp, lr, tol, sl)
    want, got = ref.init_cache(3, 20), port.init_cache(3, 20)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()


def test_vlm_loss_is_over_the_text_and_every_gradient(f32):
    """``Model.loss`` slices off the patch positions before the CE (the
    labels cover the text alone); value and every gradient equal."""
    cfg, ref, params, port = _twins(ARCH, seed=2)
    rb, pb = _batches(cfg, seq=16, seed=3)
    assert tuple(pb["labels"].shape) == (2, 16 - cfg.n_patches)
    r_val, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b)))(params, rb)
    val = port.loss(pb)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(r_val), **GRAD)
    _assert_trees(reference_tree({n: p.grad for n, p in
                                  port.named_parameters()}),
                  r_grads, GRAD, "grad")


# --------------------------------------------------------------------------- #
# the reference's consistency check, on the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", MOE_VLM_ENCDEC)
def test_prefill_decode_consistency(arch):
    """``tests/test_arch_smoke.py::test_prefill_decode_consistency`` on the
    port, at bfloat16 with its bar, with its batches (the vlm's patches,
    the enc-dec's frames): prefill's last logits equal the forward's, and
    one decode step's equal the forward over one more token."""
    cfg, _, _, port = _twins(arch, seed=1)
    rng = np.random.default_rng(0)
    S = 12
    toks = torch.from_numpy(rng.integers(0, 200, (2, S + 1)).astype(np.int32))
    _, batch = _batches(cfg, batch=2, seq=S, labels=False)
    batch_next = dict(batch, tokens=toks[:, :S + 1])
    batch["tokens"] = toks[:, :S]
    with torch.no_grad():
        full, _ = port.forward(batch)
        full2, _ = port.forward(batch_next)
    last, cache = port.prefill(batch, 32)
    np.testing.assert_allclose(last[:, -1].numpy(), full[:, -1].numpy(),
                               **BF16)
    step = S if cfg.family != "vlm" else S + cfg.n_patches
    dl, _ = port.decode_step(cache, toks[:, S:S + 1], step)
    np.testing.assert_allclose(dl[:, -1].numpy(), full2[:, -1].numpy(),
                               **BF16)
