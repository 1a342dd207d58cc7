"""The port's dense decoder (``repro_torch.models``) against the reference
(``repro.models``) on the CPU, module by module and model by model.

The same numpy inputs and the same weights (the reference's
``model.init(jax.random.key(seed))``, carried over by
``repro_torch.models.convert``) go through both packages.  Two bars:

- **float32**: both packages run with their activation dtype ``DTYPE``
  set to float32 (``monkeypatch`` on ``repro.models.{common,attention,
  transformer,model}.DTYPE`` and ``repro_torch.models.common.DTYPE``;
  nothing in either package changes).  Logits agree to rtol 1e-5 /
  atol 1e-5: the two differ only in the order of float32 sums.
- **bfloat16**, the shipped dtype: rtol 0.05 / atol 0.08, the
  reference's own bar between prefill and forward
  (``tests/test_arch_smoke.py``).

The reference runs eagerly (no ``jax.jit``), so the patched ``DTYPE`` is
read on every call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs
import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.model as r_model
import repro.models.transformer as r_tf
from conftest import tiny_config
from repro.models import build_model as r_build

import repro_torch.configs as p_configs
import repro_torch.models.attention as p_attn
import repro_torch.models.common as p_common
from repro_torch.models import Model, build_model
from repro_torch.models.convert import load_reference_params

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.08)
DENSE = ["h2o-danube-3-4b", "gemma2-27b", "minitron-4b"]
# (arch, split_local_cache): gemma2 runs flat and with paired caches
MODELS = [("h2o-danube-3-4b", False), ("gemma2-27b", False),
          ("gemma2-27b", True), ("minitron-4b", False)]


@pytest.fixture(params=["f32", "bf16"])
def dtype(request, monkeypatch):
    """The activation dtype of both packages, and the bar it is held to."""
    if request.param == "f32":
        for mod in (r_common, r_attn, r_tf, r_model):
            monkeypatch.setattr(mod, "DTYPE", jnp.float32)
        monkeypatch.setattr(p_common, "DTYPE", torch.float32)
        return jnp.float32, torch.float32, F32
    return jnp.bfloat16, torch.bfloat16, BF16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.array(a)).to(dt)


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), err_msg=what, **tol)


def _inputs(rng, shape, jdt, tdt, scale=1.0):
    a = (rng.normal(0, scale, shape)).astype(np.float32)
    return jnp.asarray(a, jdt), _t(a, tdt)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #

def test_configs_are_the_references():
    assert p_configs.list_configs() == r_configs.list_configs()
    for name in r_configs.list_configs():
        assert (dataclasses.asdict(p_configs.get_config(name))
                == dataclasses.asdict(r_configs.get_config(name))), name
    assert ({k: dataclasses.asdict(v) for k, v in p_configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()})
    from repro.configs.paper_coax import CONFIG as r_paper
    from repro_torch.configs.paper_coax import CONFIG as p_paper
    assert dataclasses.asdict(p_paper) == dataclasses.asdict(r_paper)
    with pytest.raises(KeyError):
        p_configs.get_config("no-such-arch")


# --------------------------------------------------------------------------- #
# per module
# --------------------------------------------------------------------------- #

def test_rmsnorm_softcap_and_rope(dtype):
    jdt, tdt, tol = dtype
    rng = np.random.default_rng(0)
    xj, xt = _inputs(rng, (2, 6, 4, 16), jdt, tdt, 3.0)
    sj, st = _inputs(rng, (16,), jnp.float32, torch.float32)
    _close(p_common.rmsnorm(xt, st, 1e-6), r_common.rmsnorm(xj, sj, 1e-6), tol)
    _close(p_common.softcap(xt.float(), 2.5),
           r_common.softcap(xj.astype(jnp.float32), 2.5), tol)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(p_common.apply_rope(xt, torch.from_numpy(pos), theta),
               r_common.apply_rope(xj, jnp.asarray(pos), theta), tol,
               f"rope theta={theta}")


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply(dtype, act, gated):
    jdt, tdt, tol = dtype
    params, _ = r_common.mlp_init(jax.random.key(3), 32, 64, gated=gated)
    p_params = {k: _t(np.asarray(v)) for k, v in params.items()}
    rng = np.random.default_rng(1)
    xj, xt = _inputs(rng, (2, 5, 32), jdt, tdt)
    r_act = jax.nn.silu if act == "silu" else jax.nn.gelu
    p_act = p_common.silu if act == "silu" else p_common.gelu
    _close(p_common.mlp_apply(p_params, xt, act=p_act),
           r_common.mlp_apply(params, xj, act=r_act), tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(p_common.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


ATTN_CASES = {
    "causal": dict(causal=True),
    "windowed": dict(causal=True, window=5),
    "softcapped": dict(causal=True, attn_softcap=3.0, scale=0.4),
    "chunks_window_cap": dict(causal=True, window=7, attn_softcap=5.0,
                              chunk=4),
    "non_causal_offset": dict(causal=False, q_offset=3, chunk=8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention(dtype, case):
    jdt, tdt, tol = dtype
    kw = {"chunk": 16, **ATTN_CASES[case]}
    rng = np.random.default_rng(2)
    qj, qt = _inputs(rng, (2, 16, 4, 8), jdt, tdt, 2.0)
    kj, kt = _inputs(rng, (2, 16, 2, 8), jdt, tdt, 2.0)
    vj, vt = _inputs(rng, (2, 16, 2, 8), jdt, tdt)
    got = p_attn.chunked_attention(qt, kt, vt, **kw)
    assert got.dtype == tdt
    _close(got, r_attn.chunked_attention(qj, kj, vj, **kw), tol)


def test_chunked_attention_keeps_the_chunk_assertion():
    q = torch.zeros((1, 6, 2, 4))
    k = torch.zeros((1, 6, 1, 4))
    with pytest.raises(AssertionError):
        p_attn.chunked_attention(q, k, k, chunk=4)


@pytest.mark.parametrize("mask", ["ring", "flat", "flat_window"])
def test_decode_attention(dtype, mask):
    jdt, tdt, tol = dtype
    rng = np.random.default_rng(3)
    qj, qt = _inputs(rng, (2, 1, 4, 8), jdt, tdt, 2.0)
    kj, kt = _inputs(rng, (2, 12, 2, 8), jdt, tdt, 2.0)
    vj, vt = _inputs(rng, (2, 12, 2, 8), jdt, tdt)
    idx, step = np.arange(12), 7
    valid = {"ring": idx <= min(step, 11), "flat": idx <= step,
             "flat_window": (idx <= step) & (idx > step - 3)}[mask]
    valid = np.broadcast_to(valid, (2, 12))
    for cap in (None, 4.0):
        got = p_attn.decode_attention(qt, kt, vt, torch.from_numpy(valid.copy()),
                                      attn_softcap=cap)
        _close(got, r_attn.decode_attention(qj, kj, vj, jnp.asarray(valid),
                                            attn_softcap=cap), tol, f"cap {cap}")


def _gqa_params(seed=4, d=32, h=4, kv=2, hd=8):
    params, _ = r_attn.gqa_init(jax.random.key(seed), d, h, kv, hd)
    return params, {k: _t(np.asarray(v)) for k, v in params.items()}


@pytest.mark.parametrize("window", [None, 6])
def test_gqa_forward(dtype, window):
    jdt, tdt, tol = dtype
    rp, pp = _gqa_params()
    rng = np.random.default_rng(5)
    xj, xt = _inputs(rng, (2, 12, 32), jdt, tdt)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, window=window, chunk=4,
              attn_softcap=6.0, query_scale=0.3)
    out_p, (k_p, v_p) = p_attn.gqa_forward(pp, xt, **kw)
    out_r, (k_r, v_r) = r_attn.gqa_forward(rp, xj, **kw)
    _close(out_p, out_r, tol)
    _close(k_p, k_r, tol)
    _close(v_p, v_r, tol)


@pytest.mark.parametrize("ring,limit", [(True, None), (False, None),
                                        (False, 4)])
def test_gqa_decode(dtype, ring, limit):
    """A run of decode steps, the ring wrapping twice: outputs and every
    written cache slot equal."""
    jdt, tdt, tol = dtype
    rp, pp = _gqa_params()
    rng = np.random.default_rng(6)
    t = 5 if ring else 16
    ck_r = jnp.zeros((2, t, 2, 8), jdt)
    cv_r = jnp.zeros((2, t, 2, 8), jdt)
    ck_p = torch.zeros((2, t, 2, 8), dtype=tdt)
    cv_p = torch.zeros((2, t, 2, 8), dtype=tdt)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, ring=ring, window_limit=limit)
    for step in range(12):
        xj, xt = _inputs(rng, (2, 1, 32), jdt, tdt)
        out_r, ck_r, cv_r = r_attn.gqa_decode(rp, xj, ck_r, cv_r,
                                              jnp.int32(step), **kw)
        out_p, ck_p2, cv_p2 = p_attn.gqa_decode(pp, xt, ck_p, cv_p, step, **kw)
        assert ck_p2 is ck_p and cv_p2 is cv_p        # written in place
        _close(out_p, out_r, tol, f"step {step}")
        _close(ck_p, ck_r, tol)
        _close(cv_p, cv_r, tol)


# --------------------------------------------------------------------------- #
# per model
# --------------------------------------------------------------------------- #

def _twins(arch, split=False, seed=0):
    cfg = tiny_config(r_configs.get_config(arch))
    if split:
        cfg = dataclasses.replace(cfg, split_local_cache=True)
    ref = r_build(cfg)
    params, _ = ref.init(jax.random.key(seed))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


@pytest.mark.parametrize("arch,split", MODELS,
                         ids=[f"{a}{'-paired' if s else ''}" for a, s in MODELS])
def test_model_forward_prefill_decode(dtype, arch, split):
    """``forward``, ``prefill`` and 12 ``decode_step``s, through a ring of
    8 slots (window 8) that wraps, against a cache of 32."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(arch, split)
    assert cfg.paired_local_global == split
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 200, (2, 32)).astype(np.int32)
    s, cache_len = 12, 32

    with torch.no_grad():
        lp, aux = port.forward({"tokens": torch.from_numpy(toks[:, :16])})
    lr, _ = ref.forward(params, {"tokens": jnp.asarray(toks[:, :16])})
    assert lp.dtype == torch.float32 and float(aux) == 0.0
    _close(lp, lr, tol, "forward")

    lp, cache_p = port.prefill({"tokens": torch.from_numpy(toks[:, :s])},
                               cache_len)
    lr, cache_r = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                              cache_len)
    _close(lp, lr, tol, "prefill")
    assert sorted(cache_p) == sorted(cache_r)
    for k in cache_r:
        assert tuple(cache_p[k].shape) == cache_r[k].shape, k
        assert cache_p[k].dtype == tdt
        _close(cache_p[k], cache_r[k], tol, k)

    for step in range(s, s + 12):
        tok = toks[:, step % 32][:, None]
        lp, cache_p = port.decode_step(cache_p, torch.from_numpy(tok), step)
        lr, cache_r = ref.decode_step(params, cache_r, jnp.asarray(tok),
                                      jnp.int32(step))
        _close(lp, lr, tol, f"decode step {step}")
    for k in cache_r:
        _close(cache_p[k], cache_r[k], tol, k)


@pytest.mark.parametrize("arch,split", MODELS,
                         ids=[f"{a}{'-paired' if s else ''}" for a, s in MODELS])
def test_init_cache_and_logits_slices(dtype, arch, split):
    """``init_cache`` has the reference's entries, shapes and dtype (zeros),
    and ``forward``'s "last" and "hidden" slices equal the reference's."""
    jdt, tdt, tol = dtype
    cfg, ref, params, port = _twins(arch, split)
    for batch, cache_len in ((2, 32), (3, 5)):
        want = ref.init_cache(batch, cache_len)
        got = port.init_cache(batch, cache_len)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == tdt and not got[k].any(), k
    toks = np.random.default_rng(9).integers(0, 200, (2, 8)).astype(np.int32)
    for sl in ("last", "hidden"):
        with torch.no_grad():
            lp, _ = port.forward({"tokens": torch.from_numpy(toks)},
                                 logits_slice=sl)
        lr, _ = ref.forward(params, {"tokens": jnp.asarray(toks)},
                            logits_slice=sl)
        assert tuple(lp.shape) == lr.shape, sl
        _close(lp, lr, tol, sl)


def test_cast_params_is_the_cast_on_use():
    """A model cast once to bfloat16 computes bit for bit what its float32
    masters compute when cast on every use (the reference's way); norm
    scales, read in float32 by the reference, stay float32."""
    cfg, _, _, port = _twins("gemma2-27b")
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if p.ndim == 1:                # norms away from their init
                p.copy_(torch.from_numpy(rng.normal(1, 0.3, p.shape)))
    toks = torch.from_numpy(rng.integers(0, 200, (2, 8)))
    with torch.no_grad():
        want, _ = port.forward({"tokens": toks})
        p_common.cast_params(port)
        for p in port.parameters():
            assert p.dtype == (torch.bfloat16 if p.ndim == 2
                               else torch.float32)
        got, _ = port.forward({"tokens": toks})
    assert torch.equal(got, want)


def test_init_is_seeded_and_finite():
    cfg = tiny_config(p_configs.get_config("h2o-danube-3-4b"))
    a = build_model(cfg, device="cpu").init(p_common.make_generator(3))
    b = build_model(cfg, device="cpu").init(p_common.make_generator(3))
    c = build_model(cfg, device="cpu").init(p_common.make_generator(4))
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert pa.dtype == torch.float32
        assert torch.equal(pa, pb), n
        if pa.ndim == 2:
            assert not torch.equal(pa, pc), n
            bound = 2.0 / np.sqrt(pa.shape[0]) if "embed" not in n else None
            if bound is not None:
                assert float(pa.detach().abs().max()) <= bound * (1 + 1e-6), n
        else:
            assert torch.equal(pa, torch.ones_like(pa)), n
    with torch.no_grad():
        logits, _ = a.forward({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert bool(torch.isfinite(logits).all())


def test_convert_refuses_a_tree_that_does_not_fit():
    cfg, _, params, port = _twins("minitron-4b")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, extra=np.zeros(3))
    with pytest.raises(KeyError, match="extra"):
        load_reference_params(port, bad)
    bad = dict(tree, final_norm=np.zeros(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        load_reference_params(port, bad)
    other = tiny_config(r_configs.get_config("minitron-4b"))
    with pytest.raises(ValueError, match="stacked layers"):
        load_reference_params(
            build_model(dataclasses.replace(other, n_layers=3), device="cpu"),
            tree)


# --------------------------------------------------------------------------- #
# full-size accounting and what is not ported
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", DENSE)
def test_param_count_at_full_size_on_meta(arch):
    model = build_model(p_configs.get_config(arch), device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert model.param_count() == r_build(r_configs.get_config(arch)).param_count()
    if arch == "h2o-danube-3-4b":
        assert model.param_count() == 3_838_959_360
        assert len(model.layers) == 24


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-vl-2b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "mamba2-130m",
                                  "seamless-m4t-large-v2"])
def test_build_model_refuses_what_is_not_ported(arch):
    cfg = p_configs.get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(tiny_config(cfg), device="cpu")
