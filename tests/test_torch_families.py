"""The ssm, hybrid and MLA families (mamba2-130m, zamba2-2.7b,
minicpm3-4b) of the port against the reference on the CPU, beyond the
per-model twins they share with the dense archs in
``test_torch_models.py``: the MLA modules, the reference's own
prefill/decode consistency check run on the port, a hybrid too shallow
for a segment, ``cast_params`` and ``convert`` on the new trees, the
bfloat16 drift of a deep hybrid against the reference's, and the train
and serve launchers' round trip for each arch.

Same inputs, weights and bars as ``test_torch_models.py`` (whose
helpers this file uses): float32 rtol 1e-5 for MLA, bfloat16 rtol 0.05 /
atol 0.08.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs
import repro.models.attention as r_attn
from conftest import tiny_config
from repro.models import build_model as r_build
from test_torch_models import (BF16, NEW, _close, _inputs, _t, _twins,
                               dtype)  # noqa: F401  (dtype: a fixture)

import repro_torch.configs as p_configs
import repro_torch.models.attention as p_attn
import repro_torch.models.common as p_common
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params
from repro_torch.runtime.checkpoint import latest_step


@pytest.mark.parametrize("arch", NEW)
def test_build_model_builds_the_ssm_hybrid_and_mla_archs(arch):
    """The three archs once refused build at full size on ``meta``, tiny
    on the CPU (seeded, finite logits), and raise on ``cuda`` without a
    card; their layers are the family's modules."""
    from repro_torch.models.transformer import DecoderLayer, MambaLayer
    cfg = p_configs.get_config(arch)
    full = build_model(cfg, device="meta")
    want = MambaLayer if cfg.family in ("ssm", "hybrid") else DecoderLayer
    assert all(type(layer) is want for layer in full.layers)
    assert hasattr(full, "shared") == (cfg.family == "hybrid")
    if cfg.mla:
        assert sorted(full.layers[0].attn) == sorted(
            ["w_dq", "w_uq", "w_dkv", "w_kpe", "w_uk", "w_uv", "wo"])
    tiny = build_model(tiny_config(cfg), device="cpu").init(
        p_common.make_generator(0))
    with torch.no_grad():
        logits, _ = tiny.forward({"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)})
    assert bool(torch.isfinite(logits).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            build_model(tiny_config(cfg), device="cuda")


# --------------------------------------------------------------------------- #
# MLA, per module
# --------------------------------------------------------------------------- #

MLA = dict(n_heads=4, nope_dim=8, rope_dim=4, v_dim=6)


def _mla_params(seed=11, d=32):
    params, _ = r_attn.mla_init(jax.random.key(seed), d, 4, q_lora=16,
                                kv_lora=12, nope_dim=8, rope_dim=4, v_dim=6)
    return params, {k: _t(np.asarray(v)) for k, v in params.items()}


def test_mla_forward(dtype):
    """Non-absorbed MLA forward (scale 1/sqrt(nope + rope), RoPE on the
    last ``rope_dim`` of q and on the shared k_pe): output, latent and
    rotated k_pe equal."""
    jdt, tdt, tol = dtype
    rp, pp = _mla_params()
    rng = np.random.default_rng(12)
    xj, xt = _inputs(rng, (2, 12, 32), jdt, tdt)
    kw = dict(q_lora=16, kv_lora=12, chunk=4, **MLA)
    out_p, (ckv_p, kpe_p) = p_attn.mla_forward(pp, xt, **kw)
    out_r, (ckv_r, kpe_r) = r_attn.mla_forward(rp, xj, **kw)
    assert out_p.dtype == tdt and tuple(kpe_p.shape) == kpe_r.shape
    _close(out_p, out_r, tol, "out")
    _close(ckv_p, ckv_r, tol, "ckv")
    _close(kpe_p, kpe_r, tol, "kpe")


def test_mla_decode(dtype):
    """Twelve absorbed-matmul decode steps into flat latent caches of 16:
    outputs and every written slot equal, the port's caches written in
    place."""
    jdt, tdt, tol = dtype
    rp, pp = _mla_params(seed=13)
    rng = np.random.default_rng(14)
    ckv_r, kpe_r = jnp.zeros((2, 16, 12), jdt), jnp.zeros((2, 16, 4), jdt)
    ckv_p = torch.zeros((2, 16, 12), dtype=tdt)
    kpe_p = torch.zeros((2, 16, 4), dtype=tdt)
    for step in range(12):
        xj, xt = _inputs(rng, (2, 1, 32), jdt, tdt)
        out_r, ckv_r, kpe_r = r_attn.mla_decode(rp, xj, ckv_r, kpe_r,
                                                jnp.int32(step), **MLA)
        out_p, c2, k2 = p_attn.mla_decode(pp, xt, ckv_p, kpe_p, step, **MLA)
        assert c2 is ckv_p and k2 is kpe_p
        _close(out_p, out_r, tol, f"step {step}")
        _close(ckv_p, ckv_r, tol, f"ckv, step {step}")
        _close(kpe_p, kpe_r, tol, f"kpe, step {step}")


# --------------------------------------------------------------------------- #
# the reference's own consistency checks, on the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_consistency(arch):
    """The reference's ``test_prefill_decode_consistency`` on the port, at
    bfloat16 with its bar: prefill's last logits equal the forward's, and
    one decode step's equal the forward over one more token (KV caches,
    MLA absorption, the SSD/recurrence duality)."""
    cfg, _, _, port = _twins(arch, seed=1)
    rng = np.random.default_rng(0)
    S = 12
    toks = torch.from_numpy(rng.integers(0, 200, (2, S + 1)).astype(np.int32))
    with torch.no_grad():
        full, _ = port.forward({"tokens": toks[:, :S]})
        full2, _ = port.forward({"tokens": toks})
    last, cache = port.prefill({"tokens": toks[:, :S]}, 32)
    np.testing.assert_allclose(last[:, -1].numpy(), full[:, -1].numpy(),
                               **BF16)
    dl, _ = port.decode_step(cache, toks[:, S:S + 1], S)
    np.testing.assert_allclose(dl[:, -1].numpy(), full2[:, -1].numpy(),
                               **BF16)


def test_hybrid_below_one_segment_has_no_attention():
    """A hybrid with fewer layers than ``attn_every`` has no segment: no
    shared block runs and its Mamba2 layers are skipped, in both packages'
    forward; the port's prefill gives empty stacks and decode runs."""
    cfg = dataclasses.replace(tiny_config(r_configs.get_config("zamba2-2.7b")),
                              n_layers=1)
    ref = r_build(cfg)
    params, _ = ref.init(jax.random.key(0))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(3).integers(0, 200, (2, 8)).astype(np.int32)
    with torch.no_grad():
        lp, _ = port.forward({"tokens": torch.from_numpy(toks)})
    lr, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    _close(lp, lr, BF16, "forward")
    logits, cache = port.prefill({"tokens": torch.from_numpy(toks)}, 16)
    assert cache["k"].shape[0] == 0 and cache["ssm"].shape[0] == 0
    logits, _ = port.decode_step(cache, torch.from_numpy(toks[:, :1]), 8)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b", "minicpm3-4b"])
def test_cast_params_keeps_what_the_reference_reads_in_float32(arch):
    """Cast once to bfloat16, the new families compute bit for bit what
    their float32 masters compute cast on use; the Mamba2 gated norm's
    (H, P) scale, like every 1-D leaf, stays float32."""
    cfg, _, _, port = _twins(arch)
    rng = np.random.default_rng(15)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if p.ndim == 1 or name.endswith(".norm"):
                p.copy_(torch.from_numpy(rng.normal(1, 0.3, p.shape)))
    toks = torch.from_numpy(rng.integers(0, 200, (2, 8)))
    with torch.no_grad():
        want, _ = port.forward({"tokens": toks})
        p_common.cast_params(port)
        for name, p in port.named_parameters():
            f32 = p.ndim == 1 or name.endswith(".mamba.norm")
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        got, _ = port.forward({"tokens": toks})
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "minicpm3-4b"])
def test_convert_carries_shared_blocks_and_mla_both_ways(arch):
    """``reference_tree`` of a loaded port model is the reference's tree,
    every leaf bit for bit (zamba2's ``shared`` stack of its own length,
    MLA's projections)."""
    from repro_torch.models.convert import Stacked, reference_tree
    cfg, _, params, port = _twins(arch)
    want = jax.tree.map(np.asarray, params)
    got = reference_tree(port)

    def as_np(node):
        if isinstance(node, dict):
            return {k: as_np(v) for k, v in node.items()}
        if isinstance(node, Stacked):
            return np.stack([t.detach().numpy() for t in node])
        return node.detach().numpy()
    got = as_np(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w)
    if cfg.family == "hybrid":
        assert got["shared"]["attn"]["wq"].shape[0] == cfg.n_shared_attn
        bad = dict(want, shared=jax.tree.map(lambda a: a[:1], want["shared"]))
        with pytest.raises(ValueError, match="'shared'"):
            load_reference_params(build_model(cfg, device="cpu"), bad)


def test_bf16_drift_of_a_deep_hybrid_is_the_references(monkeypatch):
    """At bfloat16 a deep stack's prefill + decode moves away from its own
    forward as rounding compounds over the blocks, in the reference as in
    the port: a 24-layer hybrid (4 segments) drifts by about as much in
    both (each within 2x the other's), while at float32 the port's
    prefill + decode is its forward to 1e-4."""
    cfg = dataclasses.replace(tiny_config(r_configs.get_config("zamba2-2.7b")),
                              n_layers=24, attn_every=6)
    ref = r_build(cfg)
    params, _ = ref.init(jax.random.key(2))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(16).integers(1, 200, (2, 38)).astype(np.int32)
    s = 32

    def port_drift():
        with torch.no_grad():
            full, _ = port.forward({"tokens": torch.from_numpy(toks)})
        got, cache = port.prefill({"tokens": torch.from_numpy(toks[:, :s])},
                                  48)
        errs = [float((got[:, 0] - full[:, s - 1]).abs().max())]
        for i in range(s, toks.shape[1] - 1):
            got, cache = port.decode_step(
                cache, torch.from_numpy(toks[:, i:i + 1]), i)
            errs.append(float((got[:, 0] - full[:, i]).abs().max()))
        return max(errs)

    full, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    got, cache = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])}, 48)
    errs = [float(jnp.abs(got[:, 0] - full[:, s - 1]).max())]
    for i in range(s, toks.shape[1] - 1):
        got, cache = ref.decode_step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.int32(i))
        errs.append(float(jnp.abs(got[:, 0] - full[:, i]).max()))
    ref_drift, bf16_drift = max(errs), port_drift()
    print(f"bfloat16 drift: port {bf16_drift:.4f}, reference {ref_drift:.4f}")
    assert 0.5 * ref_drift <= bf16_drift <= 2.0 * ref_drift, (bf16_drift,
                                                              ref_drift)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)
    f32_drift = port_drift()
    assert f32_drift < 1e-4 < bf16_drift, (f32_drift, bf16_drift)


# --------------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,layers", [("mamba2-130m", "2"),
                                         ("zamba2-2.7b", "12"),
                                         ("minicpm3-4b", "2")])
def test_new_family_launchers_train_then_serve(tmp_path, capsys, arch,
                                               layers):
    """``--arch`` of each new family through both launchers with
    ``--ckpt-dir``: trained to 4 with a checkpoint every 2, then served
    from that checkpoint (zamba2 at 12 layers: both shared blocks run);
    every served parameter is the checkpoint's, cast."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch
    ck = tmp_path / "ck"
    small = ["--arch", arch, "--reduced-layers", layers, "--reduced-width",
             "64", "--device", "cpu"]
    out = launch.main(small + ["--batch", "2", "--seq", "32", "--steps", "4",
                               "--ckpt-every", "2", "--ckpt-dir", str(ck)])
    assert out["final_step"] == 4 and latest_step(ck) == 4
    srv = serve.main(small + ["--ckpt-dir", str(ck), "--requests", "6",
                              "--max-new", "5"])
    assert "restored step 4" in capsys.readouterr().out
    with np.load(ck / "step_00000004" / "arrays.npz") as z:
        for name, p in srv.model.named_parameters():
            parts = name.split(".")
            if parts[0] in ("layers", "shared"):
                want = z["//".join(["params", parts[0]] + parts[2:])][
                    int(parts[1])]
            else:
                want = z["//".join(["params"] + parts)]
            assert torch.equal(p, torch.from_numpy(want).to(p.dtype)), name
    assert srv.waves >= 1
