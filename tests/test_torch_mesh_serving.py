"""Prefill and decode of every family on a mesh against the port's
single-device run and the reference, on 4 gloo ranks
(``test_torch_mesh_workers.run_ranks``: spawned ranks, a ``file://``
store each).

A family's tiny config serves one prompt and 4 decode steps through
``runtime.steps`` at float32, on a 2x2 (data, model) mesh under the decode
cell's rules (``rules_for_arch`` of a decode ``ShapeConfig``) and on one
rank alone, from the reference's weights: the logits of every step agree
within 1e-5, and every cache entry leaves prefill placed by
``input_pspecs`` of ``cache_logical_axes`` and keeps that placement and
its local storage through every decode step (the writes are in place,
never gathered).  The mesh's logits of every step are also held against
the reference's ``prefill`` and ``decode_step`` on the same inputs, at
the single-device bars of ``test_torch_models`` (rtol 1e-5 / atol 1e-5;
the ssm and hybrid archs rtol 1e-4, the SSD's ``exp(cumsum)`` chains).
Two cases take the mesh's harder paths: 3 query heads over 2 model ranks
(context-parallel attention, the caches' length sharded over "model")
and 3 SSM heads over 2 ranks (the SSM's (H, P) projections as each
rank's local product).  The batch-1 cases replicate the batch and shard the caches' length over
the data axis (and over the model axis where the kv heads do not divide
it), so decode combines the partial softmax of each rank's slots.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tiny_config
from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build
from repro_torch.configs import get_config
from test_torch_distributed import f32  # noqa: F401
import test_torch_mesh_workers as workers

STEPS, CACHE_LEN, PROMPT = 4, 32, 16
F32 = dict(rtol=1e-5, atol=1e-5)
SSM_F32 = dict(rtol=1e-4, atol=1e-5)


def _reference_logits(r_cfg, params, prompt, tokens):
    """The reference's logits of prefill and of each decode step."""
    ref = r_build(r_cfg)
    start = sum(v.shape[1] for k, v in prompt.items()
                if k in ("tokens", "patches"))
    logits, cache = ref.prefill(params, {k: jnp.asarray(v)
                                         for k, v in prompt.items()},
                                CACHE_LEN)
    out = [np.asarray(logits)]
    for j in range(tokens.shape[0]):
        logits, cache = ref.decode_step(params, cache,
                                        jnp.asarray(tokens[j]), start + j)
        out.append(np.asarray(logits))
    return out


def _case(name, arch, batch, seed, **over):
    """(the workers' case, the reference's logits of every step)."""
    r_cfg = dataclasses.replace(tiny_config(r_get_config(arch)), **over)
    cfg = dataclasses.replace(tiny_config(get_config(arch)), **over)
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(0, 200, (batch, PROMPT)).astype(
        np.int32)}
    if cfg.family == "vlm":
        prompt = {"patches": rng.normal(0, 1, (batch, cfg.n_patches,
                                               cfg.d_model)).astype(
                                                   np.float32),
                  "tokens": prompt["tokens"][:, :PROMPT - cfg.n_patches]}
    if cfg.family == "encdec":
        prompt["frames"] = rng.normal(0, 1, (batch, PROMPT, cfg.d_model)
                                      ).astype(np.float32)
    tokens = rng.integers(0, 200, (STEPS, batch, 1)).astype(np.int32)
    params, _ = r_build(r_cfg).init(jax.random.key(seed))
    want = _reference_logits(r_cfg, params, prompt, tokens)
    return ({"name": name, "cfg": cfg,
             "params": jax.tree.map(np.asarray, params), "prompt": prompt,
             "tokens": tokens, "cache_len": CACHE_LEN}, want)


# windows of 6 under a 16-token prompt: the ring fill rotates (16 % 6)
FAMILIES = [("dense-swa", "h2o-danube-3-4b", dict(window=6)),
            ("dense-local-global", "gemma2-27b", {}),
            ("mla", "minicpm3-4b", {}),
            ("moe", "mixtral-8x7b", {}),
            ("ssm", "mamba2-130m", {}),
            ("hybrid", "zamba2-2.7b", {}),
            ("vlm", "qwen2-vl-2b", {}),
            ("encdec", "seamless-m4t-large-v2", {}),
            # 3 q heads over 2 model ranks: context-parallel attention
            ("dense-context-parallel", "h2o-danube-3-4b",
             dict(n_heads=3, n_kv_heads=1, head_dim=16)),
            # 3 SSM heads over 2 model ranks: the (H, P) projections run as
            # each rank's local product
            ("ssm-unaligned-heads", "mamba2-130m",
             dict(d_model=48, ssm_head_p=32))]
# batch 1: the batch replicated, the caches' length sharded over "data",
# and over "model" too where one kv head cannot be split
# (6 ring slots over 4 ranks: 2, 2, 2 and none)
KV_SPLIT = [("dense-kv-split", "h2o-danube-3-4b",
             dict(n_kv_heads=1, window=6)),
            ("mla-kv-split", "minicpm3-4b", {}),
            ("encdec-kv-split", "seamless-m4t-large-v2", {})]


def _check(got, name, cfg, want):
    r = got[name]
    assert r["err"] <= 1e-5, (name, r["err"])
    assert r["kept"] == r["entries"], (name, r)
    assert r["placed"], (name, r)            # something was sharded
    tol = SSM_F32 if cfg.family in ("ssm", "hybrid") else F32
    assert len(r["logits"]) == len(want) == STEPS + 1
    for j, (g, w) in enumerate(zip(r["logits"], want)):
        np.testing.assert_allclose(g, w, err_msg=f"{name} step {j}", **tol)


def _run(cases, tmp_path):
    """Rank 0's results of ``serve_twins`` over ``cases`` (each rank's
    error the same)."""
    out = workers.run_ranks(workers.serve_twins, 4, tmp_path / "ranks",
                            [c for c, _ in cases], timeout=240.0)
    for c, _ in cases:
        assert all(o[c["name"]]["err"] == out[0][c["name"]]["err"]
                   for o in out[1:])
    return out[0]


GROUPS = {"attention": ("dense-swa", "dense-local-global", "mla", "moe",
                        "dense-context-parallel"),
          "state": ("ssm", "hybrid", "vlm", "encdec", "ssm-unaligned-heads")}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_prefill_and_decode_on_a_2x2_mesh(group, f32, tmp_path):
    names = GROUPS[group]
    cases = [_case(n, a, 4, i, **o) for i, (n, a, o) in enumerate(FAMILIES)
             if n in names]
    out = _run(cases, tmp_path)
    for case, want in cases:
        name = case["name"]
        _check(out, name, case["cfg"], want)
        assert out[name]["rules"]["batch"] == ("data",)
    if group == "attention":
        assert out["dense-context-parallel"]["rules"]["kv_len"] == \
            ("model",)


def test_decode_over_a_length_sharded_cache(f32, tmp_path):
    cases = [_case(n, a, 1, 10 + i, **o) for i, (n, a, o)
             in enumerate(KV_SPLIT)]
    out = _run(cases, tmp_path)
    for case, want in cases:
        name = case["name"]
        _check(out, name, case["cfg"], want)
        assert out[name]["rules"]["batch"] is None
        assert "data" in out[name]["rules"]["kv_len"]
    assert out["dense-kv-split"]["rules"]["kv_len"] == ("data", "model")
