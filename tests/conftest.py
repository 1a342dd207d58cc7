import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def rng():
    """Deterministic per-test RNG.

    Tests draw randomness from this instead of seeding global numpy state,
    so results are identical whether or not a plugin (e.g. pytest-randomly)
    reseeds the globals — the suite behaves the same with and without
    ``-p no:randomly``.
    """
    return np.random.default_rng(0xC0AC5)


def tiny_config(cfg):
    """Shrink an arch config to smoke scale, preserving its family traits."""
    kw = dict(
        n_layers=2, d_model=64, d_ff=128, vocab_size=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else None, window=8,
    )
    if cfg.mla:
        kw.update(q_lora=32, kv_lora=16, nope_dim=8, rope_dim=4, v_dim=8)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2, capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_expand=2, ssm_head_p=8)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, n_shared_attn=2)
    if cfg.enc_layers:
        kw.update(enc_layers=2)
    if cfg.n_patches:
        kw.update(n_patches=4)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))
    return dataclasses.replace(cfg, **kw)


def make_batch(cfg, batch=2, seq=16, seed=0, with_labels=True):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, 200, (batch, seq)), jnp.int32)
    labels = jnp.asarray(rng.integers(0, 200, (batch, seq)), jnp.int32)
    if cfg.family == "encdec":
        b = {"frames": jnp.asarray(rng.normal(0, 1, (batch, seq, cfg.d_model)),
                                   jnp.bfloat16),
             "tokens": toks}
        if with_labels:
            b["labels"] = labels
        return b
    if cfg.family == "vlm":
        st = seq - cfg.n_patches
        b = {"patches": jnp.asarray(rng.normal(0, 1, (batch, cfg.n_patches, cfg.d_model)),
                                    jnp.bfloat16),
             "tokens": toks[:, :st]}
        if with_labels:
            b["labels"] = labels[:, :st]
        return b
    b = {"tokens": toks}
    if with_labels:
        b["labels"] = labels
    return b


def run_in_subprocess(code: str, devices: int = 8, timeout: int = 560) -> str:
    """Run ``code`` in a fresh python with N fake XLA devices; returns stdout."""
    prelude = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
        import sys
        sys.path.insert(0, {SRC!r})
    """)
    proc = subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout
