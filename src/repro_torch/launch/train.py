"""Config reduction shared by the launchers.

The port of ``repro.launch.train``'s ``reduced``; the training launcher's
``main`` waits for the training slice (ROADMAP queue 1, item 3(a)).
"""
from __future__ import annotations

import dataclasses

__all__ = ["reduced"]


def reduced(cfg, layers, d_model):
    return dataclasses.replace(
        cfg, n_layers=layers, d_model=d_model,
        d_ff=max(d_model * 3, 128),
        n_heads=min(cfg.n_heads, 8) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=(d_model // 8) if cfg.head_dim else None,
        vocab_size=min(cfg.vocab_size, 8192),
        enc_layers=min(cfg.enc_layers, layers) if cfg.enc_layers else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0)
