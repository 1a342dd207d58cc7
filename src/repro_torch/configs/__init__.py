"""Architecture registry: one module per assigned architecture plus the
paper's own experiment config.  ``get_config(name)`` accepts the canonical
ids used throughout benchmarks/launchers.

Plain dataclasses, copied from the JAX package's ``configs`` so that the
port imports nothing of it; ``tests/test_torch_models.py`` holds every
registered config equal to the reference's."""
from __future__ import annotations

from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeConfig
from . import (
    gemma2_27b,
    h2o_danube3_4b,
    mamba2_130m,
    minicpm3_4b,
    minitron_4b,
    mixtral_8x7b,
    phi35_moe,
    qwen2_vl_2b,
    seamless_m4t_large_v2,
    zamba2_2p7b,
)

_MODULES = [
    h2o_danube3_4b,
    minicpm3_4b,
    gemma2_27b,
    minitron_4b,
    seamless_m4t_large_v2,
    qwen2_vl_2b,
    mixtral_8x7b,
    phi35_moe,
    zamba2_2p7b,
    mamba2_130m,
]

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> List[str]:
    return list(REGISTRY)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "get_config", "list_configs"]
