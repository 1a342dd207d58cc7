"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    layer_pattern=("local",),   # SWA everywhere -> ring KV cache, long_500k OK
    window=4096,
    rope_theta=10_000.0,
    notes="GQA kv=8; SWA window 4096; head_dim 120",
)
