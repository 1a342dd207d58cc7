"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    n_experts=8,
    top_k=2,
    layer_pattern=("local",),   # SWA everywhere -> long_500k OK
    window=4096,
    rope_theta=1_000_000.0,
    notes="8e top-2; E=8 does not divide TP=16 -> per-expert d_ff tensor parallel",
)
