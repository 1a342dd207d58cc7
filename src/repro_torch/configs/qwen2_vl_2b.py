"""qwen2-vl-2b [vlm]: M-RoPE decoder; vision patch embeds are a stub frontend.
[arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    n_patches=1024,             # stub image: 1024 patch embeddings prepended
    rope_theta=1_000_000.0,
    notes="M-RoPE (t/h/w sections 16/24/24); dynamic resolution stubbed to 1024 patches",
)
