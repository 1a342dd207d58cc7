"""minicpm3-4b [dense]: multi-head latent attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    mla=True,
    q_lora=768,
    kv_lora=256,
    nope_dim=64,
    rope_dim=32,
    v_dim=64,
    rope_theta=10_000.0,
    notes="MLA latent cache (kv_lora 256 + rope 32 per token); decode uses absorbed matmuls",
)
