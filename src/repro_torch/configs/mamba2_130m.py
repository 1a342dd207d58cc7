"""mamba2-130m [ssm]: pure SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                     # attn-free, no separate MLP (mamba block only)
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_p=64,
    notes="SSD; d_inner 1536, 24 ssm heads of 64; constant-state decode",
)
