"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,                # mamba2 layers
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,                 # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_p=64,
    attn_every=6,               # shared attn applied after every 6 mamba layers
    n_shared_attn=2,            # two shared blocks, cycled
    rope_theta=10_000.0,
    notes="Mamba2 + 2 shared attn/MLP blocks cycled every 6 layers (9 applications)",
)
