"""gemma2-27b [dense]: alternating local/global attention + logit softcaps.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,               # decoupled from d_model/n_heads, per the hf config
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=0.0625,         # 1/sqrt(query_pre_attn_scalar=256)
    sandwich_norm=True,
    rope_theta=10_000.0,
    notes="local+global alternating; attn softcap 50, final softcap 30; GeGLU",
)
