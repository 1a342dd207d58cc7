"""minitron-4b [dense]: width-pruned nemotron. [arXiv:2407.14679; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10_000.0,
    notes="pruned nemotron; 24 heads (not divisible by TP=16 -> attention "
          "weights replicated, MLP/vocab sharded; see DESIGN.md)",
)
