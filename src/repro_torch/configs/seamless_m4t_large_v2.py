"""seamless-m4t-large-v2 [audio]: encoder-decoder backbone; the speech
frontend is a stub per the brief (input_specs provides precomputed frame
embeddings). [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                # decoder layers
    enc_layers=24,              # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    rope_theta=10_000.0,
    notes="enc-dec; frames arrive as stub embeddings (B, S, d_model)",
)
