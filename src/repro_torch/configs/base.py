"""Config dataclasses: architecture (ModelConfig) and workload shape
(ShapeConfig) definitions shared by smoke tests, the dry-run and launchers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "VOCAB_PAD"]

VOCAB_PAD = 128  # pad vocab to a multiple (Megatron-style) so TP always divides


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention pattern: cycled over layers ("global" / "local")
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None     # e.g. gemma2 query_pre_attn_scalar
    sandwich_norm: bool = False             # gemma2 post-block RMSNorms
    rope_theta: float = 10_000.0

    # MLA (multi-head latent attention)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    nope_dim: int = 0
    rope_dim: int = 0
    v_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_p: int = 64
    ssd_chunk: int = 128            # SSD intra-chunk length (memory lever)
    attn_every: int = 0                     # hybrid: shared attn cadence
    n_shared_attn: int = 0                  # hybrid: number of shared blocks

    # enc-dec
    enc_layers: int = 0

    # multimodal stubs
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_patches: int = 0                      # vlm: stub patch embeds prepended
    frontend: Optional[str] = None          # "audio" | "vision" stub frontends

    tie_embeddings: bool = True
    rms_eps: float = 1e-6
    remat: str = "full"                     # "none" | "full"
    attn_chunk: int = 1024                  # flash-attention KV chunk length
    split_local_cache: bool = False         # local/global alternating archs:
                                            # ring caches (window slots) for the
                                            # local layers, full-length caches
                                            # only for the global ones
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_p

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    @property
    def uses_swa_everywhere(self) -> bool:
        return all(k == "local" for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: bounded-memory attention everywhere."""
        return self.family in ("ssm", "hybrid") or self.uses_swa_everywhere

    @property
    def paired_local_global(self) -> bool:
        return (self.split_local_cache
                and self.layer_pattern == ("local", "global")
                and self.n_layers % 2 == 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
