"""The model facade: one ``nn.Module`` per architecture config exposing

    init / forward / prefill / decode_step / init_cache / param_count

so the server, the launcher and the tests never dispatch on family
themselves.  The port of ``repro.models.model`` for the dense family;
the parameters live in the module (the reference passes a params tree).

``build_model`` refuses a family or feature this port does not have yet
(moe, ssm, hybrid, encdec, vlm, MLA), naming the ROADMAP item; it never
falls back to another family.  ``loss`` waits for the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import transformer as tf
from .common import embedding_init, rmsnorm_init

__all__ = ["Model", "build_model"]

_NOT_PORTED = "not ported yet (ROADMAP queue 1, item 3(b))"


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is {_NOT_PORTED}")
    if cfg.mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention is {_NOT_PORTED}")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers are {_NOT_PORTED}")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is {_NOT_PORTED}")


def _resolve_device(device) -> torch.device:
    """The device a model lives on; ``cuda`` with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "model asked for CUDA but no card is present (pass "
            "device='cpu' to run on the host)")
    return dev


class Model(nn.Module):
    """A dense decoder: ``embed``, ``layers`` (``DecoderLayer`` each),
    ``final_norm`` and, untied, ``unembed``.  Construction allocates the
    float32 parameters uninitialised (nothing on ``meta``); ``init`` fills
    them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_ported(cfg)
        super().__init__()
        dev = _resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(embedding_init(
            None, cfg.padded_vocab, cfg.d_model, device=dev))
        self.layers = nn.ModuleList(tf.DecoderLayer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(rmsnorm_init(cfg.d_model, device=dev))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(embedding_init(
                None, cfg.padded_vocab, cfg.d_model, device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------- init -------------------------------- #
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device,
        ``common.make_generator``); returns self."""
        tf.decoder_init(self, generator)
        return self

    # --------------------------- forward -------------------------------- #
    def forward(self, batch: Dict[str, torch.Tensor], *,
                chunk: Optional[int] = None,
                logits_slice: Optional[str] = None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S); returns
        (logits, aux_loss)."""
        return tf.decoder_forward(self, self.cfg, batch["tokens"],
                                  chunk=chunk or self.cfg.attn_chunk,
                                  logits_slice=logits_slice)

    # --------------------------- serving -------------------------------- #
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int, *,
                chunk: Optional[int] = None):
        """Prompt pass: (last-token logits (B, 1, V) float32, cache)."""
        return tf.decoder_prefill(self, self.cfg, batch["tokens"],
                                  cache_len=cache_len,
                                  chunk=chunk or self.cfg.attn_chunk)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, step: int):
        """One token (B, 1) at absolute position ``step``: (logits, cache);
        the cache is updated in place."""
        return tf.decoder_decode_step(self, self.cfg, cache, tokens, step)

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        return tf.init_cache(self.cfg, batch, cache_len, device=self.device)

    # --------------------------- accounting ----------------------------- #
    def param_count(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` (``"meta"`` counts without
    allocating); raises for a family or feature not ported yet."""
    return Model(cfg, device=device)
