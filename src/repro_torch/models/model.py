"""The model facade: one ``nn.Module`` per architecture config exposing

    init / forward / loss / prefill / decode_step / init_cache / param_count

so the trainer, the server, the launchers and the tests never dispatch
on family themselves.  The port of ``repro.models.model`` for the dense
(GQA or MLA), ssm and hybrid families; the parameters live in the module
(the reference passes a params tree).

``build_model`` refuses a family or feature this port does not have yet
(moe, encdec, vlm, M-RoPE), naming the ROADMAP item; it never falls back
to another family.

A model that trains keeps its float32 masters (never ``cast_params`` it):
the forward casts each weight on use, so the gradients reach the masters
in float32, as ``jax.grad`` gives them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import transformer as tf
from .common import (chunked_softmax_cross_entropy, embedding_init,
                     rmsnorm_init)

__all__ = ["Model", "build_model"]

_NOT_PORTED = "not ported yet (ROADMAP queue 1, item 3(b))"
_PORTED = ("dense", "ssm", "hybrid")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is {_NOT_PORTED}")
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
    """A decoder: ``embed``, ``layers`` (``DecoderLayer`` each; for the ssm
    and hybrid families ``MambaLayer``), for the hybrid family ``shared``
    (``n_shared_attn`` ``DecoderLayer``s), ``final_norm`` and, untied,
    ``unembed`` (the hybrid always unembeds with ``embed``).  Construction
    allocates the float32 parameters uninitialised (nothing on ``meta``);
    ``init`` fills them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_ported(cfg)
        super().__init__()
        dev = _resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(embedding_init(
            None, cfg.padded_vocab, cfg.d_model, device=dev))
        layer = (tf.MambaLayer if cfg.family in ("ssm", "hybrid")
                 else tf.DecoderLayer)
        self.layers = nn.ModuleList(layer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = nn.ModuleList(tf.DecoderLayer(cfg, device=dev)
                                        for _ in range(cfg.n_shared_attn))
        self.final_norm = nn.Parameter(rmsnorm_init(cfg.d_model, device=dev))
        if not cfg.tie_embeddings and cfg.family != "hybrid":
            self.unembed = nn.Parameter(embedding_init(
                None, cfg.padded_vocab, cfg.d_model, device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------- init -------------------------------- #
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device,
        ``common.make_generator``); returns self."""
        if self.cfg.family == "hybrid":
            tf.hybrid_init(self, generator)
        else:
            tf.decoder_init(self, generator)
        return self

    # --------------------------- forward -------------------------------- #
    def forward(self, batch: Dict[str, torch.Tensor], *,
                chunk: Optional[int] = None,
                logits_slice: Optional[str] = None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S); returns
        (logits, aux_loss)."""
        fwd = (tf.hybrid_forward if self.cfg.family == "hybrid"
               else tf.decoder_forward)
        return fwd(self, self.cfg, batch["tokens"],
                   chunk=chunk or self.cfg.attn_chunk,
                   logits_slice=logits_slice)

    def loss(self, batch: Dict[str, torch.Tensor], *,
             chunk: Optional[int] = None) -> torch.Tensor:
        """Token-mean CE of ``batch["labels"]`` (B, S) through the chunked
        unembed, plus 0.01 x the auxiliary loss; a 0-d float32 tensor."""
        cfg = self.cfg
        hidden, aux = self.forward(batch, chunk=chunk, logits_slice="hidden")
        ce = chunked_softmax_cross_entropy(hidden, tf._unembed_w(self),
                                           batch["labels"],
                                           cap=cfg.final_softcap)
        return ce + 0.01 * aux

    # --------------------------- serving -------------------------------- #
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int, *,
                chunk: Optional[int] = None):
        """Prompt pass: (last-token logits (B, 1, V) float32, cache)."""
        chunk = chunk or self.cfg.attn_chunk
        if self.cfg.family == "hybrid":
            return tf.hybrid_prefill(self, self.cfg, batch["tokens"],
                                     cache_len, chunk=chunk)
        return tf.decoder_prefill(self, self.cfg, batch["tokens"],
                                  cache_len=cache_len, chunk=chunk)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, step: int):
        """One token (B, 1) at absolute position ``step``: (logits, cache);
        the cache is updated in place."""
        step_fn = (tf.hybrid_decode_step if self.cfg.family == "hybrid"
                   else tf.decoder_decode_step)
        return step_fn(self, self.cfg, cache, tokens, step)

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        return tf.init_cache(self.cfg, batch, cache_len, device=self.device)

    # --------------------------- accounting ----------------------------- #
    def param_count(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` (``"meta"`` counts without
    allocating); raises for a family or feature not ported yet."""
    return Model(cfg, device=device)
