"""The model facade: one ``nn.Module`` per architecture config exposing

    init / forward / loss / prefill / decode_step / init_cache /
    param_count / active_param_count

so the trainer, the server, the launchers and the tests never dispatch
on family themselves.  The port of ``repro.models.model`` for every
family of the registry: dense (GQA or MLA), MoE, vlm (M-RoPE over stub
patch embeddings), ssm, hybrid and enc-dec; the parameters live in the
module (the reference passes a params tree).

The vlm reads ``batch["patches"]`` (B, n_patches, D) beside its text
``tokens``, the enc-dec ``batch["frames"]`` (B, Se, D): the serve loop
passes neither, so these two families run through ``prefill`` /
``decode_step`` (``runtime.steps``), as in the reference.

A model that trains keeps its float32 masters (never ``cast_params`` it):
the forward casts each weight on use, so the gradients reach the masters
in float32, as ``jax.grad`` gives them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.partitioning import logical_to_spec
from . import common
from . import encdec as ed
from . import transformer as tf
from .common import (EMBED_AXES, NORM_AXES, chunked_softmax_cross_entropy,
                     embed, embedding_init, rmsnorm_init)

__all__ = ["Model", "build_model"]


def _resolve_device(device) -> torch.device:
    """The device a model lives on; ``cuda`` with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "model asked for CUDA but no card is present (pass "
            "device='cpu' to run on the host)")
    return dev


def _vlm_positions3(batch: int, n_patches: int, seq_total: int, grid: int,
                    device=None) -> torch.Tensor:
    """M-RoPE ids (B, S, 3) int32: the image patches take (t=0, h, w) on
    a ``grid`` x ``grid`` raster; the text continues temporally after the
    image's spatial extent, at ``grid + i`` on all three streams."""
    p = torch.arange(n_patches, dtype=torch.int32, device=device)
    img = torch.stack([torch.zeros_like(p), p // grid, p % grid], dim=-1)
    txt = grid + torch.arange(seq_total - n_patches, dtype=torch.int32,
                              device=device)
    pos = torch.cat([img, txt[:, None].expand(-1, 3)], dim=0)
    return pos[None].expand(batch, seq_total, 3)


class Model(nn.Module):
    """A decoder: ``embed``, ``layers`` (``DecoderLayer`` each, with an
    MoE block in place of the MLP for the moe family; for the ssm and
    hybrid families ``MambaLayer``), for the hybrid family ``shared``
    (``n_shared_attn`` ``DecoderLayer``s), ``final_norm`` and, untied,
    ``unembed`` (the hybrid always unembeds with ``embed``).  The enc-dec
    holds ``enc_layers`` (``EncoderLayer``), ``dec_layers``
    (``CrossDecoderLayer``), ``enc_norm`` and ``final_norm`` beside
    ``embed``, and unembeds with ``embed``.  Construction allocates the
    float32 parameters uninitialised (nothing on ``meta``); ``init``
    fills them.  ``mesh`` is the ``DeviceMesh`` the parameters are placed
    on (``distributed.sharding.place_model``), else None."""

    mesh = None

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = _resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(embedding_init(
            None, cfg.padded_vocab, cfg.d_model, device=dev))
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                ed.EncoderLayer(cfg, device=dev)
                for _ in range(cfg.enc_layers))
            self.dec_layers = nn.ModuleList(
                ed.CrossDecoderLayer(cfg, device=dev)
                for _ in range(cfg.n_layers))
            self.enc_norm = nn.Parameter(rmsnorm_init(cfg.d_model,
                                                      device=dev))
        else:
            layer = (tf.MambaLayer if cfg.family in ("ssm", "hybrid")
                     else tf.DecoderLayer)
            self.layers = nn.ModuleList(layer(cfg, device=dev)
                                        for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = nn.ModuleList(tf.DecoderLayer(cfg, device=dev)
                                        for _ in range(cfg.n_shared_attn))
        self.final_norm = nn.Parameter(rmsnorm_init(cfg.d_model, device=dev))
        if not cfg.tie_embeddings and cfg.family not in ("hybrid", "encdec"):
            self.unembed = nn.Parameter(embedding_init(
                None, cfg.padded_vocab, cfg.d_model, device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------- init -------------------------------- #
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device,
        ``common.make_generator``); returns self."""
        init = {"encdec": ed.encdec_init,
                "hybrid": tf.hybrid_init}.get(self.cfg.family, tf.decoder_init)
        init(self, generator)
        return self

    # --------------------------- forward -------------------------------- #
    def _vlm_inputs(self, batch) -> Dict[str, torch.Tensor]:
        """The vlm's decoder inputs: ``x_embed``, the patches and the
        embedded text (activation dtype), and their M-RoPE ids."""
        cfg = self.cfg
        x = torch.cat([batch["patches"].to(common.DTYPE),
                       embed(self.embed, batch["tokens"])], dim=1)
        pos3 = _vlm_positions3(x.shape[0], cfg.n_patches, x.shape[1],
                               math.isqrt(cfg.n_patches), device=x.device)
        return {"x_embed": x, "positions3": pos3}

    def forward(self, batch: Dict[str, torch.Tensor], *,
                chunk: Optional[int] = None,
                logits_slice: Optional[str] = None):
        """Full-sequence forward; returns (logits, aux_loss).  Reads
        ``batch["tokens"]`` (B, S), with the vlm's ``patches`` or the
        enc-dec's ``frames``; the vlm's logits cover the patches too."""
        cfg = self.cfg
        kw = dict(chunk=chunk or cfg.attn_chunk, logits_slice=logits_slice)
        if cfg.family == "encdec":
            return ed.encdec_forward(self, cfg, batch["frames"],
                                     batch["tokens"], **kw)
        if cfg.family == "hybrid":
            return tf.hybrid_forward(self, cfg, batch["tokens"], **kw)
        if cfg.family == "vlm":
            return tf.decoder_forward(self, cfg, **self._vlm_inputs(batch),
                                      **kw)
        return tf.decoder_forward(self, cfg, batch["tokens"], **kw)

    def loss(self, batch: Dict[str, torch.Tensor], *,
             chunk: Optional[int] = None) -> torch.Tensor:
        """Token-mean CE of ``batch["labels"]`` (B, S) through the chunked
        unembed (the vlm's text positions only), plus 0.01 x the
        auxiliary loss; a 0-d float32 tensor."""
        cfg = self.cfg
        hidden, aux = self.forward(batch, chunk=chunk, logits_slice="hidden")
        if cfg.family == "vlm":
            hidden = hidden[:, cfg.n_patches:, :]
        ce = chunked_softmax_cross_entropy(hidden, tf._unembed_w(self),
                                           batch["labels"],
                                           cap=cfg.final_softcap)
        return ce + 0.01 * aux

    # --------------------------- serving -------------------------------- #
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int, *,
                chunk: Optional[int] = None):
        """Prompt pass: (last-token logits (B, 1, V) float32, cache)."""
        cfg = self.cfg
        chunk = chunk or cfg.attn_chunk
        if cfg.family == "encdec":
            return ed.encdec_prefill(self, cfg, batch["frames"],
                                     batch["tokens"], cache_len, chunk=chunk)
        if cfg.family == "hybrid":
            return tf.hybrid_prefill(self, cfg, batch["tokens"], cache_len,
                                     chunk=chunk)
        if cfg.family == "vlm":
            return tf.decoder_prefill(self, cfg, cache_len=cache_len,
                                      chunk=chunk, **self._vlm_inputs(batch))
        return tf.decoder_prefill(self, cfg, batch["tokens"],
                                  cache_len=cache_len, chunk=chunk)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, step: int):
        """One token (B, 1) at absolute position ``step``: (logits, cache);
        the cache is updated in place.  The vlm's text token is rotated
        to ``step - n_patches + grid``, where its prefill put the text."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return ed.encdec_decode_step(self, cfg, cache, tokens, step)
        if cfg.family == "hybrid":
            return tf.hybrid_decode_step(self, cfg, cache, tokens, step)
        rope_pos = None
        if cfg.family == "vlm":
            rope_pos = int(step) - cfg.n_patches + math.isqrt(cfg.n_patches)
        return tf.decoder_decode_step(self, cfg, cache, tokens, step,
                                      rope_pos=rope_pos)

    def init_cache(self, batch: int, cache_len: int, *,
                   enc_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed decode caches; the enc-dec's cross caches hold
        ``enc_len`` (default ``cache_len``) encoder positions.  A model on
        a mesh, under rules, gets each entry placed by
        ``cache_logical_axes`` (each rank allocating its block)."""
        like = self.embed if self.mesh is not None else None
        if self.cfg.family == "encdec":
            return ed.init_cache(self.cfg, batch, cache_len,
                                 enc_len or cache_len, device=self.device,
                                 like=like)
        return tf.init_cache(self.cfg, batch, cache_len, device=self.device,
                             like=like)

    # ---------------------- logical axes and specs ----------------------- #
    def param_logical_axes(self) -> Dict[str, Tuple]:
        """{parameter name: the reference's logical axes}.  A per-layer
        tensor (``layers.<i>.<path>``, any stack) drops the reference's
        leading ``"layers"``; an MoE leaf keeps ``("experts", ...)``.
        Works on a model built on ``meta``."""
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            top = getattr(self, parts[0])
            if isinstance(top, nn.ModuleList):
                node = top[int(parts[1])].param_axes(self.cfg)
                for k in parts[2:]:
                    node = node[k]
            else:
                node = EMBED_AXES if parts[0] in ("embed", "unembed") \
                    else NORM_AXES
            out[name] = tuple(node)
        return out

    def param_pspecs(self, rules=None) -> Dict[str, Tuple]:
        """{parameter name: ``Spec``} of ``param_logical_axes`` under
        ``rules`` (or the active ones)."""
        return {k: logical_to_spec(ax, rules)
                for k, ax in self.param_logical_axes().items()}

    def cache_logical_axes(self, batch: int, cache_len: int, *,
                           enc_len=None) -> Dict[str, Tuple]:
        """The reference's logical axes of each decode-cache entry (the
        caches keep the stacked layout, so ``"layers"`` leads)."""
        if self.cfg.family == "encdec":
            return dict(ed.ENCDEC_CACHE_AXES)
        return tf.cache_axes(self.cfg)

    def input_specs(self, shape: ShapeConfig, *, enc_len: Optional[int] = None,
                    device=None) -> Dict[str, torch.Tensor]:
        """Zero stand-ins of a ``shape`` cell's batch, the reference's
        shapes and dtypes (int32 tokens and labels, patches and frames in
        ``DTYPE``), on ``device`` (default the model's): on ``meta``, or
        under a ``FakeTensorMode``, nothing is allocated.  A
        decode cell's batch is its one new token a sequence; ``enc_len``
        is taken for the reference's signature."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dev = self.device if device is None else device

        def sd(shp, dt=torch.int32):
            return torch.zeros(shp, dtype=dt, device=dev)
        if shape.kind == "decode":
            return {"tokens": sd((b, 1))}
        extra, s_text = {}, s
        if cfg.family == "encdec":
            extra = {"frames": sd((b, s, cfg.d_model), common.DTYPE)}
        elif cfg.family == "vlm":
            s_text = s - cfg.n_patches
            extra = {"patches": sd((b, cfg.n_patches, cfg.d_model),
                                   common.DTYPE)}
        if shape.kind == "train":
            return {**extra, "tokens": sd((b, s_text)),
                    "labels": sd((b, s_text))}
        if cfg.family == "encdec":
            return {**extra, "tokens": sd((b, 1))}
        return {**extra, "tokens": sd((b, s_text))}

    def input_logical_axes(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """The logical axes of each input of a ``shape`` cell's batch."""
        cfg = self.cfg
        if shape.kind == "train":
            if cfg.family == "encdec":
                return {"frames": ("batch", "seq", "embed"),
                        "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
            if cfg.family == "vlm":
                return {"patches": ("batch", "seq", "embed"),
                        "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
            return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if shape.kind == "prefill":
            if cfg.family == "encdec":
                return {"frames": ("batch", "seq", "embed"),
                        "tokens": ("batch", None)}
            if cfg.family == "vlm":
                return {"patches": ("batch", "seq", "embed"),
                        "tokens": ("batch", "seq")}
            return {"tokens": ("batch", "seq")}
        return {"tokens": ("batch", None)}

    # --------------------------- accounting ----------------------------- #
    def param_count(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def active_param_count(self) -> int:
        """MoE: the parameters a token touches (``top_k`` of the
        ``n_experts`` experts of each layer); else ``param_count``."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        expert_p = 3 * cfg.d_model * cfg.d_ff      # w_in, w_gate, w_out
        return total - cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert_p


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` (``"meta"`` counts without
    allocating)."""
    return Model(cfg, device=device)
