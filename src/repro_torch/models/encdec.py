"""Encoder-decoder stack (the seamless-m4t backbone).

The port of ``repro.models.encdec``.  The encoder runs bidirectional
self-attention (RoPE on the frame positions) over stub modality
embeddings: the speech frontend's precomputed frames (B, Se, D).  The
decoder runs causal self-attention, cross-attention to the encoder
output (non-causal, no RoPE) and a non-gated tanh-GELU MLP.  Both stacks
are ``nn.ModuleList``s, ``enc_layers`` and ``dec_layers``; the model
always unembeds with ``embed``.

The decode cache holds a flat self-attention KV cache ``k``/``v``
(L, B, T, K, hd), written in place a step, and the cross-attention's
``ck``/``cv`` (L, B, Se, K, hd), fixed after prefill.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.partitioning import replicate_like, shard
from . import common
from .attention import (GQA_AXES, cross_attn_forward, cross_kv,
                        decode_rope_tables, decode_valid, gqa_decode,
                        gqa_forward, gqa_init)
from .common import (MLP_AXES, NORM_AXES, embed, embedding_init, gelu,
                     mlp_apply, mlp_init, rmsnorm, rmsnorm_init, unembed)
from .transformer import _fill_flat, _Layer, _remat, load_tree

__all__ = ["EncoderLayer", "CrossDecoderLayer", "encdec_init", "encode",
           "encdec_forward", "encdec_prefill", "encdec_decode_step",
           "encdec_cache_spec", "init_cache"]


def _enc_layer_init(generator, cfg: ModelConfig, *, device=None):
    """``ln1``, ``attn`` (GQA), ``ln2``, ``mlp`` (``w_in w_out``)."""
    return {"ln1": rmsnorm_init(cfg.d_model, device=device),
            "attn": gqa_init(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, device=device),
            "ln2": rmsnorm_init(cfg.d_model, device=device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=False,
                            device=device)}


def _dec_layer_init(generator, cfg: ModelConfig, *, device=None):
    """``ln1``, ``attn`` (causal GQA), ``lnx``, ``xattn`` (cross GQA),
    ``ln2``, ``mlp`` (``w_in w_out``)."""
    def gqa():
        return gqa_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd, device=device)
    return {"ln1": rmsnorm_init(cfg.d_model, device=device), "attn": gqa(),
            "lnx": rmsnorm_init(cfg.d_model, device=device), "xattn": gqa(),
            "ln2": rmsnorm_init(cfg.d_model, device=device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=False,
                            device=device)}


class EncoderLayer(_Layer):
    """One bidirectional self-attention + MLP block."""

    param_tree = staticmethod(_enc_layer_init)
    param_axes = staticmethod(lambda cfg: {
        "ln1": NORM_AXES, "attn": GQA_AXES, "ln2": NORM_AXES,
        "mlp": {k: MLP_AXES[k] for k in ("w_in", "w_out")}})


class CrossDecoderLayer(_Layer):
    """One causal self-attention + cross-attention + MLP block."""

    param_tree = staticmethod(_dec_layer_init)
    param_axes = staticmethod(lambda cfg: {
        "ln1": NORM_AXES, "attn": GQA_AXES, "lnx": NORM_AXES,
        "xattn": GQA_AXES, "ln2": NORM_AXES,
        "mlp": {k: MLP_AXES[k] for k in ("w_in", "w_out")}})


@torch.no_grad()
def encdec_init(model, generator: torch.Generator) -> None:
    """Fill ``model`` in place from ``generator``: the embedding table,
    each encoder layer, each decoder layer, the two final norms."""
    cfg, dev = model.cfg, model.embed.device
    model.embed.copy_(embedding_init(generator, cfg.padded_vocab,
                                     cfg.d_model, device=dev))
    for layer in list(model.enc_layers) + list(model.dec_layers):
        load_tree(layer, layer.param_tree(generator, cfg, device=dev))
    model.enc_norm.fill_(1.0)
    model.final_norm.fill_(1.0)


def _gqa_kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd)


def _enc_layer_fwd(p, cfg: ModelConfig, h, chunk):
    hn = rmsnorm(h, p["ln1"], cfg.rms_eps)
    attn_out, _ = gqa_forward(p["attn"], hn, rope_theta=cfg.rope_theta,
                              causal=False, chunk=chunk, **_gqa_kw(cfg))
    h = h + attn_out
    hn = rmsnorm(h, p["ln2"], cfg.rms_eps)
    return h + mlp_apply(p["mlp"], hn, act=gelu)


def encode(model, cfg: ModelConfig, frames, *, chunk=1024):
    """frames (B, Se, D) -> the encoder output (B, Se, D), final-normed."""
    x = shard(frames.to(common.DTYPE), "batch", "seq", "embed")
    layer = _remat(_enc_layer_fwd, cfg)
    for p_l in model.enc_layers:
        x = layer(p_l, cfg, x, chunk)
    return rmsnorm(x, model.enc_norm, cfg.rms_eps)


def _dec_layer_fwd(p, cfg: ModelConfig, h, enc_out, chunk, collect=False):
    """One decoder block over the whole target; with ``collect`` also its
    self-attention (k, v) and cross (k, v)."""
    hn = rmsnorm(h, p["ln1"], cfg.rms_eps)
    attn_out, kv = gqa_forward(p["attn"], hn, rope_theta=cfg.rope_theta,
                               causal=True, chunk=chunk, **_gqa_kw(cfg))
    h = h + attn_out
    hn = rmsnorm(h, p["lnx"], cfg.rms_eps)
    ckv = cross_kv(p["xattn"], enc_out, n_kv=cfg.n_kv_heads, head_dim=cfg.hd)
    h = h + cross_attn_forward(p["xattn"], hn, ckv, chunk=chunk,
                               **_gqa_kw(cfg))
    hn = rmsnorm(h, p["ln2"], cfg.rms_eps)
    h = h + mlp_apply(p["mlp"], hn, act=gelu)
    return (h, kv, ckv) if collect else h


def encdec_forward(model, cfg: ModelConfig, frames, tokens, *, chunk=1024,
                   logits_slice: Optional[str] = None):
    """Training forward: (decoder logits, aux = 0).  ``logits_slice`` as
    in ``transformer.decoder_forward``."""
    enc_out = encode(model, cfg, frames, chunk=chunk)
    x = embed(model.embed, tokens)
    layer = _remat(_dec_layer_fwd, cfg)
    for p_l in model.dec_layers:
        x = layer(p_l, cfg, x, enc_out, chunk)
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    if logits_slice == "hidden":
        return x, aux
    if logits_slice == "last":
        x = x[:, -1:, :]
    return unembed(model.embed, x), aux


def encdec_prefill(model, cfg: ModelConfig, frames, tokens, cache_len: int,
                   *, chunk=1024):
    """Encode, run the decoder prompt and build the caches: (last-token
    logits, {"k", "v", "ck", "cv"})."""
    enc_out = encode(model, cfg, frames, chunk=chunk)
    x = embed(model.embed, tokens)
    ks, vs, cks, cvs = [], [], [], []
    for p_l in model.dec_layers:
        x, (k, v), (ck, cv) = _dec_layer_fwd(p_l, cfg, x, enc_out, chunk,
                                             collect=True)
        ks.append(k)
        vs.append(v)
        cks.append(ck)
        cvs.append(cv)
    x = rmsnorm(x[:, -1:, :], model.final_norm, cfg.rms_eps)
    dt = common.DTYPE
    cache = {"k": _fill_flat(torch.stack(ks), cache_len),
             "v": _fill_flat(torch.stack(vs), cache_len),
             "ck": torch.stack(cks).to(dt), "cv": torch.stack(cvs).to(dt)}
    return unembed(model.embed, x), cache


def encdec_decode_step(model, cfg: ModelConfig, cache, tokens, step):
    """One decoder token at ``step``: (logits (B, 1, V), cache), ``k``/``v``
    written in place; the RoPE tables and the slot mask are built once a
    step."""
    x = embed(model.embed, tokens)
    step, b, dev = int(step), x.shape[0], x.device
    kw = dict(rope_theta=cfg.rope_theta,
              tables=decode_rope_tables(b, step, cfg.hd, cfg.rope_theta, dev),
              valid=decode_valid(b, cache["k"].shape[2], step, ring=False,
                                 device=dev), **_gqa_kw(cfg))
    enc_len = cache["ck"].shape[2]
    for i, p_l in enumerate(model.dec_layers):
        hn = rmsnorm(x, p_l["ln1"], cfg.rms_eps)
        a_out, _, _ = gqa_decode(p_l["attn"], hn, cache["k"][i],
                                 cache["v"][i], step, **kw)
        x = x + a_out
        hn = rmsnorm(x, p_l["lnx"], cfg.rms_eps)
        x = x + cross_attn_forward(p_l["xattn"], hn,
                                   (cache["ck"][i], cache["cv"][i]),
                                   chunk=enc_len, **_gqa_kw(cfg))
        hn = rmsnorm(x, p_l["ln2"], cfg.rms_eps)
        x = x + mlp_apply(p_l["mlp"], hn, act=gelu)
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    return unembed(model.embed, x), cache


def encdec_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{name: (shape, dtype)}: self-attention ``k``/``v`` of ``cache_len``
    slots, cross ``ck``/``cv`` of ``enc_len``, all in the activation
    dtype."""
    kv = (cfg.n_kv_heads, cfg.hd)
    dt, L = common.DTYPE, cfg.n_layers
    return {"k": ((L, batch, cache_len) + kv, dt),
            "v": ((L, batch, cache_len) + kv, dt),
            "ck": ((L, batch, enc_len) + kv, dt),
            "cv": ((L, batch, enc_len) + kv, dt)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int,
               *, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in encdec_cache_spec(cfg, batch, cache_len,
                                                enc_len).items()}
