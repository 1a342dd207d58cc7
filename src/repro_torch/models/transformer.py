"""The dense decoder: per-layer modules, full-sequence forward, KV caches,
prefill and one-token decode.

The port of the dense family of ``repro.models.transformer``.  Where the
reference stacks its layers on a leading ``L`` axis and drives them with
``lax.scan``, the port holds an ``nn.ModuleList`` of ``DecoderLayer``s
and loops; per-layer heterogeneity (gemma2's local/global alternation)
is the same per-layer window limit.  Caches keep the reference's layout,
one tensor per entry with the layers stacked on axis 0, and decode writes
each layer's slot in place.

The MLA, MoE, ssm and hybrid branches wait for later slices (ROADMAP
queue 1); ``models.model.build_model`` refuses those configs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from . import common
from .attention import (decode_rope_tables, decode_valid, gqa_decode,
                        gqa_forward, gqa_init)
from .common import (embed, embedding_init, gelu, mlp_apply, mlp_init,
                     rmsnorm, rmsnorm_init, silu, unembed)

__all__ = ["BIG_WINDOW", "DecoderLayer", "decoder_init", "decoder_forward",
           "cache_spec", "init_cache", "decoder_prefill",
           "decoder_decode_step"]

BIG_WINDOW = 1 << 30


# --------------------------------------------------------------------------- #
# per-layer parameters
# --------------------------------------------------------------------------- #

def _attn_layer_init(generator, cfg: ModelConfig, *, device=None):
    """One layer's parameter tree, the reference's names: ``ln1``, ``attn``
    (``wq wk wv wo``), ``ln2``, ``mlp`` (``w_in w_gate w_out``) and, with
    sandwich norms, ``ln1_post``/``ln2_post``.  ``generator=None`` only
    allocates."""
    params = {"ln1": rmsnorm_init(cfg.d_model, device=device),
              "attn": gqa_init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, device=device),
              "ln2": rmsnorm_init(cfg.d_model, device=device),
              "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, gated=True,
                              device=device)}
    if cfg.sandwich_norm:
        params["ln1_post"] = rmsnorm_init(cfg.d_model, device=device)
        params["ln2_post"] = rmsnorm_init(cfg.d_model, device=device)
    return params


class DecoderLayer(nn.Module):
    """One attention + MLP block.  ``layer["attn"]["wq"]`` reads as the
    reference's ``p["attn"]["wq"]``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        for name, val in _attn_layer_init(None, cfg, device=device).items():
            if isinstance(val, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in val.items()}))
            else:
                setattr(self, name, nn.Parameter(val))

    def __getitem__(self, name: str):
        return getattr(self, name)


@torch.no_grad()
def load_tree(module: nn.Module, tree) -> None:
    """Copy a nested dict of arrays (torch or numpy) into ``module``'s
    parameters of the same names; every parameter must be given, with its
    shape.  The copy casts to the parameter's dtype and device."""
    own = dict(module.named_parameters())
    # an explicit stack, not a recursive closure: a closure that refers to
    # itself is a reference cycle, and would keep the given tensors alive
    # until the cyclic collector runs
    flat, stack = {}, [("", tree)]
    while stack:
        prefix, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}{k}.", v))
            else:
                flat[f"{prefix}{k}"] = v
    if set(flat) != set(own):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(own) - set(flat))}, unknown "
                       f"{sorted(set(flat) - set(own))}")
    for name, val in flat.items():
        p = own[name]
        if isinstance(val, np.ndarray) and not val.flags.writeable:
            val = val.copy()                 # a jax array's read-only view
        val = torch.as_tensor(val)
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(val.shape)}, the model "
                             f"holds {tuple(p.shape)}")
        p.copy_(val)


# --------------------------------------------------------------------------- #
# per-layer forward (forward / prefill)
# --------------------------------------------------------------------------- #

def _act(cfg: ModelConfig):
    return gelu if cfg.sandwich_norm else silu


def _attn_layer_fwd(p, cfg: ModelConfig, x, window_limit, *,
                    causal=True, chunk=1024, collect_kv=False):
    h = rmsnorm(x, p["ln1"], cfg.rms_eps)
    attn_out, kv = gqa_forward(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=causal, window=window_limit, attn_softcap=cfg.attn_softcap,
        query_scale=cfg.query_scale, chunk=chunk)
    if cfg.sandwich_norm:
        attn_out = rmsnorm(attn_out, p["ln1_post"], cfg.rms_eps)
    x = x + attn_out

    h = rmsnorm(x, p["ln2"], cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ff = mlp_apply(p["mlp"], h, act=_act(cfg))
    if cfg.sandwich_norm:
        ff = rmsnorm(ff, p["ln2_post"], cfg.rms_eps)
    x = x + ff
    return (x, aux, kv) if collect_kv else (x, aux)


def _window_limits(cfg: ModelConfig, n_layers: int):
    return [cfg.window if cfg.layer_kind(i) == "local" else BIG_WINDOW
            for i in range(n_layers)]


# --------------------------------------------------------------------------- #
# the decoder
# --------------------------------------------------------------------------- #

@torch.no_grad()
def decoder_init(model, generator: torch.Generator) -> None:
    """Fill ``model``'s parameters in place from ``generator``: the
    embedding table, each layer, the final norm and (untied) the unembed
    table, in that order.  One layer's fresh tensors are alive at a time."""
    cfg, dev = model.cfg, model.embed.device
    model.embed.copy_(embedding_init(generator, cfg.padded_vocab,
                                     cfg.d_model, device=dev))
    for layer in model.layers:
        load_tree(layer, _attn_layer_init(generator, cfg, device=dev))
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        model.unembed.copy_(embedding_init(generator, cfg.padded_vocab,
                                           cfg.d_model, device=dev))


def _unembed_w(model):
    return model.embed if model.cfg.tie_embeddings else model.unembed


def decoder_forward(model, cfg: ModelConfig, tokens, *, chunk=1024,
                    logits_slice: Optional[str] = None):
    """Full-sequence forward.

    logits_slice: None -> full logits; "last" -> last position only;
    "hidden" -> the final-normed hidden states.  Returns (logits, aux).
    """
    x = embed(model.embed, tokens, scale_by_dim=cfg.sandwich_norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l, limit in zip(model.layers, _window_limits(cfg, cfg.n_layers)):
        x, aux_l = _attn_layer_fwd(p_l, cfg, x, limit, chunk=chunk)
        aux = aux + aux_l
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    if logits_slice == "hidden":
        return x, aux
    if logits_slice == "last":
        x = x[:, -1:, :]
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), aux


# --------------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------------- #

def cache_spec(cfg: ModelConfig, batch: int, cache_len: int
               ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{name: (shape, dtype)} of this config's decode cache.

    SWA-everywhere configs get a RING cache of ``min(window, cache_len)``
    slots; paired local/global configs a ring for each local layer and a
    full-length cache for each global one; the rest a flat cache."""
    L = cfg.n_layers
    kv = (cfg.n_kv_heads, cfg.hd)
    dt = common.DTYPE
    if cfg.paired_local_global:
        half = L // 2
        w = min(cfg.window, cache_len)
        return {"k_loc": ((half, batch, w) + kv, dt),
                "v_loc": ((half, batch, w) + kv, dt),
                "k_glob": ((half, batch, cache_len) + kv, dt),
                "v_glob": ((half, batch, cache_len) + kv, dt)}
    t = min(cfg.window, cache_len) if cfg.uses_swa_everywhere else cache_len
    return {"k": ((L, batch, t) + kv, dt), "v": ((L, batch, t) + kv, dt)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_spec(cfg, batch, cache_len).items()}


def _finish_block(p_l, cfg: ModelConfig, h, attn_out):
    """Residual + MLP half of a decoder block (decode path)."""
    if cfg.sandwich_norm:
        attn_out = rmsnorm(attn_out, p_l["ln1_post"], cfg.rms_eps)
    h = h + attn_out
    hn = rmsnorm(h, p_l["ln2"], cfg.rms_eps)
    ff = mlp_apply(p_l["mlp"], hn, act=_act(cfg))
    if cfg.sandwich_norm:
        ff = rmsnorm(ff, p_l["ln2_post"], cfg.rms_eps)
    return h + ff


# --------------------------------------------------------------------------- #
# prefill (build decode caches from a prompt)
# --------------------------------------------------------------------------- #

def _fill_ring(k_stack, cache_len: int, window: int):
    """Place the last ``window`` positions of (L, B, S, ...) into ring
    slots ``(s-w ... s-1) % w``."""
    s = k_stack.shape[2]
    w = min(window, cache_len)
    out = torch.zeros(k_stack.shape[:2] + (w,) + k_stack.shape[3:],
                      dtype=common.DTYPE, device=k_stack.device)
    if s <= w:
        out[:, :, :s] = k_stack
        return out
    slots = torch.arange(s - w, s, device=k_stack.device) % w
    out[:, :, slots] = k_stack[:, :, s - w:].to(out.dtype)
    return out


def _fill_flat(k_stack, cache_len: int):
    out = torch.zeros(k_stack.shape[:2] + (cache_len,) + k_stack.shape[3:],
                      dtype=common.DTYPE, device=k_stack.device)
    out[:, :, :k_stack.shape[2]] = k_stack
    return out


def decoder_prefill(model, cfg: ModelConfig, tokens, *, cache_len: int,
                    chunk=1024):
    """Prompt pass: returns (last-token logits, decode cache)."""
    x = embed(model.embed, tokens, scale_by_dim=cfg.sandwich_norm)
    ks, vs = [], []
    for p_l, limit in zip(model.layers, _window_limits(cfg, cfg.n_layers)):
        x, _, (k, v) = _attn_layer_fwd(p_l, cfg, x, limit, chunk=chunk,
                                       collect_kv=True)
        ks.append(k)
        vs.append(v)
    k_s, v_s = torch.stack(ks), torch.stack(vs)
    if cfg.uses_swa_everywhere:
        cache = {"k": _fill_ring(k_s, cache_len, cfg.window),
                 "v": _fill_ring(v_s, cache_len, cfg.window)}
    elif cfg.paired_local_global:
        cache = {"k_loc": _fill_ring(k_s[0::2], cache_len, cfg.window),
                 "v_loc": _fill_ring(v_s[0::2], cache_len, cfg.window),
                 "k_glob": _fill_flat(k_s[1::2], cache_len),
                 "v_glob": _fill_flat(v_s[1::2], cache_len)}
    else:
        cache = {"k": _fill_flat(k_s, cache_len),
                 "v": _fill_flat(v_s, cache_len)}
    x = rmsnorm(x[:, -1:, :], model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache


# --------------------------------------------------------------------------- #
# decode step (one token)
# --------------------------------------------------------------------------- #

def decoder_decode_step(model, cfg: ModelConfig, cache, tokens, step):
    """One-token decode: returns (logits (B, 1, V), cache).  ``cache`` is
    updated in place (each layer writes its slot) and returned.  The RoPE
    tables and each kind of layer's slot mask are built once a step and
    shared by the layers."""
    x = embed(model.embed, tokens, scale_by_dim=cfg.sandwich_norm)
    step, b, dev = int(step), x.shape[0], x.device
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, attn_softcap=cfg.attn_softcap,
              query_scale=cfg.query_scale,
              tables=decode_rope_tables(b, step, cfg.hd, cfg.rope_theta, dev))
    if cfg.paired_local_global:
        # (local, global) layer pairs: the local layer's cache is a ring of
        # `window` slots, the global layer's is full length
        valid = {local: decode_valid(b, cache[name].shape[2], step,
                                     ring=local, device=dev)
                 for local, name in ((True, "k_loc"), (False, "k_glob"))}
        for i, p_l in enumerate(model.layers):
            j, local = i // 2, i % 2 == 0
            k_c = cache["k_loc" if local else "k_glob"][j]
            v_c = cache["v_loc" if local else "v_glob"][j]
            hn = rmsnorm(x, p_l["ln1"], cfg.rms_eps)
            a_out, _, _ = gqa_decode(p_l["attn"], hn, k_c, v_c, step,
                                     ring=local, valid=valid[local], **kw)
            x = _finish_block(p_l, cfg, x, a_out)
    else:
        ring = cfg.uses_swa_everywhere
        limits = _window_limits(cfg, cfg.n_layers)
        t = cache["k"].shape[2]
        valid = {lim: decode_valid(b, t, step, ring=ring, window_limit=lim,
                                   device=dev) for lim in set(limits)}
        for i, p_l in enumerate(model.layers):
            hn = rmsnorm(x, p_l["ln1"], cfg.rms_eps)
            a_out, _, _ = gqa_decode(p_l["attn"], hn, cache["k"][i],
                                     cache["v"][i], step, ring=ring,
                                     valid=valid[limits[i]], **kw)
            x = _finish_block(p_l, cfg, x, a_out)
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache
