"""Decoder stacks (dense, MoE, vlm, MLA, ssm, hybrid): per-layer
modules, full-sequence forward, decode caches, prefill and one-token
decode.

The port of ``repro.models.transformer``.  Where the reference stacks
its layers on a leading ``L`` axis and drives them with ``lax.scan``,
the port holds an ``nn.ModuleList`` of layers (``DecoderLayer`` for
attention blocks, ``MambaLayer`` for Mamba2 blocks) and loops; per-layer
heterogeneity (gemma2's local/global alternation) is the same per-layer
window limit.
Caches keep the reference's layout, one tensor per entry with the layers
stacked on axis 0; prefill fills them and decode writes each layer's
slot, conv tails and SSM state in place.

The hybrid (zamba2) stacks its Mamba2 layers in segments of
``attn_every``, each followed by one of ``n_shared_attn`` shared
attention blocks, cycled; the shared blocks are a second stack,
``shared``.  An MoE layer holds ``moe`` (``models.moe``) in place of
``mlp``; its aux loss is summed over the layers by the forward and
dropped by decode, as in the reference.  The vlm feeds pre-embedded
inputs (``x_embed``) rotated by M-RoPE ids (``positions3``) and decodes
at a RoPE position of its own (``rope_pos``).  The enc-dec stacks live
in ``models.encdec``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.partitioning import (placed_zeros, replicate_like,
                                        set_at, shard)
from . import common
from .attention import (GQA_AXES, MLA_AXES, decode_rope_tables,
                        decode_valid, gqa_decode, gqa_forward, gqa_init,
                        mla_decode, mla_forward, mla_init)
from .common import (MLP_AXES, NORM_AXES, embed, embedding_init, gelu,
                     mlp_apply, mlp_init, rmsnorm, rmsnorm_init, silu,
                     unembed)
from .moe import MOE_AXES, moe_apply, moe_init
from .ssm import (CONV_K, MAMBA2_AXES, mamba2_decode, mamba2_forward,
                  mamba2_init)

__all__ = ["BIG_WINDOW", "DecoderLayer", "MambaLayer", "decoder_init",
           "decoder_forward", "cache_spec", "cache_axes", "init_cache",
           "decoder_prefill",
           "decoder_decode_step", "hybrid_init", "hybrid_forward",
           "hybrid_prefill", "hybrid_decode_step"]

BIG_WINDOW = 1 << 30


# --------------------------------------------------------------------------- #
# per-layer parameters
# --------------------------------------------------------------------------- #

def _attn_layer_init(generator, cfg: ModelConfig, *, device=None):
    """One attention layer's parameter tree, the reference's names:
    ``ln1``, ``attn`` (GQA ``wq wk wv wo``, or MLA ``w_dq w_uq w_dkv
    w_kpe w_uk w_uv wo``), ``ln2``, ``mlp`` (``w_in w_gate w_out``) and,
    with sandwich norms, ``ln1_post``/``ln2_post``; an MoE layer holds
    ``moe`` (``router w_in w_gate w_out``) in place of ``mlp``.
    ``generator=None`` only allocates."""
    if cfg.mla:
        attn = mla_init(generator, cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
                        kv_lora=cfg.kv_lora, nope_dim=cfg.nope_dim,
                        rope_dim=cfg.rope_dim, v_dim=cfg.v_dim, device=device)
    else:
        attn = gqa_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd, device=device)
    params = {"ln1": rmsnorm_init(cfg.d_model, device=device),
              "attn": attn,
              "ln2": rmsnorm_init(cfg.d_model, device=device)}
    if cfg.n_experts:
        params["moe"] = moe_init(generator, cfg.d_model, cfg.d_ff,
                                 cfg.n_experts, device=device)
    else:
        params["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                 gated=True, device=device)
    if cfg.sandwich_norm:
        params["ln1_post"] = rmsnorm_init(cfg.d_model, device=device)
        params["ln2_post"] = rmsnorm_init(cfg.d_model, device=device)
    return params


def _attn_layer_axes(cfg: ModelConfig):
    """The reference's logical axes of ``_attn_layer_init``'s tree (one
    layer: no leading ``"layers"``)."""
    axes = {"ln1": NORM_AXES, "attn": MLA_AXES if cfg.mla else GQA_AXES,
            "ln2": NORM_AXES}
    if cfg.n_experts:
        axes["moe"] = MOE_AXES
    else:
        axes["mlp"] = MLP_AXES
    if cfg.sandwich_norm:
        axes["ln1_post"] = axes["ln2_post"] = NORM_AXES
    return axes


def _mamba_layer_init(generator, cfg: ModelConfig, *, device=None):
    """One Mamba2 layer's parameter tree: ``ln`` and ``mamba``
    (``ssm.mamba2_init``'s names)."""
    return {"ln": rmsnorm_init(cfg.d_model, device=device),
            "mamba": mamba2_init(generator, cfg.d_model,
                                 expand=cfg.ssm_expand,
                                 head_p=cfg.ssm_head_p, state=cfg.ssm_state,
                                 device=device)}


class _Layer(nn.Module):
    """A layer holding the parameter tree ``param_tree(None, cfg)`` allocates,
    under the same names: ``layer["attn"]["wq"]`` reads as the
    reference's ``p["attn"]["wq"]``.  ``param_axes(cfg)`` is the same tree
    of the reference's logical axes."""

    param_tree = None
    param_axes = None

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        for name, val in self.param_tree(None, cfg, device=device).items():
            if isinstance(val, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in val.items()}))
            else:
                setattr(self, name, nn.Parameter(val))

    def __getitem__(self, name: str):
        return getattr(self, name)


class DecoderLayer(_Layer):
    """One attention (GQA or MLA) + MLP (or MoE) block."""

    param_tree = staticmethod(_attn_layer_init)
    param_axes = staticmethod(_attn_layer_axes)


class MambaLayer(_Layer):
    """One Mamba2 block: ``ln`` and ``mamba`` (``w_z w_x w_b w_c w_dt
    conv_x conv_b conv_c A_log dt_bias D norm w_out``)."""

    param_tree = staticmethod(_mamba_layer_init)
    param_axes = staticmethod(lambda cfg: {"ln": NORM_AXES,
                                           "mamba": MAMBA2_AXES})


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


def _ffn(p, cfg: ModelConfig, h):
    """The block's feed-forward half on the normed stream: (out, aux),
    aux the MoE's load-balancing loss (None for an MLP)."""
    if cfg.n_experts:
        return moe_apply(p["moe"], h, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor)
    return mlp_apply(p["mlp"], h, act=_act(cfg)), None


def _attn_layer_fwd(p, cfg: ModelConfig, x, window_limit, *,
                    positions3=None, causal=True, chunk=1024,
                    collect_kv=False):
    h = rmsnorm(x, p["ln1"], cfg.rms_eps)
    if cfg.mla:
        attn_out, kv = mla_forward(
            p["attn"], h, n_heads=cfg.n_heads, q_lora=cfg.q_lora,
            kv_lora=cfg.kv_lora, nope_dim=cfg.nope_dim,
            rope_dim=cfg.rope_dim, v_dim=cfg.v_dim,
            rope_theta=cfg.rope_theta, chunk=chunk)
    else:
        attn_out, kv = gqa_forward(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections, positions3=positions3,
            causal=causal, window=window_limit,
            attn_softcap=cfg.attn_softcap, query_scale=cfg.query_scale,
            chunk=chunk)
    if cfg.sandwich_norm:
        attn_out = rmsnorm(attn_out, p["ln1_post"], cfg.rms_eps)
    x = x + attn_out

    ff, aux = _ffn(p, cfg, rmsnorm(x, p["ln2"], cfg.rms_eps))
    if aux is None:
        aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                         device=x.device), x)
    if cfg.sandwich_norm:
        ff = rmsnorm(ff, p["ln2_post"], cfg.rms_eps)
    x = x + ff
    return (x, aux, kv) if collect_kv else (x, aux)


def _window_limits(cfg: ModelConfig, n_layers: int):
    return [cfg.window if cfg.layer_kind(i) == "local" else BIG_WINDOW
            for i in range(n_layers)]


def _mamba_kw(cfg: ModelConfig):
    return dict(d_model=cfg.d_model, expand=cfg.ssm_expand,
                head_p=cfg.ssm_head_p, state=cfg.ssm_state)


def _mamba_layer_fwd(p, cfg: ModelConfig, x, chunk=256):
    """``x + mamba(rmsnorm(x))`` over the full sequence, the SSD in chunks
    of ``chunk`` (``mamba2_forward``'s default unless given)."""
    return x + mamba2_forward(p["mamba"], rmsnorm(x, p["ln"], cfg.rms_eps),
                              chunk=chunk, **_mamba_kw(cfg))


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat == "full"``
    and autograd records (the reference's ``jax.checkpoint``): it keeps
    only its inputs for the backward pass, which runs it again."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


# --------------------------------------------------------------------------- #
# the decoder
# --------------------------------------------------------------------------- #

@torch.no_grad()
def decoder_init(model, generator: torch.Generator) -> None:
    """Fill ``model``'s parameters in place from ``generator``: the
    embedding table, each layer (Mamba2 layers for the ssm family), the
    final norm and (untied) the unembed table, in that order.  One layer's
    fresh tensors are alive at a time."""
    cfg, dev = model.cfg, model.embed.device
    model.embed.copy_(embedding_init(generator, cfg.padded_vocab,
                                     cfg.d_model, device=dev))
    for layer in model.layers:
        load_tree(layer, layer.param_tree(generator, cfg, device=dev))
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        model.unembed.copy_(embedding_init(generator, cfg.padded_vocab,
                                           cfg.d_model, device=dev))


def _unembed_w(model):
    """The unembedding table: ``unembed`` where the model has one (untied,
    not hybrid), else ``embed``."""
    return getattr(model, "unembed", model.embed)


def _embed_or(model, cfg: ModelConfig, tokens, x_embed):
    """The input stream: ``x_embed`` as given (the vlm's patches and text),
    else the tokens embedded."""
    if x_embed is not None:
        return x_embed
    return embed(model.embed, tokens, scale_by_dim=cfg.sandwich_norm)


def decoder_forward(model, cfg: ModelConfig, tokens=None, *, x_embed=None,
                    positions3=None, chunk=1024,
                    logits_slice: Optional[str] = None):
    """Full-sequence forward over ``tokens`` or the pre-embedded
    ``x_embed`` (rotated by the M-RoPE ids ``positions3`` where the
    config has ``mrope_sections``).

    logits_slice: None -> full logits; "last" -> last position only;
    "hidden" -> the final-normed hidden states.  Returns (logits, aux),
    aux the MoE layers' summed load-balancing loss.
    With ``cfg.remat == "full"`` and autograd recording, each layer runs
    under ``torch.utils.checkpoint``.  The ssm family's SSD runs in
    chunks of ``cfg.ssd_chunk``.
    """
    x = shard(_embed_or(model, cfg, tokens, x_embed), "batch", "seq", "embed")
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    if cfg.family == "ssm":
        layer = _remat(_mamba_layer_fwd, cfg)
        for p_l in model.layers:
            x = layer(p_l, cfg, x, cfg.ssd_chunk)
    else:
        layer = _remat(_attn_layer_fwd, cfg)
        for p_l, limit in zip(model.layers,
                              _window_limits(cfg, cfg.n_layers)):
            x, aux_l = layer(p_l, cfg, x, limit, positions3=positions3,
                             chunk=chunk)
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

    ssm: each layer's conv tails (``conv_x``, ``conv_b``, ``conv_c``, the
    activation dtype) and SSD state (``ssm``, float32); hybrid: those, and
    a flat KV cache per shared-block application; MLA: flat latent
    ``ckv`` and rotated ``kpe`` caches.  SWA-everywhere configs get a RING
    cache of ``min(window, cache_len)`` slots; paired local/global configs
    a ring for each local layer and a full-length cache for each global
    one; the rest a flat cache."""
    L = cfg.n_layers
    kv = (cfg.n_kv_heads, cfg.hd)
    dt = common.DTYPE
    if cfg.family in ("ssm", "hybrid"):
        hp, n = (cfg.ssm_heads, cfg.ssm_head_p), cfg.ssm_state
        spec = {"conv_x": ((L, batch, CONV_K - 1) + hp, dt),
                "conv_b": ((L, batch, CONV_K - 1, n), dt),
                "conv_c": ((L, batch, CONV_K - 1, n), dt),
                "ssm": ((L, batch) + hp + (n,), torch.float32)}
        if cfg.family == "hybrid":
            n_app = L // cfg.attn_every
            spec["k"] = ((n_app, batch, cache_len) + kv, dt)
            spec["v"] = ((n_app, batch, cache_len) + kv, dt)
        return spec
    if cfg.mla:
        return {"ckv": ((L, batch, cache_len, cfg.kv_lora), dt),
                "kpe": ((L, batch, cache_len, cfg.rope_dim), dt)}
    if cfg.paired_local_global:
        half = L // 2
        w = min(cfg.window, cache_len)
        return {"k_loc": ((half, batch, w) + kv, dt),
                "v_loc": ((half, batch, w) + kv, dt),
                "k_glob": ((half, batch, cache_len) + kv, dt),
                "v_glob": ((half, batch, cache_len) + kv, dt)}
    t = min(cfg.window, cache_len) if cfg.uses_swa_everywhere else cache_len
    return {"k": ((L, batch, t) + kv, dt), "v": ((L, batch, t) + kv, dt)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """The reference's logical axes of each entry of ``cache_spec`` (the
    caches keep the stacked layout, so ``"layers"`` leads)."""
    layers = ("layers", "batch", "kv_len", "kv_heads", None)
    if cfg.family in ("ssm", "hybrid"):
        conv_bc = ("layers", "batch", None, None)
        axes = {"conv_x": ("layers", "batch", None, None, "ssm_inner"),
                "conv_b": conv_bc, "conv_c": conv_bc,
                "ssm": ("layers", "batch", None, "ssm_inner", None)}
        if cfg.family == "hybrid":
            axes["k"] = axes["v"] = layers
        return axes
    if cfg.mla:
        return dict.fromkeys(("ckv", "kpe"),
                             ("layers", "batch", "kv_len", None))
    if cfg.paired_local_global:
        return dict.fromkeys(("k_loc", "v_loc", "k_glob", "v_glob"), layers)
    return {"k": layers, "v": layers}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device=None, like=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches on ``device``; given ``like``, a DTensor of a
    model on a mesh under rules, each entry is placed by ``cache_axes``
    (``partitioning.placed_zeros``)."""
    if like is not None:
        axes = cache_axes(cfg)
        return {k: placed_zeros(s, dt, like, axes[k])
                for k, (s, dt) in cache_spec(cfg, batch, cache_len).items()}
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_spec(cfg, batch, cache_len).items()}


def _finish_block(p_l, cfg: ModelConfig, h, attn_out):
    """Residual + MLP half of a decoder block (decode path)."""
    if cfg.sandwich_norm:
        attn_out = rmsnorm(attn_out, p_l["ln1_post"], cfg.rms_eps)
    h = h + attn_out
    ff, _ = _ffn(p_l, cfg, rmsnorm(h, p_l["ln2"], cfg.rms_eps))
    if cfg.sandwich_norm:
        ff = rmsnorm(ff, p_l["ln2_post"], cfg.rms_eps)
    return h + ff


# --------------------------------------------------------------------------- #
# prefill (build decode caches from a prompt)
# --------------------------------------------------------------------------- #

def _fill_ring(k_stack, cache_len: int, window: int, axes):
    """Place the last ``window`` positions of (L, B, S, ...) into ring
    slots ``(s-w ... s-1) % w``: a cache (placed by ``axes`` on a mesh)
    that holds position ``p`` at slot ``p % w``."""
    s = k_stack.shape[2]
    w = min(window, cache_len)
    out = placed_zeros(k_stack.shape[:2] + (w,) + k_stack.shape[3:],
                       common.DTYPE, k_stack, axes)
    if s <= w:
        return set_at(out, (slice(None), slice(None), slice(0, s)), k_stack)
    r = s % w                   # the slot of position s - w
    last = k_stack[:, :, s - w:]
    set_at(out, (slice(None), slice(None), slice(r, w)), last[:, :, :w - r])
    if r:
        set_at(out, (slice(None), slice(None), slice(0, r)),
               last[:, :, w - r:])
    return out


def _fill_flat(k_stack, cache_len: int, axes):
    out = placed_zeros(k_stack.shape[:2] + (cache_len,) + k_stack.shape[3:],
                       common.DTYPE, k_stack, axes)
    return set_at(out, (slice(None), slice(None), slice(0, k_stack.shape[2])),
                  k_stack)


def _mamba_prefill(p_l, cfg: ModelConfig, x, cache, i: int):
    """One Mamba2 layer over the prompt (SSD chunk ``cfg.ssd_chunk``):
    writes its conv tails and final state into layer ``i`` of ``cache``;
    returns the residual stream."""
    out, (conv, state) = mamba2_forward(
        p_l["mamba"], rmsnorm(x, p_l["ln"], cfg.rms_eps),
        chunk=cfg.ssd_chunk, return_state=True, **_mamba_kw(cfg))
    for name in ("x", "b", "c"):
        set_at(cache[f"conv_{name}"], (i,), conv[name])
    set_at(cache["ssm"], (i,), state)
    return x + out


def decoder_prefill(model, cfg: ModelConfig, tokens=None, *, x_embed=None,
                    cache_len: int, positions3=None, chunk=1024):
    """Prompt pass over ``tokens`` or ``x_embed`` (see
    ``decoder_forward``): returns (last-token logits, decode cache)."""
    x = shard(_embed_or(model, cfg, tokens, x_embed), "batch", "seq", "embed")
    if cfg.family == "ssm":
        cache = init_cache(cfg, x.shape[0], cache_len, like=x)
        for i, p_l in enumerate(model.layers):
            x = _mamba_prefill(p_l, cfg, x, cache, i)
        x = rmsnorm(x[:, -1:, :], model.final_norm, cfg.rms_eps)
        return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache
    ks, vs = [], []
    for p_l, limit in zip(model.layers, _window_limits(cfg, cfg.n_layers)):
        x, _, (k, v) = _attn_layer_fwd(p_l, cfg, x, limit,
                                       positions3=positions3, chunk=chunk,
                                       collect_kv=True)
        ks.append(k)
        vs.append(v)
    k_s, v_s = torch.stack(ks), torch.stack(vs)
    axes = cache_axes(cfg)
    if cfg.mla:
        cache = {"ckv": _fill_flat(k_s, cache_len, axes["ckv"]),
                 "kpe": _fill_flat(v_s, cache_len, axes["kpe"])}
    elif cfg.uses_swa_everywhere:
        cache = {"k": _fill_ring(k_s, cache_len, cfg.window, axes["k"]),
                 "v": _fill_ring(v_s, cache_len, cfg.window, axes["v"])}
    elif cfg.paired_local_global:
        ring = functools.partial(_fill_ring, cache_len=cache_len,
                                 window=cfg.window, axes=axes["k_loc"])
        flat = functools.partial(_fill_flat, cache_len=cache_len,
                                 axes=axes["k_glob"])
        cache = {"k_loc": ring(k_s[0::2]), "v_loc": ring(v_s[0::2]),
                 "k_glob": flat(k_s[1::2]), "v_glob": flat(v_s[1::2])}
    else:
        cache = {"k": _fill_flat(k_s, cache_len, axes["k"]),
                 "v": _fill_flat(v_s, cache_len, axes["v"])}
    x = rmsnorm(x[:, -1:, :], model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache


# --------------------------------------------------------------------------- #
# decode step (one token)
# --------------------------------------------------------------------------- #

def decoder_decode_step(model, cfg: ModelConfig, cache, tokens, step,
                        rope_pos: Optional[int] = None):
    """One-token decode: returns (logits (B, 1, V), cache).  ``cache`` is
    updated in place (each layer writes its slot, or its conv tails and
    SSD state) and returned.  The RoPE tables and each kind of layer's
    slot mask are built once a step and shared by the layers; a GQA
    stack rotates the token to ``rope_pos`` where that is given (the
    vlm), else to ``step``."""
    x = embed(model.embed, tokens, scale_by_dim=cfg.sandwich_norm)
    step, b, dev = int(step), x.shape[0], x.device
    if cfg.family == "ssm":
        for i, p_l in enumerate(model.layers):
            x = _mamba_decode(p_l, cfg, x, cache, i)
    elif cfg.mla:
        kw = dict(n_heads=cfg.n_heads, nope_dim=cfg.nope_dim,
                  rope_dim=cfg.rope_dim, v_dim=cfg.v_dim,
                  rope_theta=cfg.rope_theta,
                  tables=decode_rope_tables(b, step, cfg.rope_dim,
                                            cfg.rope_theta, dev),
                  valid=decode_valid(b, cache["ckv"].shape[2], step,
                                     ring=False, device=dev))
        for i, p_l in enumerate(model.layers):
            hn = rmsnorm(x, p_l["ln1"], cfg.rms_eps)
            a_out, _, _ = mla_decode(p_l["attn"], hn, cache["ckv"][i],
                                     cache["kpe"][i], step, **kw)
            x = _finish_block(p_l, cfg, x, a_out)
    else:
        x = _gqa_decode_layers(model, cfg, cache, x, step,
                               step if rope_pos is None else int(rope_pos))
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache


def _mamba_decode(p_l, cfg: ModelConfig, x, cache, i: int):
    """One Mamba2 layer for one token, on layer ``i`` of ``cache`` in
    place; returns the residual stream."""
    conv = {name: cache[f"conv_{name}"][i] for name in ("x", "b", "c")}
    out, _, _ = mamba2_decode(p_l["mamba"], rmsnorm(x, p_l["ln"], cfg.rms_eps),
                              conv, cache["ssm"][i], **_mamba_kw(cfg))
    return x + out


def _gqa_decode_layers(model, cfg: ModelConfig, cache, x, step: int,
                      rope_pos: int):
    """The GQA decoder's layers for one token at ``step``, rotated to
    ``rope_pos`` (see ``decoder_decode_step``); returns the residual
    stream."""
    b, dev = x.shape[0], x.device
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, attn_softcap=cfg.attn_softcap,
              query_scale=cfg.query_scale,
              tables=decode_rope_tables(b, rope_pos, cfg.hd, cfg.rope_theta,
                                        dev))
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
    return x


# --------------------------------------------------------------------------- #
# hybrid (zamba2): Mamba2 backbone + shared attention blocks
# --------------------------------------------------------------------------- #

@torch.no_grad()
def hybrid_init(model, generator: torch.Generator) -> None:
    """Fill a hybrid ``model`` in place from ``generator``: the embedding
    table, each Mamba2 layer, each shared block, the final norm."""
    cfg, dev = model.cfg, model.embed.device
    model.embed.copy_(embedding_init(generator, cfg.padded_vocab,
                                     cfg.d_model, device=dev))
    for layer in list(model.layers) + list(model.shared):
        load_tree(layer, layer.param_tree(generator, cfg, device=dev))
    model.final_norm.fill_(1.0)


def _hybrid_segments(cfg: ModelConfig) -> int:
    """Segments of ``attn_every`` Mamba2 layers, each followed by a shared
    block (0 when ``n_layers < attn_every``: no attention at all)."""
    return cfg.n_layers // cfg.attn_every


def _segment(model, cfg: ModelConfig, seg: int):
    """(the segment's Mamba2 layers with their layer indices, its shared
    block: the blocks are cycled)."""
    lo = seg * cfg.attn_every
    layers = list(enumerate(model.layers))[lo:lo + cfg.attn_every]
    return layers, model.shared[seg % cfg.n_shared_attn]


def hybrid_forward(model, cfg: ModelConfig, tokens, *, chunk=1024,
                   logits_slice: Optional[str] = None):
    """Full-sequence forward; the SSD runs at ``mamba2_forward``'s default
    chunk (256), not ``cfg.ssd_chunk``, as in the reference.  Under remat
    only the Mamba2 layers are recomputed; the shared blocks keep their
    activations."""
    x = embed(model.embed, tokens)
    mamba = _remat(_mamba_layer_fwd, cfg)
    for seg in range(_hybrid_segments(cfg)):
        layers, shared = _segment(model, cfg, seg)
        for _, p_l in layers:
            x = mamba(p_l, cfg, x)
        x, _ = _attn_layer_fwd(shared, cfg, x, BIG_WINDOW, chunk=chunk)
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    if logits_slice == "hidden":
        return x, aux
    if logits_slice == "last":
        x = x[:, -1:, :]
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), aux


def hybrid_prefill(model, cfg: ModelConfig, tokens, cache_len: int, *,
                   chunk=1024):
    """Prompt pass: (last-token logits, cache).  The SSD runs in chunks of
    ``cfg.ssd_chunk``; the cache holds the segments' Mamba2 layers and
    one flat KV cache per shared-block application."""
    x = embed(model.embed, tokens)
    n_seg = _hybrid_segments(cfg)
    cache = init_cache(cfg, x.shape[0], cache_len, like=x)
    for name in ("conv_x", "conv_b", "conv_c", "ssm"):
        cache[name] = cache[name][:n_seg * cfg.attn_every]
    s = x.shape[1]
    for seg in range(n_seg):
        layers, shared = _segment(model, cfg, seg)
        for i, p_l in layers:
            x = _mamba_prefill(p_l, cfg, x, cache, i)
        x, _, (k, v) = _attn_layer_fwd(shared, cfg, x, BIG_WINDOW,
                                       chunk=chunk, collect_kv=True)
        set_at(cache["k"], (seg, slice(None), slice(0, s)), k)
        set_at(cache["v"], (seg, slice(None), slice(0, s)), v)
    x = rmsnorm(x[:, -1:, :], model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache


def hybrid_decode_step(model, cfg: ModelConfig, cache, tokens, step):
    """One-token decode: (logits (B, 1, V), cache), the cache updated in
    place.  The shared blocks' RoPE tables and slot mask are built once a
    step."""
    x = embed(model.embed, tokens)
    step, b, dev = int(step), x.shape[0], x.device
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, ring=False, window_limit=None,
              tables=decode_rope_tables(b, step, cfg.hd, cfg.rope_theta, dev),
              valid=decode_valid(b, cache["k"].shape[2], step, ring=False,
                                 device=dev))
    for seg in range(_hybrid_segments(cfg)):
        layers, shared = _segment(model, cfg, seg)
        for i, p_l in layers:
            x = _mamba_decode(p_l, cfg, x, cache, i)
        hn = rmsnorm(x, shared["ln1"], cfg.rms_eps)
        a_out, _, _ = gqa_decode(shared["attn"], hn, cache["k"][seg],
                                 cache["v"][seg], step, **kw)
        x = x + a_out
        hn = rmsnorm(x, shared["ln2"], cfg.rms_eps)
        x = x + mlp_apply(shared["mlp"], hn)
    x = rmsnorm(x, model.final_norm, cfg.rms_eps)
    return unembed(_unembed_w(model), x, cap=cfg.final_softcap), cache
