"""GQA attention (RoPE, sliding window, softcap): chunked prefill attention
and single-token decode over a ring or flat KV cache.

The port of ``repro.models.attention`` (MLA and cross-attention wait for
later slices, ROADMAP queue 1).  Scores and outputs are float32 from
activation-dtype operands, as the reference's
``preferred_element_type=jnp.float32``: the operands are upcast (exact,
bfloat16 embeds in float32) before each product, and the probabilities
are cast back to the value dtype before the PV product.  Masks use
``NEG = -1e30``, not ``-inf``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from .common import _w, dense_init, rope_tables, rotate, softcap

__all__ = ["NEG", "chunked_attention", "decode_attention", "gqa_init",
           "gqa_forward", "decode_rope_tables", "decode_valid", "gqa_decode"]

NEG = -1e30


def _mm32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 output from any operand dtype."""
    return torch.einsum(eq, a.float(), b.float())


# --------------------------------------------------------------------------- #
# chunked prefill attention
# --------------------------------------------------------------------------- #

def chunked_attention(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Skv, K, hd)
    v: torch.Tensor,              # (B, Skv, K, vd)
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; returns (B, Sq, H, vd)."""
    b, sq, h, hd = q.shape
    _, skv, kh, vd = v.shape
    rep = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    chunk = min(chunk, skv)
    assert skv % chunk == 0, (skv, chunk)
    n_chunks = skv // chunk
    dev = q.device

    qh = q.reshape(b, sq, kh, rep, hd)
    kc = k.reshape(b, n_chunks, chunk, kh, hd)
    vc = v.reshape(b, n_chunks, chunk, kh, vd)
    pos_q = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, sq, kh, rep), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kh, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kh, rep, vd), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj, vj = kc[:, j], vc[:, j]
        s = _mm32("bqkrd,bckd->bqkrc", qh, kj.to(qh.dtype)) * scale
        if attn_softcap is not None:
            s = softcap(s, attn_softcap)
        pos_k = j * chunk + torch.arange(chunk, device=dev)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos_q[:, None] >= pos_k[None, :]
        if window is not None:
            mask &= (pos_q[:, None] - pos_k[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm32("bqkrc,bckd->bqkrd",
                                             p.to(vj.dtype), vj)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, vd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, hd)
    k_cache: torch.Tensor,        # (B, T, K, hd)
    v_cache: torch.Tensor,        # (B, T, K, vd)
    valid_mask: torch.Tensor,     # (B, T) bool: which slots hold real keys
    *,
    attn_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache."""
    b, _, h, hd = q.shape
    _, t, kh, vd = v_cache.shape
    rep = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(b, kh, rep, hd).to(k_cache.dtype)
    s = _mm32("bkrd,btkd->bkrt", qh, k_cache) * scale
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    s = torch.where(valid_mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = _mm32("bkrt,btkd->bkrd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, vd).to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA attention block
# --------------------------------------------------------------------------- #

def gqa_init(generator, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, *, device=None):
    return {
        "wq": dense_init(generator, d_model, n_heads * head_dim, device=device),
        "wk": dense_init(generator, d_model, n_kv * head_dim, device=device),
        "wv": dense_init(generator, d_model, n_kv * head_dim, device=device),
        "wo": dense_init(generator, n_heads * head_dim, d_model, device=device),
    }


def _project_qkv(params: Mapping[str, torch.Tensor], x, n_heads, n_kv,
                 head_dim):
    b, s, _ = x.shape
    q = (x @ _w(params, "wq", x)).reshape(b, s, n_heads, head_dim)
    k = (x @ _w(params, "wk", x)).reshape(b, s, n_kv, head_dim)
    v = (x @ _w(params, "wv", x)).reshape(b, s, n_kv, head_dim)
    return q, k, v


def gqa_forward(
    params, x, *,
    n_heads: int, n_kv: int, head_dim: int,
    rope_theta: float = 10_000.0,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    query_scale: Optional[float] = None,
    chunk: int = 1024,
):
    """Prefill/forward attention; returns ``(out, (k, v))`` so prefill can
    seed the decode cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    pos = torch.arange(s, device=x.device)[None, :]
    tables = rope_tables(pos, head_dim, rope_theta)     # shared by q and k
    q, k = rotate(q, tables), rotate(k, tables)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            attn_softcap=attn_softcap, chunk=chunk,
                            scale=query_scale)
    proj = out.reshape(b, s, n_heads * head_dim) @ _w(params, "wo", x)
    return proj, (k, v)


def decode_rope_tables(b: int, step: int, head_dim: int, rope_theta: float,
                       device) -> tuple:
    """RoPE ``(sin, cos)`` of the new token at absolute position ``step``,
    for a batch of ``b``."""
    pos = torch.full((b, 1), int(step), dtype=torch.int32, device=device)
    return rope_tables(pos, head_dim, rope_theta)


def decode_valid(b: int, t: int, step: int, *, ring: bool,
                 window_limit: Optional[int] = None, device=None):
    """(B, T) mask of the cache slots a token at ``step`` attends to.

    Ring cache: ``idx <= min(step, T-1)``.  Flat cache: ``idx <= step``,
    windowed by ``window_limit`` for local layers in a full-length cache."""
    idx = torch.arange(t, device=device)
    if ring:
        valid = idx <= min(step, t - 1)
    else:
        valid = idx <= step
        if window_limit is not None:
            valid &= idx > (step - int(window_limit))
    return valid[None, :].expand(b, t)


def gqa_decode(
    params, x, cache_k, cache_v, step: int, *,
    n_heads: int, n_kv: int, head_dim: int,
    rope_theta: float = 10_000.0,
    ring: bool = False,
    window_limit: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    query_scale: Optional[float] = None,
    tables=None,
    valid=None,
):
    """One-token decode.  ``step`` is the absolute position of the new token.

    Flat cache: slot = step; ring cache: slot = step % T (see
    ``decode_valid`` for the slots attended to).  ``tables`` and ``valid``
    depend only on ``step`` and the cache's shape, so a decoder builds
    them once a step (``decode_rope_tables``, ``decode_valid``) and passes
    them to every layer; left ``None`` they are built here.
    ``cache_k``/``cache_v`` are written IN PLACE at the slot (the
    reference returns updated copies); returns ``(out, cache_k, cache_v)``.
    """
    b, one, _ = x.shape
    t = cache_k.shape[1]
    step = int(step)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    if tables is None:
        tables = decode_rope_tables(b, step, head_dim, rope_theta, x.device)
    q, k = rotate(q, tables), rotate(k, tables)

    slot = (step % t) if ring else step      # ring: overwrite the oldest slot
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    if valid is None:
        valid = decode_valid(b, t, step, ring=ring,
                             window_limit=window_limit, device=x.device)

    out = decode_attention(q, cache_k, cache_v, valid,
                           attn_softcap=attn_softcap, scale=query_scale)
    proj = out.reshape(b, 1, n_heads * head_dim) @ _w(params, "wo", x)
    return proj, cache_k, cache_v

