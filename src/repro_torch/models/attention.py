"""Attention layers: GQA (RoPE or Qwen2-VL's M-RoPE, sliding window,
softcap) with chunked prefill attention and single-token decode over a
ring or flat KV cache, MLA (MiniCPM3/DeepSeek-V2-style multi-head latent
attention), whose decode runs in the latent space over ``ckv``/``kpe``
caches, and the enc-dec's cross-attention (non-causal, no RoPE, over the
encoder's keys and values).

The port of ``repro.models.attention``.  Scores and outputs are float32 from
activation-dtype operands, as the reference's
``preferred_element_type=jnp.float32``: the operands are upcast (exact,
bfloat16 embeds in float32) before each product, and the probabilities
are cast back to the value dtype before the PV product.  Masks use
``NEG = -1e30``, not ``-inf``.  On a mesh the attention core runs on
each rank's local block (``_sharded_attention``).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch

from ..distributed.partitioning import is_dtensor, shard
from .common import (_w, dense_init, mrope_tables, rope_tables, rotate,
                     softcap)

__all__ = ["NEG", "chunked_attention", "decode_attention", "gqa_init",
           "gqa_forward", "decode_rope_tables", "decode_valid", "gqa_decode",
           "mla_init", "mla_forward", "mla_decode", "cross_attn_forward",
           "cross_kv", "GQA_AXES", "MLA_AXES"]

NEG = -1e30

# the reference's logical axes of the attention parameters
GQA_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
MLA_AXES = {"w_dq": ("embed", "q_lora"), "w_uq": ("q_lora", "heads"),
            "w_dkv": ("embed", "kv_lora"), "w_kpe": ("embed", None),
            "w_uk": ("kv_lora", "heads"), "w_uv": ("kv_lora", "heads"),
            "wo": ("heads", "embed")}


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
    """Online-softmax attention over KV chunks; returns (B, Sq, H, vd).
    DTensor operands run as ``_sharded_attention``."""
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              attn_softcap=attn_softcap, chunk=chunk, scale=scale)
    if is_dtensor(q):
        return _sharded_attention(q, k, v, **kw)
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


def _sharded_attention(q, k, v, *, q_offset: int = 0, **kw):
    """``chunked_attention`` of DTensors, each rank on its local block:
    attention is independent across batch rows and (GQA-aligned) heads,
    so a rank keeps q's batch and head shards, takes k/v alike, and with
    q's sequence sharded (context parallel, "attn_seq") the whole k/v
    sequence and an offset for its causal mask.  Any other placement is
    gathered first.  (Run through DTensor, the score einsums merge the
    data-sharded batch with the model-sharded heads into one bmm batch
    dim, a ``_StridedShard`` whose redistribution plans cost seconds
    each.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    qp, kp = [], []
    for i, p in enumerate(q.placements):
        if p == Shard(0):
            qp.append(p)
            kp.append(p)
        elif p == Shard(2) and k.placements[i] == Shard(2):
            qp.append(p)
            kp.append(p)
        elif p == Shard(1):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            q_offset += min(r * -(-q.shape[1] // n), q.shape[1])
            qp.append(p)
            kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    q, k, v = (q.redistribute(mesh, qp), k.redistribute(mesh, kp),
               v.redistribute(mesh, kp))
    out = chunked_attention(q.to_local(), k.to_local(), v.to_local(),
                            q_offset=q_offset, **kw)
    return DTensor.from_local(out, mesh, qp, run_check=False)


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
    q = shard(q, "batch", "attn_seq", "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def gqa_forward(
    params, x, *,
    n_heads: int, n_kv: int, head_dim: int,
    rope_theta: float = 10_000.0,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
    positions3: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    query_scale: Optional[float] = None,
    chunk: int = 1024,
):
    """Prefill/forward attention; returns ``(out, (k, v))`` so prefill can
    seed the decode cache.  Positions are ``arange(S)``, or with
    ``mrope_sections`` the (B, S, 3) M-RoPE ids ``positions3``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    if mrope_sections is not None:
        tables = mrope_tables(positions3, head_dim, mrope_sections,
                              rope_theta)
    else:
        pos = torch.arange(s, device=x.device)[None, :]
        tables = rope_tables(pos, head_dim, rope_theta)
    q, k = rotate(q, tables), rotate(k, tables)         # one table for both
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            attn_softcap=attn_softcap, chunk=chunk,
                            scale=query_scale)
    out = shard(out, "batch", "attn_seq", "heads", None)
    proj = out.reshape(b, s, n_heads * head_dim) @ _w(params, "wo", x)
    return shard(proj, "batch", "seq", "embed"), (k, v)


def decode_rope_tables(b: int, pos: int, head_dim: int, rope_theta: float,
                       device) -> tuple:
    """RoPE ``(sin, cos)`` of the new token at RoPE position ``pos`` (its
    absolute position ``step`` unless the model says otherwise: the vlm's
    text continues after the image's grid), for a batch of ``b``."""
    pos = torch.full((b, 1), int(pos), dtype=torch.int32, device=device)
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
    depend only on the step and the cache's shape, so a decoder builds
    them once a step (``decode_rope_tables``, at the vlm's RoPE position
    where that differs from ``step``; ``decode_valid``) and passes them to
    every layer; left ``None`` they are built here, at ``step``.
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


# --------------------------------------------------------------------------- #
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# --------------------------------------------------------------------------- #

def mla_init(generator, d_model: int, n_heads: int, *, q_lora: int,
             kv_lora: int, nope_dim: int, rope_dim: int, v_dim: int,
             device=None):
    def dense(i, o):
        return dense_init(generator, i, o, device=device)
    return {
        "w_dq": dense(d_model, q_lora),
        "w_uq": dense(q_lora, n_heads * (nope_dim + rope_dim)),
        "w_dkv": dense(d_model, kv_lora),
        "w_kpe": dense(d_model, rope_dim),
        "w_uk": dense(kv_lora, n_heads * nope_dim),
        "w_uv": dense(kv_lora, n_heads * v_dim),
        "wo": dense(n_heads * v_dim, d_model),
    }


def _mla_q(params, x, n_heads, nope_dim, rope_dim):
    """(q_nope (b, s, H, nope), q_pe (b, s, H, rope)), not yet rotated."""
    b, s, _ = x.shape
    q = (x @ _w(params, "w_dq", x)) @ _w(params, "w_uq", x)
    q = q.reshape(b, s, n_heads, nope_dim + rope_dim)
    return q[..., :nope_dim], q[..., nope_dim:]


def _mla_qkv(params, x, n_heads, nope_dim, rope_dim, v_dim, rope_theta):
    """Full (non-absorbed) q/k/v materialisation for forward and prefill;
    also the latent ``c_kv`` (b, s, kv_lora) and the rotated shared
    ``k_pe`` (b, s, rope) the decode cache keeps."""
    b, s, _ = x.shape
    q_nope, q_pe = _mla_q(params, x, n_heads, nope_dim, rope_dim)
    c_kv = x @ _w(params, "w_dkv", x)                       # latent
    k_pe = x @ _w(params, "w_kpe", x)                       # shared by heads
    k_nope = (c_kv @ _w(params, "w_uk", x)).reshape(b, s, n_heads, nope_dim)
    v = (c_kv @ _w(params, "w_uv", x)).reshape(b, s, n_heads, v_dim)

    pos = torch.arange(s, device=x.device)[None, :]
    tables = rope_tables(pos, rope_dim, rope_theta)
    q_pe = rotate(q_pe, tables)
    k_pe_r = rotate(k_pe[:, :, None, :], tables)            # (b,s,1,r)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe_r.expand(b, s, n_heads, rope_dim)],
                       dim=-1)
    return q_full, k_full, v, c_kv, k_pe_r[:, :, 0, :]


def mla_forward(params, x, *, n_heads: int, q_lora: int, kv_lora: int,
                nope_dim: int, rope_dim: int, v_dim: int,
                rope_theta: float = 10_000.0, chunk: int = 1024):
    """Forward/prefill MLA: causal attention over the materialised heads
    at scale ``1/sqrt(nope + rope)``; returns ``(out, (c_kv, k_pe))`` so
    prefill can seed the latent caches."""
    b, s, _ = x.shape
    q, k, v, c_kv, k_pe = _mla_qkv(params, x, n_heads, nope_dim, rope_dim,
                                   v_dim, rope_theta)
    q = shard(q, "batch", "attn_seq", "heads", None)
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    out = chunked_attention(q, k, v, causal=True, chunk=chunk, scale=scale)
    out = shard(out, "batch", "attn_seq", "heads", None)
    proj = out.reshape(b, s, n_heads * v_dim) @ _w(params, "wo", x)
    return shard(proj, "batch", "seq", "embed"), (c_kv, k_pe)


def mla_decode(params, x, cache_ckv, cache_kpe, step: int, *, n_heads: int,
               nope_dim: int, rope_dim: int, v_dim: int,
               rope_theta: float = 10_000.0, tables=None, valid=None):
    """Absorbed-matmul MLA decode: attention runs in the latent space, so
    the cache stays ``kv_lora + rope_dim`` values a token, and ``w_uk`` /
    ``w_uv`` are folded into the query and output paths.  Scores and the
    latent context are float32 from cache-dtype operands (``_mm32``).

    Slot ``step`` of ``cache_ckv`` (b, T, kv_lora) and ``cache_kpe``
    (b, T, rope) is written IN PLACE; slots ``<= step`` are attended to.
    ``tables`` (``decode_rope_tables`` at ``rope_dim``) and ``valid``
    (``decode_valid``, flat) are built here when not given.  Returns
    ``(out (b, 1, d), cache_ckv, cache_kpe)``."""
    b, one, _ = x.shape
    t, kv_lora = cache_ckv.shape[1], cache_ckv.shape[2]
    step = int(step)
    if tables is None:
        tables = decode_rope_tables(b, step, rope_dim, rope_theta, x.device)
    if valid is None:
        valid = decode_valid(b, t, step, ring=False, device=x.device)

    q_nope, q_pe = _mla_q(params, x, n_heads, nope_dim, rope_dim)
    q_pe = rotate(q_pe, tables)
    c_kv_new = x @ _w(params, "w_dkv", x)
    k_pe_new = rotate((x @ _w(params, "w_kpe", x))[:, :, None, :], tables)
    cache_ckv[:, step] = c_kv_new[:, 0].to(cache_ckv.dtype)
    cache_kpe[:, step] = k_pe_new[:, 0, 0].to(cache_kpe.dtype)

    # absorb W_uk into the query: q_lat (b, h, c)
    w_uk = _w(params, "w_uk", x).reshape(kv_lora, n_heads, nope_dim)
    q_lat = torch.einsum("bshn,chn->bshc", q_nope, w_uk)[:, 0]

    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    s_lat = _mm32("bhc,btc->bht", q_lat.to(cache_ckv.dtype), cache_ckv)
    s_pe = _mm32("bhr,btr->bht", q_pe[:, 0].to(cache_kpe.dtype), cache_kpe)
    s = (s_lat + s_pe) * scale
    s = torch.where(valid[:, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    ctx_lat = _mm32("bht,btc->bhc", p.to(cache_ckv.dtype), cache_ckv)

    # absorb W_uv into the output projection
    w_uv = _w(params, "w_uv", x).reshape(kv_lora, n_heads, v_dim)
    ctx = torch.einsum("bhc,chv->bhv", ctx_lat.to(x.dtype), w_uv)
    proj = ctx.reshape(b, n_heads * v_dim) @ _w(params, "wo", x)
    return proj[:, None, :], cache_ckv, cache_kpe


# --------------------------------------------------------------------------- #
# cross-attention (enc-dec)
# --------------------------------------------------------------------------- #

def cross_attn_forward(params, x, enc_kv, *, n_heads: int, n_kv: int,
                       head_dim: int, chunk: int = 1024):
    """Decoder -> encoder attention: non-causal, no RoPE, over ``enc_kv`` =
    (k, v) (B, Se, K, hd) from ``cross_kv``, in KV chunks of
    ``min(chunk, Se)``; uses ``wq`` and ``wo`` of ``params``."""
    b, s, _ = x.shape
    k, v = enc_kv
    q = (x @ _w(params, "wq", x)).reshape(b, s, n_heads, head_dim)
    q = shard(q, "batch", "attn_seq", "heads", None)
    out = chunked_attention(q, k, v, causal=False,
                            chunk=min(chunk, k.shape[1]))
    proj = out.reshape(b, s, n_heads * head_dim) @ _w(params, "wo", x)
    return shard(proj, "batch", "seq", "embed")


def cross_kv(params, enc_out, *, n_kv: int, head_dim: int):
    """The cross-attention's (k, v) (B, Se, K, hd) of the encoder output,
    from ``wk`` and ``wv`` of ``params``: computed once a prompt, the
    decode steps' ``ck``/``cv`` caches."""
    b, s, _ = enc_out.shape
    k = (enc_out @ _w(params, "wk", enc_out)).reshape(b, s, n_kv, head_dim)
    v = (enc_out @ _w(params, "wv", enc_out)).reshape(b, s, n_kv, head_dim)
    return k, v
