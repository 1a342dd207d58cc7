"""Shared building blocks of the dense decoder: parameter construction,
norms, MLPs, rotary embeddings, softcap, embeddings.

The port of ``repro.models.common``.  Weights keep the reference's
``(in, out)`` layout, so every projection is ``x @ W`` as there.

``DTYPE`` (bfloat16, the activation dtype) and ``PARAM_DTYPE`` (float32,
the master weights) are module constants that every function of
``repro_torch.models`` reads at call time, through this module: setting
``common.DTYPE = torch.float32`` runs the whole model, caches included,
in float32 (the tests' float32 twins do that).

Numerics follow the reference where a plain torch translation would
compute something else:

- ``rmsnorm``, ``apply_rope`` and the final softcap compute in float32
  and cast back; ``unembed``'s product is in the activation dtype before
  its float32 cast.
- ``embed`` gives the gathered rows of the table cast to ``DTYPE`` (the
  reference casts the whole table first: the same values), and the
  sqrt(d_model) scale is rounded to the activation dtype first, as
  JAX's weakly typed scalar is.
- GELU is the tanh approximation (``jax.nn.gelu``'s default).
- The losses gather the label's logit with int64 indices and keep the
  z-loss term; ``chunked_softmax_cross_entropy`` puts each sequence chunk
  under ``torch.utils.checkpoint`` as the reference puts it under
  ``jax.checkpoint``.

On a mesh (parameters placed as DTensors, ``distributed.sharding``) the
models run under the active rules: the reference's ``shard(...)`` points
(the identity without rules) sit at the same places in every family,
and every tensor a forward creates beside a DTensor operand (RoPE
tables, the SSD's mask and entering state, zero accumulators) is made a
``Replicate`` DTensor by ``replicate_like``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.partitioning import (is_dtensor, local_offsets, matmul,
                                        replicate_like, shard)

__all__ = ["DTYPE", "PARAM_DTYPE", "dense_init", "embedding_init",
           "rmsnorm_init", "cast_params", "rmsnorm", "softcap", "mlp_init",
           "mlp_apply", "silu", "gelu", "rope_freqs", "rope_tables",
           "mrope_tables", "rotate", "apply_rope", "apply_mrope", "embed",
           "unembed", "make_generator",
           "softmax_cross_entropy", "chunked_softmax_cross_entropy",
           "EMBED_AXES", "NORM_AXES", "MLP_AXES"]

DTYPE = torch.bfloat16       # activation/weight dtype on the wire
PARAM_DTYPE = torch.float32  # master weights

Params = Dict[str, torch.Tensor]

# the reference's logical axes of each parameter (``repro.models.common``'s
# inits return them beside the arrays); ``Model.param_logical_axes`` reads
# these tables by parameter name
EMBED_AXES = ("vocab", "embed")
NORM_AXES = (None,)
MLP_AXES = {"w_in": ("embed", "ff"), "w_gate": ("embed", "ff"),
            "w_out": ("ff", "embed")}


# --------------------------------------------------------------------------- #
# parameter construction
# --------------------------------------------------------------------------- #

def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A seeded generator on ``device`` (a CUDA tensor draws from a CUDA
    generator)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _empty(shape, generator, device):
    dev = device if device is not None else (
        generator.device if generator is not None else "cpu")
    return torch.empty(shape, dtype=PARAM_DTYPE, device=dev)


def dense_init(generator: Optional[torch.Generator], in_dim: int,
               out_dim: int, scale: Optional[float] = None, *,
               device=None) -> torch.Tensor:
    """Weight ``(in, out)``: truncated normal on [-2, 2] times
    ``1/sqrt(in)`` (fan-in), float32.  ``generator=None`` only allocates
    (the ``meta`` device counts parameters that way)."""
    w = _empty((in_dim, out_dim), generator, device)
    if generator is None:
        return w
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale)


def embedding_init(generator: Optional[torch.Generator], vocab: int,
                   d_model: int, *, device=None) -> torch.Tensor:
    w = _empty((vocab, d_model), generator, device)
    if generator is None:
        return w
    return w.normal_(0.0, 1.0, generator=generator).mul_(0.02)


def rmsnorm_init(dim: int, *, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=PARAM_DTYPE, device=device)


# parameters of two or more dims that the reference reads in float32: the
# Mamba2 gated norm's (H, P) scale (``ssm._gated_norm``)
_READ_IN_F32 = ("norm",)


def cast_params(module: torch.nn.Module, dtype=None) -> torch.nn.Module:
    """Cast the weight matrices, conv taps and embedding tables of
    ``module`` (every floating parameter of two or more dims but a Mamba2
    ``norm``) to ``dtype`` (default ``DTYPE``, read now) in place; returns
    the module.

    The reference keeps float32 masters and casts those to the activation
    dtype on every use (``w.astype(x.dtype)``, ``embed``); rounding is
    deterministic, so casting once gives the same operand values and a
    serving model need not hold the masters.  Norm scales stay float32:
    the reference reads them in float32 (``rmsnorm``, the gated norm), as
    it reads the 1-D ``A_log``, ``dt_bias`` and ``D``."""
    dtype = DTYPE if dtype is None else dtype
    for name, p in module.named_parameters():
        if (p.is_floating_point() and p.ndim >= 2
                and name.rsplit(".", 1)[-1] not in _READ_IN_F32):
            p.data = p.data.to(dtype)
    return module


def _w(params: Mapping[str, torch.Tensor], name: str, x: torch.Tensor):
    """``params[name].astype(x.dtype)``: a no-op once the weights are cast."""
    return params[name].to(x.dtype)


# --------------------------------------------------------------------------- #
# normalisation / activations
# --------------------------------------------------------------------------- #

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)      # no-op cast: scales stay f32


def softcap(x: torch.Tensor, cap: Optional[float]):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


silu = F.silu


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #

def mlp_init(generator, d_model: int, d_ff: int, gated: bool = True, *,
             device=None) -> Params:
    params: Params = {"w_in": dense_init(generator, d_model, d_ff,
                                         device=device)}
    if gated:
        params["w_gate"] = dense_init(generator, d_model, d_ff, device=device)
    params["w_out"] = dense_init(generator, d_ff, d_model, device=device)
    return params


def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, act=silu):
    """(Gated-)MLP: ``act(x @ w_gate) * (x @ w_in) @ w_out``.  On a mesh
    a sequence-sharded ``x`` is gathered once ("mlp_seq") for both input
    products."""
    x = shard(x, "batch", "mlp_seq", "embed")
    h = x @ _w(params, "w_in", x)
    if "w_gate" in params:
        h = act(x @ _w(params, "w_gate", x)) * h
    else:
        h = act(h)
    h = shard(h, "batch", "mlp_seq", "ff")
    return shard(h @ _w(params, "w_out", x), "batch", "seq", "embed")


# --------------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None):
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                  ** expo)


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: str) -> torch.Tensor:
    """``rope_freqs`` computed once per (head_dim, theta, device): building
    it copies ``theta`` to the device, which waits for the card."""
    return rope_freqs(head_dim, theta, device=device)


@functools.lru_cache(maxsize=None)
def _mrope_streams(sections: tuple, device: str) -> torch.Tensor:
    """The stream (0 t, 1 h, 2 w) of each frequency band, built once per
    (sections, device) for the same reason as ``_inv_freqs``."""
    return torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                        device=device)


def _is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's): the tables cached
    above are never built from one, or a later real run would get it."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0):
    """(sin, cos) of shape (..., S, 1, hd/2) for ``positions`` (..., S)."""
    inv = (rope_freqs(head_dim, theta, device=positions.device)
           if _is_fake(positions) else
           _inv_freqs(head_dim, float(theta), str(positions.device)))
    ang = positions[..., :, None].float() * inv                  # (..., S, hd/2)
    return torch.sin(ang)[..., :, None, :], torch.cos(ang)[..., :, None, :]


def mrope_tables(positions3: torch.Tensor, head_dim: int,
                 sections, theta: float = 1_000_000.0):
    """Qwen2-VL multimodal RoPE tables: (sin, cos) of shape (..., S, 1,
    hd/2) for temporal/height/width ids ``positions3`` (..., S, 3).
    ``sections`` splits the hd/2 frequency bands among the three streams
    in order ((16, 24, 24) for hd 128): band ``j`` turns by the id of its
    stream.  With the three ids equal these are ``rope_tables``'."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not split "
                         f"head_dim/2 = {half}")
    if _is_fake(positions3):
        inv = rope_freqs(head_dim, theta, device=positions3.device)
        stream = _mrope_streams.__wrapped__(tuple(sections),
                                            positions3.device)
    else:
        inv = _inv_freqs(head_dim, float(theta), str(positions3.device))
        stream = _mrope_streams(tuple(sections), str(positions3.device))
    ang = positions3.float()[..., stream] * inv                  # (..., S, hd/2)
    return torch.sin(ang)[..., :, None, :], torch.cos(ang)[..., :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Apply precomputed ``rope_tables`` to x (..., S, H, hd), in float32."""
    sin, cos = (replicate_like(t, x) for t in tables)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 1_000_000.0):
    """x: (..., S, H, hd); positions3: (..., S, 3) (``mrope_tables``)."""
    return rotate(x, mrope_tables(positions3, x.shape[-1], sections, theta))


# --------------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------------- #

def _local_rows(table: torch.Tensor, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``table[tokens]`` in ``dtype`` of DTensors, placed as ``embed``
    places it, with the table never gathered along its vocab: each rank
    looks its tokens up in its own vocab block, an id outside the block
    giving a zero row, and the rows, a partial sum over the mesh dims
    that shard the vocab, are reduced into their placement (an all-reduce
    or a reduce-scatter of tokens x d).  The tokens are gathered over
    those dims (each vocab block sees every token of its group) and the
    table over the others (FSDP's weight gather).  DTensor's own index
    and its backward (index_put) fail on sharded ids in some torch
    releases (2.11); here the table's gradient is each rank's index-add
    into its block, a partial sum over the mesh dims that shard the
    tokens, reduced back into the table's placement."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    table = replicate_like(table, tokens)
    mesh = tokens.device_mesh
    vocab = {i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0}
    tokens = tokens.redistribute(mesh, [
        Replicate() if i in vocab else p
        for i, p in enumerate(tokens.placements)])
    table = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    grad = [Shard(0) if i in vocab else Partial() if p.is_shard()
            else Replicate() for i, p in enumerate(tokens.placements)]
    block = table.to_local(grad_placements=grad)
    ids = tokens.to_local().long() - local_offsets(table)[0]
    inside = (ids >= 0) & (ids < block.shape[0])
    rows = block[ids.clamp(0, block.shape[0] - 1)].to(dtype)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    d = table.shape[1]
    rows = DTensor.from_local(
        rows, mesh, [Partial() if i in vocab else p
                     for i, p in enumerate(tokens.placements)],
        run_check=False, shape=tuple(tokens.shape) + (d,),
        stride=(tokens.shape[1] * d, d, 1))
    return shard(rows, "batch", "seq", "embed")


def embed(params_w: torch.Tensor, tokens: torch.Tensor,
          scale_by_dim: bool = False):
    """The tokens' rows of the table in ``DTYPE``.  On a mesh each rank
    looks its tokens up in its own vocab block (``_local_rows``)."""
    if is_dtensor(tokens):
        out = _local_rows(params_w, tokens, DTYPE)
    else:
        out = params_w[tokens.long()].to(DTYPE)  # gather, then cast: same values
    if scale_by_dim:
        # the scale rounded to the activation dtype on the host (a device
        # tensor would wait for the card), as JAX's weakly typed scalar is
        out = out * float(torch.tensor(math.sqrt(params_w.shape[1]),
                                       dtype=out.dtype))
    return shard(out, "batch", "seq", "embed")


def unembed(params_w: torch.Tensor, x: torch.Tensor,
            cap: Optional[float] = None):
    logits = matmul(x, params_w.to(x.dtype).T)
    return shard(softcap(logits.float(), cap), "batch", "logit_seq", "vocab")


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Per-token ``lse - logit[label]`` (+ ``z_loss * lse**2``), float32.

    On a mesh the logits' vocab is gathered first (``shard(logits,
    "batch", "logit_seq", None)``): DTensor has no rule for
    ``take_along_dim`` over a sharded vocab."""
    logits = shard(logits, "batch", "logit_seq", None)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def _ce_chunk(x, w_un, labels, cap, z_loss):
    return _ce_terms(unembed(w_un, x, cap=cap), labels, z_loss).sum()


def chunked_softmax_cross_entropy(x: torch.Tensor, w_un: torch.Tensor,
                                  labels: torch.Tensor, *,
                                  cap: Optional[float] = None,
                                  z_loss: float = 1e-4, seq_chunk: int = 512):
    """Token-mean cross-entropy that never holds the full (B, S, V) logits:
    the unembed + CE runs one sequence chunk at a time, each recomputed in
    the backward pass (peak logits memory O(seq_chunk * V)).  With
    ``S <= seq_chunk`` or ``S % seq_chunk`` the logits are made whole."""
    b, s, d = x.shape
    if s % seq_chunk or s <= seq_chunk:
        return softmax_cross_entropy(unembed(w_un, x, cap=cap), labels, z_loss)
    # on a mesh, a sequence-sharded x is gathered once, not once a chunk
    x = shard(x, "batch", "logit_seq", "embed")
    total = replicate_like(torch.zeros((), dtype=torch.float32,
                                       device=x.device), x)
    for lo in range(0, s, seq_chunk):
        hi = lo + seq_chunk
        total = total + checkpoint(_ce_chunk, x[:, lo:hi], w_un,
                                   labels[:, lo:hi], cap, z_loss,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 1e-4):
    """Token-mean CE with an optional z-loss regulariser."""
    return _ce_terms(logits.float(), labels, z_loss).mean()
