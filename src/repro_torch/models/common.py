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
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

__all__ = ["DTYPE", "PARAM_DTYPE", "dense_init", "embedding_init",
           "rmsnorm_init", "cast_params", "rmsnorm", "softcap", "mlp_init",
           "mlp_apply", "silu", "gelu", "rope_freqs", "rope_tables",
           "rotate", "apply_rope", "embed", "unembed", "make_generator"]

DTYPE = torch.bfloat16       # activation/weight dtype on the wire
PARAM_DTYPE = torch.float32  # master weights

Params = Dict[str, torch.Tensor]


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


def cast_params(module: torch.nn.Module, dtype=None) -> torch.nn.Module:
    """Cast the weight matrices and embedding tables of ``module`` (every
    floating parameter of two or more dims) to ``dtype`` (default
    ``DTYPE``, read now) in place; returns the module.

    The reference keeps float32 masters and casts those to the activation
    dtype on every use (``w.astype(x.dtype)``, ``embed``); rounding is
    deterministic, so casting once gives the same operand values and a
    serving model need not hold the masters.  Norm scales stay float32:
    the reference reads them in float32 (``rmsnorm``)."""
    dtype = DTYPE if dtype is None else dtype
    for p in module.parameters():
        if p.is_floating_point() and p.ndim >= 2:
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
    """(Gated-)MLP: ``act(x @ w_gate) * (x @ w_in) @ w_out``."""
    h = x @ _w(params, "w_in", x)
    if "w_gate" in params:
        h = act(x @ _w(params, "w_gate", x)) * h
    else:
        h = act(h)
    return h @ _w(params, "w_out", x)


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


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0):
    """(sin, cos) of shape (..., S, 1, hd/2) for ``positions`` (..., S)."""
    inv = _inv_freqs(head_dim, float(theta), str(positions.device))  # (hd/2,)
    ang = positions[..., :, None].float() * inv                  # (..., S, hd/2)
    return torch.sin(ang)[..., :, None, :], torch.cos(ang)[..., :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Apply precomputed ``rope_tables`` to x (..., S, H, hd), in float32."""
    sin, cos = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------------- #

def embed(params_w: torch.Tensor, tokens: torch.Tensor,
          scale_by_dim: bool = False):
    out = params_w[tokens.long()].to(DTYPE)      # gather, then cast: same values
    if scale_by_dim:
        # the scale rounded to the activation dtype on the host (a device
        # tensor would wait for the card), as JAX's weakly typed scalar is
        out = out * float(torch.tensor(math.sqrt(params_w.shape[1]),
                                       dtype=out.dtype))
    return out


def unembed(params_w: torch.Tensor, x: torch.Tensor,
            cap: Optional[float] = None):
    logits = x @ params_w.to(x.dtype).T
    return softcap(logits.float(), cap)
