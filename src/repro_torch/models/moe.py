"""Mixture-of-Experts layer: a top-k router and grouped, sort-based
dispatch into per-expert capacity buffers.

The port of ``repro.models.moe``.  Groups are the batch rows: each row
routes its own ``S * k`` (token, slot) pairs with a capacity of
``C = ceil(S * k * capacity_factor / E)`` pairs per expert, so the
expert products run over a ``(B, E, C, D)`` buffer whatever the routing
(every expert's weights are read by every call).  The reference's
choices that decide which pairs run are kept exactly:

- **top-k ties** go to the lower expert index, as ``jax.lax.top_k``
  breaks them (``torch.topk`` promises no order among equals, and the
  router's bfloat16 logits tie often): the k experts are the first k of
  a stable descending sort of the probabilities;
- **overflow**: the pairs of a row are ordered by a stable sort on their
  expert (token order within an expert), and the first ``C`` of each
  expert are kept; the rest are dropped (their token gets nothing from
  that expert);
- **dropped pairs** never reach a kept pair's slot: they are written to a
  spare slot past ``C`` that the products never read (the reference adds
  zeros at slot 0).

The expert products are ``torch.einsum`` in the activation dtype, as the
reference's ``jnp.einsum``; a token's k pair outputs are summed in token
order (with k = 2 the reference's scatter-add gives the same sum).
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from .common import PARAM_DTYPE, dense_init, silu

__all__ = ["moe_init", "capacity", "route", "moe_apply"]


def _experts(generator, shape, scale: float, device):
    """A stack of expert matrices: truncated normal on [-2, 2] times
    ``scale``, float32 (``generator=None`` only allocates)."""
    dev = device if device is not None else (
        generator.device if generator is not None else "cpu")
    w = torch.empty(shape, dtype=PARAM_DTYPE, device=dev)
    if generator is None:
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale)


def moe_init(generator, d_model: int, d_ff: int, n_experts: int, *,
             device=None):
    """``router`` (D, E) and the gated experts' ``w_in``/``w_gate``
    (E, D, F) and ``w_out`` (E, F, D), the reference's names and
    scales (fan-in)."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": dense_init(generator, d_model, n_experts, device=device),
        "w_in": _experts(generator, (n_experts, d_model, d_ff), s_in, device),
        "w_gate": _experts(generator, (n_experts, d_model, d_ff), s_in,
                           device),
        "w_out": _experts(generator, (n_experts, d_ff, d_model), s_out,
                          device),
    }


def capacity(s: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Pairs an expert takes from one row of ``s`` tokens."""
    return max(1, int(math.ceil(s * top_k * capacity_factor / n_experts)))


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """(probs (B, S, E) float32, gate values (B, S, k) renormalised over
    the k, expert ids (B, S, k)): the router's logits in the activation
    dtype, softmax in float32, the k largest with ties to the lower id."""
    logits = x @ router.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return probs, vals, idx


def moe_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, *,
              n_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
              act=silu) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (B, S, D) in x's dtype, the Switch aux loss): x (B, S, D),
    each batch row routed on its own (see the module's docstring)."""
    b, s, d = x.shape
    e, k = n_experts, top_k
    probs, gate_vals, gate_idx = route(params["router"], x, k)
    cap = capacity(s, k, capacity_factor, e)
    p = s * k                                               # pairs a row

    # ---- per-row route sort: pairs by expert, token order within one ---- #
    flat_e = gate_idx.reshape(b, p)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(1, order)
    tok_sorted = order // k                   # pair j belongs to token j // k
    gate_sorted = gate_vals.reshape(b, p).gather(1, order)
    counts = F.one_hot(e_sorted, e).sum(dim=1)                        # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(p, device=x.device)[None, :]
           - starts.gather(1, e_sorted))
    keep = pos < cap
    slot = torch.where(keep, pos, cap)        # dropped pairs: the spare slot
    rows = torch.arange(b, device=x.device)[:, None].expand(b, p)

    # ---- scatter into (B, E, C + 1, D); slot C is never read ------------ #
    gathered = x.gather(1, tok_sorted[..., None].expand(b, p, d))
    expert_in = x.new_zeros((b, e, cap + 1, d))
    expert_in[rows, e_sorted, slot] = gathered
    expert_in = expert_in[:, :, :cap]

    # ---- the experts' gated FFN over every slot ------------------------- #
    h = torch.einsum("becd,edf->becf", expert_in, params["w_in"].to(x.dtype))
    g = torch.einsum("becd,edf->becf", expert_in,
                     params["w_gate"].to(x.dtype))
    h = act(g) * h
    expert_out = torch.einsum("becf,efd->becd", h,
                              params["w_out"].to(x.dtype))

    # ---- combine: each kept pair's output times its gate, summed a token - #
    pair_out = expert_out[rows, e_sorted, torch.where(keep, pos, 0)]
    pair_out = torch.where(keep[..., None], pair_out, 0)
    pair_out = pair_out * gate_sorted[..., None].to(x.dtype)
    by_pair = pair_out.gather(1, torch.argsort(order, dim=-1)[..., None]
                              .expand(b, p, d))       # back to pair order
    out = by_pair.reshape(b, s, k, d).sum(dim=2)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx, e).float().sum(dim=2).mean(dim=(0, 1)) / k
    aux = e * torch.sum(me * ce)
    return out, aux
