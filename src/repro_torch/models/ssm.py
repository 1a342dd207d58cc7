"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

The port of ``repro.models.ssm``.  Training and prefill use the chunked
SSD algorithm: inside a chunk the recurrence is evaluated in its
quadratic 'attention' dual form, and the chunk states are threaded
through a Python loop over the chunks (the reference's ``lax.scan``).
Decode is the exact single-step recurrence over a constant-size
``(H, P, N)`` state and a ``CONV_K - 1`` token causal-conv tail, both
written IN PLACE (the reference returns updated copies).

The inner dimension stays factored as ``(H heads, P head-dim)``: ``w_z``
and ``w_x`` are ``(d, H, P)``, ``w_out`` ``(H, P, d)``, ``conv_x``
``(K, H, P)``; each projection runs as one ``x @ W`` over the flattened
``H * P`` columns.  Dtypes follow the reference: the projections and the
conv in the activation dtype, the SSD and the gated norm in float32
(``dt`` through ``softplus`` with ``dt_bias``; the norm's fixed eps
1e-6 and its float32 ``(H, P)`` scale).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..distributed.partitioning import (is_dtensor, matmul, replicate_like,
                                        set_at, shard)
from .common import _empty, _w, dense_init, silu

__all__ = ["CONV_K", "mamba2_init", "ssd_chunked", "mamba2_forward",
           "mamba2_decode", "MAMBA2_AXES"]

CONV_K = 4

# the reference's logical axes of a Mamba2 block's parameters
MAMBA2_AXES = {"w_z": ("embed", None, "ssm_inner"),
               "w_x": ("embed", None, "ssm_inner"),
               "w_b": ("embed", None), "w_c": ("embed", None),
               "w_dt": ("embed", None), "conv_x": (None, None, "ssm_inner"),
               "conv_b": (None, None), "conv_c": (None, None),
               "A_log": (None,), "dt_bias": (None,), "D": (None,),
               "norm": (None, "ssm_inner"),
               "w_out": (None, "ssm_inner", "embed")}

Params = Dict[str, torch.Tensor]


def mamba2_init(generator: Optional[torch.Generator], d_model: int, *,
                expand: int = 2, head_p: int = 64, state: int = 128,
                device=None) -> Params:
    """One block's parameters, the reference's names and shapes, float32:
    truncated-normal fan-in projections, conv taps ~ N(0, 0.1^2),
    ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` 0, ``D`` 1 and the
    norm's scale 1.  ``generator=None`` only allocates."""
    d_inner = expand * d_model
    n_heads = d_inner // head_p

    def trunc(shape, scale):
        w = _empty(shape, generator, device)
        if generator is not None:
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            w.mul_(scale)
        return w

    def normal(shape):
        w = _empty(shape, generator, device)
        if generator is not None:
            w.normal_(0.0, 1.0, generator=generator).mul_(0.1)
        return w

    scale = 1.0 / math.sqrt(d_model)
    params: Params = {
        "w_z": trunc((d_model, n_heads, head_p), scale),
        "w_x": trunc((d_model, n_heads, head_p), scale),
        "w_b": dense_init(generator, d_model, state, device=device),
        "w_c": dense_init(generator, d_model, state, device=device),
        "w_dt": dense_init(generator, d_model, n_heads, device=device),
        "conv_x": normal((CONV_K, n_heads, head_p)),
        "conv_b": normal((CONV_K, state)),
        "conv_c": normal((CONV_K, state)),
    }
    dev = params["w_z"].device
    params["A_log"] = torch.log(torch.linspace(1.0, 16.0, n_heads,
                                               dtype=torch.float32,
                                               device=dev))
    params["dt_bias"] = torch.zeros((n_heads,), dtype=torch.float32,
                                    device=dev)
    params["D"] = torch.ones((n_heads,), dtype=torch.float32, device=dev)
    params["norm"] = torch.ones((n_heads, head_p), dtype=torch.float32,
                                device=dev)
    params["w_out"] = trunc((n_heads, head_p, d_model),
                            1.0 / math.sqrt(d_inner))
    return params


def _proj(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """``x (..., d) @ params[name] (d, *out)`` -> ``(..., *out)``, the
    weight cast to the activation dtype."""
    return matmul(x, _w(params, name, x))


def _out_proj(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y (..., H, P) @ w (H, P, d)`` over the (H, P) dims."""
    return matmul(y, w, contract=2)


def _local_ssd(fn, x, dt, A, B, C, D, state):
    """``fn(x, dt, A, B, C, D, state) -> (y, state)`` (the chunked SSD or
    one decode step) of DTensors, run on each rank's local block: the
    recurrence is independent across batch rows, heads and head dims.
    x is ``(b, [s,] h, p)``, dt ``(b, [s,] h)``, B and C ``(b, [s,] n)``,
    A and D ``(h,)``, the state ``(b, h, p, n)`` or None.  Per mesh dim,
    x keeps a shard of its batch, heads or head dim (the others follow
    it; an operand that sees only part of what it feeds gets a partial
    sum for its gradient); any other shard (the sequence's) is
    gathered.  Returns y (x's shape and placement) and the state."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, rep = x.device_mesh, Replicate()
    hd = x.ndim - 2
    keys = ("x", "dt", "A", "bc", "state")
    place = {k: [] for k in keys}
    grad = {k: [] for k in keys}
    for px in x.placements:
        dim = px.dim if isinstance(px, Shard) else None
        if dim == 0:                                      # batch rows
            pl = dict(x=px, dt=px, A=rep, bc=px, state=px)
            gr = dict(pl, A=Partial())
        elif dim == hd:                                   # heads
            pl = dict(x=px, dt=Shard(dt.ndim - 1), A=Shard(0), bc=rep,
                      state=Shard(1))
            gr = dict(pl, bc=Partial())
        elif dim == hd + 1:                               # head dims
            pl = dict(x=px, dt=rep, A=rep, bc=rep, state=Shard(2))
            gr = dict(pl, dt=Partial(), A=Partial(), bc=Partial())
        else:
            pl = gr = dict.fromkeys(keys, rep)
        for k in keys:
            place[k].append(pl[k])
            grad[k].append(gr[k])

    def local(t, key):
        if t is None:
            return None
        return replicate_like(t, x).redistribute(mesh, place[key]) \
            .to_local(grad_placements=grad[key])

    def placed(t, key, shape):
        return DTensor.from_local(t.contiguous(), mesh, place[key],
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())
    y, final = fn(local(x, "x"), local(dt, "dt"), local(A, "A"),
                  local(B, "bc"), local(C, "bc"), local(D, "A"),
                  local(state, "state"))
    return (placed(y, "x", tuple(x.shape)),
            placed(final, "state", (x.shape[0], x.shape[hd],
                                    x.shape[hd + 1], B.shape[-1])))


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv along time.  seq: (b, s, ...ch), w: (K, ...ch),
    tail: (b, K-1, ...ch) history (zeros at sequence start).  Returns
    (out, the new tail: the last K-1 positions)."""
    s = seq.shape[1]
    full = torch.cat([tail.to(seq.dtype), seq], dim=1)
    out = full[:, 0:s] * w[0]
    for i in range(1, CONV_K):
        out = out + full[:, i:i + s] * w[i]
    return out, full[:, -(CONV_K - 1):]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the (H, P) inner dims of ``y * silu(z)``, in float32."""
    g = y * silu(z.float())
    var = g.square().mean(dim=(-2, -1), keepdim=True)
    return g * torch.rsqrt(var + eps) * scale


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum' for the intra-chunk decay matrix L.

    dA: (..., L) -> (..., L, L) with L[i, j] = exp(sum_{j<k<=i} dA_k),
    lower-triangular (zero above the diagonal)."""
    l = dA.shape[-1]
    csum = dA.cumsum(dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = replicate_like(torch.ones((l, l), dtype=torch.bool,
                                     device=dA.device).tril(), dA)
    # mask BEFORE exp: upper-triangle diffs are large-positive and would
    # overflow; masking after exp leaves 0 * inf = NaN in the backward pass
    diff = torch.where(mask, diff, -math.inf)
    return torch.exp(diff)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 256, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) negative decay;
    B, C: (b, s, n); D: (h,) skip.  Returns (y (b, s, h, p), final state
    (b, h, p, n)).  ``s`` must be a multiple of ``chunk``.  DTensors run
    on each rank's local block (``_local_ssd``)."""
    if is_dtensor(x):
        return _local_ssd(
            lambda *a: ssd_chunked(*a[:6], chunk=chunk, init_state=a[6]),
            x, dt, A, B, C, D, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk

    xb = x.reshape(b, nc, chunk, h, p)
    dtb = dt.reshape(b, nc, chunk, h)
    Bb = B.reshape(b, nc, chunk, n)
    Cb = C.reshape(b, nc, chunk, n)

    dA = dtb * A                                           # (b,nc,l,h) <= 0
    dA_cum = dA.cumsum(dim=2)                              # within chunk
    dA_tot = dA_cum[:, :, -1:, :]                          # (b,nc,1,h)

    # intra-chunk (dual quadratic form): y_intra = (L o (C B^T)) (dt*x)
    L = _segsum(dA.transpose(2, 3))                        # (b,nc,h,l,l)
    scores = torch.einsum("bcln,bcmn->bclm", Cb, Bb)       # (b,nc,l,l)
    gated = scores[:, :, None] * L                         # (b,nc,h,l,l)
    xdt = xb * dtb[..., None]                              # (b,nc,l,h,p)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", gated, xdt)

    # chunk-final states: sum_l exp(dA_tot - dA_cum_l) * B_l (dt*x)_l
    decay_to_end = torch.exp(dA_tot - dA_cum)              # (b,nc,l,h)
    states = torch.einsum("bcln,bclhp->bchpn", Bb,
                          xdt * decay_to_end[..., None])   # (b,nc,h,p,n)

    # inter-chunk recurrence over nc: the state entering each chunk
    chunk_decay = torch.exp(dA_tot[:, :, 0, :])            # (b,nc,h)
    h_state = (init_state if init_state is not None
               else replicate_like(torch.zeros((b, h, p, n), dtype=x.dtype,
                                               device=x.device), x))
    entering = []
    for c in range(nc):
        entering.append(h_state)
        h_state = h_state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(entering, dim=1)                 # (b,nc,h,p,n)

    # contribution of the entering state to each position in the chunk
    decay_from_start = torch.exp(dA_cum)                   # (b,nc,l,h)
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cb, h_prevs) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p) + x * D[:, None]
    return y, h_state


def mamba2_forward(params: Params, hidden: torch.Tensor, *, d_model: int,
                   expand: int = 2, head_p: int = 64, state: int = 128,
                   chunk: int = 256, conv_state=None, ssm_state=None,
                   return_state: bool = False):
    """Full-sequence Mamba2 block (train / prefill).

    conv_state: optional dict {"x": (b,K-1,h,p), "b": (b,K-1,n), "c": ...};
    ssm_state: optional (b, h, p, n) float32.  With ``return_state``
    returns ``(out, (conv tails, final state))``."""
    b, s, _ = hidden.shape
    n_heads = expand * d_model // head_p

    z = shard(_proj(hidden, params, "w_z"),                # (b,s,h,p)
              "batch", None, None, "ssm_inner")
    x = shard(_proj(hidden, params, "w_x"), "batch", None, None, "ssm_inner")
    # B, C and dt replicated past the batch: the causal conv runs along
    # the whole sequence, and every head's SSD reads all of B and C
    Bp = shard(_proj(hidden, params, "w_b"), "batch", None, None)   # (b,s,n)
    Cp = shard(_proj(hidden, params, "w_c"), "batch", None, None)
    dt = shard(_proj(hidden, params, "w_dt"), "batch", None, None)  # (b,s,h)

    if conv_state is None:
        zeros_n = hidden.new_zeros((b, CONV_K - 1, state))
        conv_state = {"x": hidden.new_zeros((b, CONV_K - 1, n_heads, head_p)),
                      "b": zeros_n, "c": zeros_n}
    x_c, tail_x = _causal_conv(x, _w(params, "conv_x", x), conv_state["x"])
    B_c, tail_b = _causal_conv(Bp, _w(params, "conv_b", x), conv_state["b"])
    C_c, tail_c = _causal_conv(Cp, _w(params, "conv_c", x), conv_state["c"])
    x_c, B_c, C_c = silu(x_c), silu(B_c), silu(C_c)

    dt_s = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final = ssd_chunked(
        x_c.float(), dt_s, A, B_c.float(), C_c.float(), params["D"],
        chunk=min(chunk, s), init_state=ssm_state)
    y = _gated_norm(y, z, params["norm"]).to(hidden.dtype)
    out = shard(_out_proj(y, _w(params, "w_out", hidden)), "batch", "seq",
                "embed")
    if return_state:
        return out, ({"x": tail_x, "b": tail_b, "c": tail_c}, final)
    return out


def _conv_step(tail: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """One token of the causal conv: ``silu`` of the taps over the tail and
    ``new``; the tail (b, K-1, ...) shifts by one IN PLACE (through the
    new history, a copy, since source and target overlap; a placed tail
    in each rank's block, ``set_at``)."""
    hist = torch.cat([tail.to(new.dtype), new[:, None]], dim=1)  # (b,K,...)
    out = (hist * w.to(new.dtype)).sum(dim=1)
    set_at(tail, (), hist[:, 1:])
    return silu(out)


def _ssd_step(x, dt, A, B, C, D, state):
    """One token of the SSD recurrence: x (b, h, p), dt (b, h), B and C
    (b, n), the state (b, h, p, n) -> (y (b, h, p), the new state).
    DTensors run on each rank's local block (``_local_ssd``)."""
    if is_dtensor(x):
        return _local_ssd(_ssd_step, x, dt, A, B, C, D, state)
    dA = torch.exp(dt * A)                                 # (b,h)
    xdt = x * dt[..., None]                                # (b,h,p)
    new_state = state * dA[..., None, None] + xdt[..., None] * B[:, None,
                                                                 None, :]
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y + x * D[:, None], new_state


def mamba2_decode(params: Params, hidden: torch.Tensor, conv_state,
                  ssm_state: torch.Tensor, *, d_model: int, expand: int = 2,
                  head_p: int = 64, state: int = 128):
    """Single-token recurrent step.

    conv_state: {"x": (b,K-1,h,p), "b": (b,K-1,n), "c": (b,K-1,n)};
    ssm_state: (b, h, p, n) float32.  Both are updated IN PLACE.  Returns
    (out (b, 1, d), conv_state, ssm_state)."""
    h1 = hidden[:, 0]
    z = _proj(h1, params, "w_z")                           # (b,h,p)
    x = _proj(h1, params, "w_x")
    Bp = _proj(h1, params, "w_b")                          # (b,n)
    Cp = _proj(h1, params, "w_c")
    dt = _proj(h1, params, "w_dt")                         # (b,h)

    x_c = _conv_step(conv_state["x"], x, params["conv_x"])
    B_c = _conv_step(conv_state["b"], Bp, params["conv_b"]).float()
    C_c = _conv_step(conv_state["c"], Cp, params["conv_c"]).float()

    dt_s = F.softplus(dt.float() + params["dt_bias"])      # (b,h)
    A = -torch.exp(params["A_log"])
    y, new_state = _ssd_step(x_c.float(), dt_s, A, B_c, C_c, params["D"],
                             ssm_state)
    set_at(ssm_state, (), new_state)
    y = _gated_norm(y, z, params["norm"]).to(hidden.dtype)
    out = _out_proj(y, _w(params, "w_out", hidden))
    return out[:, None], conv_state, ssm_state
