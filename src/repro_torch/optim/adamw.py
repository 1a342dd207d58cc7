"""Hand-rolled AdamW (+ global-norm clipping, schedules), updating in place.

The port of ``repro.optim.adamw``.  The state mirrors the parameters:
``mu`` and ``nu`` are float32 tensors keyed by the parameter's name (a
model's ``named_parameters()``), beside a host ``step`` counter (a Python
int; the reference's int32 scalar).  The arithmetic is the reference's,
in its order (``mu_hat / (sqrt(nu_hat) + eps) + wd * p``, then
``p - lr * delta``), which ``torch.optim.AdamW`` does not compute.

``adamw_update`` writes ``p``, ``mu`` and ``nu`` in place, one leaf at a
time, applying the clip scale to each gradient as it goes: at full width
a second gradient tree or a new parameter tree would not fit beside the
state.  The step counter, the bias corrections and the schedules stay on
the host (float32 numpy scalars), so an update waits for nothing on the
card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup_cosine"]

f32 = np.float32
Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (a 0-d float32 tensor on the leaves' device)."""
    sums = [x.float().square().sum() for x in tree.values()]
    return torch.stack(sums).sum().sqrt()


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float):
    """(the tree scaled to a global norm of at most ``max_norm``, the norm
    before clipping); each leaf scaled in float32 and cast back."""
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, gn


def adamw_init(params) -> Dict:
    """Zero ``mu`` and ``nu`` (float32, each parameter's shape and device)
    for a module's named parameters or a mapping of tensors; step 0."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
    return {"mu": zeros(), "nu": zeros(), "step": 0}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict, cfg: AdamWConfig,
                 lr_schedule: Optional[Callable[[int], float]] = None):
    """One AdamW step IN PLACE on ``params`` and ``state`` (``mu``, ``nu``
    and ``step``); returns the metrics ``{"grad_norm": the norm before
    clipping (0-d tensor), "lr": the step's rate (float)}``.

    ``params``, ``grads``, ``state["mu"]`` and ``state["nu"]`` share their
    keys; ``grads`` is left as it was."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = int(state["step"]) + 1
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    mu_s, nu_s = state["mu"], state["nu"]
    for k, p in params.items():
        g = grads[k]
        g = (g.float() * scale).to(g.dtype).float()      # clip_by_global_norm
        mu, nu = mu_s[k], nu_s[k]
        mu.mul_(b1).add_(g * (1 - b1))                   # b1*mu + (1-b1)*g
        nu.mul_(b2).add_(g.square().mul_(1 - b2))        # b2*nu + (1-b2)*g^2
        delta = mu / bc1                                 # mu_hat
        delta.div_((nu / bc2).sqrt_().add_(cfg.eps))     # / (sqrt(nu_hat)+eps)
        delta.add_(p.float() * cfg.weight_decay)         # + wd * p
        p.copy_(p.float() - delta.mul_(lr))              # p - lr * delta
    state["step"] = step
    return {"grad_norm": gn, "lr": lr}


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    """step (int) -> rate (float), computed in float32 as the reference's
    jnp schedule is."""
    def fn(step: int) -> float:
        t = min(max(f32(step) / f32(total_steps), f32(0.0)), f32(1.0))
        cos = np.cos(f32(math.pi) * t)
        return float(f32(base_lr) * (f32(final_frac) + f32(1 - final_frac)
                                     * f32(0.5) * (f32(1.0) + cos)))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: int) -> float:
        if step <= warmup:
            return float(f32(base_lr) * f32(step) / f32(max(warmup, 1)))
        return cos(step - warmup)
    return fn
