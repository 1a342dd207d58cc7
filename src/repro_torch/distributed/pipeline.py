"""Pipeline parallelism: GPipe-style microbatches over a "stage" mesh axis.

The port of ``repro.distributed.pipeline``.  Each rank of the stage axis
holds one stage's parameters.  Microbatches stream through: at tick t,
stage s computes microbatch (t - s) and hands its activation to stage
s + 1 (``batch_isend_irecv`` over the stage group).  Total ticks =
n_microbatches + n_stages - 1; bubble fraction = (S-1)/(M+S-1).  The last
stage's result is broadcast to every stage.  With one stage nothing is
sent.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = ["pipeline_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage_slice(stage_params: Any, stage: int):
    """This stage's parameters: index ``stage`` of each leaf's leading
    (stage) dim."""
    if isinstance(stage_params, dict):
        return {k: _stage_slice(v, stage) for k, v in stage_params.items()}
    return stage_params[stage]


@torch.no_grad()
def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh,
    *,
    n_microbatches: int,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``stage_fn`` over the stages of ``mesh``'s ``axis``.

    stage_params: a tensor (or dict of tensors) whose leaves have leading
        dim n_stages (stage-major); rank s of the axis reads slice s.
    x: (batch, ...) global input, the same on every stage;
        batch % n_microbatches == 0.
    Returns the final stage's output, with the shape of ``x`` (the stages
    must preserve it), on every stage."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    stage = ranks.index(dist.get_rank())
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} is not a multiple of {n_microbatches} "
                         f"microbatches")
    params = _stage_slice(stage_params, stage)
    micro = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    outs = torch.zeros_like(micro)
    buf = torch.empty_like(micro[0])          # the activation arriving
    for t in range(n_microbatches + n_stages - 1):
        mb = t - stage
        y = None
        if 0 <= mb < n_microbatches:
            y = stage_fn(params, micro[mb] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs[mb] = y
        ops = []
        if y is not None and stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  ranks[stage + 1], group))
        if stage > 0 and 0 <= t + 1 - stage < n_microbatches:
            buf = torch.empty_like(micro[0])
            ops.append(dist.P2POp(dist.irecv, buf, ranks[stage - 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if n_stages > 1:
        dist.broadcast(outs, ranks[-1], group=group)
    return outs.reshape(x.shape)
