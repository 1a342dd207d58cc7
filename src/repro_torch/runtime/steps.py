"""Step functions of the training and serving paths.

The port of ``repro.runtime.steps``.  The reference's steps are pure
functions of (params, opt_state, batch) handed to ``jax.jit``; the
port's model holds its parameters, so a train step updates the model and
the AdamW state IN PLACE and returns its metrics.  A step takes a batch
of numpy arrays, as the loader yields it, and moves it to the model's
device.

A train step mutates nothing until the loss and every gradient exist: a
step that raises before the update leaves the model and the state as
they were, as the reference's functional step does (``train``'s retry
restores from a checkpoint and runs the step again).

A model placed on a mesh (``distributed.sharding.place_model``) trains
under ``use_rules(rules)``, as the reference's steps run under its mesh
and rules: each rank is given the GLOBAL batch, which the step places by
``input_pspecs`` (a data rank keeps its rows), the loss is the mean over
the whole batch on every rank, and each gradient is redistributed to its
parameter's placement (the data-parallel all-reduce) before AdamW runs
on the DTensor leaves.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs.base import ShapeConfig
from ..distributed.partitioning import get_rules, is_dtensor
from ..distributed.sharding import input_pspecs, place_batch
from ..models.model import Model
from ..optim import AdamWConfig, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "make_eval_step"]


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Each array of ``batch`` (numpy or torch) as a tensor on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _on_mesh(model: Model, batch: Dict[str, torch.Tensor]):
    """``batch`` as it is, or on the model's mesh placed by the active
    rules' ``input_pspecs``."""
    if model.mesh is None:
        return batch
    rules = get_rules()
    if rules is None:
        raise RuntimeError("a model placed on a mesh trains under "
                           "use_rules(rules_for_arch(cfg, mesh))")
    axes = model.input_logical_axes(ShapeConfig("step", 0, 0, "train"))
    return place_batch(batch, model.mesh, input_pspecs(axes, rules))


def _mesh_loss(model: Model, batch) -> torch.Tensor:
    """``model.loss`` of the (placed) batch as a plain tensor: a DTensor
    loss is gathered (``full_tensor``, differentiable)."""
    loss = model.loss(_on_mesh(model, batch))
    return loss.full_tensor() if is_dtensor(loss) else loss


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    grad_transform: Optional[Callable] = None,
                    microbatches: int = 1):
    """``train_step(opt_state, batch) -> metrics`` (``loss``, ``grad_norm``
    as 0-d tensors, ``lr`` as a float), updating ``model`` and
    ``opt_state`` in place.

    ``grad_transform`` optionally rewrites the gradients (a mapping of
    parameter name to float32 tensor) before the optimizer.  Nothing
    passes it (``distributed.compression`` has a step of its own), as in
    the reference.

    ``microbatches > 1`` accumulates the gradients of dim-0 slices of the
    batch in float32 (``.grad`` accumulation is the reference's
    ``acc + g``) and divides the loss and the gradients by their count,
    so live activation memory scales with the micro-batch.
    """
    params = dict(model.named_parameters())

    def _grads():
        return {k: _grad(p) for k, p in params.items()}

    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        batch = _to_device(batch, model.device)
        for p in params.values():
            p.grad = None
        try:
            if microbatches == 1:
                loss = _mesh_loss(model, batch)
                loss.backward()
                loss = loss.detach()
            else:
                m = next(iter(batch.values())).shape[0] // microbatches
                loss = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for i in range(microbatches):
                    mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                    l_mb = _mesh_loss(model, mb)
                    l_mb.backward()
                    loss = loss + l_mb.detach()
                loss = loss / microbatches
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(microbatches)
            grads = _grads()
            if grad_transform is not None:
                grads = grad_transform(grads)
            metrics = adamw_update(params, grads, opt_state, opt_cfg,
                                   lr_schedule)
        finally:
            for p in params.values():
                p.grad = None               # the next step's are fresh
        metrics["loss"] = loss
        return metrics
    return train_step


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient (zeros where it has none), a DTensor's in ``p``'s
    placement: a ``Partial`` gradient is reduced there."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        return model.loss(_to_device(batch, model.device))
    return eval_step


def make_prefill_step(model: Model, cache_len: int):
    def prefill_step(batch: Dict):
        return model.prefill(_to_device(batch, model.device), cache_len)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(cache, tokens: torch.Tensor, step: int):
        return model.decode_step(cache, tokens, step)
    return serve_step
