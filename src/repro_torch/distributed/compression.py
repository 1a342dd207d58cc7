"""Gradient compression with error feedback.

The port of ``repro.distributed.compression``.  Two compressors, each a
map over a {parameter name: gradient} mapping:

* ``Int8Compressor`` — per-leaf symmetric int8 quantisation (scale =
  max|g|/127), error feedback accumulates the quantisation residual so the
  compression bias vanishes over steps (Karimireddy et al., 2019);
* ``TopKCompressor`` — keep the top-k fraction by magnitude, error
  feedback on the rest.

``compressed_psum`` is the wire-level form over a process group (the data
ranks): an all-reduce MAX agrees on the scale, the int8-range payload is
summed as int32 (exact), and the sum is dequantised.
``make_compressed_train_step`` is a train step of its own that threads the
error-feedback state; ``runtime.steps``' ``grad_transform`` hook has no
caller, as in the reference.

A leaf is the reference's: the port's per-layer tensors of one stacked
reference leaf (``layers.<i>.<path>`` for every ``i``, any stack) share
one int8 scale and one top-k threshold, as the reference's ``(L, ...)``
leaf does.  Rounding is ``torch.round`` (half to even, as ``jnp.round``)
of an IEEE float32 division, so the compressors agree with the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["Int8Compressor", "TopKCompressor", "compressed_psum",
           "make_compressed_train_step"]

Tree = Mapping[str, torch.Tensor]


def _zeros(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


_LAYER = re.compile(r"^(layers|shared|enc_layers|dec_layers)\.\d+\.")


def _leaves(names) -> List[List[str]]:
    """The names grouped by the reference leaf they belong to: the
    per-layer tensors of one stack path together, every other name
    alone; in first-seen order."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        groups.setdefault(_LAYER.sub(r"\1.*.", name), []).append(name)
    return list(groups.values())


def _int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(g / scale), -127, 127)`` (float32)."""
    return torch.clamp(torch.round(g / scale), -127, 127)


def _scale(m: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(m, 1e-12) / 127.0


class Int8Compressor:
    name = "int8_ef"

    def init(self, params) -> Dict[str, torch.Tensor]:
        """Zero error-feedback state (float32) of a module's parameters or
        a mapping of tensors."""
        return _zeros(params)

    @torch.no_grad()
    def compress(self, grads: Tree, err: Tree):
        """(dequantised gradients, new error state), each a new mapping."""
        deq, new_err = {}, {}
        for leaf in _leaves(grads):
            g = {k: grads[k].float() + err[k] for k in leaf}
            scale = _scale(torch.stack([v.abs().max() for v in g.values()])
                           .max())
            for k, v in g.items():
                d = _int8(v, scale) * scale
                deq[k], new_err[k] = d, v - d
        return deq, new_err

    def wire_bytes_ratio(self) -> float:
        return 1.0 / 4.0  # int8 vs f32


@dataclasses.dataclass
class TopKCompressor:
    frac: float = 0.05
    name = "topk_ef"

    def init(self, params) -> Dict[str, torch.Tensor]:
        return _zeros(params)

    @torch.no_grad()
    def compress(self, grads: Tree, err: Tree):
        """(the kept entries, zeros elsewhere; new error state): an entry
        is kept when its magnitude reaches the k-th largest's."""
        kept, new_err = {}, {}
        for leaf in _leaves(grads):
            g = {k: grads[k].float() + err[k] for k in leaf}
            flat = torch.cat([v.reshape(-1) for v in g.values()])
            k = max(int(flat.numel() * self.frac), 1)
            thresh = torch.topk(flat.abs(), k).values[-1]
            for name, v in g.items():
                kp = torch.where(v.abs() >= thresh, v, 0.0)
                kept[name], new_err[name] = kp, v - kp
        return kept, new_err

    def wire_bytes_ratio(self) -> float:
        return 2.0 * self.frac  # value+index per kept entry


@torch.no_grad()
def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantised all-reduce SUM of ``x`` over ``group`` (default: the
    whole job; on a mesh ``mesh.get_group("data")``).

    The scale is agreed by an all-reduce MAX of ``max|x|`` (float32), the
    payload ``clip(round(x / scale), -127, 127)`` is summed as int32
    (exact), and the sum dequantised: float32 ``total * scale``."""
    m = x.abs().max().float().reshape(1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(m[0])
    q = _int8(x.float(), scale).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale


def make_compressed_train_step(model, opt_cfg, compressor,
                               lr_schedule: Optional[Callable] = None):
    """``step(opt_state, ef_state, batch) -> metrics``, updating the model,
    the AdamW state and the error-feedback state (``compressor.init``'s)
    IN PLACE: the loss and its gradients, the gradients compressed with
    error feedback, then AdamW on the compressed gradients."""
    from ..optim import adamw_update
    from ..runtime.steps import _grad, _mesh_loss, _to_device

    params = dict(model.named_parameters())

    def step(opt_state: Dict, ef_state: Dict, batch: Dict) -> Dict:
        batch = _to_device(batch, model.device)
        for p in params.values():
            p.grad = None
        try:
            loss = _mesh_loss(model, batch)
            loss.backward()
            grads = {k: _grad(p) for k, p in params.items()}
            grads, new_ef = compressor.compress(grads, ef_state)
            metrics = adamw_update(params, grads, opt_state, opt_cfg,
                                   lr_schedule)
            ef_state.update(new_ef)
        finally:
            for p in params.values():
                p.grad = None
        metrics["loss"] = loss.detach()
        return metrics

    return step
