"""Per-architecture sharding policy, and placing a model on a mesh.

The port of ``repro.distributed.sharding``.  ``rules_for_arch`` adapts the
logical-axis rules to a concrete (architecture, mesh, workload) cell:

* TP axes engage only where tensor dims divide the model-axis size
  (heads/kv_heads/ff/vocab/experts/ssm head-dim);
* architectures whose head count does NOT divide TP fall back to
  CONTEXT-PARALLEL attention (the "attn_seq" logical axis shards the
  query sequence over the model axis);
* MoE: expert parallelism when E % tp == 0, otherwise per-expert d_ff
  tensor parallelism;
* tiny-batch decode cells (batch 1) replicate batch and shard the
  KV-cache length over the data axis instead.

``zero1_state_specs`` shards AdamW mu/nu over the data axis along the
first divisible unsharded dim (ZeRO-1); ``fsdp_param_specs`` applies the
same transform to the parameters themselves (ZeRO-3 / FSDP).

The "mesh" argument of the rules is a ``DeviceMesh`` or a ``MeshShape``
(axis name -> size), so the rules run with no process group.  Specs map
over the port's named parameters (``model.param_pspecs``), not a pytree.

**The ``layers`` axis.**  The reference stacks a layer's leaves on a
leading ``L`` axis, and ``_add_axis`` picks ``L`` for the data axis where
``L`` divides it (h2o's ``wq (24, 3840, 3840)`` gets ``('data', None,
'model')`` on a 2x2 mesh).  The port holds one tensor per layer, so it
cannot place whole layers on a data rank: it shards each per-layer
tensor's first divisible dim instead (``('data', 'model')`` for that
``wq``).  Where the reference does not pick ``L``, the two agree.

``place_model`` makes each parameter a DTensor on the mesh, and
``place_opt_state`` the AdamW state; ``place_batch`` a batch by
``input_pspecs``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from .partitioning import (LogicalRules, Spec, logical_to_spec, placements,
                           rules_for_mesh)
from .partitioning import _sizes as mesh_sizes

__all__ = ["MeshShape", "rules_for_arch", "zero1_state_specs",
           "fsdp_param_specs", "batch_axis_size", "input_pspecs",
           "place_tensor", "place_model", "place_opt_state", "place_batch",
           "place_for_training"]


class MeshShape:
    """A mesh's shape without devices: ``shape`` maps each axis name to
    its size, in order (``MeshShape(data=2, model=4)``)."""

    def __init__(self, **sizes: int):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)

    def __repr__(self):
        return f"MeshShape({self.shape})"


def batch_axis_size(mesh, rules: LogicalRules) -> int:
    axes = rules.get("batch")
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def rules_for_arch(
    cfg: ModelConfig,
    mesh,
    shape: Optional[ShapeConfig] = None,
    *,
    sequence_parallel: bool = False,
    expert_parallel: bool = True,
) -> LogicalRules:
    rules = rules_for_mesh(mesh, sequence_parallel=sequence_parallel,
                           expert_parallel=expert_parallel)
    tp = mesh_sizes(mesh)["model"]

    heads_ok = bool(cfg.n_heads) and cfg.n_heads % tp == 0
    rules["heads"] = ("model",) if heads_ok else None
    if cfg.n_heads and not heads_ok:
        # context-parallel attention fallback; align the residual stream so
        # norms/projections don't reshard on every block boundary.
        rules["attn_seq"] = ("model",)
        rules["seq"] = ("model",)
    rules["kv_heads"] = ("model",) if (cfg.n_kv_heads and cfg.n_kv_heads % tp == 0) else None
    rules["ff"] = ("model",) if (cfg.d_ff and cfg.d_ff % tp == 0) else None
    rules["vocab"] = ("model",) if cfg.padded_vocab % tp == 0 else None
    if cfg.n_experts:
        if expert_parallel and cfg.n_experts % tp == 0:
            rules["experts"], rules["expert_ff"] = ("model",), None
        else:
            rules["experts"] = None
            rules["expert_ff"] = ("model",) if cfg.d_ff % tp == 0 else None
        rules["moe_capacity"] = rules["batch"]  # C ~ tokens: batch axes
    if cfg.ssm_state:
        rules["ssm_inner"] = ("model",) if cfg.ssm_head_p % tp == 0 else None

    if shape is not None:
        if shape.kind == "decode" and rules["kv_heads"] is None:
            # KV heads can't split over the model axis -> shard the cache
            # LENGTH there instead (partial-softmax decode).
            rules["kv_len"] = ("model",)
        bsz = batch_axis_size(mesh, rules)
        if shape.global_batch % bsz != 0:
            # tiny-batch cell: context-parallel decode — batch replicated,
            # KV length sharded over the data axis too.
            rules["batch"] = None
            if cfg.n_experts:
                rules["moe_capacity"] = None
            if shape.kind == "decode":
                kl = rules.get("kv_len")
                kl = kl if isinstance(kl, tuple) else ((kl,) if kl else ())
                rules["kv_len"] = tuple(dict.fromkeys(("data",) + kl))
    return rules


def _spec_axes(spec: Spec):
    out = set()
    for e in spec:
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            out.update(e)
        else:
            out.add(e)
    return out


def _add_axis(spec: Spec, shape: Tuple[int, ...], axis_name: str,
              axis_size: int) -> Spec:
    """Shard the first unsharded, divisible dim of ``shape`` on
    ``axis_name``.  No-op if the spec already uses ``axis_name`` (e.g. FSDP
    ran first) or if no dim is divisible."""
    if axis_name in _spec_axes(spec):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % axis_size == 0 and dim >= axis_size:
            entries[i] = axis_name
            return tuple(entries)
    return spec  # nothing divisible: leave as-is


def _shapes(param_shapes) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a module's named parameters or of a mapping of
    tensors or shapes."""
    if isinstance(param_shapes, torch.nn.Module):
        param_shapes = dict(param_shapes.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in param_shapes.items()}


def zero1_state_specs(param_specs: Mapping[str, Spec], param_shapes,
                      mesh) -> Dict:
    """AdamW state specs: mu/nu sharded over "data" (ZeRO-1), step
    replicated."""
    data = mesh_sizes(mesh)["data"]
    shapes = _shapes(param_shapes)
    mu = {k: _add_axis(s, shapes[k], "data", data)
          for k, s in param_specs.items()}
    return {"mu": mu, "nu": dict(mu), "step": ()}


def fsdp_param_specs(param_specs: Mapping[str, Spec], param_shapes,
                     mesh) -> Dict[str, Spec]:
    """FSDP / ZeRO-3: parameters additionally sharded over "data"."""
    data = mesh_sizes(mesh)["data"]
    shapes = _shapes(param_shapes)
    return {k: _add_axis(s, shapes[k], "data", data)
            for k, s in param_specs.items()}


def input_pspecs(logical_axes: Dict[str, Tuple],
                 rules: LogicalRules) -> Dict[str, Spec]:
    return {k: logical_to_spec(ax, rules) for k, ax in logical_axes.items()}


# --------------------------------------------------------------------------- #
# placing tensors, a model, its AdamW state and a batch on a mesh
# --------------------------------------------------------------------------- #

def local_chunk(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``place`` (the
    chunks DTensor's ``Shard`` makes, ``torch.chunk``'s); on a one-rank
    mesh ``t`` itself."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    local = t
    for mdim, p in enumerate(place):
        if isinstance(p, Shard) and mesh.size(mdim) > 1:
            local = torch.chunk(local, mesh.size(mdim), dim=p.dim)[coord[mdim]]
    return local if local is t else local.contiguous()


def place_tensor(t: torch.Tensor, mesh, spec: Spec):
    """The full tensor ``t`` (the same on every rank) as a DTensor on
    ``mesh`` placed by ``spec``, with no communication.  On a one-rank mesh
    the DTensor's local tensor IS ``t`` (same storage)."""
    from torch.distributed.tensor import DTensor
    place = placements(spec, mesh)
    return DTensor.from_local(local_chunk(t, mesh, place), mesh, place,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


@torch.no_grad()
def place_model(model, mesh, rules: LogicalRules, *, fsdp: bool = False):
    """Make every parameter of ``model`` a DTensor on ``mesh``, placed by
    ``model.param_pspecs(rules)`` (with ``fsdp``, by ``fsdp_param_specs``
    over those).  Each rank must hold the same full weights (the same
    seed, or a checkpoint).  On a one-rank mesh no weight is copied.
    Returns the specs used ({parameter name: Spec})."""
    specs = model.param_pspecs(rules)
    if fsdp:
        specs = fsdp_param_specs(specs, model, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            place_tensor(p.data, mesh, specs[name]),
            requires_grad=p.requires_grad)
    model.mesh = mesh
    return specs


@torch.no_grad()
def place_opt_state(opt_state: Dict, mesh, state_specs: Dict) -> Dict:
    """The AdamW state of a placed model (``adamw_init``'s DTensors, in
    the parameters' placements) with ``mu`` and ``nu`` redistributed to
    ``state_specs`` (``zero1_state_specs``; from ``Replicate`` a local
    chunk, no communication); in place, returned."""
    for part in ("mu", "nu"):
        opt_state[part] = {
            k: v.redistribute(mesh, placements(state_specs[part][k], mesh))
            for k, v in opt_state[part].items()}
    return opt_state


def place_batch(batch: Mapping[str, torch.Tensor], mesh,
                specs: Mapping[str, Spec]) -> Dict:
    """Each array of a GLOBAL batch (the same on every rank) as a DTensor
    placed by ``specs`` (``input_pspecs``)."""
    return {k: place_tensor(v, mesh, specs[k]) for k, v in batch.items()}


def place_for_training(model, mesh, rules: LogicalRules, *,
                       fsdp: bool = False) -> Dict:
    """Place ``model`` on ``mesh`` (``place_model``) and return a fresh
    AdamW state (``optim.adamw_init``) with ``mu``/``nu`` in ZeRO-1
    placement (``zero1_state_specs`` over the parameters' specs)."""
    from ..optim import adamw_init
    specs = place_model(model, mesh, rules, fsdp=fsdp)
    return place_opt_state(adamw_init(model), mesh,
                           zero1_state_specs(specs, model, mesh))
