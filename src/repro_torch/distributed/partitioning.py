"""Logical-axis partitioning (MaxText-style rules) over a torch
``DeviceMesh``.

The port of ``repro.distributed.partitioning``.  Model code annotates
every parameter and key activation with LOGICAL axis names ("batch",
"heads", "ff", ...).  A rules table maps logical names to mesh axes;
``logical_to_spec`` builds a ``Spec``, ``placements`` turns a ``Spec``
into DTensor placements, and ``shard`` redistributes a DTensor to them,
or is the identity when no rules are active, so the same model code runs
single-device tests and meshes.

A ``Spec`` is a tuple whose entries are exactly a JAX ``PartitionSpec``'s
(``None``, one mesh axis name, or a tuple of names), so the port's specs
compare with the reference's with ``==``.

Rules are installed via ``use_rules`` (context manager) or ``set_rules``,
per thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "LogicalRules",
    "Spec",
    "DEFAULT_RULES",
    "SP_RULES",
    "rules_for_mesh",
    "set_rules",
    "get_rules",
    "use_rules",
    "logical_to_spec",
    "placements",
    "is_dtensor",
    "replicate_like",
    "replicated",
    "shard",
]

MeshAxes = Union[None, str, Tuple[str, ...]]
LogicalRules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]

# Baseline DP+TP rules for the production meshes (launch/mesh.py):
#   single-pod ("data", "model"); multi-pod adds a leading "pod" axis that
#   the mesh-aware helpers fold into the batch axes.
DEFAULT_RULES: LogicalRules = {
    "batch": ("data",),
    "seq": None,            # sequence replicated (no SP) by default
    "attn_seq": None,       # seq sharding INSIDE attention (context parallel)
                            # — used instead of "heads" when heads % tp != 0
    "mlp_seq": None,        # seq inside the FFN: gathered when ff is sharded
                            # (Megatron SP semantics)
    "logit_seq": None,      # seq at the unembed: gathered when vocab sharded
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),  # EP when n_experts divides the model axis
    "expert_ff": None,      # MoE fallback: ff sharding inside each expert
    "moe_capacity": ("data",),  # capacity dim of (E, C, d) dispatch buffers
                            # follows the batch axes (C ~ tokens)
    "ssm_inner": ("model",),
    "ssm_state": None,
    "layers": None,         # stacked leading axis is never sharded
    "kv_len": None,
    "q_lora": None,
    "kv_lora": None,
}

# Sequence-parallel variant: activations' seq axis sharded over "model" in
# the norm/residual regions (attention/FFN re-gather via their own specs).
SP_RULES: LogicalRules = dict(DEFAULT_RULES, seq=("model",))


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a mesh stand-in with
    ``axis_names`` (``sharding.MeshShape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def _sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in whose ``shape``
    maps names to sizes."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), shape))


def rules_for_mesh(mesh, *, sequence_parallel: bool = False,
                   expert_parallel: bool = True) -> LogicalRules:
    """Rules adapted to a concrete mesh.

    * multi-pod meshes fold the leading "pod" axis into the batch sharding;
    * ``sequence_parallel`` shards the activations' seq axis over "model";
    * ``expert_parallel=False`` forces MoE to TP (ff inside each expert).
    """
    rules = dict(SP_RULES if sequence_parallel else DEFAULT_RULES)
    if "pod" in mesh_axis_names(mesh):
        rules["batch"] = ("pod", "data")
    if not expert_parallel:
        rules["experts"] = None
        rules["expert_ff"] = ("model",)
    return rules


_state = threading.local()


def set_rules(rules: Optional[LogicalRules]) -> None:
    _state.rules = rules


def get_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def _flatten(axes: MeshAxes):
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes
    if len(axes) == 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[LogicalRules] = None) -> Spec:
    """Map a tuple of logical axis names to a ``Spec`` (``()``, fully
    replicated, when no rules are given or active)."""
    rules = rules if rules is not None else get_rules()
    if rules is None:
        return ()
    return tuple(None if name is None else _flatten(rules.get(name))
                 for name in logical_axes)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` on every mesh axis that tensor dim ``i`` maps to (a dim
    mapped to ``("pod", "data")`` is sharded on both), else
    ``Replicate()``.  An axis of size 1 shards nothing and gets
    ``Replicate()`` (on a 1x1 mesh every placement is)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for i, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else (entry or ())):
            if name in dim_of:
                raise ValueError(f"mesh axis '{name}' shards two dims of "
                                 f"spec {spec}")
            dim_of[name] = i
    sizes = _sizes(mesh)
    out = [Shard(dim_of[name]) if name in dim_of and sizes[name] > 1
           else Replicate() for name in mesh_axis_names(mesh)]
    unknown = set(dim_of) - set(mesh_axis_names(mesh))
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} the mesh "
                         f"{mesh_axis_names(mesh)} lacks")
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` as a ``Replicate`` DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor, else ``t`` as it is.  The forward passes every tensor it
    creates (RoPE tables, masks, positions, accumulators, zeros) through
    this beside a DTensor operand: DTensor refuses mixed operands."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` redistributed to ``Replicate`` on every mesh dim,
    its local tensor contiguous (a plain tensor as it is): the explicit
    gather around an op whose sharded form DTensor cannot run."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).contiguous()


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to the placement its logical axes imply.

    The identity when no rules are active (single-device runs), so model
    code stays the same everywhere.  Under rules ``x`` must be a DTensor
    and is redistributed (``Partial`` sums are reduced there); a plain
    tensor raises, so a tensor that was never placed shows up."""
    rules = get_rules()
    if rules is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"shard{logical_axes}: rules are active but the "
                        f"tensor is not a DTensor (place the model and the "
                        f"batch on the mesh first)")
    spec = logical_to_spec(logical_axes, rules)
    mesh = x.device_mesh
    want = placements(spec, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
