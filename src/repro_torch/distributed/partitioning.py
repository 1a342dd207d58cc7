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
import math
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
    "local_offsets",
    "placed_zeros",
    "set_at",
    "all_reduce_over",
    "replicated_dims",
    "matmul",
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


def local_offsets(x) -> Tuple[int, ...]:
    """The global index of the first element of a DTensor's local block,
    a dim each (zeros for a plain tensor).  ``Shard`` chunks as
    ``torch.chunk`` does, mesh dim after mesh dim; computed on the host,
    with no tensor (under a ``FakeTensorMode`` a tensor's values are
    unknown)."""
    if not is_dtensor(x):
        return (0,) * x.ndim
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = x.device_mesh
    size, off = list(x.shape), [0] * x.ndim
    for i, p in enumerate(x.placements):
        if isinstance(p, _StridedShard):
            raise ValueError(f"no local offsets of {x.placements}")
        if isinstance(p, Shard):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-size[p.dim] // n)
            start = min(r * chunk, size[p.dim])
            off[p.dim] += start
            size[p.dim] = max(min(chunk, size[p.dim] - start), 0)
    return tuple(off)


def placed_zeros(shape, dtype, like: torch.Tensor,
                 logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Zeros of ``shape``: a plain tensor on ``like``'s device, or, when
    ``like`` is a DTensor and rules are active, a DTensor on its mesh
    placed by ``logical_axes``, each rank allocating only its block (a
    decode cache made by prefill on a mesh)."""
    rules = get_rules()
    if not is_dtensor(like) or rules is None:
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros
    mesh = like.device_mesh
    return zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                 placements=placements(logical_to_spec(logical_axes, rules),
                                       mesh))


def set_at(dst: torch.Tensor, index: Tuple, value: torch.Tensor):
    """``dst[index] = value`` in place; returns ``dst``.

    ``index`` holds an int or a step-1 slice for each leading dim of
    ``dst`` (the rest are whole).  A DTensor ``dst`` keeps its placement
    and its storage: ``value`` is redistributed so that every rank holds
    what falls in its block (sharded as ``dst`` along the dims written
    whole, replicated along the dims written in part: the new token of a
    cache whose length is sharded), and each rank writes its part into
    its local tensor; a rank whose block the index misses writes
    nothing.  The cache is never gathered."""
    if not is_dtensor(dst):
        dst[tuple(index)] = value.to(dst.dtype)
        return dst
    from torch.distributed.tensor import Replicate, Shard
    index = tuple(index) + (slice(None),) * (dst.ndim - len(index))
    vdim, bounds, j = [], [], 0
    for e, size in zip(index, dst.shape):
        if isinstance(e, slice):
            lo, hi, step = e.indices(size)
            if step != 1:
                raise ValueError(f"set_at takes step-1 slices, not {e}")
            vdim.append(j)
            bounds.append((lo, hi))
            j += 1
        else:
            e = int(e) + (size if int(e) < 0 else 0)
            vdim.append(None)
            bounds.append((e, e + 1))
    whole = [vdim[d] is not None and bounds[d] == (0, dst.shape[d])
             for d in range(dst.ndim)]
    mesh = dst.device_mesh
    vplace = [Shard(vdim[p.dim]) if isinstance(p, Shard) and whole[p.dim]
              else Replicate() for p in dst.placements]
    local = dst.to_local()
    off = local_offsets(dst)
    v = replicate_like(value, dst).redistribute(mesh, vplace).to_local()
    dst_idx, v_idx = [], []
    for d, (lo, hi) in enumerate(bounds):
        a, b = max(lo, off[d]), min(hi, off[d] + local.shape[d])
        if a >= b:
            return dst                        # not this rank's block
        if vdim[d] is None:
            dst_idx.append(a - off[d])
        else:
            dst_idx.append(slice(a - off[d], b - off[d]))
            v_idx.append(slice(None) if whole[d] else slice(a - lo, b - lo))
    local[tuple(dst_idx)] = v[tuple(v_idx)].to(local.dtype)
    return dst


def all_reduce_over(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """A rank's plain tensor ``x`` reduced (``"sum"`` or ``"max"``) over
    the ranks of the mesh dims ``dims`` (an all-reduce a dim); the same
    tensor when ``dims`` is empty."""
    if not dims:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    place = [Partial(op) if i in dims else Replicate()
             for i in range(mesh.ndim)]
    return DTensor.from_local(x, mesh, place, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def replicated_dims(x: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor ``x`` gathered along the tensor dims ``dims`` (every
    other placement kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims}
    place = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
             for p in x.placements]
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to the placement its logical axes imply; a dim
    shorter than the ranks that would shard it stays replicated (a decode
    token's length-1 sequence under context-parallel rules).

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
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(p, Shard)
            and x.shape[p.dim] < mesh.size(i) else p
            for i, p in enumerate(placements(spec, mesh))]
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _merges_cleanly(t: torch.Tensor, dims) -> bool:
    """Whether a ``view`` that merges the consecutive ``dims`` of a
    DTensor ``t`` into one (or splits that one back) keeps t's
    placement: of those dims only the first may be sharded, and into
    equal blocks."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim in dims and (
                p.dim != dims[0] or t.shape[p.dim] % mesh.size(i)):
            return False
    return True


def matmul(x: torch.Tensor, w: torch.Tensor, contract: int = 1
           ) -> torch.Tensor:
    """``x (..., *k) @ w (*k, *out)`` -> ``(..., *out)``, contracting x's
    last ``contract`` dims with w's first ``contract``, as one ``@`` over
    the flattened dims.

    DTensor runs that ``@`` through views of its operands and result,
    and a view cannot merge two sharded dims, nor a dim sharded into
    unequal blocks (torch 2.11 refuses both; later releases plan them
    as ``_StridedShard``).  Where a view would, the product runs as each
    rank's local product instead.  Per mesh dim: a shard of one of w's
    output dims is kept (x gathered there, x's gradient a partial sum);
    else a shard of one of x's leading dims is kept (w gathered, w's
    gradient a partial sum); else a shard of the same contracted dim in
    both is kept (the result a partial sum); else both are gathered.
    The result is rebuilt from the local products with its global shape
    (shards may be uneven)."""
    lead, out = x.ndim - contract, w.shape[contract:]
    x, w = replicate_like(x, w), replicate_like(w, x)
    if not is_dtensor(x) or (
            _merges_cleanly(x, tuple(range(lead)))
            and _merges_cleanly(x, tuple(range(lead, x.ndim)))
            and _merges_cleanly(w, tuple(range(contract)))
            and _merges_cleanly(w, tuple(range(contract, w.ndim)))):
        y = x.reshape(*x.shape[:lead], -1) @ w.reshape(-1, math.prod(out))
        return y.reshape(*x.shape[:lead], *out)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    xp, wp, yp, x_grad, w_grad = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        sx = px.dim if isinstance(px, Shard) else None
        sw = pw.dim if isinstance(pw, Shard) else None
        if sw is not None and sw >= contract:             # w's output dim
            xp.append(Replicate())
            wp.append(pw)
            yp.append(Shard(lead + sw - contract))
            x_grad.append(Partial())
            w_grad.append(pw)
        elif sx is not None and sx < lead:                # x's leading dim
            xp.append(px)
            wp.append(Replicate())
            yp.append(px)
            x_grad.append(px)
            w_grad.append(Partial())
        elif sx is not None and sx - lead == sw:          # one contracted dim
            xp.append(px)
            wp.append(pw)
            yp.append(Partial())
            x_grad.append(px)
            w_grad.append(pw)
        else:
            for p in (xp, wp, yp, x_grad, w_grad):
                p.append(Replicate())
    xl = x.redistribute(mesh, xp).to_local(grad_placements=x_grad)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=w_grad)
    y = matmul(xl, wl, contract)
    shape = tuple(x.shape[:lead]) + tuple(out)
    return DTensor.from_local(y, mesh, yp, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())
