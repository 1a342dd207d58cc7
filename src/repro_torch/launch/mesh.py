"""Mesh construction over ``torch.distributed.device_mesh``.

The port of ``repro.launch.mesh``.  Defined as FUNCTIONS (never
module-level constants), so importing this module touches no process
group.  Each function needs ``torch.distributed`` initialised with as
many ranks as the mesh has (``torchrun``, or ``init_process_group`` with a
``file://`` store; torch's ``fake`` process group stands in for 256 or 512
ranks on one host).  The default device is the card (NCCL); ``device=
"cpu"`` builds the mesh over gloo ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "make_mesh_compat"]


def make_mesh_compat(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` on
    ``device`` ("cuda" or "cpu") over the default process group, which
    must hold exactly ``prod(shape)`` ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card (pass device='cpu' "
                           "for gloo ranks on the host)")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: run under "
                           "torchrun or call init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh.

    Axes: "pod" (outer data parallel), "data" (data parallel / ZeRO shard
    axis), "model" (tensor/expert parallel).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A (data, model) mesh over the job's ranks."""
    return make_mesh_compat((data, model), ("data", "model"), device)
