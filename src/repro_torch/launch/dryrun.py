"""Multi-pod dry run: build every (architecture x input-shape x mesh) cell
on fake tensors over a fake process group -- no allocation, no card --
run one step of its kind, and record each device's FLOPs, bytes moved,
collective bytes and peak memory, which feed the roofline table
(``launch.report``).

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell on 512 forced host devices and reads XLA's memory and
cost analyses, the port joins torch's ``fake`` process group as rank 0 of
256 ranks (the single-pod 16 x 16 mesh) or 512 (2 x 16 x 16), builds the
model under ``FakeTensorMode``, places it by ``rules_for_arch`` (FSDP
parameters and ZeRO-1 AdamW state for train cells, bfloat16 weights for
serving cells, as the reference's ``_lower_cell`` casts them), and runs
one eager step -- train (AdamW, ``microbatches`` slices), prefill, or one
decode token over a placed cache -- under ``StepCounter``, which sees
every op rank 0 runs on its local tensors:

* FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention kernels) of each local op;
* bytes: each local op's tensor inputs read once and its outputs written
  once (views move nothing).  This is the eager port's traffic, op by op,
  with no fusion -- not XLA's ``bytes accessed`` of a fused program, and
  far above what a fused step would move;
* transcendentals: elements out of exp, log, tanh, sin, cos, rsqrt, ...;
* collectives: the result bytes of each collective rank 0 issues
  (``launch.collectives``);
* memory: the bytes of the local storages alive at once, from the step's
  inputs (arguments) through its peak, under the reference's keys.

A DTensor op passes through the counter to DTensor, which runs the local
op that the counter then sees; the global-shape fake op DTensor runs to
propagate an output's shape is not the device's work and is not counted.
Replicated work counts in full on each device, as in the reference's
SPMD program.  The MoE dispatch runs on gathered tensors in the port
(``models.moe``), and the dry run counts it so.

Every cell runs at full depth (its memory needs it), and eager torch
counts every layer (XLA's cost analysis counts a while-loop body once),
so the cell's costs are that exact count (also ``cost_scanbody``).  The
reference's depth extrapolation (``probe_costs``, ``--probe 1``) is kept:
for a homogeneous stack it equals the full-depth count (the tests hold it
so), but here it saves no host time, and where a step is not linear in
depth (its microbatches re-read the weights; DTensor plans the first
layer otherwise) it differs from the count.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --jobs 4   # parallel subprocesses
  python -m repro_torch.launch.dryrun --all --probe-depth 1 --jobs 8  # quick
  python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b --shape train_4k \
      --mesh local --batch 8 --seq 256 --microbatches 1 --probe 0  # one card

Cells land in ``build/dryrun_torch/`` (``--out``), never in the
reference's ``experiments/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..configs import SHAPES, get_config, list_configs
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.partitioning import is_dtensor, use_rules
from ..distributed.sharding import (input_pspecs, place_batch, place_model,
                                    place_opt_state, rules_for_arch,
                                    zero1_state_specs)
from ..models import build_model
from ..models.common import cast_params
from ..optim import AdamWConfig, adamw_init
from ..runtime.steps import make_prefill_step, make_serve_step, make_train_step
from .collectives import CollectiveCounter
from .mesh import make_local_mesh, make_production_mesh
from .roofline import H100_SXM, model_flops, roofline

__all__ = ["OUT_DIR", "skip_reason", "StepCounter", "counting", "cell_step",
           "count_step", "count_cell", "probe_costs", "run_cell",
           "cell_filename", "fake_group", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
# fake ranks of each mesh: the single-pod 16 x 16 and the two-pod
# 2 x 16 x 16 production meshes, and "local", the 1 x 1 mesh of one card
FAKE_RANKS = {"single": 256, "multi": 512, "local": 1}

# ops whose output elements each cost one transcendental evaluation
_TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "tanh_", "sin",
                   "cos", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sigmoid",
                   "erf", "softplus", "log_softmax", "_log_softmax",
                   "_softmax", "logsumexp", "pow", "silu", "gelu",
                   "expm1", "log1p"}
# factories that write nothing (their output is counted when an op fills it)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "wait_tensor"}


def skip_reason(cfg: ModelConfig, shape: ShapeConfig):
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 524k context exceeds any serving "
                "envelope; run only for SSM/hybrid/SWA archs per the brief")
    return None


def _enc_len(cfg: ModelConfig, shape: ShapeConfig):
    """Encoder length for enc-dec decode cells (frames seen at prefill)."""
    return 4096 if cfg.family == "encdec" else None


# --------------------------------------------------------------------------- #
# the counter
# --------------------------------------------------------------------------- #

_tls = threading.local()


def _propagating() -> bool:
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def _uncounted():
    """The ops run inside are DTensor's own bookkeeping, not the device's
    work: the counter lets them through uncounted."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


@contextlib.contextmanager
def _meta_propagation_uncounted():
    """While DTensor runs an op on global-shape fake tensors to learn its
    output's shape (``ShardingPropagator._propagate_tensor_meta_non_cached``,
    an internal of torch pinned by the dry run's tests), the counter lets
    the ops through uncounted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        with _uncounted():
            return orig(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


class StepCounter(TorchDispatchMode):
    """Counts the work of the ops run under it on ONE device (see the
    module's docstring): ``flops``, ``bytes``, ``transcendentals``,
    ``collectives`` (a ``CollectiveCounter``'s tally), per-op totals
    ``ops``, and the bytes of live local storages (``hold`` the step's
    inputs first; ``peak``).

    The counts are the same on fake and on real tensors: the smoke counts
    a step on the card with it beside the same step on fake tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collectives = CollectiveCounter()
        self.ops: Dict[str, list] = {}
        self._live: Dict[int, tuple] = {}
        self.live = 0
        self.peak = 0
        self.held = set()

    # ---- memory: local storages alive ---- #
    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return key
        n = st.nbytes()

        def gone(_, key=key, n=n, live=self._live):
            if live.pop(key, None) is not None:
                self.live -= n
        self._live[key] = (weakref.ref(st, gone), n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return key

    def hold(self, tree) -> int:
        """Count the step's inputs (DTensors by their local tensors) as
        alive from the start; returns their bytes."""
        for t in _tensors(tree):
            self.held.add(self._track(_local(t)))
        return sum(self._live[k][1] for k in self.held)

    def memory(self, outputs) -> Dict[str, int]:
        """The reference's memory keys after the step: ``argument_bytes``
        (the held inputs), ``output_bytes`` (the step's results and the
        inputs it updates in place, passed as ``outputs``),
        ``alias_bytes`` (outputs that are inputs), ``temp_bytes`` and
        ``peak_bytes_per_device`` (the most bytes alive at once)."""
        arg = sum(self._live[k][1] for k in self.held if k in self._live)
        out, alias, seen = 0, 0, set()
        for t in _tensors(outputs):
            st = _local(t).untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out += st.nbytes()
            if id(st) in self.held:
                alias += st.nbytes()
        temp = max(self.peak - (arg + out - alias), 0)
        return {"argument_bytes": arg, "output_bytes": out,
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_bytes_per_device": arg + out + temp - alias}

    # ---- work ---- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _propagating():
            return func(*args, **kwargs)
        flat = tree_flatten((args, kwargs))[0]
        if any(is_dtensor(a) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        name = func._schema.name.partition("::")[2]
        outs = _tensors(out)
        if not outs:
            return                  # metadata (a device, a size): no work
        for t in outs:
            self._track(t)
        if self.collectives.record(func, args, out):
            return
        flops = 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            shape = lambda x: x.shape if isinstance(x, torch.Tensor) else x
            flops = float(flop_registry[packet](
                *tree_map(shape, args), **tree_map(shape, kwargs),
                out_val=tree_map(shape, out)))
        nbytes = 0
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            in_ids = {id(t) for t in ins}
            nbytes = (sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs if id(t) not in in_ids))
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        self.flops += flops
        self.bytes += nbytes
        row = self.ops.setdefault(f"aten.{name}" if func.namespace == "aten"
                                  else f"{func.namespace}.{name}",
                                  [0.0, 0.0, 0])
        row[0] += flops
        row[1] += nbytes
        row[2] += 1

    def cost(self) -> Dict:
        """``_extract_cost``'s keys of what was counted."""
        total, per_op = self.collectives.totals()
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "coll_total": float(total), "coll_per_op": per_op}

    def top_ops(self, n: int = 10) -> Dict[str, Dict]:
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return {k: {"flops": v[0], "bytes": v[1], "calls": v[2]}
                for k, v in rows}


@contextlib.contextmanager
def counting():
    """A ``StepCounter`` entered with DTensor's shape propagation left
    uncounted."""
    with _meta_propagation_uncounted():
        counter = StepCounter()
        with counter:
            yield counter


# --------------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def fake_group(world_size: int):
    """torch's ``fake`` process group of ``world_size`` ranks, this process
    rank 0 (``FakeStore``, an internal of torch pinned by the tests),
    destroyed on exit.  Two of DTensor's internals are adapted while it
    lives: a shard-to-shard redistribution issues its all-to-all as on
    the card (DTensor's CPU fallback, an all-gather, would count other
    bytes), and ``_StridedShard`` (what a matmul of a tensor sharded on
    its batch and sequence dims gives) computes its shard offsets on real
    index tensors, which under ``FakeTensorMode`` would be fake ones
    whose values it cannot read; a ``StepCounter`` does not count them."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run joins a fake group of its own")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    strided = placement_types._StridedShard
    offsets = strided.local_shard_size_and_offset

    def real_offsets(self, *args, **kwargs):
        with unset_fake_temporarily(), _uncounted():
            return offsets(self, *args, **kwargs)
    orig = placement_types.shard_dim_alltoall
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    placement_types.shard_dim_alltoall = alltoall
    strided.local_shard_size_and_offset = real_offsets
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig
        strided.local_shard_size_and_offset = offsets
        dist.destroy_process_group()


def cell_step(model, cfg, shape, mesh, rules, *, fsdp, microbatches):
    """(the step as a thunk, its inputs, the inputs it updates in place)
    of ``model``, built for the cell and placed here on ``mesh`` under
    ``rules`` (which must be active): the cell's batch (zeros), for a
    train cell AdamW's state in ZeRO-1 placement, for a decode cell a
    placed cache.  Each call of the thunk runs one step."""
    if shape.kind != "train":
        cast_params(model)       # serving deploys bfloat16 weights
    specs = place_model(model, mesh, rules,
                        fsdp=fsdp and shape.kind == "train")
    placed = lambda tree, axes: place_batch(tree, mesh,
                                            input_pspecs(axes, rules))
    params = dict(model.named_parameters())
    if shape.kind == "train":
        opt = place_opt_state(adamw_init(model), mesh,
                              zero1_state_specs(specs, model, mesh))
        batch = placed(model.input_specs(shape),
                       model.input_logical_axes(shape))
        step = make_train_step(model, AdamWConfig(),
                               microbatches=microbatches)
        inputs = (params, opt["mu"], opt["nu"], batch)
        return (lambda: step(opt, batch)), inputs, inputs[:3]
    if shape.kind == "prefill":
        batch = placed(model.input_specs(shape),
                       model.input_logical_axes(shape))
        step = make_prefill_step(model, cache_len=shape.seq_len)
        return (lambda: step(batch)), (params, batch), ()
    enc_len = _enc_len(cfg, shape)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             enc_len=enc_len)
    tokens = placed(model.input_specs(shape),
                    model.input_logical_axes(shape))["tokens"]
    step = make_serve_step(model)
    return ((lambda: step(cache, tokens, shape.seq_len - 1)),
            (params, cache, tokens), (cache,))


def count_step(run, inputs, updated):
    """One step, ``run()``, under ``counting()``, its ``inputs`` alive
    from the start: (the counter, ``StepCounter.memory``'s keys, with
    ``updated``, the inputs it writes in place, among the outputs)."""
    with counting() as c:
        c.hold(inputs)
        out = run()
        memory = c.memory((out, updated))
    return c, memory


def count_cell(cfg, shape, mesh, rules, *, fsdp: bool = True,
               microbatches: int = 1, fake: bool = True) -> Dict:
    """Build ``cfg``, place it for the cell on ``mesh`` under ``rules``
    and count one step (``count_step``): {"cost": ``_extract_cost``'s
    keys, "memory": the reference's memory keys, "top_ops",
    "params_total", "params_active", "seconds"}.  ``fake`` builds on fake
    tensors (nothing allocated), else on the host's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode, use_rules(rules):
        model = build_model(cfg, device="cpu")
        c, memory = count_step(*cell_step(model, cfg, shape, mesh, rules,
                                          fsdp=fsdp,
                                          microbatches=microbatches))
    return {"cost": c.cost(), "memory": memory, "top_ops": c.top_ops(),
            "params_total": model.param_count(),
            "params_active": model.active_param_count(),
            "seconds": time.time() - t0}


def _probe_depths(cfg):
    """Reduced-depth config pair for linear cost extrapolation."""
    if cfg.family == "hybrid":
        period = cfg.attn_every * cfg.n_shared_attn
        l1, l2 = period, 2 * period
        return (dataclasses.replace(cfg, n_layers=l1),
                dataclasses.replace(cfg, n_layers=l2), l1, l2)
    if cfg.family == "encdec":
        return (dataclasses.replace(cfg, n_layers=1, enc_layers=1),
                dataclasses.replace(cfg, n_layers=2, enc_layers=2), 1, 2)
    period = max(len(cfg.layer_pattern), 1)
    return (dataclasses.replace(cfg, n_layers=period),
            dataclasses.replace(cfg, n_layers=2 * period), period, 2 * period)


def probe_costs(cfg, shape, mesh, rules, *, fsdp: bool) -> dict:
    """Cost terms extrapolated linearly in depth from two reduced-depth
    configs (``_probe_depths``), as the reference's, which needs them
    because XLA counts a while-loop body once.  The probes run one
    microbatch, as the reference's (its FLOPs are linear in tokens; its
    bytes and collectives are not: each microbatch reads the weights
    again).  For a homogeneous stack at one microbatch the extrapolation
    equals the full-depth count (the tests hold it so)."""
    cfg1, cfg2, l1, l2 = _probe_depths(cfg)
    m1 = count_cell(cfg1, shape, mesh, rules, fsdp=fsdp)["cost"]
    m2 = count_cell(cfg2, shape, mesh, rules, fsdp=fsdp)["cost"]
    L = cfg.n_layers
    scale = (L - l1) / (l2 - l1)

    def ext(a, b):
        return a + (b - a) * scale

    ops = set(m1["coll_per_op"]) | set(m2["coll_per_op"])
    per_op = {op: max(ext(m1["coll_per_op"].get(op, 0),
                          m2["coll_per_op"].get(op, 0)), 0.0) for op in ops}
    return {
        "method": f"eager depth-extrapolation (L1={l1}, L2={l2}, L={L})",
        "flops_per_device": max(ext(m1["flops"], m2["flops"]), 0.0),
        "bytes_per_device": max(ext(m1["bytes"], m2["bytes"]), 0.0),
        "transcendentals": max(ext(m1["transcendentals"],
                                   m2["transcendentals"]), 0.0),
        "collective_bytes_per_device": max(ext(m1["coll_total"],
                                               m2["coll_total"]), 0.0),
        "collective_per_op": per_op,
        "probe_points": {"l1": m1, "l2": m2},
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             fsdp: bool = True, sequence_parallel: bool = None,
             expert_parallel: bool = True, remat: str = None,
             attn_chunk: int = 1024, tag: str = "baseline",
             probe: bool = False, probe_depth: bool = False,
             microbatches: int = None, split_cache: bool = False,
             ssd_chunk: int = None, capacity_factor: float = None,
             batch: int = None, seq: int = None,
             out_dir: Path = OUT_DIR) -> dict:
    """One cell on a fake group of 256 ("single") or 512 ("multi") ranks,
    or of one rank ("local", the 1 x 1 mesh of one card): the
    reference's result keys, ``status`` "ok" or "skipped".  ``batch`` and
    ``seq`` override the shape's global batch and length; ``probe_depth``
    builds the config at its first probe depth (``_probe_depths``: one
    layer pattern, a hybrid's attention period, one encoder and decoder
    layer), a quick check that every layer kind runs on the mesh.  The
    group is destroyed on return, also on error."""
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if split_cache:
        cfg = dataclasses.replace(cfg, split_local_cache=True)
    if ssd_chunk is not None:
        cfg = dataclasses.replace(cfg, ssd_chunk=ssd_chunk)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    if attn_chunk != 1024:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    if probe_depth:
        cfg = _probe_depths(cfg)[0]
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    if sequence_parallel is None:
        sequence_parallel = shape.kind == "train"
    if microbatches is None:
        microbatches = 4 if shape.kind == "train" else 1
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "fsdp": fsdp, "sequence_parallel": sequence_parallel,
        "expert_parallel": expert_parallel, "remat": cfg.remat,
        "attn_chunk": attn_chunk, "microbatches": microbatches,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        result.update(status="skipped", reason=reason)
        return result

    with fake_group(FAKE_RANKS[mesh_kind]):
        mesh = (make_local_mesh(1, 1, device="cpu") if mesh_kind == "local"
                else make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                          device="cpu"))
        n_chips = mesh.size()
        rules = rules_for_arch(cfg, mesh, shape,
                               sequence_parallel=sequence_parallel,
                               expert_parallel=expert_parallel)
        full = count_cell(cfg, shape, mesh, rules, fsdp=fsdp,
                          microbatches=microbatches)
        scanbody = full["cost"]
        cost = None
        if probe:
            cost = probe_costs(cfg, shape, mesh, rules, fsdp=fsdp)

    if cost is not None:
        flops_dev = cost["flops_per_device"]
        bytes_dev = cost["bytes_per_device"]
        coll_total = cost["collective_bytes_per_device"]
        coll_per_op = cost["collective_per_op"]
    else:
        flops_dev = scanbody["flops"]
        bytes_dev = scanbody["bytes"]
        coll_total = scanbody["coll_total"]
        coll_per_op = scanbody["coll_per_op"]

    active, total = full["params_active"], full["params_total"]
    embed_p = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    mf = model_flops(cfg, shape, active, embed_p)
    terms = roofline(flops_dev, bytes_dev, coll_total)

    result.update(
        status="ok",
        n_chips=n_chips,
        compile_s=round(full["seconds"], 1),
        params_total=total,
        params_active=active,
        memory=full["memory"],
        cost={
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "transcendentals": (cost or {}).get(
                "transcendentals", scanbody["transcendentals"]),
            "method": (cost or {}).get(
                "method", f"eager {'probe' if probe_depth else 'full'} "
                          f"depth (L={cfg.n_layers}, "
                          f"microbatches={microbatches})"),
            "top_ops": full["top_ops"],
        },
        cost_scanbody=scanbody,
        collectives={"total_bytes_per_device": coll_total,
                     "per_op": coll_per_op},
        model_flops_global=mf,
        model_flops_per_device=mf / n_chips,
        useful_flops_ratio=(mf / n_chips) / flops_dev if flops_dev else None,
        roofline=terms,
        roofline_mfu_bound=((mf / n_chips) / H100_SXM["peak_flops"])
            / terms["step_time_bound_s"] if terms["step_time_bound_s"]
            else None,
        rules={k: list(v) if isinstance(v, tuple) else v
               for k, v in rules.items()},
    )
    return result


def cell_filename(arch, shape, mesh, tag):
    return f"{arch}__{shape}__{mesh}__{tag}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="single",
                    choices=list(FAKE_RANKS))
    ap.add_argument("--all", action="store_true",
                    help="run every cell, both meshes")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--tag", type=str, default="baseline")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=-1,
                    help="sequence parallelism: -1 auto (train on), 0 off, "
                         "1 on")
    ap.add_argument("--ep", type=int, default=1, help="expert parallelism")
    ap.add_argument("--remat", type=str, default=None,
                    choices=[None, "none", "full"])
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--probe", type=int, default=0,
                    help="1: costs by the reference's depth extrapolation "
                         "(probe_costs) in place of the full-depth count")
    ap.add_argument("--probe-depth", type=int, default=0,
                    help="1: build the config at its first probe depth")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--split-cache", type=int, default=0)
    ap.add_argument("--ssd-chunk", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the shape's sequence length")
    ap.add_argument("--out", type=str, default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s, m) for a in list_configs() for s in SHAPES
                 for m in ("single", "multi")]
        procs, failures = [], []
        for a, s, m in cells:
            fn = out_dir / cell_filename(a, s, m, args.tag)
            if fn.exists():
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m, "--tag", args.tag,
                   "--fsdp", str(args.fsdp), "--sp", str(args.sp),
                   "--ep", str(args.ep), "--probe", str(args.probe),
                   "--probe-depth", str(args.probe_depth),
                   "--out", str(out_dir)]
            if args.remat:
                cmd += ["--remat", args.remat]
            procs.append((a, s, m, subprocess.Popen(cmd)))
            while len([p for *_, p in procs if p.poll() is None]) >= args.jobs:
                time.sleep(2)
        for a, s, m, p in procs:
            if p.wait() != 0:
                failures.append((a, s, m))
        print(f"dry-run complete; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    try:
        res = run_cell(args.arch, args.shape, args.mesh, fsdp=bool(args.fsdp),
                       sequence_parallel=(bool(args.sp) if args.sp >= 0
                                          else None),
                       expert_parallel=bool(args.ep), remat=args.remat,
                       attn_chunk=args.attn_chunk, tag=args.tag,
                       probe=bool(args.probe),
                       probe_depth=bool(args.probe_depth),
                       microbatches=args.microbatches,
                       split_cache=bool(args.split_cache),
                       ssd_chunk=args.ssd_chunk,
                       capacity_factor=args.capacity_factor,
                       batch=args.batch, seq=args.seq, out_dir=out_dir)
    except Exception:
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "tag": args.tag, "status": "error",
               "error": traceback.format_exc()}
    fn = out_dir / cell_filename(args.arch, args.shape, args.mesh, args.tag)
    fn.write_text(json.dumps(res, indent=2, default=str))
    if res["status"] == "ok":
        r = res["roofline"]
        print(f"{args.arch} {args.shape} {args.mesh}: OK "
              f"flops={res['cost']['flops_per_device']:.6e} "
              f"trace={res['compile_s']}s "
              f"mem={res['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
              f"terms(c/m/coll)={r['compute_s']:.4f}/{r['memory_s']:.4f}/"
              f"{r['collective_s']:.4f}s dominant={r['dominant']}")
    else:
        print(f"{args.arch} {args.shape} {args.mesh}: "
              f"{res['status'].upper()}")
        if res["status"] == "error":
            print(res["error"][-2000:])
            sys.exit(1)


if __name__ == "__main__":
    main()
