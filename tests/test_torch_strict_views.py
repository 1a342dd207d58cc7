"""No DTensor ``view`` on the mesh paths needs a redistribution.

DTensor runs ``aten.view`` and ``aten._unsafe_view`` (what a matmul of a
3-D activation and a ``reshape`` of a contiguous tensor become) as strict
views: a view may not change how its operand is sharded.  torch 2.11
holds that strictly, with ``Shard`` placements alone, and refuses
(``_view_ops.propagate_shape_and_sharding``, ``strict_view``):

- a view that merges dims of which any but the first is sharded (a
  ``(B, S, D)`` activation sharded on its batch and its sequence,
  flattened to ``(B*S, D)``; an SSM's ``(H, P)`` with ``P`` sharded);
- a view that merges a first dim sharded into unequal blocks;
- a view that splits a sharded dim whose first factor its ranks do not
  divide (``(H*P)`` split into ``H`` heads, ``H`` not a multiple of them).

Later releases plan such views as ``_StridedShard`` and run them, so on
this host they pass unseen.  ``StrictViews`` records every view DTensor
propagates that 2.11 would refuse, and the guard runs a probe-depth step
of a context-parallel arch (minicpm3-4b: 40 heads over 16 ranks, so the
attention's sequence is sharded) and of an SSM arch (mamba2-130m: 24
heads over 16 ranks) on the dry run's fake group of 256 ranks at small
batch and length: train, prefill and decode.  None may be recorded.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC, TESTS = str(ROOT / "src"), str(ROOT / "tests")

_STRICT = '''
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def refusals(x, shape):
    """Why torch 2.11 would refuse to view the DTensor ``x`` as ``shape``
    (an empty list: it would not)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                         Split, view_groups)
    sizes = x.device_mesh.shape
    where = {}
    for m, p in enumerate(x.placements):
        if isinstance(p, (Shard, _StridedShard)):
            where.setdefault(p.dim, []).append(m)
    out = []

    def first(cmd):
        if isinstance(cmd, InputDim):
            return cmd.input_dim
        if isinstance(cmd, Flatten):
            for i, d in enumerate(cmd.input_dims):
                dim = d.input_dim
                if dim in where and i > 0:
                    out.append(f"merges sharded dim {dim}")
                elif dim in where and any(x.shape[dim] % sizes[m]
                                          for m in where[dim]):
                    out.append(f"merges unevenly sharded dim {dim}")
            return cmd.input_dims[0].input_dim
        if isinstance(cmd, Split):
            dim = first(cmd.input_dim)
            if cmd.split_id == 0 and dim in where and any(
                    cmd.group_shape[0] % sizes[m] for m in where[dim]):
                out.append(f"splits sharded dim {dim} into "
                           f"{tuple(cmd.group_shape)}")
            return dim if cmd.split_id == 0 else None
        return None

    for cmd in view_groups(tuple(x.shape), tuple(shape)):
        first(cmd)
    return out


class StrictViews(TorchDispatchMode):
    """Records (op, shape, target, placements, why) of every DTensor view
    torch 2.11 would refuse; the op then runs as DTensor runs it."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func in VIEWS and isinstance(args[0], DTensor):
            why = refusals(args[0], args[1])
            if why:
                self.found.append([str(func), list(args[0].shape),
                                   list(args[1]),
                                   [str(p) for p in args[0].placements],
                                   why])
        if any(isinstance(a, DTensor) for a in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        return func(*args, **kwargs)
'''


def _run(code: str, timeout: float = 300.0):
    """``code`` after ``_STRICT`` in a fresh python (no JAX); the JSON of
    its last line of output."""
    prelude = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{SRC!r}, {TESTS!r}]
        import torch
        torch.set_num_threads(1)
    """)
    out = subprocess.run([sys.executable, "-c", prelude + _STRICT
                          + textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_recorder_flags_what_torch_2_11_refuses():
    """On a 2 x 2 fake mesh: a (batch, sequence)-sharded activation
    flattened, a dim sharded into unequal blocks flattened, and 3 heads
    split out of a dim sharded over 2 ranks are refused; a batch-sharded
    flatten and 2 heads split out of it are not."""
    got = _run("""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.launch.mesh import make_local_mesh
        cases = {
            "batch_and_seq": ((2, 8, 6), (Shard(0), Shard(1)), (16, 6)),
            "uneven_first": ((3, 4, 6), (Shard(0), Replicate()), (12, 6)),
            "uneven_heads": ((2, 8, 6), (Shard(0), Shard(2)), (2, 8, 3, 2)),
            "batch_only": ((2, 8, 6), (Shard(0), Replicate()), (16, 6)),
            "even_heads": ((2, 8, 8), (Shard(0), Shard(2)), (2, 8, 2, 4)),
        }
        out = {}
        with fake_group(4):
            mesh = make_local_mesh(2, 2, device="cpu")
            for name, (shape, place, view) in cases.items():
                x = DTensor.from_local(
                    torch.zeros(shape), mesh, list(place), run_check=False,
                    shape=shape, stride=torch.zeros(shape).stride())
                out[name] = refusals(x, view)
        print(json.dumps(out))
    """)
    assert got == {"batch_and_seq": ["merges sharded dim 1"],
                   "uneven_first": ["merges unevenly sharded dim 0"],
                   "uneven_heads": ["splits sharded dim 2 into (3, 2)"],
                   "batch_only": [], "even_heads": []}


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-130m"])
def test_mesh_steps_take_no_view_torch_2_11_refuses(arch):
    got = _run(f"""
        import dataclasses
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.distributed.partitioning import use_rules
        from repro_torch.distributed.sharding import rules_for_arch
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import build_model
        cfg = dryrun._probe_depths(get_config({arch!r}))[0]
        found, steps = [], 0
        with dryrun.fake_group(256):
            mesh = make_production_mesh(device="cpu")
            for name, batch in (("train_4k", 64), ("prefill_32k", 32),
                                ("decode_32k", 128)):
                shape = dataclasses.replace(SHAPES[name], global_batch=batch,
                                            seq_len=256)
                rules = rules_for_arch(cfg, mesh, shape,
                                       sequence_parallel=shape.kind == "train")
                with FakeTensorMode(allow_non_fake_inputs=True), \\
                        use_rules(rules):
                    model = build_model(cfg, device="cpu")
                    run, _, _ = dryrun.cell_step(
                        model, cfg, shape, mesh, rules, fsdp=True,
                        microbatches=4 if shape.kind == "train" else 1)
                    rec = StrictViews()
                    with rec:
                        run()
                found += [[name] + f for f in rec.found]
                steps += 1
        print(json.dumps({{"steps": steps, "found": found}}))
    """)
    assert got["steps"] == 3
    assert got["found"] == [], got["found"][:5]
