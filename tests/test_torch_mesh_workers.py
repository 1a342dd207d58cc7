"""Rank functions of the port's multi-rank twins (``test_torch_distributed``,
``test_torch_mesh_families``); this module holds no test itself.

Each function runs on every rank of a gloo job started by ``run_ranks``
(spawned processes, a ``file://`` store, so parallel test workers never
share a port).  This module imports only torch, numpy and ``repro_torch``:
the reference's numbers are computed by the test and handed in as numpy.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STEP_EPS = 1e-3   # AdamW eps of the step twins (see test_torch_train)


def _rank_main(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = {"ok": fn(rank, world, *args)}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    try:
        dist.destroy_process_group()
    finally:
        if "error" in out:
            os._exit(1)


def run_ranks(fn, world: int, tmp, *args, timeout: float = 120.0):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns each rank's result, or raises with the failing ranks'
    tracebacks (or on ``timeout`` seconds, after killing the ranks)."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, tmp, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"more than {timeout} s")
    except mp.ProcessRaisedException:
        pass
    except mp.ProcessExitedException:
        pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results, errors = [], []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result")
            continue
        with open(path, "rb") as f:
            out = pickle.load(f)
        if "error" in out:
            errors.append(f"rank {r}:\n{out['error']}")
        results.append(out.get("ok"))
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# --------------------------------------------------------------------------- #
# a sharded train step against the single-device step, each family
# --------------------------------------------------------------------------- #

def _full(t):
    t = t.detach()
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()


def step_twins(rank, world, cases, ckpt_in, ckpt_out):
    """For each case {"cfg", "params" (reference tree, numpy), "batch"}:
    one AdamW step of the port on one rank and on a (2, world/2) mesh
    from the same weights.  Returns {arch: {"plain": loss, "mesh": loss,
    "leaf": max |mesh - plain| over the updated leaves, "placed": the
    number of sharded parameters, "restored"}}.  With
    ``ckpt_in``/``ckpt_out`` given, the first case also restores the
    reference-written checkpoint ``ckpt_in`` into the placed model
    ("restored": the largest difference to the reference's weights) and
    writes its state after the step to ``ckpt_out``."""
    from repro_torch.distributed.partitioning import use_rules
    from repro_torch.distributed.sharding import (place_for_training,
                                                  rules_for_arch)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, common
    from repro_torch.models.convert import load_reference_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.checkpoint import Checkpointer
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.train_loop import state_tree

    common.DTYPE = torch.float32
    mesh = make_local_mesh(2, world // 2, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, eps=STEP_EPS)
    out = {}
    for i, case in enumerate(cases):
        cfg = case["cfg"]
        plain = load_reference_params(build_model(cfg, device="cpu"),
                                      case["params"])
        state = adamw_init(plain)
        m_plain = make_train_step(plain, opt_cfg)(state, case["batch"])

        model = load_reference_params(build_model(cfg, device="cpu"),
                                      case["params"])
        rules = rules_for_arch(cfg, mesh)
        m_state = place_for_training(model, mesh, rules)
        restored = None
        if i == 0 and ckpt_in:
            want = _flat_params(cfg, case["params"])
            Checkpointer(ckpt_in).restore(state_tree(model, m_state))
            restored = max(float(np.abs(_full(p) - want[k]).max())
                           for k, p in model.named_parameters())
        with use_rules(rules):
            m_mesh = make_train_step(model, opt_cfg)(m_state, case["batch"])
        own = dict(plain.named_parameters())
        leaf = max(float(np.abs(_full(p) - own[k].detach().numpy()).max())
                   for k, p in model.named_parameters())
        placed = sum(any(pl.is_shard() for pl in p.placements)
                     for p in model.parameters())
        out[cfg.name] = {"plain": float(m_plain["loss"]),
                         "mesh": float(m_mesh["loss"]), "leaf": leaf,
                         "placed": placed, "restored": restored}
        if i == 0 and ckpt_out:
            Checkpointer(ckpt_out).save(1, state_tree(model, m_state))
    return out


def _flat_params(cfg, params):
    """{port parameter name: full numpy array} of a reference tree."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_reference_params
    m = load_reference_params(build_model(cfg, device="cpu"), params)
    return {k: p.detach().numpy() for k, p in m.named_parameters()}


# --------------------------------------------------------------------------- #
# collectives: compressed psum, pipeline stages
# --------------------------------------------------------------------------- #

def collectives(rank, world, x_rows, ws, x, n_micro):
    """(``compressed_psum`` of row ``rank`` of ``x_rows`` over the job,
    ``pipeline_forward`` of ``tanh(x @ w_s)`` over ``world`` stages)."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_mesh_compat

    psum = compressed_psum(torch.from_numpy(x_rows[rank])).numpy()
    mesh = make_mesh_compat((world,), ("stage",), device="cpu")
    out = pipeline_forward(lambda w, a: torch.tanh(a @ w),
                           torch.from_numpy(ws), torch.from_numpy(x), mesh,
                           n_microbatches=n_micro)
    return psum, out.numpy()


# --------------------------------------------------------------------------- #
# the train launcher on a mesh
# --------------------------------------------------------------------------- #

def launcher(rank, world, argv):
    """``launch.train.main(argv)`` on this rank (the process group is
    already joined); returns its loss history."""
    from repro_torch.launch.train import main
    out = main(list(argv))
    return [h["loss"] for h in out["history"]]
