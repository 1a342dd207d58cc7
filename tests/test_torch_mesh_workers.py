"""Rank functions of the port's multi-rank twins (``test_torch_distributed``,
``test_torch_mesh_families``, ``test_torch_mesh_serving``); this module
holds no test itself.

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
    """For each case {"cfg", "params" (reference tree, numpy), "batch",
    optionally "microbatches" and "sequence_parallel"}: one AdamW step of
    the port on one rank and on a (2, world/2) mesh from the same
    weights.  Returns {arch: {"plain": loss, "mesh": loss,
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
        micro = case.get("microbatches", 1)
        m_plain = make_train_step(plain, opt_cfg, microbatches=micro)(
            state, case["batch"])

        model = load_reference_params(build_model(cfg, device="cpu"),
                                      case["params"])
        rules = rules_for_arch(cfg, mesh, sequence_parallel=case.get(
            "sequence_parallel", False))
        m_state = place_for_training(model, mesh, rules)
        restored = None
        if i == 0 and ckpt_in:
            want = _flat_params(cfg, case["params"])
            Checkpointer(ckpt_in).restore(state_tree(model, m_state))
            restored = max(float(np.abs(_full(p) - want[k]).max())
                           for k, p in model.named_parameters())
        with use_rules(rules):
            m_mesh = make_train_step(model, opt_cfg, microbatches=micro)(
                m_state, case["batch"])
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


# --------------------------------------------------------------------------- #
# prefill and decode on a mesh against the single-device run
# --------------------------------------------------------------------------- #

def _leaf_state(cache):
    """{entry: (placements, the local tensor's data pointer)} of a placed
    cache."""
    return {k: (tuple(v.placements), v.to_local().data_ptr())
            for k, v in cache.items()}


def serve_twins(rank, world, cases):
    """For each case {"name", "cfg", "params" (reference tree, numpy),
    "prompt" (numpy batch), "tokens" (numpy (n, B, 1)), "cache_len"}:
    prefill then ``n`` decode steps through ``runtime.steps`` at float32,
    once on this rank alone and once on a (2, world/2) mesh under the
    decode cell's rules, from the reference's weights.  Returns {name:
    {"err": the largest |mesh - plain| over every step's logits,
    "logits": the mesh's logits of every step (numpy, gathered), "rules":
    the cache's rules, "placed": the sharded cache entries, "kept": the
    cache entries that kept their placement and storage through every
    decode step (checked against ``input_pspecs`` of
    ``cache_logical_axes`` after prefill), "entries"}}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.partitioning import placements, use_rules
    from repro_torch.distributed.sharding import (input_pspecs, place_model,
                                                  rules_for_arch)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, common
    from repro_torch.models.convert import load_reference_params
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    common.DTYPE = torch.float32
    mesh = make_local_mesh(2, world // 2, device="cpu")
    out = {}
    for case in cases:
        cfg, n_cache = case["cfg"], case["cache_len"]
        toks = case["tokens"]
        start = sum(v.shape[1] for k, v in case["prompt"].items()
                    if k in ("tokens", "patches"))

        plain = load_reference_params(build_model(cfg, device="cpu"),
                                      case["params"])
        logits, cache = make_prefill_step(plain, n_cache)(case["prompt"])
        want = [logits]
        for j in range(toks.shape[0]):
            logits, cache = make_serve_step(plain)(cache, toks[j], start + j)
            want.append(logits)

        model = load_reference_params(build_model(cfg, device="cpu"),
                                      case["params"])
        shape = ShapeConfig("serve", n_cache, toks.shape[1], "decode")
        rules = rules_for_arch(cfg, mesh, shape)
        place_model(model, mesh, rules)
        specs = input_pspecs(model.cache_logical_axes(toks.shape[1], n_cache),
                             rules)
        with use_rules(rules):
            logits, cache = make_prefill_step(model, n_cache)(case["prompt"])
            got = [logits.full_tensor()]
            kept = {k for k, v in cache.items()
                    if list(v.placements) == placements(specs[k], mesh)}
            state = _leaf_state(cache)
            for j in range(toks.shape[0]):
                logits, cache = make_serve_step(model)(cache, toks[j],
                                                       start + j)
                got.append(logits.full_tensor())
                now = _leaf_state(cache)
                kept &= {k for k in now if now[k] == state[k]}
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        out[case["name"]] = {
            "err": err, "logits": [g.numpy() for g in got],
            "entries": sorted(cache), "kept": sorted(kept),
            "placed": sorted(k for k, v in cache.items()
                             if any(p.is_shard() for p in v.placements)),
            "rules": {k: rules[k] for k in ("batch", "kv_len", "kv_heads")}}
    return out
