"""The training loop: train steps, atomic/async checkpoints, preemption
handling, bounded retry with restore-from-latest-good, straggler
surveillance, metric logging.

The port of ``repro.runtime.train_loop``.  The model's parameters and the
AdamW state are updated in place by the step; a checkpoint holds them in
the reference's layout (``{"params": ..., "opt": {"mu", "nu", "step"}}``
with stacked layers), so either package resumes from the other's.

``train(..., mesh=mesh)`` runs under ``use_rules(rules)``: after the
init the model is placed on the mesh (``place_for_training``: DTensor
parameters, ZeRO-1 AdamW state), each rank is fed the global batch, and
the checkpoints hold full tensors, so a run resumes on any mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ..distributed.partitioning import get_rules
from ..distributed.sharding import place_for_training
from ..models.common import make_generator
from ..models.convert import reference_tree
from ..models.model import Model
from ..optim import AdamWConfig, adamw_init, linear_warmup_cosine
from .checkpoint import Checkpointer, latest_step
from .failure import FailureInjector, GracefulShutdown, StragglerDetector, retry
from .steps import make_train_step

__all__ = ["TrainLoopConfig", "train", "state_tree", "restore_state"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    resume: bool = True
    seed: int = 0
    warmup: int = 10
    max_retries: int = 2
    async_ckpt: bool = True


def state_tree(model: Model, opt_state: Dict) -> Dict[str, Any]:
    """The checkpointed state in the reference's layout, over the live
    tensors (no copy)."""
    return {"params": reference_tree(model),
            "opt": {"mu": reference_tree(opt_state["mu"]),
                    "nu": reference_tree(opt_state["nu"]),
                    "step": np.asarray(opt_state["step"], np.int32)}}


def restore_state(ckpt: Checkpointer, model: Model, opt_state: Dict,
                  step: Optional[int] = None) -> None:
    """Restore the model and the AdamW state in place from ``ckpt``."""
    out = ckpt.restore(state_tree(model, opt_state), step)
    opt_state["step"] = int(out["opt"]["step"])


def train(
    model: Model,
    data_iter: Iterator[Dict[str, Any]],
    opt_cfg: AdamWConfig = AdamWConfig(),
    loop: TrainLoopConfig = TrainLoopConfig(),
    *,
    failure_injector: Optional[FailureInjector] = None,
    log_fn: Callable[[str], None] = print,
    mesh=None,
) -> Dict[str, Any]:
    """Returns {"params", "opt_state", "history", "stragglers", "restarts",
    "final_step"}; ``params`` is the model's named parameters.  With a
    ``mesh`` the active rules place the model and the state on it."""
    lr_sched = linear_warmup_cosine(opt_cfg.lr, loop.warmup, loop.steps)

    ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep) if loop.ckpt_dir else None
    model.init(make_generator(loop.seed, model.device))
    if mesh is None:
        opt_state = adamw_init(model)
    else:
        if get_rules() is None:
            raise RuntimeError("train on a mesh runs under use_rules(...)")
        opt_state = place_for_training(model, mesh, get_rules())
    step_fn = make_train_step(model, opt_cfg, lr_sched)   # the placed leaves
    start_step = 0

    if ckpt and loop.resume and latest_step(loop.ckpt_dir) is not None:
        restore_state(ckpt, model, opt_state)
        start_step = ckpt.manifest()["step"]
        log_fn(f"[train] resumed from step {start_step}")

    detector = StragglerDetector()
    history: List[Dict[str, float]] = []
    restarts = 0

    def save(step, blocking=False):
        if not ckpt:
            return
        tree = state_tree(model, opt_state)
        if loop.async_ckpt and not blocking:
            ckpt.save_async(step, tree, extra={
                "loss": history[-1]["loss"] if history else None})
        else:
            ckpt.save(step, tree, extra={})

    with GracefulShutdown() as shutdown:
        step = start_step
        while step < loop.steps:
            batch = next(data_iter)
            t0 = time.time()

            def run_step():
                if failure_injector is not None:
                    failure_injector.maybe_fail(step)
                return step_fn(opt_state, batch)

            def on_error(attempt, exc):
                nonlocal restarts
                restarts += 1
                log_fn(f"[train] step {step} failed ({exc}); retry {attempt} "
                       f"from latest checkpoint")
                if ckpt and latest_step(loop.ckpt_dir) is not None:
                    restore_state(ckpt, model, opt_state)

            metrics = retry(run_step, retries=loop.max_retries,
                            on_error=on_error)
            loss = float(metrics["loss"])            # waits for the step
            dt = time.time() - t0
            report = detector.record(step, dt)
            if report is not None:
                log_fn(f"[train] straggler: step {report.step} took "
                       f"{report.duration:.3f}s (z={report.z:.1f})")

            history.append({"step": step, "loss": loss, "dt": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if step % loop.log_every == 0:
                log_fn(f"[train] step {step} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")

            step += 1
            if ckpt and step % loop.ckpt_every == 0:
                save(step)
            if shutdown.requested:
                log_fn(f"[train] shutdown requested; checkpointing at step {step}")
                save(step, blocking=True)
                break

    if ckpt:
        save(step, blocking=True)
        ckpt.wait()
    return {"params": dict(model.named_parameters()), "opt_state": opt_state,
            "history": history, "stragglers": detector.flags,
            "restarts": restarts, "final_step": step}
