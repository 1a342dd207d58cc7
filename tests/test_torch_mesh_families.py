"""The sharded train step of every other family, and the train launcher on
a mesh, against the single-device port and the reference, on 4 gloo ranks
(the h2o twin, the rules and specs are in ``test_torch_distributed``).

A family's tiny config (``tiny_config``) steps once on a 2x2 mesh: the
loss and every updated leaf equal the port's single-device step (1e-5),
the loss the reference's (1e-4), at float32.  The MoE families run their
dispatch on gathered tensors (``models.moe.moe_apply``).
"""
from __future__ import annotations

import numpy as np
import pytest

import dataclasses

import jax
import jax.numpy as jnp

from conftest import make_batch, tiny_config
from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.runtime.steps import make_train_step as r_make_train_step
from repro_torch.configs import get_config
from test_torch_distributed import _case, _step_twins, f32  # noqa: F401
import test_torch_mesh_workers as workers

ARCHS = ["gemma2-27b", "mamba2-130m", "zamba2-2.7b", "minicpm3-4b",
         "mixtral-8x7b", "qwen2-vl-2b", "seamless-m4t-large-v2"]


def test_sharded_train_steps_of_each_family(f32, tmp_path):
    cases = []
    for i, arch in enumerate(ARCHS, start=1):
        case, _, _, loss = _case(arch, i)
        cases.append((case, loss))
    got = _step_twins(cases, tmp_path, checkpoints=False)
    assert sorted(got) == sorted(c["cfg"].name for c, _ in cases)


# the mesh's harder paths: q heads sharded over kv heads that are not (each
# rank reads its heads' kv group), 3 q heads over 2 ranks (context-parallel
# attention: each rank's k/v gradient is a partial sum), 3 SSM heads over
# 2 ranks (the (H, P) projections as each rank's local product)
HARDER = [("h2o-danube-3-4b", dict(n_kv_heads=1)),
          ("h2o-danube-3-4b", dict(n_heads=3, n_kv_heads=1, head_dim=16)),
          ("mamba2-130m", dict(d_model=48, ssm_head_p=32))]


def test_sharded_train_steps_on_the_harder_paths(f32, tmp_path):
    cases = []
    for i, (arch, over) in enumerate(HARDER, start=20):
        name = f"{arch}-{i}"
        r_cfg = dataclasses.replace(tiny_config(r_get_config(arch)),
                                    name=name, **over)
        cfg = dataclasses.replace(tiny_config(get_config(arch)), name=name,
                                  **over)
        batch = {k: np.asarray(v) for k, v in make_batch(
            r_cfg, batch=4, seq=16, seed=i).items()}
        ref = r_build(r_cfg)
        params, _ = ref.init(jax.random.key(i))
        loss = float(jax.jit(ref.loss)(params, {k: jnp.asarray(v) for k, v
                                                in batch.items()}))
        cases.append(({"cfg": cfg, "params": jax.tree.map(np.asarray, params),
                       "batch": batch}, loss))
    got = _step_twins(cases, tmp_path, checkpoints=False)
    assert len(got) == len(HARDER)


# microbatches on a mesh: the i-th is the i-th contiguous slice of the
# global batch, as in the reference (the router's aux loss, a product of
# means over a microbatch's tokens, depends on which rows it holds); h2o
# under sequence parallelism, as the dry run's train cells run (the
# embedding's rows reduce-scattered over the sequence)
MICRO = [("h2o-danube-3-4b", {}, True),
         ("mixtral-8x7b", dict(capacity_factor=1.0), False)]


def test_sharded_train_steps_in_microbatches(f32, tmp_path):
    """Two microbatches of 2 rows each on a 2x2 mesh: the loss and every
    updated leaf equal the port's single-device step at 2 microbatches
    (1e-5), the loss the reference's step at 2 microbatches (1e-4)."""
    cases = []
    for i, (arch, over, sp) in enumerate(MICRO, start=30):
        name = f"{arch}-micro"
        r_cfg = dataclasses.replace(tiny_config(r_get_config(arch)),
                                    name=name, **over)
        cfg = dataclasses.replace(tiny_config(get_config(arch)), name=name,
                                  **over)
        batch = {k: np.asarray(v) for k, v in make_batch(
            r_cfg, batch=4, seq=16, seed=i).items()}
        ref = r_build(r_cfg)
        params, _ = ref.init(jax.random.key(i))
        r_step = jax.jit(r_make_train_step(
            ref, RAdamWConfig(lr=1e-3, eps=workers.STEP_EPS),
            microbatches=2))
        _, _, metrics = r_step(params, r_adamw_init(params),
                               {k: jnp.asarray(v) for k, v in batch.items()})
        cases.append(({"cfg": cfg, "params": jax.tree.map(np.asarray, params),
                       "batch": batch, "microbatches": 2,
                       "sequence_parallel": sp},
                      float(metrics["loss"])))
    got = _step_twins(cases, tmp_path, checkpoints=False)
    assert len(got) == len(MICRO)


def test_train_launcher_on_a_2x2_mesh(tmp_path, capsys):
    """``launch.train --mesh-data 2 --mesh-model 2`` on 4 gloo ranks gives
    the single-process run's losses; a single process asking for a mesh is
    refused with the torchrun command."""
    from repro_torch.launch import train as launch
    argv = ["--reduced-layers", "2", "--steps", "3", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--reduced-width", "64"]
    mesh = ["--mesh-data", "2", "--mesh-model", "2"]
    out = workers.run_ranks(workers.launcher, 4, tmp_path / "ranks",
                            argv + mesh + ["--ckpt-dir",
                                           str(tmp_path / "mesh")])
    single = launch.main(argv + ["--ckpt-dir", str(tmp_path / "single")])
    want = [h["loss"] for h in single["history"]]
    assert all(o == out[0] for o in out[1:])
    np.testing.assert_allclose(out[0], want, rtol=1e-4)
    with pytest.raises(SystemExit):
        launch.main(argv + mesh + ["--ckpt-dir", str(tmp_path / "x")])
    assert "torchrun --nproc-per-node 4" in capsys.readouterr().err
