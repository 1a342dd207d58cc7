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
