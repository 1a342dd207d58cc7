"""The port's dry run (``launch/{roofline,collectives,dryrun,report}.py``)
against the reference's ``launch/{roofline,dryrun,hloparse,report}.py``.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its values (``_probe_depths``) are read in a subprocess;
``roofline`` and ``report`` are imported here.  Every fake process group
of the port runs in a subprocess of its own (``_run``), which checks that
each group it joined was destroyed; no test writes under
``experiments/dryrun/`` (the cells go to ``tmp_path``).

- ``model_flops`` and ``roofline`` equal the reference's (``roofline``
  at the reference's TPU figures); ``H100_SXM`` holds the data sheet's.
- ``_probe_depths`` equals the reference's for every config.
- ``StepCounter``: collective result bytes of hand-built collectives over
  4 fake ranks (the reference's ``test_collective_bytes_parser``); the
  local FLOPs of one sharded matmul (a mode above DTensor would count the
  global product); the fake count of a tiny step on a 1x1 mesh equal to
  the real CPU step's; the depth extrapolation equal to the full-depth
  count of a homogeneous stack.
- ``run_cell`` on a tiny config of each family x shape kind (h2o's and
  mixtral's on the 256-rank mesh, the others' on one rank): status "ok"
  with the reference's keys, and ``report`` formats the cells.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from conftest import run_in_subprocess, tiny_config
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.launch import report as r_report
from repro.launch.roofline import TPU_V5E
from repro.launch.roofline import model_flops as r_model_flops
from repro.launch.roofline import roofline as r_roofline
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import report
from repro_torch.launch.roofline import H100_SXM, model_flops, roofline
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TESTS = str(ROOT / "tests")

# the keys of an "ok" cell of the reference's run_cell
# (src/repro/launch/dryrun.py:186-195 and :241-267)
CELL_KEYS = {"arch", "shape", "mesh", "tag", "fsdp", "sequence_parallel",
             "expert_parallel", "remat", "attn_chunk", "microbatches",
             "status", "n_chips", "compile_s", "params_total",
             "params_active", "memory", "cost", "cost_scanbody",
             "collectives", "model_flops_global", "model_flops_per_device",
             "useful_flops_ratio", "roofline", "roofline_mfu_bound", "rules"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes_per_device"}


def _run(code: str, timeout: float = 120.0):
    """``code`` in a fresh python (``src`` and ``tests`` importable, no
    JAX); returns the JSON its last line of output prints.  The code runs
    after a prelude whose ``groups_gone()`` says whether no process group
    is left."""
    prelude = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{SRC!r}, {TESTS!r}]
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        def groups_gone():
            return not dist.is_initialized()
    """)
    out = subprocess.run([sys.executable, "-c",
                          prelude + textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------- #
# roofline
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_equal_the_reference(arch):
    model = build_model(get_config(arch), device="meta")
    active, total = model.active_param_count(), model.param_count()
    for name in SHAPES:
        for embed in (0, 12345, total // 3):
            assert model_flops(get_config(arch), SHAPES[name], active,
                               embed) == r_model_flops(
                r_get_config(arch), R_SHAPES[name], active, embed)


def test_roofline_equals_the_reference_at_its_figures():
    ref_hw = {"peak_flops": TPU_V5E["peak_flops"],
              "hbm_bw": TPU_V5E["hbm_bw"], "link_bw": TPU_V5E["ici_bw"]}
    for flops, nbytes, coll in [(1e15, 1e9, 1e6), (1e9, 1e13, 1e6),
                                (1e9, 1e9, 1e12), (0.0, 0.0, 0.0),
                                (3.2e14, 2.5e11, 4.1e10)]:
        assert roofline(flops, nbytes, coll, ref_hw) == \
            r_roofline(flops, nbytes, coll)
    # the H100 SXM's data-sheet rates (the smoke's own constants)
    assert H100_SXM["peak_flops"] == 989e12
    assert H100_SXM["hbm_bw"] == 3.35e12
    assert H100_SXM["link_bw"] == 50e9 < H100_SXM["nvlink_bw"]
    r = roofline(989e12, 3.35e12, 0.0)
    assert r["compute_s"] == r["memory_s"] == 1.0
    assert r["dominant"] == "compute" and r["step_time_bound_s"] == 1.0


# --------------------------------------------------------------------------- #
# probe depths
# --------------------------------------------------------------------------- #

def test_probe_depths_equal_the_references():
    out = run_in_subprocess("""
        import json
        from repro.configs import get_config, list_configs
        from repro.launch.dryrun import _probe_depths
        res = {}
        for a in list_configs():
            c1, c2, l1, l2 = _probe_depths(get_config(a))
            res[a] = [l1, l2, c1.n_layers, c2.n_layers, c1.enc_layers,
                      c2.enc_layers]
        print(json.dumps(res))
    """, devices=1, timeout=120)
    want = json.loads(out.strip().splitlines()[-1])
    from repro_torch.launch.dryrun import _probe_depths
    got = {}
    for a in list_configs():
        c1, c2, l1, l2 = _probe_depths(get_config(a))
        got[a] = [l1, l2, c1.n_layers, c2.n_layers, c1.enc_layers,
                  c2.enc_layers]
        assert c1 == dataclasses.replace(get_config(a), n_layers=l1,
                                         enc_layers=c1.enc_layers)
    assert got == want


# --------------------------------------------------------------------------- #
# the counter
# --------------------------------------------------------------------------- #

def test_collective_bytes_on_four_fake_ranks():
    """Result sizes, counted once each, per op type: an all-reduce of
    (16, 64) bf16, an all-gather of (8, 32) f32 -> (32, 32), a
    reduce-scatter of (16, 4) f32 -> (4, 4) and an all-to-all of (8, 8)
    f32; then DTensor's own redistributions under ``fake_group`` (a
    shard-to-shard move is an all-to-all, as on the card)."""
    res = _run("""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from repro_torch.launch.dryrun import counting, fake_group
        ops = torch.ops._c10d_functional
        with fake_group(4):
            mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
            g = mesh.get_group(0).group_name
            with FakeTensorMode():
                a = torch.empty(16, 64, dtype=torch.bfloat16)
                b, c, d = torch.empty(8, 32), torch.empty(16, 4), \\
                    torch.empty(8, 8)
                with counting() as hand:
                    ops.wait_tensor(ops.all_reduce(a, "sum", g))
                    ops.wait_tensor(ops.all_gather_into_tensor(b, 4, g))
                    ops.wait_tensor(ops.reduce_scatter_tensor(c, "sum", 4, g))
                    ops.wait_tensor(ops.all_to_all_single(d, [2] * 4, [2] * 4, g))
                x = torch.empty(8, 16)
                with counting() as dt:
                    part = DTensor.from_local(x, mesh, [Partial()],
                                              run_check=False)
                    part.redistribute(mesh, [Replicate()])
                    s0 = DTensor.from_local(x, mesh, [Shard(0)],
                                            run_check=False)
                    s0.redistribute(mesh, [Shard(1)])
        print(json.dumps({"hand": hand.collectives.totals(),
                          "calls": hand.collectives.calls,
                          "dtensor": dt.collectives.totals()[1],
                          "gone": groups_gone()}))
    """)
    total, per = res["hand"]
    assert per == {"all-reduce": 16 * 64 * 2, "all-gather": 32 * 32 * 4,
                   "reduce-scatter": 4 * 4 * 4, "all-to-all": 8 * 8 * 4}
    assert total == sum(per.values())
    assert res["calls"] == dict.fromkeys(per, 1)
    assert res["dtensor"] == {"all-reduce": 8 * 16 * 4,
                              "all-to-all": 8 * 16 * 4}
    assert res["gone"]


def test_counts_are_the_local_work_of_a_sharded_matmul():
    """x (64, 32) sharded on "data" @ w (32, 48) sharded on "model" over
    a 2x2 fake mesh: ``StepCounter`` counts rank 0's local product,
    2 * 32 * 32 * 24 FLOPs; torch's ``FlopCounterMode`` above DTensor
    counts the global one, 4x that."""
    res = _run("""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch.dryrun import counting, fake_group
        from repro_torch.launch.mesh import make_local_mesh
        with fake_group(4):
            mesh = make_local_mesh(2, 2, device="cpu")
            with FakeTensorMode():
                x = DTensor.from_local(torch.empty(32, 32), mesh,
                                       [Shard(0), Replicate()],
                                       run_check=False)
                w = DTensor.from_local(torch.empty(32, 24), mesh,
                                       [Replicate(), Shard(1)],
                                       run_check=False)
                with counting() as c:
                    y = x @ w
                with FlopCounterMode(display=False) as f:
                    x @ w
        print(json.dumps({"local": c.flops, "global": f.get_total_flops(),
                          "bytes": c.bytes, "place": str(y.placements),
                          "gone": groups_gone()}))
    """)
    assert res["local"] == 2 * 32 * 32 * 24
    assert res["global"] == 4 * res["local"]
    assert res["bytes"] == 4 * (32 * 32 + 32 * 24 + 32 * 24)
    assert res["place"] == "(Shard(dim=0), Shard(dim=1))"
    assert res["gone"]


_CELL = textwrap.dedent("""
    import dataclasses
    from conftest import tiny_config
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import rules_for_arch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_local_mesh
    cfg = tiny_config(get_config({arch!r}))
""")


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-130m"])
def test_fake_count_equals_the_real_cpu_steps(arch, tmp_path):
    """One train, prefill and decode step of a tiny config on a 1x1 mesh,
    counted on fake tensors (a fake group, its own process) and on real
    ones (a one-rank gloo group, another process): the same FLOPs and
    argument bytes; bytes moved and peak memory within 0.1% (the real run
    builds its RoPE frequency table once and reuses it from ``common``'s
    cache, the fake run builds it each time, a few small ops)."""
    counts = {}
    for fake in (True, False):
        join = ("group = dr.fake_group(1)" if fake else
                f"dist.init_process_group('gloo', init_method="
                f"'file://{tmp_path}/store', rank=0, world_size=1)\n"
                f"import contextlib\n"
                f"group = contextlib.nullcontext()")
        counts[fake] = _run(_CELL.format(arch=arch) + join + textwrap.dedent(f"""
            out = {{}}
            with group:
                mesh = make_local_mesh(1, 1, device="cpu")
                for kind in ("train", "prefill", "decode"):
                    shape = ShapeConfig(kind, 32, 4, kind)
                    rules = rules_for_arch(cfg, mesh, shape)
                    res = dr.count_cell(cfg, shape, mesh, rules, fake={fake})
                    out[kind] = {{"cost": res["cost"],
                                 "memory": res["memory"]}}
            if dist.is_initialized():
                dist.destroy_process_group()
            out["gone"] = groups_gone()
            print(json.dumps(out))
        """))
        assert counts[fake].pop("gone")
    for kind in ("train", "prefill", "decode"):
        f, r = counts[True][kind], counts[False][kind]
        assert f["cost"]["flops"] == r["cost"]["flops"] > 0, kind
        assert f["cost"]["bytes"] == pytest.approx(r["cost"]["bytes"],
                                                   rel=1e-3), kind
        assert f["memory"]["peak_bytes_per_device"] == pytest.approx(
            r["memory"]["peak_bytes_per_device"], rel=1e-3), kind
        assert f["memory"]["argument_bytes"] == \
            r["memory"]["argument_bytes"], kind


def test_depth_extrapolation_equals_the_full_depth_count():
    """A homogeneous 4-layer stack on a 2x2 fake mesh, train and decode:
    ``probe_costs`` (1 and 2 layers, extrapolated) equals the count of
    the whole stack."""
    res = _run(_CELL.format(arch="h2o-danube-3-4b") + textwrap.dedent("""
        out = {}
        with dr.fake_group(4):
            for kind in ("train", "decode"):
                shape = ShapeConfig(kind, 32, 4, kind)
                mesh = make_local_mesh(2, 2, device="cpu")
                deep = dataclasses.replace(cfg, n_layers=4)
                rules = rules_for_arch(deep, mesh, shape)
                full = dr.count_cell(deep, shape, mesh, rules)["cost"]
                probe = dr.probe_costs(deep, shape, mesh, rules, fsdp=True)
                out[kind] = [full, probe]
        out["gone"] = groups_gone()
        print(json.dumps(out))
    """))
    assert res.pop("gone")
    for kind, (full, probe) in res.items():
        assert probe["method"].endswith("(L1=1, L2=2, L=4)")
        assert probe["flops_per_device"] == full["flops"] > 0, kind
        assert probe["bytes_per_device"] == full["bytes"], kind
        assert probe["transcendentals"] == full["transcendentals"], kind
        assert probe["collective_bytes_per_device"] == full["coll_total"]
        assert probe["collective_per_op"] == pytest.approx(
            full["coll_per_op"]), kind


# --------------------------------------------------------------------------- #
# run_cell and the report
# --------------------------------------------------------------------------- #

FAMILIES = ["h2o-danube-3-4b", "minicpm3-4b", "mixtral-8x7b", "mamba2-130m",
            "zamba2-2.7b", "qwen2-vl-2b", "seamless-m4t-large-v2"]


def _tiny_cells(arch, out_dir, mesh, probe, micro):
    """``run_cell`` of ``arch``'s tiny config at three tiny
    shapes (train over 32 sequences in ``micro`` microbatches, prefill and
    decode of 16) and ``long_500k`` on ``mesh`` ("single", the 256-rank
    single-pod mesh, or "local", one rank), each cell's JSON written to
    ``out_dir`` as ``main`` writes it; the train cell's costs from the
    probe depths with ``probe``, the others' from the full-depth count
    (``test_depth_extrapolation_equals_the_full_depth_count`` holds the
    two equal)."""
    return _run(f"""
        import dataclasses, json
        from pathlib import Path
        from conftest import tiny_config
        from repro_torch.configs import SHAPES
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun as dr
        real = dr.get_config
        dr.get_config = lambda a: tiny_config(real(a))
        dr.SHAPES = {{"train_4k": ShapeConfig("train_4k", 32, 32, "train"),
                      "prefill_32k": ShapeConfig("prefill_32k", 32, 16,
                                                 "prefill"),
                      "decode_32k": ShapeConfig("decode_32k", 32, 16,
                                                "decode"),
                      "long_500k": SHAPES["long_500k"]}}
        out, gone = {{}}, []
        for name in dr.SHAPES:
            res = dr.run_cell({arch!r}, name, {mesh!r},
                              probe={probe} and name == "train_4k",
                              microbatches=({micro} if name == "train_4k"
                                            else None))
            gone.append(groups_gone())
            Path({str(out_dir)!r}, dr.cell_filename({arch!r}, name,
                 {mesh!r}, "baseline")).write_text(json.dumps(res))
            out[name] = res
        print(json.dumps({{"cells": out, "gone": gone}}))
    """, timeout=240)


# the families whose cells run on the 256-rank fake mesh; the others run
# on one rank ("local"), to keep the host time (their sharded steps are
# held by the gloo twins of test_torch_mesh_serving and
# test_torch_mesh_families)
ON_256 = ("h2o-danube-3-4b", "mixtral-8x7b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_of_each_family_and_the_report(arch, tmp_path, capsys):
    # the probes and the microbatches once (h2o), to keep the host time
    probe = arch == "h2o-danube-3-4b"
    mesh = "single" if arch in ON_256 else "local"
    ranks = {"single": 256, "local": 1}[mesh]
    res = _tiny_cells(arch, tmp_path, mesh, probe, micro=2 if probe else 1)
    assert all(res["gone"])
    cells = res["cells"]
    quadratic = not tiny_config(get_config(arch)).sub_quadratic
    for name, cell in cells.items():
        if name == "long_500k" and quadratic:
            assert cell["status"] == "skipped"
            continue
        assert cell["status"] == "ok", (name, cell)
        assert set(cell) == CELL_KEYS, set(cell) ^ CELL_KEYS
        assert set(cell["memory"]) == MEMORY_KEYS
        assert cell["n_chips"] == ranks
        assert cell["cost"]["method"].startswith(
            "eager depth-extrapolation" if probe and name == "train_4k"
            else "eager full depth")
        assert cell["cost"]["flops_per_device"] > 0
        assert cell["memory"]["peak_bytes_per_device"] >= \
            cell["memory"]["argument_bytes"] > 0
        assert cell["roofline"]["step_time_bound_s"] > 0
        assert 0 < cell["roofline_mfu_bound"]
        want_mf = cell["model_flops_global"] / ranks
        assert cell["model_flops_per_device"] == pytest.approx(want_mf)
    # the report: one row a cell, the reference's row where the cell fits
    # both cards' memory, and the summary lines
    report.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    for cell in cells.values():
        row = report.fmt_row(cell)
        assert row in text
        if cell["status"] == "ok":
            assert row == r_report.fmt_row(cell)
    n_ok = sum(c["status"] == "ok" for c in cells.values())
    assert (f"cells={len(cells)} ok={n_ok} "
            f"skipped={len(cells) - n_ok} fit_hbm={n_ok}/{n_ok}") in text
    assert "worst MFU-bound: " in text and "most collective-bound: " in text
