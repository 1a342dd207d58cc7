"""The distribution layer of the port against ``repro.distributed``.

- Rules and specs, in process, on ``MeshShape`` stand-ins (the
  reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so
  both packages are handed the same stand-in): the rules of every config
  x shape x mesh, the parameter specs over the port's named parameters
  (built on ``meta``) against the reference's ``axes_to_pspecs`` of
  ``jax.eval_shape(init)``, ZeRO-1/FSDP, cache and input specs.  A
  stacked reference leaf drops its ``"layers"`` entry; where ZeRO-1 or
  FSDP picks that ``L`` axis, the port shards the per-layer tensor's first
  divisible dim instead (pinned below).
- Multi-rank twins on 4 gloo ranks (``test_torch_mesh_workers``; spawned, a
  ``file://`` store each, 120 s a spawn): a sharded train step of each
  family on a 2x2 mesh against the port's single-device step (1e-5) and
  the reference's loss (1e-4), sharded checkpoints both ways, the
  compressed all-reduce against ``jax.vmap(compressed_psum)`` (bit for
  bit), GPipe stages, and the train launcher on a mesh.
- Single process: the compressors and the compressed train step, the
  production mesh on torch's fake process group, ``shard`` without a
  mesh.

Float32 twins patch ``DTYPE`` in both packages, as ``test_torch_train``
does; the step twins run AdamW at eps 1e-3 for the reason given there.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.encdec as r_encdec
import repro.models.model as r_model
import repro.models.transformer as r_tf
from conftest import make_batch, tiny_config
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.distributed import compression as r_comp
from repro.distributed import partitioning as r_part
from repro.distributed import sharding as r_shard
from repro.models import build_model as r_build
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro.runtime.checkpoint import Checkpointer as RefCheckpointer
from repro.runtime.steps import make_train_step as r_make_train_step

import repro_torch.models.common as p_common
import test_torch_mesh_workers as workers
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.distributed import compression as comp
from repro_torch.distributed import partitioning as part
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model
from repro_torch.models.convert import (load_reference_opt,
                                        load_reference_params)
from repro_torch.optim import AdamWConfig, adamw_init

MESHES = [dict(data=1, model=1), dict(data=2, model=2),
          dict(data=2, model=4), dict(data=1, model=8),
          dict(data=16, model=16), dict(pod=2, data=16, model=16)]
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def f32(monkeypatch):
    """Both packages at float32 activations."""
    for mod in (r_common, r_attn, r_tf, r_model, r_encdec):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


def _spec(p):
    """A reference PartitionSpec as the port's ``Spec`` tuple."""
    return tuple(p)


# --------------------------------------------------------------------------- #
# rules and specs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", list_configs())
def test_rules_equal_the_reference(arch):
    """Every shape (and none) x every mesh of ``MESHES``."""
    for sizes in MESHES:
        mesh = shd.MeshShape(**sizes)
        for shape in [None, *SHAPES]:
            got = shd.rules_for_arch(get_config(arch), mesh,
                                     SHAPES[shape] if shape else None)
            want = r_shard.rules_for_arch(
                r_get_config(arch), mesh, R_SHAPES[shape] if shape else None)
            assert got == want, (sizes, shape)
        for ep in (True, False):
            assert (shd.rules_for_arch(get_config(arch), mesh,
                                       expert_parallel=ep,
                                       sequence_parallel=True)
                    == r_shard.rules_for_arch(r_get_config(arch), mesh,
                                              expert_parallel=ep,
                                              sequence_parallel=True))


def _ref_leaves(tree):
    """{reference key path tuple: leaf} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _port_key(name: str):
    """(reference key path, stacked?) of a port parameter name."""
    parts = name.split(".")
    if parts[0] in ("layers", "shared", "enc_layers", "dec_layers"):
        return (parts[0],) + tuple(parts[2:]), True
    return tuple(parts), False


def _pinned_layers_axis(want, shape, data):
    """The port's spec where the reference's ZeRO-1/FSDP put "data" on the
    stacked ``L`` axis: the per-layer tensor's first divisible dim."""
    return shd._add_axis(tuple(want[1:]), shape, "data", data)


@pytest.mark.parametrize("arch", list_configs())
def test_param_and_state_specs_equal_the_reference(arch):
    """Parameter axes and specs, ZeRO-1 and FSDP specs, per mesh; every
    stacked leaf drops the reference's (unsharded) ``"layers"`` entry."""
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    model = build_model(cfg, device="meta")
    ref = r_build(r_cfg)
    holder = {}

    def _init(k):
        params, axes = ref.init(k)
        holder["axes"] = axes
        return params
    shapes = jax.eval_shape(_init, jax.random.key(0))
    ref_axes = jax.tree_util.tree_flatten_with_path(
        holder["axes"], is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))[0]
    ref_axes = {tuple(k.key for k in p): ax for p, ax in ref_axes}
    port_axes = model.param_logical_axes()
    assert len(port_axes) == sum(1 for _ in model.parameters())
    p_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    r_shapes = {k: tuple(v.shape) for k, v in _ref_leaves(shapes).items()}
    for name, ax in port_axes.items():
        key, stacked = _port_key(name)
        want = ref_axes[key]
        assert ax == (want[1:] if stacked else want), name
        assert p_shapes[name] == (r_shapes[key][1:] if stacked
                                  else r_shapes[key]), name
        if stacked:
            assert want[0] == "layers", name
    pinned = 0
    for sizes in MESHES[1:5]:
        mesh = shd.MeshShape(**sizes)
        rules = shd.rules_for_arch(cfg, mesh)
        ref_specs = ref.param_pspecs(rules)
        specs = model.param_pspecs(rules)
        z_ref = r_shard.zero1_state_specs(ref_specs, shapes, mesh)
        f_ref = _ref_leaves(r_shard.fsdp_param_specs(ref_specs, shapes,
                                                     mesh))
        z = shd.zero1_state_specs(specs, model, mesh)
        f = shd.fsdp_param_specs(specs, model, mesh)
        assert z["step"] == _spec(z_ref["step"]) == ()
        r_specs, z_mu = _ref_leaves(ref_specs), _ref_leaves(z_ref["mu"])
        assert _ref_leaves(z_ref["nu"]) == z_mu
        for name, spec in specs.items():
            key, stacked = _port_key(name)
            want = _spec(r_specs[key])
            assert spec == (want[1:] if stacked else want), (sizes, name)
            for got, ref_spec in ((z["mu"][name], _spec(z_mu[key])),
                                  (f[name], _spec(f_ref[key]))):
                if not stacked:
                    assert got == ref_spec, (sizes, name)
                elif ref_spec[0] == "data":       # the reference took L
                    pinned += 1
                    assert got == _pinned_layers_axis(
                        ref_spec, p_shapes[name], sizes["data"]), name
                else:
                    assert ref_spec[0] is None and got == ref_spec[1:], \
                        (sizes, name)
        assert z["nu"] == z["mu"]
    assert pinned or arch != "h2o-danube-3-4b"


def test_layers_axis_divergence_is_pinned():
    """The one difference: h2o's ``wq`` (24, 3840, 3840) under ZeRO-1 on a
    2x2 mesh gets ``('data', None, 'model')`` in the reference (L = 24
    divides data = 2); the port's per-layer (3840, 3840) tensor gets
    ``('data', 'model')``.  On 16x16 (24 % 16 != 0) the two agree."""
    cfg = get_config("h2o-danube-3-4b")
    model = build_model(cfg, device="meta")
    ref = r_build(r_get_config("h2o-danube-3-4b"))
    shapes = jax.eval_shape(lambda k: ref.init(k)[0], jax.random.key(0))
    for sizes, want_ref in ((dict(data=2, model=2), ("data", None, "model")),
                            (dict(data=16, model=16), (None, "data", "model"))):
        mesh = shd.MeshShape(**sizes)
        rules = shd.rules_for_arch(cfg, mesh)
        z_ref = r_shard.zero1_state_specs(ref.param_pspecs(rules), shapes,
                                          mesh)
        z = shd.zero1_state_specs(model.param_pspecs(rules), model, mesh)
        assert _spec(z_ref["mu"]["layers"]["attn"]["wq"]) == want_ref
        assert z["mu"]["layers.0.attn.wq"] == ("data", "model")


@pytest.mark.parametrize("arch", list_configs())
def test_cache_and_input_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    model, ref = build_model(cfg, device="meta"), r_build(r_get_config(arch))
    enc = 64 if cfg.family == "encdec" else None
    assert model.cache_logical_axes(2, 128, enc_len=enc) == \
        ref.cache_logical_axes(2, 128, enc_len=enc)
    for name, shape in SHAPES.items():
        axes = model.input_logical_axes(shape)
        assert axes == ref.input_logical_axes(R_SHAPES[name]), name
        for sizes in MESHES:
            mesh = shd.MeshShape(**sizes)
            rules = shd.rules_for_arch(cfg, mesh, shape)
            got = shd.input_pspecs(axes, rules)
            want = r_shard.input_pspecs(axes, rules)
            assert got == {k: _spec(v) for k, v in want.items()}
            assert shd.batch_axis_size(mesh, rules) == \
                r_shard.batch_axis_size(mesh, rules)


def test_rules_divisibility_adaptation():
    """The counterpart of ``tests/test_distributed.py:35``."""
    mesh = shd.MeshShape(data=2, model=4)
    r = shd.rules_for_arch(get_config("gemma2-27b"), mesh, SHAPES["train_4k"])
    assert r["heads"] == ("model",) and r["attn_seq"] is None
    r = shd.rules_for_arch(get_config("qwen2-vl-2b"), mesh, SHAPES["train_4k"])
    assert r["heads"] == ("model",)             # 12 % 4 == 0 on tp=4
    mesh8 = shd.MeshShape(data=1, model=8)
    r = shd.rules_for_arch(get_config("qwen2-vl-2b"), mesh8,
                           SHAPES["train_4k"])
    assert r["heads"] is None and r["attn_seq"] == ("model",)
    r = shd.rules_for_arch(get_config("phi3.5-moe-42b-a6.6b"), mesh8,
                           SHAPES["train_4k"])
    assert r["experts"] == ("model",)           # 16 % 8 == 0 -> EP
    r = shd.rules_for_arch(get_config("mixtral-8x7b"), mesh8,
                           SHAPES["train_4k"])
    assert r["experts"] == ("model",)           # 8 % 8 == 0 -> EP on tp=8


def test_tiny_batch_falls_back_to_context_parallel_decode():
    """The counterpart of ``tests/test_distributed.py:70``."""
    r = shd.rules_for_arch(get_config("h2o-danube-3-4b"),
                           shd.MeshShape(data=4, model=2), SHAPES["long_500k"])
    assert r["batch"] is None
    assert r["kv_len"] == ("data",)


def test_logical_to_spec_rules():
    """The counterpart of ``tests/test_distributed.py:258``, and the
    placements a spec gives on a mesh."""
    from torch.distributed.tensor import Replicate, Shard
    rules = {"batch": ("pod", "data"), "heads": ("model",), "seq": None}
    with part.use_rules(rules):
        spec = part.logical_to_spec(("batch", "seq", "heads"))
        assert spec == (("pod", "data"), None, "model")
        with r_part.use_rules(rules):
            assert spec == _spec(r_part.logical_to_spec(
                ("batch", "seq", "heads")))
    assert part.logical_to_spec(("batch",), None) == ()
    mesh = shd.MeshShape(pod=2, data=4, model=2)
    assert part.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert part.placements((None, "data"), shd.MeshShape(data=1, model=2)) \
        == [Replicate(), Replicate()]           # a size-1 axis shards nothing
    with pytest.raises(ValueError):
        part.placements(("data", "data"), mesh)


def test_shard_is_the_identity_without_rules_and_raises_on_plain_tensors():
    x = torch.ones(2, 3)
    assert part.get_rules() is None
    assert part.shard(x, "batch", "embed") is x
    with part.use_rules(part.DEFAULT_RULES):
        with pytest.raises(TypeError, match="not a DTensor"):
            part.shard(x, "batch", "embed")
    assert part.get_rules() is None


# --------------------------------------------------------------------------- #
# compression, single process
# --------------------------------------------------------------------------- #

def test_compressors_equal_the_reference():
    """Int8 (three error-feedback rounds) and top-k, bit for bit."""
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(0, 1, (512,)).astype(np.float32),
         "m": rng.normal(0, 3, (16, 24)).astype(np.float32)}
    for p_c, r_c in ((comp.Int8Compressor(), r_comp.Int8Compressor()),
                     (comp.TopKCompressor(frac=0.1),
                      r_comp.TopKCompressor(frac=0.1))):
        t = {k: torch.from_numpy(v) for k, v in g.items()}
        err, r_err = p_c.init(t), r_c.init({k: jnp.asarray(v)
                                             for k, v in g.items()})
        for _ in range(3):
            out, err = p_c.compress(t, err)
            r_out, r_err = r_c.compress({k: jnp.asarray(v)
                                         for k, v in g.items()}, r_err)
            for k in g:
                assert np.array_equal(out[k].numpy(), np.asarray(r_out[k]))
                assert np.array_equal(err[k].numpy(), np.asarray(r_err[k]))
        assert p_c.wire_bytes_ratio() == r_c.wire_bytes_ratio()


def test_compressed_train_step_equals_the_reference(f32):
    """Three Int8 error-feedback steps of tiny mamba2-130m (the
    reference's ``test_compressed_train_step_trains`` model), float32.
    Each step starts both packages from the reference's weights, AdamW
    state and error feedback, and holds the loss, the weights and the
    error feedback after it.  Int8 rounding is discontinuous: an entry
    whose ``(g + e) / scale`` lies within 1e-4 of a rounding boundary may
    round the other way on a last-ulp gradient difference (one quantum);
    such entries are found from the reference's gradients, counted, and
    excused, and nothing else may differ."""
    cfg = tiny_config(r_get_config("mamba2-130m"))
    p_cfg = tiny_config(get_config("mamba2-130m"))
    ref = r_build(cfg)
    params, _ = ref.init(jax.random.key(0))

    def named(tree):
        m = load_reference_params(build_model(p_cfg, device="cpu"),
                                  jax.tree.map(np.asarray, tree))
        return {k: p.detach() for k, p in m.named_parameters()}

    def near_boundary(g, e):
        v = g.astype(jnp.float32) + e
        q = v / (jnp.maximum(jnp.max(jnp.abs(v)), 1e-12) / 127.0)
        return (jnp.abs(jnp.abs(q - jnp.trunc(q)) - 0.5) < 1e-4).astype(
            jnp.float32)

    r_c = r_comp.Int8Compressor()
    r_step = jax.jit(r_comp.make_compressed_train_step(
        ref, RAdamWConfig(lr=3e-3, eps=1e-3), r_c))
    port = build_model(p_cfg, device="cpu")
    c = comp.Int8Compressor()
    step = comp.make_compressed_train_step(
        port, AdamWConfig(lr=3e-3, eps=1e-3), c)
    r_grad = jax.jit(jax.grad(ref.loss))
    r_opt, r_ef = r_adamw_init(params), r_c.init(params)
    excused = 0
    for i in range(3):
        batch = make_batch(cfg, batch=2, seq=16, seed=i)
        edge = named(jax.tree.map(near_boundary,
                                  r_grad(params, batch), r_ef))
        load_reference_params(port, jax.tree.map(np.asarray, params))
        opt = load_reference_opt(adamw_init(port),
                                 jax.tree.map(np.asarray, r_opt))
        ef = {k: v.clone() for k, v in named(r_ef).items()}
        m = step(opt, ef, {k: np.array(v) for k, v in batch.items()})
        params, r_opt, r_ef, r_m = r_step(params, r_opt, r_ef, batch)
        np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                                   rtol=1e-5)
        for got, want in ((dict(port.named_parameters()), named(params)),
                          (ef, named(r_ef))):
            for k, w in want.items():
                g, w = got[k].detach().numpy(), w.numpy()
                bad = ~np.isclose(g, w, **GRAD)
                assert not (bad & (edge[k].numpy() == 0)).any(), (i, k)
                excused += int(bad.sum())
    assert excused <= 8, excused


# --------------------------------------------------------------------------- #
# the production mesh on torch's fake process group
# --------------------------------------------------------------------------- #

def test_production_mesh_on_a_fake_process_group(tmp_path):
    """512 fake ranks: ``make_production_mesh(multi_pod=True)`` has shape
    {pod: 2, data: 16, model: 16}.  This pins torch's internal
    ``FakeStore``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"pod": 2, "data": 16, "model": 16}
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError):
            make_local_mesh(2, 2, device="cpu")
        # FSDP placement on a 16 x 32 mesh (no communication: each rank
        # keeps its chunk of the full weights)
        from repro_torch.launch.mesh import make_mesh_compat
        mesh = make_mesh_compat((16, 32), ("data", "model"), device="cpu")
        cfg = _h2o_tiny(get_config)
        model = build_model(cfg, device="cpu")
        rules = shd.rules_for_arch(cfg, mesh)
        want = shd.fsdp_param_specs(model.param_pspecs(rules), model, mesh)
        assert shd.place_model(model, mesh, rules, fsdp=True) == want
        assert model.mesh is mesh
        for name, p in model.named_parameters():
            assert list(p.placements) == part.placements(want[name], mesh)
        assert want["layers.0.attn.wq"] == ("data", None)   # 4 heads, tp 32
        # restore(..., shardings=): a host leaf comes back placed
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.runtime.checkpoint import Checkpointer
        w = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
        ck = Checkpointer(tmp_path)
        ck.save(0, {"w": w})
        got = ck.restore({"w": np.zeros_like(w)},
                         shardings={"w": (mesh, [Shard(0), Replicate()])})
        assert tuple(got["w"].shape) == (64, 3)
        assert np.array_equal(got["w"].to_local().numpy(), w[:4])  # rank 0
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# multi-rank twins on 4 gloo ranks
# --------------------------------------------------------------------------- #

def _h2o_tiny(get):
    """The reference's ``test_sharded_step_matches_single_device`` config."""
    return dataclasses.replace(get("h2o-danube-3-4b"), n_layers=2,
                               d_model=32, d_ff=64, vocab_size=256,
                               n_heads=4, n_kv_heads=2, head_dim=8, window=8)


def _case(arch, seed):
    if arch == "h2o-danube-3-4b":
        r_cfg, cfg = _h2o_tiny(r_get_config), _h2o_tiny(get_config)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, 200, (4, 16)).astype(np.int32),
                 "labels": rng.integers(0, 200, (4, 16)).astype(np.int32)}
    else:
        r_cfg = tiny_config(r_get_config(arch))
        cfg = tiny_config(get_config(arch))
        batch = {k: np.asarray(v, np.float32 if v.dtype != jnp.int32
                               else np.int32)
                 for k, v in make_batch(r_cfg, batch=4, seq=16,
                                        seed=seed).items()}
    ref = r_build(r_cfg)
    params, _ = ref.init(jax.random.key(seed))
    loss = float(jax.jit(ref.loss)(params, {k: jnp.asarray(v)
                                            for k, v in batch.items()}))
    return ({"cfg": cfg, "params": jax.tree.map(np.asarray, params),
             "batch": batch}, ref, params, loss)


def _step_twins(arch_cases, tmp_path, checkpoints=True):
    """Run ``workers.step_twins`` on 4 gloo ranks over ``arch_cases``
    ((case, reference loss) pairs, h2o first when it is given) and hold
    each family's mesh step against the single-device step (loss 1e-5,
    every updated leaf within 1e-5) and the reference's loss (1e-4).
    Returns rank 0's results."""
    out = workers.run_ranks(workers.step_twins, 4, tmp_path / "ranks",
                            [c for c, _ in arch_cases],
                            *((str(tmp_path / "ref_ckpt"),
                               str(tmp_path / "mesh_ckpt")) if checkpoints
                              else (None, None)))
    for (case, ref_loss) in arch_cases:
        name = case["cfg"].name
        got = out[0][name]
        assert all(o[name]["mesh"] == got["mesh"] for o in out[1:])
        assert got["placed"] > 0, name          # something was sharded
        np.testing.assert_allclose(got["mesh"], got["plain"], rtol=1e-5,
                                   err_msg=name)
        assert got["leaf"] <= 1e-5, (name, got["leaf"])
        np.testing.assert_allclose(got["mesh"], ref_loss, rtol=1e-4,
                                   err_msg=name)
    return out[0]


def test_sharded_h2o_step_and_checkpoints(f32, tmp_path):
    """h2o on a 2x2 mesh of gloo ranks (the reference's
    ``test_sharded_step_matches_single_device`` config): one step's loss
    and every updated leaf equal the port's single-device step (1e-5)
    and the loss the reference's (1e-4).  A checkpoint the reference
    wrote restores into the placed model, and the one its placed model
    writes after the step restores in the reference, equal to the
    reference's own step (1e-4)."""
    case, ref, params, loss = _case("h2o-danube-3-4b", 0)
    RefCheckpointer(tmp_path / "ref_ckpt").save(
        0, {"params": params, "opt": r_adamw_init(params)})
    got = _step_twins([(case, loss)], tmp_path)
    assert got[case["cfg"].name]["restored"] == 0.0

    r_step = jax.jit(r_make_train_step(ref, RAdamWConfig(lr=1e-3,
                                                         eps=1e-3)))
    r_params, r_opt, _ = r_step(params, r_adamw_init(params),
                                {k: jnp.asarray(v)
                                 for k, v in case["batch"].items()})
    back = RefCheckpointer(tmp_path / "mesh_ckpt").restore(
        {"params": params, "opt": r_adamw_init(params)})
    assert int(back["opt"]["step"]) == 1
    for got, want in zip(jax.tree.leaves(back["params"]),
                         jax.tree.leaves(r_params)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **GRAD)
    for got, want in zip(jax.tree.leaves(back["opt"]["mu"]),
                         jax.tree.leaves(r_opt["mu"])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **GRAD)


def test_compressed_psum_and_pipeline_on_gloo_ranks(tmp_path):
    """``compressed_psum`` over 4 ranks equals the reference's under
    ``jax.vmap(..., axis_name="data")`` bit for bit; ``pipeline_forward``
    over 4 stages and 4 microbatches equals the sequential stages
    (1e-5)."""
    from repro.distributed.pipeline import bubble_fraction as r_bubble
    from repro_torch.distributed.pipeline import bubble_fraction
    assert bubble_fraction(4, 12) == r_bubble(4, 12) == 3 / 15
    rng = np.random.default_rng(0)
    x_rows = rng.normal(0, 1, (4, 256)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda r: r_comp.compressed_psum(r, "data"),
                               axis_name="data")(jnp.asarray(x_rows)))
    ws = rng.normal(0, 0.5, (4, 16, 16)).astype(np.float32)
    x = rng.normal(0, 1, (8, 16)).astype(np.float32)
    seq = jnp.asarray(x)
    for s in range(4):
        seq = jnp.tanh(seq @ jnp.asarray(ws[s]))
    out = workers.run_ranks(workers.collectives, 4, tmp_path, x_rows, ws, x,
                            4)
    for r, (psum, piped) in enumerate(out):
        assert np.array_equal(psum, want[r]), r
        np.testing.assert_allclose(piped, np.asarray(seq), rtol=0, atol=1e-5)
