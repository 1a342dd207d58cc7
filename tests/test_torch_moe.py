"""The port's MoE layer and MoE decoders (``repro_torch.models.moe``,
mixtral-8x7b and phi3.5-moe-42b-a6.6b) against the reference on the CPU.

The same seeded numpy inputs and weights (the reference's ``init``,
carried over by ``repro_torch.models.convert``) go through both
packages.  Bars, as in ``test_torch_models.py``: float32 activations
rtol 1e-5 / atol 1e-5 (``DTYPE`` patched in both packages), losses and
gradients rtol 1e-4 / atol 1e-5 (``test_torch_train.py``), bfloat16
rtol 0.05 / atol 0.08.

Which pairs an expert keeps is a discrete choice: a router logit that
rounds differently in the two packages can move a token to another
expert, and its output by far more than any bar.  So the float32 cases
hold every choice (ties included, built exactly), and the bfloat16
cases run only on inputs whose k-th and (k+1)-th router logits, the
test asserts, lie further apart than bfloat16 rounding moves them.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs
import repro.models.attention as r_attn
import repro.models.common as r_common
import repro.models.model as r_model
import repro.models.moe as r_moe
import repro.models.transformer as r_tf
from conftest import make_batch, tiny_config
from repro.models import build_model as r_build
from test_torch_train import _assert_trees

import repro_torch.models.common as p_common
import repro_torch.models.moe as p_moe
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params, reference_tree

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.08)
MOE = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
# the least gap between the k-th and (k+1)-th router logits of a bfloat16
# case: 8 bfloat16 ulps at 1.0; the two packages' bfloat16 logits of the
# tiny MoE decoders differ by about 1
MARGIN = 2.0 ** -5


@pytest.fixture
def f32(monkeypatch):
    """Both packages at float32 activations."""
    for mod in (r_common, r_attn, r_tf, r_model):
        monkeypatch.setattr(mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(p_common, "DTYPE", torch.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), err_msg=what, **tol)


# the reference's layer, jitted (eager, each of its ops compiles alone)
r_apply = jax.jit(r_moe.moe_apply,
                  static_argnames=("n_experts", "top_k", "capacity_factor"))


def _layer(seed=0, d=32, f=48, e=4):
    params, _ = r_moe.moe_init(jax.random.key(seed), d, f, e)
    return params, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dt="float32"):
    """numpy float32 ``a`` as (a jax array, a torch tensor) of ``dt``."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _x(seed, shape, dt="float32"):
    return _both(np.random.default_rng(seed).normal(0, 1, shape)
                 .astype(np.float32), dt)


def _dropped(gate_idx, e, cap):
    """Pairs of each row past their expert's capacity, from the expert ids
    (B, S, k) in the reference's pair order."""
    flat = np.asarray(gate_idx).reshape(gate_idx.shape[0], -1)
    return sum(int(np.maximum(np.bincount(row, minlength=e) - cap, 0).sum())
               for row in flat)


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 8.0])
def test_moe_apply_at_float32(cf):
    """Output and aux loss equal the reference's, with capacities that
    drop pairs (cf 0.5 and 1.0 here), the served factor (1.25) and one
    that drops none (8.0); the same pairs are dropped, or the outputs of
    their tokens would differ."""
    rp, pp = _layer()
    xj, xt = _x(1, (3, 20, 32))
    kw = dict(n_experts=4, top_k=2, capacity_factor=cf)
    out_r, aux_r = r_apply(rp, xj, **kw)
    out_p, aux_p = p_moe.moe_apply(pp, xt, **kw)
    assert out_p.dtype == torch.float32 and tuple(out_p.shape) == (3, 20, 32)
    _close(out_p, out_r, F32, "out")
    _close(aux_p, aux_r, F32, "aux")
    _, _, idx = p_moe.route(pp["router"], xt, 2)
    cap = p_moe.capacity(20, 2, cf, 4)
    dropped = _dropped(idx.numpy(), 4, cap)
    if cf != 1.25:
        assert (dropped > 0) == (cf < 8.0), (cf, dropped)
    if dropped:                  # a token that lost a pair gets less
        full, _ = p_moe.moe_apply(pp, xt, n_experts=4, top_k=2,
                                  capacity_factor=8.0)
        assert not torch.allclose(full, out_p)


def test_moe_apply_gradients_at_float32():
    """Gradients of a scalar of the output and the aux loss with respect
    to the input and every weight, capacity overflowing (cf 0.5)."""
    rp, pp = _layer(seed=2)
    xj, xt = _x(3, (2, 12, 32))
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5)
    w = np.random.default_rng(4).normal(0, 1, (2, 12, 32)).astype(np.float32)

    def r_fn(p, x):
        out, aux = r_moe.moe_apply(p, x, **kw)
        return jnp.sum(out * w) + aux
    r_gp, r_gx = jax.jit(jax.grad(r_fn, argnums=(0, 1)))(rp, xj)
    pp = {k: v.requires_grad_() for k, v in pp.items()}
    xt.requires_grad_()
    out, aux = p_moe.moe_apply(pp, xt, **kw)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    _close(xt.grad, r_gx, GRAD, "x")
    for k in rp:
        _close(pp[k].grad, r_gp[k], GRAD, k)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_router_tie_goes_to_the_lower_expert(dt):
    """Experts 1 and 3 have the same router column and every value is a
    short dyadic fraction, so every token's second and third logits tie
    exactly in both packages and both dtypes (every partial sum is
    exact): both take expert 1, as ``jax.lax.top_k`` does, and a
    capacity of 4 of the 8 tokens' pairs makes the choice visible in the
    output."""
    rng = np.random.default_rng(5)
    d, e = 32, 4
    v = rng.choice([-1.0, 1.0], d).astype(np.float32)
    router = np.stack([0.25 * v, 0.125 * v, -0.125 * v, 0.125 * v], axis=1)
    noise = rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0], (2, 8, d))
    xj, xt = _both((0.25 * (v + noise)).astype(np.float32), dt)
    rp, pp = _layer(seed=6, d=d, e=e)
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router))
    probs, _, idx = p_moe.route(pp["router"], xt, 2)
    r_probs = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", xj, rp["router"].astype(xj.dtype)).astype(jnp.float32))
    for pr in (probs.numpy(), np.asarray(r_probs)):
        assert np.array_equal(pr[..., 1], pr[..., 3])        # exact ties
        assert (pr[..., 0] > pr[..., 1]).all() and (pr[..., 1] > pr[..., 2]).all()
    assert (idx.numpy() == [0, 1]).all()
    assert np.array_equal(idx.numpy(), np.asarray(jax.lax.top_k(r_probs, 2)[1]))
    for cf in (1.0, 8.0):
        kw = dict(n_experts=e, top_k=2, capacity_factor=cf)
        out_r, aux_r = r_apply(rp, xj, **kw)
        out_p, aux_p = p_moe.moe_apply(pp, xt, **kw)
        _close(out_p, out_r, F32 if dt == "float32" else BF16, f"cf {cf}")
        _close(aux_p, aux_r, F32, f"aux, cf {cf}")


def test_aux_loss_of_a_uniform_router_is_one():
    """A zero router gives every expert the same probability: the top-2
    tie resolves to experts 0 and 1 for every token, f = (1/2, 1/2, 0,
    0), p = 1/E, so the Switch loss E * sum f p is 1 in both packages;
    the overflowing pairs of experts 0 and 1 are dropped alike."""
    rp, pp = _layer(seed=7)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    xj, xt = _x(8, (2, 10, 32))
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25)
    out_r, aux_r = r_apply(rp, xj, **kw)
    out_p, aux_p = p_moe.moe_apply(pp, xt, **kw)
    assert float(aux_p) == pytest.approx(1.0, abs=1e-6)
    _close(aux_p, aux_r, F32, "aux")
    _close(out_p, out_r, F32, "out")
    # capacity 7 of 10 pairs an expert: the last 3 tokens get nothing
    assert p_moe.capacity(10, 2, 1.25, 4) == 7
    assert not out_p[:, 7:].any() and out_p[:, :7].abs().amax() > 0


def test_moe_apply_at_bfloat16_with_clear_margins():
    """The served dtype: router logits in bfloat16, on inputs whose top-2
    margins exceed ``MARGIN``; output within the bfloat16 bar, aux within
    float32's, capacity overflowing and not."""
    rp, pp = _layer(seed=9)
    xj, xt = _x(13, (2, 16, 32), "bfloat16")
    top = torch.sort((xt @ pp["router"].to(xt.dtype)).float(), dim=-1,
                     descending=True).values
    assert float((top[..., 1] - top[..., 2]).min()) > MARGIN
    for cf in (0.5, 8.0):
        kw = dict(n_experts=4, top_k=2, capacity_factor=cf)
        out_r, aux_r = r_apply(rp, xj, **kw)
        out_p, aux_p = p_moe.moe_apply(pp, xt, **kw)
        assert out_p.dtype == torch.bfloat16
        _close(out_p, out_r, BF16, f"cf {cf}")
        _close(aux_p, aux_r, F32, f"aux, cf {cf}")


# --------------------------------------------------------------------------- #
# the MoE decoders
# --------------------------------------------------------------------------- #

def _twins(arch, seed=0, **over):
    """(cfg, reference model, its params, the port's model) of the tiny
    ``arch`` with the reference's seeded weights in both."""
    cfg = dataclasses.replace(tiny_config(r_configs.get_config(arch)),
                              **over)
    ref = r_build(cfg)
    params = jax.jit(lambda key: ref.init(key)[0])(jax.random.key(seed))
    port = build_model(cfg, device="cpu")
    load_reference_params(port, jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


@contextlib.contextmanager
def _router_gaps():
    """Record, for every ``route`` call of the port, the least gap between
    the k-th and (k+1)-th router logits of any token."""
    gaps, route = [], p_moe.route

    def recording(router, x, top_k):
        top = torch.sort((x @ router.to(x.dtype)).float(), dim=-1,
                         descending=True).values
        gaps.append(float((top[..., top_k - 1] - top[..., top_k]).min()))
        return route(router, x, top_k)
    p_moe.route = recording
    try:
        yield gaps
    finally:
        p_moe.route = route


def _run(arch, seed, *, b=2, s=12, fwd=16, steps=12, cf=None):
    """Both packages over one token stream of ``b`` rows (capacity as the
    tiny config says, or ``cf``): the forward over ``fwd`` tokens, a
    prefill of ``s`` into a cache of 32 and ``steps`` decode steps.
    Returns (the port's outputs, the reference's, the router gaps the
    port met); the reference's calls are jitted (traced after any
    ``DTYPE`` patch)."""
    cfg, ref, params, port = _twins(arch, seed, **(
        {} if cf is None else dict(capacity_factor=cf)))
    toks = np.random.default_rng(seed + 11).integers(
        0, 200, (b, s + steps)).astype(np.int32)
    got, want = {}, {}
    with _router_gaps() as gaps:
        with torch.no_grad():
            got["forward"], got["aux"] = port.forward(
                {"tokens": torch.from_numpy(toks[:, :fwd])})
        got["prefill"], cache_p = port.prefill(
            {"tokens": torch.from_numpy(toks[:, :s])}, 32)
        for step in range(s, s + steps):
            got[step], cache_p = port.decode_step(
                cache_p, torch.from_numpy(toks[:, step:step + 1]), step)
    want["forward"], want["aux"] = jax.jit(lambda p, t: ref.forward(
        p, {"tokens": t}))(params, jnp.asarray(toks[:, :fwd]))
    want["prefill"], cache_r = jax.jit(lambda p, t: ref.prefill(
        p, {"tokens": t}, 32))(params, jnp.asarray(toks[:, :s]))
    decode = jax.jit(lambda p, c, t, i: ref.decode_step(p, c, t, i))
    for step in range(s, s + steps):
        want[step], cache_r = decode(params, cache_r,
                                     jnp.asarray(toks[:, step:step + 1]),
                                     jnp.int32(step))
    got["cache"], want["cache"] = cache_p, cache_r
    return got, want, gaps


def _hold(got, want, tol):
    for k in want:
        if k == "cache":
            assert sorted(got[k]) == sorted(want[k])
            for name in want[k]:
                _close(got[k][name], want[k][name], tol, name)
        else:
            _close(got[k], want[k], tol, str(k))


@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drop", "cf0.5"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_model_forward_prefill_decode_at_float32(f32, arch, cf):
    """Forward (logits and the layers' summed aux loss), prefill with its
    caches and 12 decode steps equal the reference's at float32, at the
    tiny config's capacity (cf 8, nothing dropped) and at cf 0.5, where
    forward, prefill and every decode step drop pairs."""
    got, want, _ = _run(arch, 0, cf=cf)
    assert float(got["aux"]) > 0
    _hold(got, want, F32)


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_forward_prefill_decode_at_bfloat16(arch):
    """The served dtype, on a short stream (one row: a forward over 8
    tokens, a prefill of 6, 2 decode steps) whose every routing choice
    has a top-2 margin above ``MARGIN``."""
    got, want, gaps = _run(arch, 3, b=1, s=6, fwd=8, steps=2)
    assert len(gaps) == 2 * 4 and min(gaps) > MARGIN, gaps
    _hold(got, want, BF16)


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_every_gradient(f32, arch):
    """``Model.loss`` (CE + 0.01 x aux) and the gradient of every
    parameter, the routers and the experts' stacks included, with a
    capacity that drops pairs (cf 0.5)."""
    cfg, ref, params, port = _twins(arch, 2, capacity_factor=0.5)
    batch = {k: np.array(v) for k, v in
             make_batch(cfg, batch=2, seq=16, seed=3).items()}
    r_val, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    val = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(r_val), **GRAD)
    _assert_trees(reference_tree({n: p.grad for n, p in
                                  port.named_parameters()}),
                  r_grads, GRAD, "grad")
    assert np.abs(np.asarray(r_grads["layers"]["moe"]["router"])).max() > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_config_and_active_params_at_full_size(arch):
    """At full size on ``meta``: the reference's parameter count, the MoE
    leaves' shapes, and ``active_param_count``'s top-k share."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    ref = r_build(r_configs.get_config(arch))
    assert model.param_count() == ref.param_count()
    assert model.active_param_count() == ref.active_param_count()
    moe = model.layers[0].moe
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(moe["router"].shape) == (d, e)
    assert tuple(moe["w_in"].shape) == tuple(moe["w_gate"].shape) == (e, d, f)
    assert tuple(moe["w_out"].shape) == (e, f, d)
    assert not hasattr(model.layers[0], "mlp")
    if arch == "mixtral-8x7b":
        assert model.param_count() == 46_571_720_704


def test_cast_params_casts_the_experts_and_keeps_the_cast_on_use():
    """Cast once to bfloat16, an MoE model computes bit for bit what its
    float32 masters compute cast on use; the routers and expert stacks
    (2-D and 3-D) are cast, the norm scales stay float32."""
    cfg, _, _, port = _twins("mixtral-8x7b")
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, 200, (2, 8)))
    with torch.no_grad():
        want, aux_want = port.forward({"tokens": toks})
        p_common.cast_params(port)
        for name, p in port.named_parameters():
            assert p.dtype == (torch.float32 if p.ndim == 1
                               else torch.bfloat16), name
        got, aux_got = port.forward({"tokens": toks})
    assert torch.equal(got, want) and torch.equal(aux_got, aux_want)


@pytest.mark.parametrize("arch", MOE)
def test_moe_launchers_train_then_serve(tmp_path, capsys, arch):
    """``--arch`` of each MoE config through both launchers at their
    reduced size (2 layers, width 64, every expert kept): trained to 4
    with a checkpoint every 2 (the loss carries the aux term), then
    served from that checkpoint; every served parameter, the expert
    stacks included, is the checkpoint's, cast."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch
    from repro_torch.runtime.checkpoint import latest_step
    ck = tmp_path / "ck"
    small = ["--arch", arch, "--reduced-layers", "2", "--reduced-width",
             "64", "--device", "cpu"]
    out = launch.main(small + ["--batch", "2", "--seq", "32", "--steps", "4",
                               "--ckpt-every", "2", "--ckpt-dir", str(ck)])
    assert out["final_step"] == 4 and latest_step(ck) == 4
    srv = serve.main(small + ["--ckpt-dir", str(ck), "--requests", "6",
                              "--max-new", "5"])
    assert "restored step 4" in capsys.readouterr().out
    with np.load(ck / "step_00000004" / "arrays.npz") as z:
        for name, p in srv.model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                want = z["//".join(["params", "layers"] + parts[2:])][
                    int(parts[1])]
            else:
                want = z["//".join(["params"] + parts)]
            assert torch.equal(p, torch.from_numpy(want).to(p.dtype)), name
    assert srv.waves >= 1
    assert srv.model.layers[0].moe["w_in"].shape[0] == r_configs.get_config(
        arch).n_experts
