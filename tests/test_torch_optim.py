"""The port's AdamW (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU.

The same seeded numpy parameters and gradients go through both.  The bar
is rtol 1e-6 (a few float32 ulps: both compute the reference's
arithmetic in its order, and differ only where a compiler contracts a
multiply-add or divides by a reciprocal), with an absolute floor of 1e-9
for moments that cancel towards zero.  The port updates in place and
keeps its step counter and schedule on the host.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamWConfig as RefConfig
from repro.optim import adamw_init as r_init
from repro.optim import adamw_update as r_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import cosine_schedule as r_cosine
from repro.optim import global_norm as r_norm
from repro.optim import linear_warmup_cosine as r_warmup

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm, linear_warmup_cosine)

TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"embed": (33, 8), "layers.0.attn.wq": (8, 12),
          "layers.1.attn.wq": (8, 12), "final_norm": (8,)}


def _arrays(rng, scale=1.0):
    return {k: (rng.normal(0, scale, s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=f"{what}[{k}]", **TOL)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 30.0])     # clip off / on
def test_adamw_update_matches_reference(schedule, grad_scale):
    rng = np.random.default_rng(1)
    p0 = _arrays(rng, 0.5)
    cfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    r_sched = r_warmup(3e-3, 2, 6) if schedule else None
    p_sched = linear_warmup_cosine(3e-3, 2, 6) if schedule else None
    r_p, r_s = _jnp(p0), r_init(_jnp(p0))
    t_p = _torch(p0)
    t_s = adamw_init(t_p)
    ptrs = {k: v.data_ptr() for k, v in t_p.items()}
    for step in range(6):
        g = _arrays(rng, grad_scale)
        r_p, r_s, r_m = r_update(r_p, _jnp(g), r_s, RefConfig(**cfg), r_sched)
        t_m = adamw_update(t_p, _torch(g), t_s, AdamWConfig(**cfg), p_sched)
        _close(t_p, r_p, f"params after step {step}")
        _close(t_s["mu"], r_s["mu"], "mu")
        _close(t_s["nu"], r_s["nu"], "nu")
        assert t_s["step"] == int(r_s["step"]) == step + 1
        np.testing.assert_allclose(float(t_m["grad_norm"]),
                                   float(r_m["grad_norm"]), **TOL)
        np.testing.assert_allclose(t_m["lr"], float(r_m["lr"]), **TOL)
    assert {k: v.data_ptr() for k, v in t_p.items()} == ptrs    # in place


def test_update_leaves_the_gradients_as_they_were():
    rng = np.random.default_rng(2)
    params, grads = _torch(_arrays(rng)), _torch(_arrays(rng, 50.0))
    before = {k: v.clone() for k, v in grads.items()}
    adamw_update(params, grads, adamw_init(params), AdamWConfig())
    for k in grads:
        assert torch.equal(grads[k], before[k]), k


@pytest.mark.parametrize("scale", [0.01, 40.0])
def test_global_norm_and_clip_match_reference(scale):
    tree = _arrays(np.random.default_rng(3), scale)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(r_norm(_jnp(tree))), **TOL)
    got, gn = clip_by_global_norm(_torch(tree), 1.0)
    want, r_gn = r_clip(_jnp(tree), 1.0)
    np.testing.assert_allclose(float(gn), float(r_gn), **TOL)
    _close(got, want, "clipped")


@pytest.mark.parametrize("warmup,total,final", [(10, 100, 0.1), (0, 50, 0.0),
                                                (7, 7, 0.25)])
def test_schedules_match_reference(warmup, total, final):
    cos, r_cos = cosine_schedule(1e-3, total, final), r_cosine(1e-3, total,
                                                               final)
    warm = linear_warmup_cosine(1e-3, warmup, total, final)
    r_warm = r_warmup(1e-3, warmup, total, final)
    for step in range(total + 5):
        s = jnp.asarray(step, jnp.int32)
        for got, want in ((cos(step), r_cos(s)), (warm(step), r_warm(s))):
            assert isinstance(got, float)
            np.testing.assert_allclose(got, float(want), err_msg=str(step),
                                       **TOL)


# ----------------------- twins of the reference's tests ------------------ #

def test_adamw_minimises_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert state["step"] == 200


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    metrics = adamw_update(params, {"w": torch.full((3,), 1e6)}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def test_adamw_init_mirrors_a_module():
    layer = torch.nn.Linear(4, 3)
    state = adamw_init(layer)
    assert set(state["mu"]) == set(state["nu"]) == {"weight", "bias"}
    assert state["mu"]["weight"].dtype == torch.float32
    assert state["mu"]["weight"].shape == (3, 4) and state["step"] == 0
