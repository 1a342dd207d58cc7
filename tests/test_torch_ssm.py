"""The port's Mamba2 block (``repro_torch.models.ssm``) against the
reference (``repro.models.ssm``) on the CPU.

The same seeded numpy inputs and weights (the reference's
``mamba2_init``) go through both packages.  Bars:

- **float32**: rtol 1e-4 / atol 1e-5.  The SSD chains ``exp(cumsum)``
  decays, and its three-operand contractions run in another order in
  torch (two products, where XLA picks its own), so the float32 sums
  differ a little more than the dense decoder's 1e-5;
- **bfloat16** activations (the projections and the conv; the SSD and
  the gated norm stay float32 in both): rtol 0.05 / atol 0.08.

The duality is held inside the port too: the single-token recurrence
stepped over a sequence gives the chunked SSD's outputs and final state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.ssm as r_ssm

import repro_torch.models.ssm as p_ssm

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.08)
D_MODEL, HEAD_P, STATE = 32, 8, 8          # H = 2 * 32 / 8 = 8 heads
KW = dict(d_model=D_MODEL, expand=2, head_p=HEAD_P, state=STATE)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               err_msg=what, **tol)


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.5, (h,))).astype(np.float32)
    B = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    D = rng.normal(1, 0.2, (h,)).astype(np.float32)
    return x, dt, A, B, C, D


def _params(seed=0, *, perturb=False):
    """The reference's ``mamba2_init`` (numpy) and the port's copy; with
    ``perturb`` the constant leaves (``dt_bias``, ``D``, ``norm``) move off
    their init so that they enter the numbers."""
    params, _ = r_ssm.mamba2_init(jax.random.key(seed), D_MODEL,
                                  expand=2, head_p=HEAD_P, state=STATE)
    params = {k: np.asarray(v) for k, v in params.items()}
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for k in ("dt_bias", "D", "norm"):
            params[k] = (params[k] + rng.normal(0, 0.3, params[k].shape)
                         ).astype(np.float32)
    return params, {k: torch.from_numpy(v.copy()) for k, v in params.items()}


# --------------------------------------------------------------------------- #
# the chunked SSD
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("s,chunk", [(16, 4), (24, 8), (32, 32), (40, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    rng = np.random.default_rng(s * 10 + chunk)
    b, h, p, n = 2, 3, 4, 5
    args = _ssd_inputs(rng, b, s, h, p, n)
    h0 = (rng.normal(0, 1, (b, h, p, n)).astype(np.float32)
          if with_state else None)
    y_r, fin_r = r_ssm.ssd_chunked(
        *map(jnp.asarray, args), chunk=chunk,
        init_state=None if h0 is None else jnp.asarray(h0))
    y_p, fin_p = p_ssm.ssd_chunked(
        *map(torch.from_numpy, args), chunk=chunk,
        init_state=None if h0 is None else torch.from_numpy(h0))
    assert y_p.shape == (b, s, h, p) and fin_p.shape == (b, h, p, n)
    _close(y_p, y_r, F32, "y")
    _close(fin_p, fin_r, F32, "final state")


def test_ssd_chunked_refuses_a_ragged_chunk():
    rng = np.random.default_rng(1)
    args = _ssd_inputs(rng, 1, 12, 2, 2, 2)
    with pytest.raises(AssertionError):
        r_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        p_ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=8)


def test_ssd_recurrence_equals_the_chunked_form():
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t + D x_t
    stepped token by token (float64) gives the chunked form's y and final
    state."""
    rng = np.random.default_rng(2)
    b, s, h, p, n = 2, 24, 3, 4, 5
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s, h, p, n)
    h0 = rng.normal(0, 1, (b, h, p, n))
    state, ys = h0.copy(), []
    for t in range(s):
        dA = np.exp(dt[:, t] * A)                               # (b, h)
        xdt = x[:, t] * dt[:, t, :, None]                       # (b, h, p)
        state = state * dA[..., None, None] + xdt[..., None] * B[:, t, None, None]
        ys.append(np.einsum("bhpn,bn->bhp", state, C[:, t])
                  + x[:, t] * D[:, None])
    y, fin = p_ssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, A, B, C, D)), chunk=8,
        init_state=torch.from_numpy(h0.astype(np.float32)))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), **F32)
    np.testing.assert_allclose(fin.numpy(), state, **F32)


def test_ssd_gradients_are_finite_and_match_reference():
    """Masking before the ``exp`` keeps the backward pass free of
    ``0 * inf``: every input's gradient is finite and equals jax.grad's."""
    rng = np.random.default_rng(3)
    args = _ssd_inputs(rng, 2, 16, 2, 3, 4)
    w = rng.normal(0, 1, (2, 16, 2, 3)).astype(np.float32)

    def r_loss(*a):
        y, fin = r_ssm.ssd_chunked(*a, chunk=4)
        return jnp.sum(y * w) + jnp.sum(fin)
    r_grads = jax.grad(r_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, fin = p_ssm.ssd_chunked(*ts, chunk=4)
    ((y * torch.from_numpy(w)).sum() + fin.sum()).backward()
    for name, t, g in zip("x dt A B C D".split(), ts, r_grads):
        assert bool(torch.isfinite(t.grad).all()), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------------- #

@pytest.fixture(params=["f32", "bf16"])
def dtype(request):
    if request.param == "f32":
        return jnp.float32, torch.float32, F32
    return jnp.bfloat16, torch.bfloat16, BF16


def _hidden(rng, shape, jdt, tdt):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 256)])
def test_mamba2_forward_and_its_state(dtype, s, chunk):
    """The block from zero state, then continued from the returned conv
    tails and SSD state: outputs, tails and states equal."""
    jdt, tdt, tol = dtype
    rp, pp = _params(perturb=True)
    rng = np.random.default_rng(4)
    hj, ht = _hidden(rng, (2, s, D_MODEL), jdt, tdt)
    out_r, (conv_r, st_r) = r_ssm.mamba2_forward(
        rp, hj, chunk=chunk, return_state=True, **KW)
    out_p, (conv_p, st_p) = p_ssm.mamba2_forward(
        pp, ht, chunk=chunk, return_state=True, **KW)
    assert out_p.dtype == tdt and st_p.dtype == torch.float32
    _close(out_p, out_r, tol, "out")
    for k in ("x", "b", "c"):
        assert conv_p[k].dtype == tdt and tuple(conv_p[k].shape) == conv_r[k].shape
        _close(conv_p[k], conv_r[k], tol, f"conv {k}")
    _close(st_p, st_r, tol, "state")

    hj, ht = _hidden(rng, (2, 8, D_MODEL), jdt, tdt)
    out_r2 = r_ssm.mamba2_forward(rp, hj, chunk=4, conv_state=conv_r,
                                  ssm_state=st_r, **KW)
    out_p2 = p_ssm.mamba2_forward(pp, ht, chunk=4, conv_state=conv_p,
                                  ssm_state=st_p, **KW)
    _close(out_p2, out_r2, tol, "continued")


def test_mamba2_decode_steps(dtype):
    """Ten single-token steps from a prefilled state: outputs, conv tails
    and state equal after every step, the port's written in place."""
    jdt, tdt, tol = dtype
    rp, pp = _params(seed=1, perturb=True)
    rng = np.random.default_rng(5)
    hj, ht = _hidden(rng, (2, 8, D_MODEL), jdt, tdt)
    _, (conv_r, st_r) = r_ssm.mamba2_forward(rp, hj, chunk=8,
                                             return_state=True, **KW)
    _, (conv_p, st_p) = p_ssm.mamba2_forward(pp, ht, chunk=8,
                                             return_state=True, **KW)
    conv_p = {k: v.clone() for k, v in conv_p.items()}
    for step in range(10):
        hj, ht = _hidden(rng, (2, 1, D_MODEL), jdt, tdt)
        out_r, conv_r, st_r = r_ssm.mamba2_decode(rp, hj, conv_r, st_r, **KW)
        tails = dict(conv_p)
        out_p, conv_p2, st_p2 = p_ssm.mamba2_decode(pp, ht, conv_p, st_p, **KW)
        assert st_p2 is st_p and all(conv_p2[k] is tails[k] for k in tails)
        assert out_p.shape == (2, 1, D_MODEL) and out_p.dtype == tdt
        _close(out_p, out_r, tol, f"out, step {step}")
        for k in ("x", "b", "c"):
            _close(conv_p[k], conv_r[k], tol, f"conv {k}, step {step}")
        _close(st_p, st_r, tol, f"state, step {step}")


def test_decode_recurrence_equals_the_chunked_block():
    """The port's block stepped token by token from zero state gives its
    own full-sequence forward (conv tails, SSD duality, gated norm)."""
    _, pp = _params(seed=2, perturb=True)
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.normal(0, 1, (2, 16, D_MODEL)).astype(np.float32))
    with torch.no_grad():
        full, (conv, state) = p_ssm.mamba2_forward(pp, h, chunk=4,
                                                   return_state=True, **KW)
        tails = {k: torch.zeros_like(v) for k, v in conv.items()}
        st = torch.zeros_like(state)
        outs = [p_ssm.mamba2_decode(pp, h[:, t:t + 1], tails, st, **KW)[0]
                for t in range(16)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **F32)
    for k in tails:
        np.testing.assert_allclose(tails[k].numpy(), conv[k].numpy(), **F32)
    np.testing.assert_allclose(st.numpy(), state.numpy(), **F32)


def test_mamba2_init_shapes_and_constants():
    """The port's init has the reference's names, shapes and dtype, and the
    reference's constant leaves; ``generator=None`` only allocates."""
    want, _ = r_ssm.mamba2_init(jax.random.key(0), D_MODEL, expand=2,
                                head_p=HEAD_P, state=STATE)
    got = p_ssm.mamba2_init(torch.Generator().manual_seed(0), D_MODEL,
                            expand=2, head_p=HEAD_P, state=STATE)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32, k
    for k in ("A_log", "dt_bias", "D", "norm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    bound = 2.0 / np.sqrt(D_MODEL)
    assert float(got["w_z"].abs().max()) <= bound * (1 + 1e-6)
    empty = p_ssm.mamba2_init(None, D_MODEL, expand=2, head_p=HEAD_P,
                              state=STATE, device="meta")
    assert all(t.is_meta for t in empty.values())
