"""The port's plain ``fused_scan`` against the JAX package's oracle and its
Pallas kernel (interpret mode), on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The bar is exact equality of counts, rows scanned and the defined hit
prefix (every reference engine is exact); beyond the prefix the port and
the jnp oracle both hold -1, while the Pallas kernel leaves it unspecified.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.engine.device import _multi_arange
from repro.kernels import fused_range_scan as ref_fused_range_scan
from repro.kernels import ref as jref
from repro_torch.kernels import fused_range_scan, fused_scan
from repro_torch.kernels import ref as tref

N, D, B, TILE = 700, 3, 5, 256


def _inputs(seed=21):
    rng = np.random.default_rng(seed)
    rows_t = rng.normal(0, 10, (D, N)).astype(np.float32)
    lo = rng.uniform(-15, 0, (B, D)).astype(np.float32)
    hi = lo + rng.uniform(0, 20, (B, D)).astype(np.float32)
    alive = (rng.random(N) > 0.1).astype(np.int32)
    coords = rng.integers(0, 4, (2, N)).astype(np.int32)
    first = rng.integers(0, 2, (B, 2)).astype(np.int32)
    last = first + rng.integers(0, 3, (B, 2)).astype(np.int32)
    sv = rows_t[1]
    tband = np.stack([lo[:, 1], hi[:, 1]], axis=1)
    probe = {"coords": coords, "first": first, "last": last}
    sort = {"sv": sv, "tband": tband}
    stages = {"none": {}, "probe": probe, "sort": sort,
              "probe+sort": {**probe, **sort}}
    return rows_t, lo, hi, alive, stages


STAGES = ["none", "probe", "sort", "probe+sort"]


def _np(out):
    return tuple(np.asarray(x) for x in out)


def _assert_prefix_equal(port, want, cap, tail=True):
    c_p, h_p, s_p = port
    c_w, h_w, s_w = want
    assert np.array_equal(c_p, c_w)
    assert np.array_equal(s_p, s_w)
    take = np.minimum(c_w.reshape(-1), cap)
    for q in range(take.size):
        assert np.array_equal(h_p[q, :take[q]], h_w[q, :take[q]]), q
        if tail:
            assert (h_p[q, take[q]:] == -1).all(), q


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("cap", [64, 4])          # 4: hit_cap overflow
def test_plain_version_equals_jnp_oracle(stage, cap):
    rows_t, lo, hi, alive, stages = _inputs()
    st = stages[stage]
    port = _np(fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                hit_cap=cap, device="cpu"))
    want = _np(ref_fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                    hit_cap=cap, use_pallas=False))
    assert port[1].shape == want[1].shape == (B, cap + TILE)
    _assert_prefix_equal(port, want, cap)
    assert np.array_equal(port[1], want[1])     # -1 tails agree too


@pytest.mark.parametrize("stage", STAGES)
def test_plain_version_equals_pallas_interpret(stage):
    rows_t, lo, hi, alive, stages = _inputs(seed=22)
    st = stages[stage]
    cap = 64
    port = _np(fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                hit_cap=cap, device="cpu"))
    want = _np(ref_fused_range_scan(rows_t, lo, hi, alive, **st, tile=TILE,
                                    hit_cap=cap, use_pallas=True,
                                    interpret=True))
    _assert_prefix_equal(port, want, cap, tail=False)


def _gather_case(seed=33):
    """Cell-major layout plus per-query candidate-box row lists, as the
    device plane builds them (the reference test's construction)."""
    rng = np.random.default_rng(seed)
    n, d, b, k, c = 2_040, 3, 7, 2, 4
    cell = np.sort(rng.integers(0, c ** k, n))
    coords = np.stack([(cell // c ** (k - 1 - j)) % c for j in range(k)])
    coords = np.pad(coords, ((0, 0), (0, 1)),
                    constant_values=-1).astype(np.int32)
    offsets = np.searchsorted(cell, np.arange(c ** k + 1))
    rows_t = rng.normal(0, 10, (d, n)).astype(np.float32)
    rows_t = np.pad(rows_t, ((0, 0), (0, 1)), constant_values=np.inf)
    alive = np.append((rng.random(n) > 0.1), 0).astype(np.int32)[None]
    lo = rng.uniform(-15, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 25, (b, d)).astype(np.float32)
    first = rng.integers(0, c - 1, (b, k)).astype(np.int32)
    last = first + rng.integers(0, 2, (b, k)).astype(np.int32)
    radix = c ** (k - 1 - np.arange(k))
    lists = []
    for q in range(b):
        cells = (first[q][None, :] +
                 np.stack(np.meshgrid(*[np.arange(last[q, j] - first[q, j] + 1)
                                        for j in range(k)], indexing="ij"),
                          axis=-1).reshape(-1, k)) @ radix
        cells.sort()
        lists.append(_multi_arange(offsets[cells],
                                   offsets[cells + 1] - offsets[cells]))
    gw = 1 << int(max(max(l.size for l in lists), 1) - 1).bit_length()
    gidx = np.full((b, gw), n, np.int32)
    for q, lst in enumerate(lists):
        gidx[q, :lst.size] = lst
    sv = rows_t[1:2].copy()
    tband = np.stack([lo[:, 1], hi[:, 1]], axis=1)
    return [rows_t, lo.T.copy(), hi.T.copy(), alive, coords, first, last,
            sv, tband], gidx


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("route", ["full", "gidx"])
def test_plain_version_routes_equal_reference(sort, route):
    """Full-scan and candidate-gather routes of the port's plain version
    against the reference oracle's same route (and each other)."""
    args, gidx = _gather_case()
    if not sort:
        args = args[:7]
    kw = dict(tile=256, hit_cap=64)
    g = gidx if route == "gidx" else None
    port = _np(tref.fused_scan_ref(*(torch.from_numpy(a) for a in args),
                                   gidx=None if g is None
                                   else torch.from_numpy(g), **kw))
    want = _np(jref.fused_scan_ref(*args, gidx=g, **kw))
    assert np.array_equal(port[0], want[0])
    assert np.array_equal(port[1], want[1])
    assert np.array_equal(port[2], want[2])
    full = _np(tref.fused_scan_ref(*(torch.from_numpy(a) for a in args),
                                   **kw))
    assert np.array_equal(port[1], full[1])


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor takes the plain version and counts no kernel launch."""
    rows_t, lo, hi, alive, stages = _inputs()
    before = fused_scan.launches
    c, h, s = fused_range_scan(rows_t, lo, hi, alive, tile=TILE, hit_cap=64,
                               device="cpu")
    assert fused_scan.launches == before
    assert c.dtype == h.dtype == s.dtype == torch.int32
    assert c.device.type == "cpu"
