"""The port's ``repro_torch.kernels`` entry points against the JAX package's
``repro.kernels`` on the CPU: ``range_scan_query``,
``range_scan_batch_query``, ``bucket_histogram`` and ``split_by_margin``.

Inputs are made with numpy from fixed seeds and handed to both packages.
Each port wrapper runs with ``device="cpu"`` (its plain version) and is held
against the reference's Pallas kernel in interpret mode (``pallas``) and
its jnp oracle (``jnp``).  The bar is exact equality of masks, counts and
histograms, and bitwise equality of ``disp``.

One reference defect shows here (ROADMAP queue 3): under XLA on the CPU,
the reference's interpret-mode ``margin_split`` contracts ``m * x + b``
into one fused multiply-add, while its oracle (``ref.margin_split_ref``)
rounds the product and the sum apart.  The port rounds apart, as the
oracle's contract says, so against the Pallas route ``disp`` differs in
the last place on exactly the rows where the two roundings differ; the
test names those rows and holds every other row bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import LinearModel as RefLinearModel
from repro.kernels import ops as jops
from repro_torch.core import LinearModel
from repro_torch.kernels import (bucket_histogram, grid_histogram,
                                 margin_split, range_scan, range_scan_batch,
                                 range_scan_batch_query, range_scan_query,
                                 ref, split_by_margin)
from repro_torch.kernels.grid_histogram import kept_prefix

ROUTES = {"pallas": dict(use_pallas=True, interpret=True),
          "jnp": dict(use_pallas=False)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---- range_scan_query -------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [512, 1024, 4096])
@pytest.mark.parametrize("d", [2, 5, 8])
@pytest.mark.parametrize("tile", [256, 512])
def test_range_scan_query_twin(route, n, d, tile):
    """The sweep of the reference's ``test_range_scan_shapes``."""
    rng = np.random.default_rng(n + d)
    rows = rng.normal(0, 5, (d, n)).astype(np.float32)
    lo = np.full(d, -3, np.float32)
    hi = np.full(d, 3, np.float32)
    win = np.array([n // 8, n - n // 8], np.int32)
    c_p, m_p = range_scan_query(rows, lo, hi, win, tile=tile, device="cpu")
    c_r, m_r = jops.range_scan_query(rows, lo, hi, win, tile=tile,
                                     **ROUTES[route])
    assert c_p.dtype == m_p.dtype == torch.int32 and c_p.shape == ()
    assert np.array_equal(_np(m_p), _np(m_r))
    assert int(c_p) == int(c_r) == int(_np(m_p).sum())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_range_scan_query_ragged_twin(route, seed):
    """Seeded draws of the reference's property test: ragged N (padded with
    +inf rows), random rects, default window — plus brute force."""
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(10, 2_000)), int(rng.integers(1, 7))
    rows = rng.normal(0, 2, (d, n)).astype(np.float32)
    lo = rng.normal(-2, 1, d).astype(np.float32)
    hi = lo + rng.uniform(0.5, 4, d).astype(np.float32)
    c_p, m_p = range_scan_query(rows, lo, hi, device="cpu")
    c_r, m_r = jops.range_scan_query(rows, lo, hi, **ROUTES[route])
    assert np.array_equal(_np(m_p), _np(m_r))
    assert int(c_p) == int(c_r)
    want = ((rows >= lo[:, None]) & (rows < hi[:, None])).all(axis=0)
    assert np.array_equal(_np(m_p).astype(bool), want)


# ---- range_scan_batch_query -------------------------------------------------

def _batch_case(seed=0, d=4, n=700, b=5):
    rng = np.random.default_rng(seed)
    rows = rng.normal(0, 5, (d, n)).astype(np.float32)
    lo = rng.uniform(-6, 0, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 8, (b, d)).astype(np.float32)
    wins = np.stack([rng.integers(0, n // 2, b),
                     rng.integers(n // 2, n, b)], 1).astype(np.int32)
    return rows, lo, hi, wins


@pytest.mark.parametrize("route", ROUTES)
def test_batch_query_matches_single_and_reference(route):
    """Twin of the reference's ``test_batch_kernel_matches_single_and_oracle``:
    the batch entry equals the reference's, and each of its rows equals the
    one-rect entry on the same window."""
    rows, lo, hi, wins = _batch_case()
    c_p, m_p = range_scan_batch_query(rows, lo, hi, wins, device="cpu")
    c_r, m_r = jops.range_scan_batch_query(rows, lo, hi, wins,
                                           **ROUTES[route])
    assert c_p.dtype == m_p.dtype == torch.int32
    assert m_p.shape == (5, 700)
    assert np.array_equal(_np(m_p), _np(m_r))
    assert np.array_equal(_np(c_p), _np(c_r))
    for i in range(lo.shape[0]):
        c1, m1 = range_scan_query(rows, lo[i], hi[i], wins[i], device="cpu")
        assert int(c1) == int(c_p[i])
        assert np.array_equal(_np(m1), _np(m_p[i])), i


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("d,n,b,tile", [(2, 1024, 3, 256), (8, 1_500, 9, 512),
                                        (5, 4096, 4, 512)])
def test_batch_query_default_windows_twin(route, d, n, b, tile):
    rows, lo, hi, _ = _batch_case(seed=d + n, d=d, n=n, b=b)
    c_p, m_p = range_scan_batch_query(rows, lo, hi, tile=tile, device="cpu")
    c_r, m_r = jops.range_scan_batch_query(rows, lo, hi, tile=tile,
                                           **ROUTES[route])
    assert np.array_equal(_np(m_p), _np(m_r))
    assert np.array_equal(_np(c_p), _np(c_r))


# ---- bucket_histogram -------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("buckets", [16, 64, 128])
@pytest.mark.parametrize("n", [999, 4096])
def test_bucket_histogram_twin(route, buckets, n):
    """The sweep of the reference's ``test_grid_histogram_matches_ref``."""
    rng = np.random.default_rng(buckets + n)
    x = rng.normal(0, 3, n).astype(np.float32)
    d = rng.gamma(2.0, 2.0, n).astype(np.float32)
    h_p = bucket_histogram(x, d, buckets=buckets, device="cpu")
    h_r = jops.bucket_histogram(x, d, buckets=buckets, **ROUTES[route])
    assert h_p.dtype == torch.float32 and h_p.shape == (buckets, buckets)
    assert np.array_equal(_np(h_p), _np(h_r))
    assert float(h_p.sum()) == n


def test_bucket_histogram_agrees_with_numpy_bincount():
    """Twin of the reference's test of the same name."""
    rng = np.random.default_rng(7)
    n, b = 2_048, 32
    x = rng.uniform(0, 1, n).astype(np.float32)
    d = rng.uniform(0, 1, n).astype(np.float32)
    h = _np(bucket_histogram(x, d, buckets=b, device="cpu"))
    wx = (x.max() - x.min()) / b
    wd = (d.max() - d.min()) / b
    ix = np.clip(((x - x.min()) / wx).astype(int), 0, b - 1)
    jd = np.clip(((d - d.min()) / wd).astype(int), 0, b - 1)
    want = np.bincount(ix * b + jd, minlength=b * b).reshape(b, b)
    assert np.array_equal(h, want)


# ---- split_by_margin --------------------------------------------------------

def _margin_case(seed):
    """One seeded draw of the reference's ``test_margin_split_property``."""
    rng = np.random.default_rng(1_000 + seed)
    n = int(rng.integers(8, 5_000))
    m, b = float(rng.uniform(-4, 4)), float(rng.uniform(-50, 50))
    eps = float(rng.uniform(0.01, 10))
    x = rng.uniform(-100, 100, n).astype(np.float32)
    d = (m * x + b + rng.normal(0, eps, n)).astype(np.float32)
    return x, d, m, b, eps


def _rounded_apart(x, m, b):
    """Rows where ``m * x + b`` fused (one rounding) and unfused (two)
    differ in float32.  The f64 product of two f32 values is exact."""
    m32, b32 = np.float32(m), np.float32(b)
    unfused = m32 * x + b32
    fused = (np.float64(m32) * x.astype(np.float64)
             + np.float64(b32)).astype(np.float32)
    return _bits(unfused) != _bits(fused)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(5))
def test_split_by_margin_twin(route, seed):
    x, d, m, b, eps = _margin_case(seed)
    disp_p, in_p = split_by_margin(x, d, m, b, eps, eps, device="cpu")
    disp_r, in_r = jops.split_by_margin(x, d, m, b, eps, eps, **ROUTES[route])
    assert disp_p.dtype == torch.float32 and in_p.dtype == torch.bool
    disp_p, in_p, disp_r, in_r = (_np(disp_p), _np(in_p), _np(disp_r),
                                  np.asarray(in_r))
    if route == "jnp":
        assert np.array_equal(_bits(disp_p), _bits(disp_r))
        assert np.array_equal(in_p, in_r)
        return
    # the reference's interpret route fuses m * x + b (ROADMAP queue 3)
    apart = _rounded_apart(x, m, b)
    differ = _bits(disp_p) != _bits(disp_r)
    assert not (differ & ~apart).any(), np.nonzero(differ & ~apart)[0][:10]
    m32, b32 = np.float32(m), np.float32(b)
    fused = d - (np.float64(m32) * x.astype(np.float64)
                 + np.float64(b32)).astype(np.float32)
    assert np.array_equal(_bits(disp_r[apart]), _bits(fused[apart]))
    assert np.array_equal(_bits(disp_p[apart]),
                          _bits((d - (m32 * x + b32))[apart]))
    # the mask follows each route's own disp
    e32 = np.float32(eps)
    assert np.array_equal(in_p, (disp_p >= -e32) & (disp_p <= e32))
    assert np.array_equal(in_r, (disp_r >= -e32) & (disp_r <= e32))
    assert np.array_equal(in_p[~apart], in_r[~apart])


def test_margin_split_matches_alg1_split():
    """Twin of the reference's test of the same name, with the port's
    ``LinearModel``; the two packages' models and splits agree too."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1_000, 8_192).astype(np.float32)
    d = (2.0 * x + 5 + rng.normal(0, 3, 8_192)).astype(np.float32)
    model = LinearModel(m=2.0, b=5.0, eps_lb=6.0, eps_ub=6.0)
    want = model.inlier_mask(x.astype(np.float64), d.astype(np.float64))
    ref_want = RefLinearModel(m=2.0, b=5.0, eps_lb=6.0,
                              eps_ub=6.0).inlier_mask(x.astype(np.float64),
                                                      d.astype(np.float64))
    assert np.array_equal(want, ref_want)
    disp, got = split_by_margin(x, d, 2.0, 5.0, 6.0, 6.0, device="cpu")
    assert (_np(got) == want).mean() > 0.999
    disp_r, got_r = jops.split_by_margin(x, d, 2.0, 5.0, 6.0, 6.0,
                                         use_pallas=False)
    assert np.array_equal(_np(got), np.asarray(got_r))
    assert np.array_equal(_bits(_np(disp)), _bits(disp_r))


# ---- the float32 row-id test above 2^24 rows --------------------------------

BIG = 2 ** 24 + 1


def _big_columns():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1_000, BIG).astype(np.float32)
    d = (2 * x + 5 + rng.normal(0, 3, BIG)).astype(np.float32)
    return x, d


def test_bucket_histogram_drops_row_2_24_as_the_reference():
    """float32(2^24 + 1) == 2^24, so row 2^24 fails ``float32(id) < n_valid``
    in both packages (the reference's contract, ROADMAP queue 3)."""
    x, d = _big_columns()
    h_p = _np(bucket_histogram(x, d, buckets=16, device="cpu"))
    h_r = np.asarray(jops.bucket_histogram(x, d, buckets=16,
                                           use_pallas=False))
    assert np.array_equal(h_p, h_r)
    assert h_p.astype(np.int64).sum() == BIG - 1


def test_split_by_margin_drops_row_2_24_as_the_reference():
    x, d = _big_columns()
    disp_p, in_p = split_by_margin(x, d, 2.0, 5.0, 6.0, 6.0, device="cpu")
    disp_r, in_r = jops.split_by_margin(x, d, 2.0, 5.0, 6.0, 6.0,
                                        use_pallas=False)
    disp_p, in_p, in_r = _np(disp_p), _np(in_p), np.asarray(in_r)
    assert np.array_equal(_bits(disp_p), _bits(disp_r))
    assert np.array_equal(in_p, in_r)
    assert -6.0 <= disp_p[-1] <= 6.0          # inside the margin by disp,
    assert not in_p[-1] and not in_r[-1]      # dropped by the row-id test


@pytest.mark.parametrize("centre", [2 ** 24, 2 ** 25, 20_000_000])
def test_kept_prefix_equals_the_float32_row_id_test(centre):
    """The redesigned kernel keeps rows ``[0, P)`` with ``P`` from
    ``kept_prefix``; that is exactly the rows whose float32 id is below
    ``n_valid`` (numpy's round-to-nearest-even), for the ops contract's
    ``n_valid = float32(n)`` and for thresholds one ulp either side, off
    the integers and out of range."""
    ids = np.arange(centre + 4, dtype=np.int64).astype(np.float32)
    for n in range(centre - 3, centre + 4):
        f = np.float32(n)
        for n_valid in (f, np.nextafter(f, np.float32(0)),
                        np.nextafter(f, np.float32(np.inf)),
                        np.float32(n - 0.5), np.float32(centre / 2 + 0.25),
                        np.float32(0), np.float32(-1), np.float32(np.inf),
                        np.float32(np.nan)):
            kept = ids[:n] < n_valid
            p = kept_prefix(n, n_valid)
            assert kept[:p].all() and not kept[p:].any(), (n, n_valid)
    # the plain version's row-id test keeps the same count
    n = centre + 1
    valid = ref._valid_rows(n, torch.tensor(np.float32(n)), "cpu")
    assert int(valid.sum()) == kept_prefix(n, np.float32(n))


# ---- routing ----------------------------------------------------------------

def test_wrappers_on_cpu_run_the_plain_versions():
    """A CPU tensor takes the plain version and counts no kernel launch."""
    fns = (range_scan, range_scan_batch, grid_histogram, margin_split)
    before = [f.launches for f in fns]
    rows, lo, hi, wins = _batch_case()
    range_scan_query(rows, lo[0], hi[0], wins[0], device="cpu")
    range_scan_batch_query(rows, lo, hi, wins, device="cpu")
    bucket_histogram(rows[0], rows[1], buckets=16, device="cpu")
    split_by_margin(rows[0], rows[1], 1.0, 0.0, 1.0, 1.0, device="cpu")
    assert [f.launches for f in fns] == before


def test_wrappers_refuse_other_devices_and_ragged_inputs():
    meta = dict(device="meta")
    rows = torch.zeros((2, 512), **meta)
    lo = torch.zeros(2, **meta)
    win = torch.zeros(2, dtype=torch.int32, **meta)
    col = torch.zeros(512, **meta)
    params = torch.zeros(8, **meta)
    with pytest.raises(ValueError):
        range_scan(rows, lo, lo, win, tile=256)
    with pytest.raises(ValueError):
        range_scan_batch(rows, lo[:, None], lo[:, None], win[None], tile=256)
    with pytest.raises(ValueError):
        grid_histogram(col, col, params, tile=256)
    with pytest.raises(ValueError):
        margin_split(col, col, params, tile=256)
    cpu = torch.zeros((2, 500))               # not a tile multiple
    win, params = torch.zeros(2, dtype=torch.int32), torch.zeros(8)
    with pytest.raises(ValueError):
        range_scan(cpu, cpu[:, 0], cpu[:, 0], win, tile=256)
    with pytest.raises(ValueError):
        margin_split(cpu[0], cpu[1], params, tile=256)
    with pytest.raises(ValueError):             # bins beyond shared memory
        grid_histogram(cpu[0], cpu[1], params, buckets=300, tile=100)


@pytest.mark.parametrize("n", [1, 3, 999])
def test_grid_histogram_takes_any_n_with_tile_1(n):
    """Both routes take the same inputs: any N that is a multiple of the
    tile (the kernel bins the rows after its last 4-row vector by scalar
    loads), and no N of 2^31 or more (int32 row ids)."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 3, n).astype(np.float32)
    d = (x + rng.normal(0, 1, n)).astype(np.float32)
    lo_x, lo_d = float(x.min()), float(d.min())
    w_x = max(float(x.max()) - lo_x, 1e-6) / 8
    w_d = max(float(d.max()) - lo_d, 1e-6) / 8
    params = torch.tensor([lo_x, 1 / w_x, lo_d, 1 / w_d, n, 0, 0, 0],
                          dtype=torch.float32)
    got = _np(grid_histogram(torch.from_numpy(x), torch.from_numpy(d),
                             params, buckets=8, tile=1))
    p = params.numpy()
    ix = np.clip((x - p[0]) * p[1], 0, 7).astype(np.int64)
    jd = np.clip((d - p[2]) * p[3], 0, 7).astype(np.int64)
    want = np.bincount(ix * 8 + jd, minlength=64).reshape(8, 8)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    huge = torch.zeros(1).expand(2 ** 31)        # a view: nothing allocated
    with pytest.raises(ValueError):
        grid_histogram(huge, huge, params, buckets=8, tile=1)
