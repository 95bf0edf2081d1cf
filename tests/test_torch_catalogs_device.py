"""Port parity: the device source finder vs subpixal_tpu.catalogs.device.

The same numpy scenes (tests/test_catalogs.py's device-finder scenes, a
scene of two exactly equal peaks, random masks) go through the JAX
functions on the CPU and through the port's on ``device="cpu"``. Rows
must come out equal and in the same order: ids, areas and bboxes exactly,
positions within ``POS_TOL`` px, fluxes within ``FLUX_RTOL`` relative,
segmentation planes equal. The statistics agree within ``STATS_RTOL``:
XLA's float32 prefix sums and torch's associate differently.
"""

import warnings

import numpy as np
import pytest
import torch

from subpixal_tpu.catalogs import device as J
from subpixal_tpu_torch import aot
from subpixal_tpu_torch import catalogs_device as T

torch.set_num_threads(2)

POS_TOL = 1e-4
FLUX_RTOL = 1e-5
STATS_RTOL = 1e-5


def _gauss(H, W):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)

    def g(x0, y0, amp, sig):
        return amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                            / (2 * sig * sig))
    return g


def _field():
    """tests/test_catalogs.py · TestDeviceCatalog._scene: 12 stars on a
    noisy 256² background."""
    rng = np.random.default_rng(11)
    H = W = 256
    img = rng.normal(5.0, 2.0, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    for (y0, x0), amp in zip(rng.uniform(20, H - 20, (12, 2)),
                             rng.uniform(40, 120, 12)):
        img += (amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 4.0)
                ).astype(np.float32)
    return img


def _crowded():
    """tests/test_catalogs.py:338: two merged pairs and a control star."""
    rng = np.random.default_rng(9)
    g = _gauss(96, 96)
    return (g(40.0, 48.0, 100.0, 2.0) + g(47.0, 50.0, 55.0, 2.0)
            + g(70.0, 20.0, 80.0, 1.8) + g(70.0, 27.5, 60.0, 1.8)
            + g(20.0, 75.0, 90.0, 2.0)
            + rng.normal(0, 0.05, (96, 96))).astype(np.float32)


def _giant():
    """tests/test_catalogs.py:389: a ~65 px footprint and two stars."""
    rng = np.random.default_rng(21)
    g = _gauss(160, 160)
    return (g(80.0, 78.0, 100.0, 12.0) + g(30.0, 30.0, 60.0, 1.8)
            + g(130.0, 40.0, 70.0, 1.8)
            + rng.normal(0, 0.05, (160, 160))).astype(np.float32)


def _capped():
    """tests/test_catalogs.py:262: 20 stars of rising amplitude."""
    rng = np.random.default_rng(3)
    img = rng.normal(0, 0.1, (256, 256)).astype(np.float32)
    yy, xx = np.mgrid[0:9, 0:9].astype(np.float32) - 4
    psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * 1.5 ** 2))
    for (y, x), a in zip(rng.integers(12, 244, (20, 2)),
                         np.linspace(10, 100, 20)):
        img[y - 4:y + 5, x - 4:x + 5] += a * psf
    return img


def _twin():
    """tests/test_catalogs.py:289: two maxima in one component."""
    g = _gauss(64, 64)
    return (g(30.0, 32.0, 50.0, 2.0) + g(36.0, 32.0, 30.0, 2.0)
            ).astype(np.float32)


def _equal_peaks():
    """Three stars of exactly equal peak value, a flat plateau and a
    fainter star: the brightness order among equal values is the index
    order (lax.top_k's tie rule)."""
    img = np.zeros((64, 96), np.float32)
    yy, xx = np.mgrid[-4:5, -4:5].astype(np.float32)
    psf = (40.0 * np.exp(-(xx ** 2 + yy ** 2) / 4.5)).astype(np.float32)
    for y, x in ((40, 20), (12, 70), (40, 60)):
        img[y - 4:y + 5, x - 4:x + 5] += psf
    img[20:23, 30:34] = 40.0                       # plateau, same value
    img[52 - 4:52 + 5, 84 - 4:84 + 5] += 0.5 * psf
    return img


SCENES = dict(field=_field, crowded=_crowded, giant=_giant,
              capped=_capped, twin=_twin, equal=_equal_peaks)


@pytest.fixture(scope="module")
def jax_find():
    """The JAX finder's result per (scene, keyword arguments), each run
    once per module: it compiles on the CPU."""
    memo = {}

    def run(scene, **kw):
        key = (scene, tuple(sorted(kw.items())))
        if key not in memo:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                cat, seg = J.find_sources_device(SCENES[scene](), **kw)
            memo[key] = (cat, np.asarray(seg),
                         [str(w.message) for w in rec])
        return memo[key]
    return run


def _port_find(scene, **kw):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cat, seg = T.find_sources_device(
            torch.from_numpy(SCENES[scene]()), **kw)
    assert seg.dtype == torch.int32 and seg.device.type == "cpu"
    return cat, seg.numpy(), [str(w.message) for w in rec]


def _assert_same(j, t, peak_rtol=0.0):
    jc, jseg, jwarn = j
    tc, tseg, twarn = t
    assert tc.colnames == jc.colnames
    assert len(tc) == len(jc)
    for col in ("id", "area", "xmin", "xmax", "ymin", "ymax"):
        np.testing.assert_array_equal(tc[col], jc[col], err_msg=col)
        assert tc[col].dtype == jc[col].dtype, col
    for col in ("x", "y"):
        assert tc[col].dtype == jc[col].dtype, col
        if len(tc):
            assert np.abs(tc[col] - jc[col]).max() < POS_TOL, col
    np.testing.assert_allclose(tc["flux"], jc["flux"], rtol=FLUX_RTOL)
    np.testing.assert_allclose(tc["peak"], jc["peak"], rtol=peak_rtol,
                               atol=peak_rtol)
    np.testing.assert_array_equal(tseg, jseg)
    assert len(twarn) == len(jwarn)


def test_stats_match_jax():
    img = _field()
    for a, b in zip(J.sigma_clipped_stats_device(img),
                    T.sigma_clipped_stats_device(torch.from_numpy(img))):
        assert b.dtype == torch.float32
        assert abs(float(b) - float(a)) <= STATS_RTOL * abs(float(a))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("density", [0.3, 0.55])
def test_labels_match_jax(connectivity, density):
    rng = np.random.default_rng(int(100 * density) + connectivity)
    det = rng.random((72, 90)) < density
    want = np.asarray(J.label_components_device(det,
                                                connectivity=connectivity))
    got = T.label_components_device(torch.from_numpy(det),
                                    connectivity=connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_labels_stop_at_max_iters():
    """A long snake needs many rounds: capped ones must stop where the
    JAX while_loop stops, mid-way, with the same labels."""
    det = np.zeros((40, 40), bool)
    det[::4, 1:-1] = True
    det[1::4, -2] = det[2::4, -2] = True
    det[3::4, 1] = True
    for it in (1, 2, 3, 5):
        want = np.asarray(J.label_components_device(det, max_iters=it))
        got = T.label_components_device(torch.from_numpy(det), max_iters=it)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["peaks", "ccl"])
def test_find_sources_explicit_threshold_matches_jax(jax_find, method):
    j = jax_find("field", threshold=12.0, method=method)
    _assert_same(j, _port_find("field", threshold=12.0, method=method))
    assert len(j[0]) == 12


@pytest.mark.parametrize("method", ["peaks", "ccl"])
def test_find_sources_derived_threshold_matches_jax(jax_find, method):
    """The derived threshold differs by a few float32 ulps (the prefix
    sums), so the peak column gets a relative tolerance."""
    j = jax_find("field", method=method)
    _assert_same(j, _port_find("field", method=method), peak_rtol=1e-5)


@pytest.mark.parametrize("nthresh", [32, 1])
def test_crowded_deblend_matches_jax(jax_find, nthresh):
    kw = dict(threshold=1.0, npixels=5, method="peaks", window=32,
              deblend_nthresh=nthresh)
    j = jax_find("crowded", **kw)
    _assert_same(j, _port_find("crowded", **kw))
    assert len(j[0]) == (5 if nthresh > 1 else 3)


def test_window_escalation_matches_jax(jax_find):
    kw = dict(threshold=1.0, npixels=5, method="peaks", window=32,
              deblend_nthresh=1)
    j = jax_find("giant", **kw)
    t = _port_find("giant", **kw)
    _assert_same(j, t)
    assert int(t[0]["area"].max()) > 32 * 32   # measured whole


def test_cap_warning_matches_jax(jax_find):
    kw = dict(threshold=3.0, max_sources=8)
    j = jax_find("capped", **kw)
    t = _port_find("capped", **kw)
    _assert_same(j, t)
    assert len(t[0]) == 8 and any("FAINTEST" in m for m in t[2])


@pytest.mark.parametrize("nthresh", [1, 32])
def test_twin_dedup_matches_jax(jax_find, nthresh):
    kw = dict(threshold=1.0, deblend_nthresh=nthresh)
    j = jax_find("twin", **kw)
    _assert_same(j, _port_find("twin", **kw))
    assert len(j[0]) == (1 if nthresh == 1 else 2)


@pytest.mark.parametrize("cap", [8192, 2])
def test_equal_peaks_tie_order_matches_jax(jax_find, cap):
    """Equal peak values: rows, ranks and the segmentation plane follow
    the index order; under a cap of 2 the index order decides which of
    the equal peaks survive."""
    kw = dict(threshold=1.0, max_sources=cap)
    j = jax_find("equal", **kw)
    t = _port_find("equal", **kw)
    _assert_same(j, t)
    assert len(t[0]) == (5 if cap > 2 else 2)


def test_ccl_npixels_filter_and_seg_zeroing_matches_jax():
    """tests/test_catalogs.py:250: a 1-px source is rejected and zeroed
    in the plane, a 9-px one kept (the ``ccl`` keep LUT)."""
    img = np.zeros((64, 64), np.float32)
    img[10, 10] = 100.0
    img[30:33, 30:33] = 50.0
    for method in ("ccl", "peaks"):
        jc, jseg = J.find_sources_device(img, threshold=10.0, method=method)
        tc, tseg = T.find_sources_device(torch.from_numpy(img),
                                         threshold=10.0, method=method)
        _assert_same((jc, np.asarray(jseg), []), (tc, tseg.numpy(), []))
        assert len(tc) == 1 and tseg[10, 10] == 0 and tseg[31, 31] > 0


def test_two_stage_sizing_buckets_the_batch(monkeypatch):
    """Above 256 slots the candidates are counted first and the batch is
    bucketed to 128 for the field's dozen candidates."""
    seen = []
    core = T._find_sources_peaks_core

    def spy(img, thr, **kw):
        seen.append(kw["max_sources"])
        return core(img, thr, **kw)

    monkeypatch.setattr(T, "_find_sources_peaks_core", spy)
    # a program cached before the patch would call the unpatched core
    monkeypatch.setattr(aot, "_MEM", {})
    cat, _ = T.find_sources_device(torch.from_numpy(_field()),
                                   threshold=12.0)
    assert seen == [128] and len(cat) == 12


def test_chunked_floods_and_sparse_checks_change_nothing(monkeypatch):
    """The deblend levels run in chunks under a memory budget, and the
    fixed points test for convergence every few rounds: neither may
    change a result."""
    kw = dict(threshold=1.0, npixels=5, window=32)
    base = _port_find("crowded", **kw)
    monkeypatch.setattr(T, "_FLOOD_BUDGET", 1)      # one level a chunk
    monkeypatch.setattr(T, "_CHECK_EVERY", 1)
    _assert_same(base, _port_find("crowded", **kw))
    monkeypatch.setattr(T, "_CHECK_EVERY", 7)
    _assert_same(base, _port_find("crowded", **kw))


def test_device_source_catalog():
    img = torch.from_numpy(_crowded())
    c = T.DeviceSourceCatalog(img, threshold=1.0, device="cpu")
    cat, seg = T.find_sources_device(img, threshold=1.0)
    assert len(c.catalog) == len(cat) == 5
    np.testing.assert_array_equal(c.catalog["x"], cat["x"])
    assert torch.equal(c.segmentation_device, seg)
    host = c.segmentation
    assert isinstance(host, np.ndarray) and c.segmentation is host
    c.set_filters([("flux", ">", float(np.sort(cat["flux"])[1]))])
    assert len(c) == 3
    # an array image goes to the catalog's device
    a = T.DeviceSourceCatalog(_crowded(), threshold=1.0, device="cpu")
    np.testing.assert_array_equal(a.segmentation, host)
