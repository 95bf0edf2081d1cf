"""Port parity: ops.peaks and ops.correlate vs subpixal_tpu.

The same seeded cutout batches go through the JAX package's
``find_displacement`` / ``find_peak`` / ``cross_correlate`` (``jnp.fft``
on the CPU) and the port's (``torch.fft``). Sizes 32², 64² and 144²; 144
is above the reference's ``_MATMUL_DFT_MAX`` of 128, where its TPU path
switches transforms. Shifts agree to ``SHIFT_TOL`` px: both are float32
FFT pipelines whose rounding differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subpixal_tpu.ops.correlate import cross_correlate as j_cc
from subpixal_tpu.ops.correlate import find_displacement as j_fd
from subpixal_tpu.ops.peaks import find_peak as j_peak
from subpixal_tpu_torch.ops.correlate import cross_correlate as t_cc
from subpixal_tpu_torch.ops.correlate import find_displacement as t_fd
from subpixal_tpu_torch.ops.peaks import find_peak as t_peak

torch.set_num_threads(2)

#: float32 FFT rounding moves a fitted peak by ~1e-6..1e-5 px
SHIFT_TOL = 2e-4


def _pairs(n, B=6, seed=0):
    """(ref, img, mask): Gaussian sources, img shifted by up to ±1.5 px,
    noise; the mask drops a border strip and a few random pixels."""
    rng = np.random.default_rng(seed + n)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    ref = np.zeros((B, n, n))
    img = np.zeros((B, n, n))
    for b in range(B):
        dx, dy = rng.uniform(-1.5, 1.5, 2)
        for _ in range(3):
            x0, y0 = rng.uniform(0.3 * n, 0.7 * n, 2)
            a, s = rng.uniform(2, 10), rng.uniform(1.5, 3.0)
            ref[b] += a * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * s * s))
            img[b] += a * np.exp(-((xx - x0 - dx) ** 2 + (yy - y0 - dy) ** 2)
                                 / (2 * s * s))
    ref += rng.normal(0, 0.05, ref.shape)
    img += rng.normal(0, 0.05, img.shape)
    mask = rng.random((B, n, n)) > 0.03
    mask[:, :2, :] = False
    return ref.astype(np.float32), img.astype(np.float32), mask


@pytest.mark.parametrize("n", [32, 64, 144])
@pytest.mark.parametrize("usfac", [1, 10])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cc_type", ["CC", "NCC", "ZNCC"])
def test_find_displacement_matches_jax(n, usfac, masked, cc_type):
    ref, img, mask = _pairs(n)
    kw = dict(cc_type=cc_type, usfac=usfac, fit_type="quadratic")
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    j = j_fd(jnp.asarray(ref), jnp.asarray(img), ref_mask=jm, img_mask=jm,
             **kw)
    t = t_fd(torch.from_numpy(ref), torch.from_numpy(img), ref_mask=tm,
             img_mask=tm, **kw)
    np.testing.assert_array_equal(t.fit_ok.numpy(), np.asarray(j.fit_ok))
    assert t.fit_ok.all()
    np.testing.assert_allclose(t.dx.numpy(), np.asarray(j.dx), atol=SHIFT_TOL)
    np.testing.assert_allclose(t.dy.numpy(), np.asarray(j.dy), atol=SHIFT_TOL)
    np.testing.assert_allclose(t.peak.numpy(), np.asarray(j.peak),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("search", ["fitbox", None, 9])
@pytest.mark.parametrize("fit_type", ["quadratic", "gaussian"])
def test_find_displacement_search_box_and_gaussian(search, fit_type):
    """Windowed coarse surface (small box), full-surface argmax (None) and
    a wider int box, with the Gaussian peak fit at usfac 10."""
    ref, img, _ = _pairs(48, seed=3)
    kw = dict(cc_type="NCC", usfac=10, fit_type=fit_type,
              peak_search_box=search)
    j = j_fd(jnp.asarray(ref), jnp.asarray(img), **kw)
    t = t_fd(torch.from_numpy(ref), torch.from_numpy(img), **kw)
    np.testing.assert_allclose(t.dx.numpy(), np.asarray(j.dx), atol=SHIFT_TOL)
    np.testing.assert_allclose(t.dy.numpy(), np.asarray(j.dy), atol=SHIFT_TOL)


@pytest.mark.parametrize("cc_type", ["CC", "NCC"])
def test_cross_correlate_surface_matches_jax(cc_type):
    ref, img, mask = _pairs(40, B=3, seed=5)
    j = np.asarray(j_cc(jnp.asarray(ref), jnp.asarray(img), cc_type=cc_type,
                        ref_mask=jnp.asarray(mask)))
    t = t_cc(torch.from_numpy(ref), torch.from_numpy(img), cc_type=cc_type,
             ref_mask=torch.from_numpy(mask)).numpy()
    scale = np.abs(j).max()
    np.testing.assert_allclose(t, j, atol=1e-5 * scale)


@pytest.mark.parametrize("fit_type", ["quadratic", "gaussian"])
@pytest.mark.parametrize("search", [None, "fitbox", (3, 12, 4, 14)])
def test_find_peak_matches_jax_with_mask(fit_type, search):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:17, 0:19].astype(np.float64)
    surf = np.stack([
        np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 6.0)
        + rng.normal(0, 0.01, xx.shape)
        for cx, cy in rng.uniform(6, 11, (8, 2))]).astype(np.float32)
    surf[0, 0, 0] = 5.0  # a far spike the search boxes must ignore
    mask = rng.random(surf.shape) > 0.05
    kw = dict(peak_fit_box=5, peak_search_box=search, fit_type=fit_type)
    j = j_peak(jnp.asarray(surf), mask=jnp.asarray(mask), **kw)
    t = t_peak(torch.from_numpy(surf), mask=torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(t.ix.numpy(), np.asarray(j.ix))
    np.testing.assert_array_equal(t.iy.numpy(), np.asarray(j.iy))
    np.testing.assert_array_equal(t.fit_ok.numpy(), np.asarray(j.fit_ok))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-4)
    np.testing.assert_allclose(t.y.numpy(), np.asarray(j.y), atol=1e-4)
    np.testing.assert_allclose(t.value.numpy(), np.asarray(j.value),
                               rtol=1e-4, atol=1e-5)


def test_argmax_takes_first_index_on_ties():
    surf = np.zeros((2, 9, 9), np.float32)
    surf[:, 2, 3] = 1.0
    surf[:, 6, 1] = 1.0
    t = t_peak(torch.from_numpy(surf))
    j = j_peak(jnp.asarray(surf))
    assert t.iy.tolist() == [2, 2] and t.ix.tolist() == [3, 3]
    np.testing.assert_array_equal(t.iy.numpy(), np.asarray(j.iy))


def test_upsampling_phase_is_integer_exact():
    """The int32 phase reduction keeps float32 phases small: an exact
    integer shift far from zero lag is recovered at usfac 10."""
    n = 64
    rng = np.random.default_rng(2)
    base = rng.normal(size=(n, n)).astype(np.float32)
    img = np.roll(base, (-7, 11), axis=(0, 1))[None]
    t = t_fd(torch.from_numpy(base[None]), torch.from_numpy(img),
             usfac=10, peak_search_box=None)
    assert abs(float(t.dx[0]) - 11) < 1e-3 and abs(float(t.dy[0]) + 7) < 1e-3


def _nwin(usfac, peak_fit_box=5):
    return -(-(usfac + peak_fit_box + 1) // 8) * 8


@pytest.mark.parametrize("H,W,usfac,box,takes", [
    (32, 32, 8, 5, True),       # the align paths' shapes
    (48, 48, 8, 5, True),
    (256, 256, 8, 5, True),     # the oversized bucket's cap
    (512, 512, 10, 17, True),
    (112, 254, 10, 5, True),    # 7·16 by 2·127
    (509, 509, 10, 5, True),    # a prime
    (512, 512, 42, 5, True),    # nwin 48
    (512, 512, 43, 5, False),   # nwin 56: past a CTA's shared memory
    (256, 256, 100, 5, False),  # nwin 112
    (1024, 1024, 10, 5, True),
    (1024, 1024, 20, 5, False),
])
def test_window_fits_shape_rule(H, W, usfac, box, takes):
    """The windowed measurement's shape rule: kernel B3's shared memory
    at its smallest cut grows with nwin · H."""
    from subpixal_tpu_torch.ops.correlate import window_fits

    assert window_fits(H, W, _nwin(usfac), box, box) is takes


def test_window_fits_reads_the_kernels_constants():
    """The rule's constants are those of csrc/measure_displacement.cu:
    227 KiB a CTA, clusters of up to 8 CTAs of up to 512 threads."""
    import pathlib
    import re

    import subpixal_tpu_torch

    src = (pathlib.Path(subpixal_tpu_torch.__file__).parent / "csrc"
           / "measure_displacement.cu").read_text()
    assert re.search(r"kSmemOne = 227 \* 1024;", src)
    assert re.search(r"kMaxCluster = 8;", src)
    assert re.search(r"kClusterThreads = 512;", src)
    assert re.search(r"kRedSlots = 4 \* kMaxWarps, kRedArg = kRedSlots \+ 16;",
                     src)
    assert re.search(r"kRed = kRedArg \+ 2 \* kMaxWarps;", src)


@pytest.mark.parametrize("masked", [False, True])
def test_find_displacement_past_window_fits_matches_jax(masked):
    """512² pairs at usfac 50 (nwin 56) under the 'fitbox' search: past
    kernel B3's shapes, so the port's find_displacement takes the full
    surface without calling the windowed measurement, and matches the JAX
    package's default path."""
    from subpixal_tpu_torch.kernels.measure import find_displacement

    ref, img, mask = _pairs(512, B=2, seed=7)
    kw = dict(cc_type="NCC", usfac=50, fit_type="gaussian")
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None

    def refuse(*a, **k):
        raise AssertionError("the windowed measurement was called")

    j = j_fd(jnp.asarray(ref), jnp.asarray(img), ref_mask=jm, img_mask=jm,
             **kw)
    tr, ti = torch.from_numpy(ref), torch.from_numpy(img)
    t = t_fd(tr, ti, ref_mask=tm, img_mask=tm, measure=refuse, **kw)
    k = find_displacement(tr, ti, ref_mask=tm, img_mask=tm, **kw)
    for r in (t, k):
        np.testing.assert_array_equal(r.fit_ok.numpy(), np.asarray(j.fit_ok))
        assert r.fit_ok.all()
        np.testing.assert_allclose(r.dx.numpy(), np.asarray(j.dx),
                                   atol=SHIFT_TOL)
        np.testing.assert_allclose(r.dy.numpy(), np.asarray(j.dy),
                                   atol=SHIFT_TOL)
