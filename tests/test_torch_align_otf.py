"""Port parity: ``wcsupdate='otf'`` vs ``subpixal_tpu.align_images``.

Under 'otf' (update as you go) the reference is re-drizzled before each
exposure is measured, and that exposure's fit is applied before the next
one. The scenes of tests/test_align.py's otf tests (three exposures with
planted shifts; two with an oversized source that the second static-shape
bucket measures whole) and a single exposure, for which 'otf' runs the
batch step, go through both packages on the CPU. They must run the same
iterations, agree on convergence and ``nmatches``, and agree on every
iteration's shifts within ``SHIFT_TOL`` px.
"""

import warnings

import numpy as np
import pytest
import torch

from subpixal_tpu import align_images as j_align
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align as TA
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.resample import Drizzle

torch.set_num_threads(2)

#: the acceptance bound: every iteration's shifts (px)
SHIFT_TOL = 1e-3

OTF = dict(fitgeom="shift", wcsupdate="otf", max_iterations=8,
           eps_shift=0.004, fit_type="gaussian", min_sources=5)


def _make_wcs(crpix, scale=0.05):
    s = scale / 3600.0
    return JTanWCS(crpix=np.asarray(crpix, float),
                   crval=np.array([150.0, 2.0]),
                   cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]))


def planted_scene(shift_err, giant=False, shape=(256, 256), seed=1):
    """tests/test_align.py · planted_scene: 30 stars rendered with each
    exposure's true WCS, which carries a planted error; with ``giant`` an
    8 px-sigma source whose footprint outgrows 48² cutouts is added, as in
    test_otf_oversized_footprint_bucket."""
    rng = np.random.default_rng(seed)
    stars = []
    while len(stars) < 30:
        p = rng.uniform(30, 220, 2)
        if all(np.hypot(*(p - q)) > 18.0 for q in stars):
            stars.append(p)
    stars = np.asarray(stars)
    ref = _make_wcs((128, 128))
    rng = np.random.default_rng(seed + 10)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    exps = []
    for e, err in enumerate(np.asarray(shift_err, float)):
        dith = rng.uniform(-6, 6, 2)
        true_wcs = _make_wcs((128 + dith[0], 128 + dith[1]))
        img = np.random.default_rng(100 + e).normal(0, 0.5, shape)
        xs, ys = true_wcs.world_to_pixel(*ref.pixel_to_world(stars[:, 0],
                                                             stars[:, 1]))
        for x0, y0 in zip(xs, ys):
            if -10 < x0 < W + 10 and -10 < y0 < H + 10:
                img += 200.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                      / (2 * 1.8 ** 2))
        wrong = _make_wcs((128 + dith[0] + err[0], 128 + dith[1] + err[1]))
        data = img.astype(np.float32)
        if giant:
            x0, y0 = wrong.world_to_pixel(*ref.pixel_to_world(60.0, 190.0))
            data = data + (400.0 * np.exp(
                -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 8.0 ** 2))
            ).astype(np.float32)
        exps.append(JExposure(data, wrong, name=f"e{e}"))
    return exps


def _run_both(exps, **kw):
    jr = j_align(resample=JDrizzle(exps, pixfrac=1.0), **kw)
    tr = TA.align_images(resample=Drizzle(exposures_from_reference(exps),
                                          pixfrac=1.0, device="cpu"),
                         device="cpu", **kw)
    return jr, tr


def _assert_same_run(jr, tr):
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    assert len(tr.history) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)


def test_otf_matches_jax():
    """tests/test_align.py · test_wcsupdate_otf_matches_batch's scene."""
    err = np.array([(0.0, 0.0), (1.1, -0.6), (-0.8, 0.4)])
    jr, tr = _run_both(planted_scene(err), usfac=1, **OTF)
    _assert_same_run(jr, tr)
    assert tr.converged
    rel = tr.shifts - tr.shifts[0]
    assert np.abs(rel - (err - err[0])).max() < 0.01


def test_otf_differs_from_batch_after_the_first_exposure():
    """In one otf iteration the first exposure sees the batch reference,
    the later ones a reference that holds the earlier updates."""
    err = np.array([(0.0, 0.0), (1.1, -0.6), (-0.8, 0.4)])
    exps = exposures_from_reference(planted_scene(err))
    kw = dict(OTF, usfac=1, max_iterations=1, device="cpu")
    otf = TA.align_images(exposures=exps, **kw)
    batch = TA.align_images(exposures=exps, **dict(kw, wcsupdate="batch"))
    a, b = otf.history[0], batch.history[0]
    assert np.hypot(*np.subtract(a[0].shift, b[0].shift)) < 1e-6
    assert max(np.hypot(*np.subtract(a[e].shift, b[e].shift))
               for e in (1, 2)) > 1e-3


def test_otf_bucket_matches_jax():
    """tests/test_align.py · test_otf_oversized_footprint_bucket's scene:
    the oversized source is measured whole in each otf step."""
    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the truncation warning must not fire
        jr, tr = _run_both(planted_scene(err, giant=True), max_cut_size=48,
                           use_weights=False, **OTF)
    assert tr.truncated_sources == [] == jr.truncated_sources
    assert "big_bucket_stage" in tr.setup_breakdown
    _assert_same_run(jr, tr)
    rel = tr.shifts - tr.shifts[0]
    assert np.abs(rel - (err - err[0])).max() < 0.02


def test_otf_one_exposure_runs_the_batch_step():
    """With one exposure 'otf' is the batch step, in both packages."""
    exps = planted_scene([(0.4, -0.3)])
    kw = dict(OTF, usfac=1, max_iterations=3)
    jr, tr = _run_both(exps, **kw)
    _assert_same_run(jr, tr)
    batch = TA.align_images(exposures=exposures_from_reference(exps),
                            device="cpu", **dict(kw, wcsupdate="batch"))
    np.testing.assert_array_equal(tr.shifts, batch.shifts)


@pytest.mark.parametrize("wcsupdate", ["batch", "otf"])
def test_redrizzles_per_iteration(wcsupdate, monkeypatch):
    """The step re-drizzles the stack once an iteration under 'batch' and
    once per exposure under 'otf'."""
    calls = []
    real = TA.drizzle_deposit_stack

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(TA, "drizzle_deposit_stack", spy)
    err = np.array([(0.0, 0.0), (1.1, -0.6), (-0.8, 0.4)])
    res = TA.align_images(exposures=exposures_from_reference(
        planted_scene(err)), device="cpu",
        **dict(OTF, usfac=1, max_iterations=2, eps_shift=1e-9,
               wcsupdate=wcsupdate))
    per_iter = 3 if wcsupdate == "otf" else 1
    assert calls == [3] * (per_iter * res.n_iterations)
