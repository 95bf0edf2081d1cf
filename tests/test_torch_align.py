"""Port parity: the whole align slice vs subpixal_tpu.align_images.

One simulated scene goes through the JAX package (CPU: XLA deposit and
gather, host finder and pixmaps, the on-device fixed point) and through
the port on ``device="cpu"`` (the plain versions of the kernels). They
must find the same sources, run the same number of iterations, agree on
convergence, and agree on every iteration's per-exposure shifts within
``SHIFT_TOL`` px.
"""

import numpy as np
import pytest
import torch

from subpixal_tpu import align_images as j_align
from subpixal_tpu.resample import Drizzle as JDrizzle
from subpixal_tpu.resample import Exposure as JExposure
from subpixal_tpu.testing import simulate_stack as j_simulate
from subpixal_tpu.wcs.wcs import TanWCS as JTanWCS
from subpixal_tpu_torch import align_images
from subpixal_tpu_torch.convert import exposures_from_reference
from subpixal_tpu_torch.resample import Drizzle
from subpixal_tpu_torch.testing import pairwise_shift_errors, simulate_stack

torch.set_num_threads(2)

#: the acceptance bound of the slice: every iteration's shifts
SHIFT_TOL = 1e-3


def _assert_same_run(jr, tr):
    assert tr.n_iterations == jr.n_iterations
    assert tr.converged == jr.converged
    assert len(tr.history) == len(jr.history)
    for jrecs, trecs in zip(jr.history, tr.history):
        for a, b in zip(jrecs, trecs):
            assert (a.name, a.iteration, a.nmatches) == (
                b.name, b.iteration, b.nmatches)
            assert np.hypot(*np.subtract(a.shift, b.shift)) < SHIFT_TOL
            np.testing.assert_allclose(b.matrix, a.matrix, atol=SHIFT_TOL / 1e3)
            assert b.escaped == 0
    np.testing.assert_allclose(tr.shifts, jr.shifts, atol=SHIFT_TOL)
    np.testing.assert_allclose(tr.matrices, jr.matrices, atol=1e-6)


def test_align_slice_matches_jax():
    exps, planted = j_simulate(n_exp=3, shape=(256, 256), n_stars=12,
                               seed=5)
    jr = j_align(exposures=exps, max_iterations=6)
    tr = align_images(exposures=exposures_from_reference(exps),
                      device="cpu", max_iterations=6)
    _assert_same_run(jr, tr)
    assert tr.history[0][0].nmatches == 12  # every star measured
    assert pairwise_shift_errors(tr.shifts, planted) < 0.005
    # corrected WCSs and the final drizzle carry the same corrections
    for a, b in zip(jr.exposures, tr.exposures):
        np.testing.assert_allclose(b.wcs.crval, a.wcs.crval, rtol=0,
                                   atol=1e-9)
    assert tr.drizzle.output_shape == tuple(jr.drizzle.output_shape)


def test_simulate_stack_matches_jax():
    je, jp = j_simulate(n_exp=2, shape=(96, 80), n_stars=5, seed=3)
    te, tp = simulate_stack(n_exp=2, shape=(96, 80), n_stars=5, seed=3)
    assert tp == jp
    for a, b in zip(je, te):
        np.testing.assert_array_equal(b.data, np.asarray(a.data))
        np.testing.assert_array_equal(b.wcs.cd, a.wcs.cd)


def _planted_scene(n_exp, shift_err, shape=(256, 256), seed=1):
    """The scene of tests/test_align.py: stars in a reference frame,
    exposures rendered with their TRUE WCS but carrying a WRONG one."""
    def make_wcs(crpix, scale=0.05):
        s = scale / 3600.0
        return JTanWCS(crpix=np.asarray(crpix, float),
                       crval=np.array([150.0, 2.0]),
                       cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]))

    rng = np.random.default_rng(seed)
    stars = []
    while len(stars) < 30:
        p = rng.uniform(30, 220, 2)
        if all(np.hypot(*(p - q)) > 18.0 for q in stars):
            stars.append(p)
    stars = np.asarray(stars)
    ref_frame = make_wcs((128, 128))
    rng = np.random.default_rng(seed + 10)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    exps = []
    for e in range(n_exp):
        dith = rng.uniform(-6, 6, 2)
        true_wcs = make_wcs((128 + dith[0], 128 + dith[1]))
        err = np.asarray(shift_err[e], float)
        noise = np.random.default_rng(100 + e)
        img = noise.normal(0, 0.5, shape)
        xs, ys = true_wcs.world_to_pixel(
            *ref_frame.pixel_to_world(stars[:, 0], stars[:, 1]))
        for x0, y0 in zip(xs, ys):
            img += 200.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 6.48)
        # one huge source whose footprint outgrows the 48 px cutouts
        x0, y0 = true_wcs.world_to_pixel(*ref_frame.pixel_to_world(60.0,
                                                                     190.0))
        img += 400.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 128.0)
        wrong = make_wcs((128 + dith[0] + err[0], 128 + dith[1] + err[1]))
        exps.append(JExposure(img.astype(np.float32), wrong, name=f"e{e}"))
    return exps


def test_oversized_footprint_bucket_matches_jax():
    """Counterpart of tests/test_align.py ·
    test_oversized_footprint_bucket_measures_whole: the oversized source
    is re-measured whole in the second static-shape bucket (nothing
    truncated), and the port follows the JAX run iteration by iteration."""
    import warnings

    err = np.array([(0.0, 0.0), (0.9, -0.4)])
    exps = _planted_scene(2, err)
    kw = dict(fitgeom="shift", max_iterations=8, eps_shift=0.004,
              fit_type="gaussian", min_sources=5, max_cut_size=48,
              use_weights=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the truncation warning must not fire
        jr = j_align(resample=JDrizzle(exps, pixfrac=1.0), **kw)
        tr = align_images(resample=Drizzle(exposures_from_reference(exps),
                                           pixfrac=1.0, device="cpu"),
                          device="cpu", **kw)
    assert tr.truncated_sources == [] == jr.truncated_sources
    assert "big_bucket_stage" in tr.setup_breakdown  # the bucket engaged
    _assert_same_run(jr, tr)
    rel = tr.shifts - tr.shifts[0]
    assert np.abs(rel - (err - err[0])).max() < 0.02


def test_history_last_keeps_one_record():
    exps, _ = simulate_stack(n_exp=2, shape=(128, 128), n_stars=8, seed=2)
    res = align_images(exposures=exps, device="cpu", max_iterations=3,
                       eps_shift=1e-9, history="last")
    assert res.n_iterations == 3 and not res.converged
    assert len(res.history) == 1 and res.history[0][0].iteration == 2
    with pytest.raises(ValueError, match="sources"):
        align_images(exposures=exps, device="cpu", min_sources=500)


def test_device_mismatch_and_use_pallas_true_off_cuda_raise():
    """A Drizzle on another device than the align's raises, and so does
    use_pallas=True off CUDA, as the JAX package's kernels raise off TPU.
    (use_pallas=False runs the plain versions, held to the JAX package in
    tests/test_torch_use_pallas.py.)"""
    exps, _ = simulate_stack(n_exp=2, shape=(96, 96), n_stars=4, seed=1)
    with pytest.raises(ValueError, match="device"):
        align_images(resample=Drizzle(exps, device="meta"), device="cpu")
    with pytest.raises(ValueError, match="use_pallas=True"):
        align_images(exposures=exps, device="cpu", use_pallas=True)


def test_cuda_device_without_index_is_the_current_device(monkeypatch):
    """A CUDA device named without an index is the current device (under a
    mesh, the rank's card), in the check that ``resample`` and ``device``
    agree: 'cuda' then equals 'cuda:1' and differs from 'cuda:0'."""
    from subpixal_tpu_torch.align import _canon

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _canon("cuda") == torch.device("cuda", 1) == _canon("cuda:1")
    assert _canon(torch.device("cuda")) != _canon("cuda:0")
    assert _canon("cpu") == torch.device("cpu") == _canon(torch.device("cpu"))


#: spellings of card 0 while it is the current device
_CARD0 = ("cuda", torch.device("cuda"), "cuda:0", torch.device("cuda", 0))


@pytest.mark.parametrize("a,b,same", [
    *((a, b, True) for i, a in enumerate(_CARD0) for b in _CARD0[i + 1:]),
    ("cuda:1", "cuda", False), ("cpu", "cpu", True)])
def test_indexed_devices_compare_however_spelled(monkeypatch, a, b, same):
    """align's test for reusing the Drizzle's device stack: every spelling
    of the current card names one device, though PyTorch's own ``==``
    tells ``torch.device("cuda")`` from ``torch.device("cuda", 0)``."""
    from subpixal_tpu_torch.align import _canon

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert (_canon(a) == _canon(b)) is same
    assert (_canon(b) == _canon(a)) is same
